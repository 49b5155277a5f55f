"""``shrimpy-tpu-torch`` command group."""

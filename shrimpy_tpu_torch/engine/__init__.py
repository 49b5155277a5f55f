"""Acquisition engine (counterpart of ``shrimpy_tpu/engine``): so far only
the focus metric of :mod:`shrimpy_tpu_torch.engine.autofocus`; the event
loop, plans and replay are ROADMAP queue 1 item 12."""

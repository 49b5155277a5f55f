"""Neural models: the virtual-staining nets and their inference
(counterpart of ``shrimpy_tpu/models``; training, ``models/train.py``, is
ROADMAP queue 1 item 10's second part)."""

from shrimpy_tpu_torch.models.vsunet import (  # noqa: F401
    VirtualStainer,
    VSUNet,
    VSUNeXt2,
    build_model,
    infer_volume,
    infer_volume_stack,
)

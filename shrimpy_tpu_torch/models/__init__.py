"""Neural models: the virtual-staining nets and their inference
and training (counterpart of ``shrimpy_tpu/models``; training is
``models/train.py``, imported on its own)."""

from shrimpy_tpu_torch.models.vsunet import (  # noqa: F401
    VirtualStainer,
    VSUNet,
    VSUNeXt2,
    build_model,
    infer_volume,
    infer_volume_stack,
)

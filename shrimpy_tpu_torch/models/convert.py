"""The weight carry: the JAX package's flax params -> the port's state dict.

An orbax checkpoint of the JAX package is restored there (it needs jax
and orbax); its param tree, as nested dicts of numpy arrays, comes here and
leaves as the ``state_dict`` of the port's net for the same settings, ready
for :meth:`~shrimpy_tpu_torch.models.vsunet.VirtualStainer.save_ckpt`.

Names: unext2's are the inverse of ``shrimpy_tpu/models/torch_import.py``'s
table (``stem`` <- ``stem.conv``, ``downsample_norm_{i}`` /
``downsample_conv_{i}`` <- ``encoder.stages.{i}.downsample.{0,1}``,
``stage_{i}_block_{j}`` <- ``encoder.stages.{i}.blocks.{j}``, ``up_{i}`` <-
``decoder.stages.{i}``, ``head_upsample`` / ``head_proj`` <-
``head.{upsample,proj}``); unet25d's are flax's automatic names
(``_ConvBlock_{k}/{Conv_0,Conv_1,LayerNorm_0}`` <- ``blocks.{k}.{conv0,
conv1,norm}``, ``Conv_0`` <- ``head``). Layouts: convolution kernels
``(kh, kw, I, O)`` / ``(kd, kh, kw, I, O)`` -> ``(O, I, kh, kw)`` /
``(O, I, kd, kh, kw)``, dense kernels ``(I, O)`` -> ``(O, I)``, LayerNorm
``scale`` -> ``weight``, GRN ``(C,)`` -> ``(1, 1, 1, C)``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from shrimpy_tpu_torch.models.vsunet import build_model

# (torch module path, flax module path) patterns, first match wins.
_UNEXT2_NAMES = (
    (r"stem\.conv", r"stem"),
    (r"encoder\.stages\.(\d+)\.downsample\.0", r"downsample_norm_\1"),
    (r"encoder\.stages\.(\d+)\.downsample\.1", r"downsample_conv_\1"),
    (r"encoder\.stages\.(\d+)\.blocks\.(\d+)\.(\w+)", r"stage_\1_block_\2/\3"),
    (r"decoder\.stages\.(\d+)\.blocks\.(\d+)\.(\w+)", r"up_\1/blocks_\2/\3"),
    (r"decoder\.stages\.(\d+)\.(upsample|proj)", r"up_\1/\2"),
    (r"head\.(upsample|proj)", r"head_\1"),
)
_UNET25D_NAMES = (
    (r"blocks\.(\d+)\.conv0", r"_ConvBlock_\1/Conv_0"),
    (r"blocks\.(\d+)\.conv1", r"_ConvBlock_\1/Conv_1"),
    (r"blocks\.(\d+)\.norm", r"_ConvBlock_\1/LayerNorm_0"),
    (r"head", r"Conv_0"),
)


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = v
    return out


def _flax_path(model: nn.Module, key: str, names) -> tuple:
    module, _, leaf = key.rpartition(".")
    for pattern, repl in names:
        if re.fullmatch(pattern, module):
            path = re.sub(pattern, repl, module).split("/")
            break
    else:
        raise ValueError(f"no flax name for {key}")
    owner = model.get_submodule(module)
    if leaf == "weight":
        leaf = "scale" if isinstance(owner, nn.LayerNorm) else "kernel"
    return (*path, leaf)


def _to_torch(leaf: str, w: np.ndarray, shape: tuple) -> np.ndarray:
    if leaf == "kernel":
        return w.transpose((w.ndim - 1, w.ndim - 2, *range(w.ndim - 2)))
    if leaf in ("gamma", "beta"):
        return w.reshape(shape)
    return w


def state_dict_from_flax(params: dict, settings) -> dict[str, torch.Tensor]:
    """The port's state dict (float32 CPU tensors) for ``settings``
    (``unet25d`` or ``unext2``) from the JAX package's params of the same
    net (``{'params': {...}}`` or the inner tree). Raises ``ValueError``
    listing the missing and unexpected flax params, or the first shape that
    differs after the layout transform."""
    flat = _flatten(params.get("params", params))
    model, _ = build_model(settings)
    names = _UNET25D_NAMES if settings.architecture == "unet25d" else _UNEXT2_NAMES
    out, missing, used = {}, [], set()
    for key, want in model.state_dict().items():
        path = _flax_path(model, key, names)
        if path not in flat:
            missing.append("/".join(path))
            continue
        used.add(path)
        w = _to_torch(path[-1], np.asarray(flat[path], np.float32), tuple(want.shape))
        if tuple(w.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {'/'.join(path)} -> {key}: flax "
                             f"{tuple(w.shape)} (after layout transform) vs torch "
                             f"{tuple(want.shape)}")
        out[key] = torch.from_numpy(np.array(w, np.float32, order="C"))
    unexpected = sorted("/".join(p) for p in set(flat) - used)
    if missing or unexpected:
        raise ValueError(
            f"flax params do not match the {settings.architecture} architecture: missing "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}; unexpected "
            f"{unexpected[:8]}{'...' if len(unexpected) > 8 else ''} ({len(missing)} missing "
            f"/ {len(unexpected)} unexpected of {len(out) + len(missing)} expected)")
    return out

"""Virtual-staining nets and their sliding-window inference (counterpart of
``shrimpy_tpu/models/vsunet.py``).

Two architectures, each a ``torch.nn.Module`` on NCHW tensors that names
its flax counterpart:

* ``unet25d`` (:class:`VSUNet`): a z-window of ``in_slices`` phase planes
  in, one plane a target channel out; 3x3 conv blocks with max-pool
  downsampling and nearest-neighbour upsampling;
* ``unext2`` (:class:`VSUNeXt2`): cytoland's UNeXt2 (ConvNeXt-V2 blocks
  with GRN), a 3-D stem that folds the z-window into channels, and a plane
  head or cytoland's voxel-stack head (``out_stack_depth`` planes a
  window). Its submodules carry cytoland's torch names (``stem.conv``,
  ``encoder.stages.{i}.downsample.{0,1}``,
  ``encoder.stages.{i}.blocks.{j}.{dwconv,norm,pwconv1,grn,pwconv2}``,
  ``decoder.stages.{i}.{upsample,proj,blocks.{j}}``,
  ``head.{upsample,proj}``), so a cytoland state dict loads by name
  (:mod:`shrimpy_tpu_torch.models.torch_import`).

The nets cast where flax casts, not under autocast: a convolution or dense
layer with ``dtype=bfloat16`` in flax casts its input, kernel and bias to
bfloat16, and here :func:`_conv` / :func:`_linear` do the same with the
net's ``compute_dtype``. LayerNorm (epsilon 1e-6, flax's), the GRN
statistics and the final 1x1 convolutions run in float32. unet25d's conv
block ends in a float32 tanh GELU, so in flax its skips and the decoder's
concat inputs are float32; here they are rounded to the compute dtype
before the pool, resize and concat, which gives the same bits (rounding
commutes with max and nearest resize, and the next convolution rounds
anyway) and halves the largest live tensors. ``compute_dtype=float32``
is the reference run: no cast anywhere. cuDNN and cuBLAS take TF32 for
float32 work unless told not to, so every forward runs under
:func:`exact_float32`.

:func:`infer_volume` and :func:`infer_volume_stack` are
``_infer_volume_jit`` and ``_infer_volume_stack_jit``: the volume
normalised by its mean and population std, edge-clamped z-windows
gathered a batch at a time (no padded copy of the volume), and for the
voxel-stack head the windows' planes summed into the output with
``index_add_`` and divided by each plane's count. :class:`VirtualStainer`
holds a net with seeded or loaded weights; its checkpoint is a directory
with ``state_dict.pt`` beside the JAX package's ``vs_model.json`` sidecar.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

from shrimpy_tpu_torch.config import (
    VS_DEFAULTS,
    arch_config_dict,
    resolved_arch_config,
    vs_settings,
)
from shrimpy_tpu_torch.config.vs_sidecar import CKPT_SIDECAR, read_vs_sidecar
from shrimpy_tpu_torch.models.torch_import import load_state, load_torch_state_dict
from shrimpy_tpu_torch.utils.device import as_tensor

logger = logging.getLogger(__name__)

STATE_DICT_FILE = "state_dict.pt"
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)
TORCH_SUFFIXES = {".ckpt", ".pt", ".pth"}


@contextlib.contextmanager
def exact_float32():
    """No TF32 in the float32 convolutions (cuDNN) and products (cuBLAS)
    inside; the caller's other flags are kept and its TF32 flags restored."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = was


def _conv(conv: nn.Conv2d | nn.Conv3d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` with its input, kernel and bias cast to ``dtype``, as flax's
    ``nn.Conv(dtype=...)`` casts them."""
    return conv._conv_forward(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype))


def _linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``lin`` over the last axis, cast as flax's ``nn.Dense(dtype=...)``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Float32 LayerNorm over the channels of NCHW ``x`` (flax's
    ``LayerNorm(dtype=float32)`` on ``x.astype(float32)``); on a
    channels-last ``x`` the permutes copy nothing."""
    y = F.layer_norm(x.float().permute(0, 2, 3, 1), norm.normalized_shape, norm.weight,
                     norm.bias, norm.eps)
    return y.permute(0, 3, 1, 2)


class ConvBlock(nn.Module):
    """flax ``_ConvBlock``: 3x3 conv, tanh GELU, 3x3 conv in the compute
    dtype, then LayerNorm and tanh GELU in float32 (flax's ``nn.gelu`` is
    the tanh form). Returns float32."""

    def __init__(self, c_in: int, width: int):
        super().__init__()
        self.conv0 = nn.Conv2d(c_in, width, 3, padding=1)
        self.conv1 = nn.Conv2d(width, width, 3, padding=1)
        self.norm = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.gelu(_conv(self.conv0, x, dtype), approximate="tanh")
        x = _conv(self.conv1, x, dtype)
        return F.gelu(_layer_norm(self.norm, x), approximate="tanh")


class VSUNet(nn.Module):
    """unet25d (flax ``VSUNet``): (B, in_slices, H, W) -> (B, n_out, H, W).

    ``blocks`` are the encoder's ``depth`` blocks, the bottleneck and the
    decoder's ``depth`` blocks, in flax's order (``_ConvBlock_{k}``);
    ``head`` is flax's ``Conv_0``, the float32 1x1 convolution."""

    out_stack_depth = 1

    def __init__(self, in_slices: int, n_out: int, base_width: int = 64, depth: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        widths = [base_width * 2**i for i in range(depth + 1)]
        blocks, c = [], in_slices
        for w in widths:
            blocks.append(ConvBlock(c, w))
            c = w
        for w in reversed(widths[:-1]):
            blocks.append(ConvBlock(c + w, w))
            c = w
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Conv2d(base_width, n_out, 1)
        self.depth = depth
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        with exact_float32():
            x = x.to(cd).contiguous(memory_format=torch.channels_last)
            skips = []
            for block in self.blocks[: self.depth]:
                x = block(x, cd).to(cd)
                skips.append(x)
                x = F.max_pool2d(x, 2)
            x = self.blocks[self.depth](x, cd)
            for block in self.blocks[self.depth + 1:]:
                x = F.interpolate(x.to(cd), scale_factor=2, mode="nearest")
                x = block(torch.cat([x, skips.pop()], 1), cd)
            return _conv(self.head, x, torch.float32)


class GRN(nn.Module):
    """flax ``_GRN`` on channels-last (B, H, W, C): the L2 norm over (H, W)
    a channel over its mean across channels, float32 statistics, the
    result in ``x``'s dtype. ``gamma`` and ``beta`` are (1, 1, 1, C), as
    cytoland's."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        gx = torch.sqrt((xf * xf).sum(dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (xf * nx) + self.beta + xf).to(x.dtype)


class NeXtV2Block(nn.Module):
    """flax ``_NeXtV2Block``: depthwise 7x7, float32 LayerNorm, pointwise
    4x, erf GELU, GRN, pointwise back, residual; the pointwise layers and
    GRN on the channels-last view."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = _conv(self.dwconv, x, dtype).float().permute(0, 2, 3, 1)
        y = F.layer_norm(y, self.norm.normalized_shape, self.norm.weight, self.norm.bias,
                         self.norm.eps)
        y = F.gelu(_linear(self.pwconv1, y, dtype))
        y = _linear(self.pwconv2, self.grn(y), dtype)
        return x + y.permute(0, 3, 1, 2).to(x.dtype)


class _Stage(nn.Module):
    """An encoder stage: for every stage but the first, flax's
    ``downsample_norm_{i}`` (float32 LayerNorm, then cast) and
    ``downsample_conv_{i}`` (2x2, stride 2) as ``downsample.{0,1}``; then
    ``stage_{i}_block_{j}`` as ``blocks.{j}``."""

    def __init__(self, in_dim: int, dim: int, n_blocks: int, first: bool):
        super().__init__()
        self.downsample = None if first else nn.ModuleList(
            [nn.LayerNorm(in_dim, eps=LN_EPS), nn.Conv2d(in_dim, dim, 2, stride=2)])
        self.blocks = nn.ModuleList([NeXtV2Block(dim) for _ in range(n_blocks)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.downsample is not None:
            norm, conv = self.downsample
            x = _conv(conv, _layer_norm(norm, x).to(dtype), dtype)
        for block in self.blocks:
            x = block(x, dtype)
        return x


class UpStage(nn.Module):
    """flax ``_UpStage`` (``up_{i}``): 3x3 conv to 4x channels, pixel
    shuffle 2x (torch's channel order), concat with the skip, 3x3
    projection, NeXt-V2 blocks."""

    def __init__(self, in_dim: int, out_dim: int, conv_blocks: int):
        super().__init__()
        self.upsample = nn.Conv2d(in_dim, out_dim * 4, 3, padding=1)
        self.proj = nn.Conv2d(out_dim * 2, out_dim, 3, padding=1)
        self.blocks = nn.ModuleList([NeXtV2Block(out_dim) for _ in range(conv_blocks)])

    def forward(self, x: torch.Tensor, skip: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.pixel_shuffle(_conv(self.upsample, x, dtype), 2)
        x = _conv(self.proj, torch.cat([x, skip.to(x.dtype)], 1), dtype)
        for block in self.blocks:
            x = block(x, dtype)
        return x


class _Stages(nn.Module):
    def __init__(self, stages: list[nn.Module]):
        super().__init__()
        self.stages = nn.ModuleList(stages)


class _Stem(nn.Module):
    """flax ``stem``: a (kz, 4, 4) conv of stride (kz, 4, 4) over the
    z-window, its z levels folded into channels channel-major
    (``b c d h w -> b (c d) h w``)."""

    def __init__(self, out_ch: int, kz: int):
        super().__init__()
        self.conv = nn.Conv3d(1, out_ch, (kz, 4, 4), stride=(kz, 4, 4))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv(self.conv, x[:, None], dtype).flatten(1, 2)


class _Head(nn.Module):
    """flax ``head_upsample`` (3x3 conv, pixel shuffle 4x, erf GELU) and
    ``head_proj`` (float32 1x1 conv to ``n_out * out_stack_depth``)."""

    def __init__(self, in_dim: int, hw: int, n_out: int, depth: int):
        super().__init__()
        self.upsample = nn.Conv2d(in_dim, hw * 16, 3, padding=1)
        self.proj = nn.Conv2d(hw, n_out * depth, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.gelu(F.pixel_shuffle(_conv(self.upsample, x, dtype), 4))
        return _conv(self.proj, x, torch.float32)


class VSUNeXt2(nn.Module):
    """unext2 (flax ``VSUNeXt2``): (B, in_slices, H, W) -> (B, n_out, H, W),
    or (B, n_out, out_stack_depth, H, W) with the voxel-stack head (the
    projection's channels split channel-major, ``b (c d) h w -> b c d h
    w``)."""

    def __init__(self, in_slices: int, n_out: int, encoder_blocks, dims,
                 decoder_conv_blocks: int = 1, stem_kernel_z: int | None = None,
                 head_expansion: int = 4, out_stack_depth: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kz = stem_kernel_z or in_slices
        z_levels = in_slices // kz
        self.stem = _Stem(dims[0] // z_levels, kz)
        self.encoder = _Stages([_Stage(dims[max(i - 1, 0)], d, n, i == 0)
                                for i, (n, d) in enumerate(zip(encoder_blocks, dims))])
        self.decoder = _Stages([UpStage(dims[-1 - i], dims[-2 - i], decoder_conv_blocks)
                                for i in range(len(dims) - 1)])
        self.head = _Head(dims[0], max(n_out, dims[0] // head_expansion), n_out,
                          out_stack_depth)
        self.n_out = n_out
        self.out_stack_depth = out_stack_depth
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        with exact_float32():
            x = self.stem(x.to(cd), cd).contiguous(memory_format=torch.channels_last)
            skips = []
            for stage in self.encoder.stages:
                x = stage(x, cd)
                skips.append(x)
            x = skips.pop()
            for stage in self.decoder.stages:
                x = stage(x, skips.pop(), cd)
            x = self.head(x, cd)
        if self.out_stack_depth == 1:
            return x
        b, _, h, w = x.shape
        return x.reshape(b, self.n_out, self.out_stack_depth, h, w)


def build_model(settings) -> tuple[nn.Module, int]:
    """(net, pad_exp) for ``settings`` (read by attribute: a namespace of
    :func:`~shrimpy_tpu_torch.config.vs_settings` or a ``VSModelSettings``);
    YX must be divisible by ``2**pad_exp``. The net's parameters are on
    the ``meta`` device, without storage: load a state dict into it with
    ``assign=True`` (as :class:`VirtualStainer` does)."""
    arch = resolved_arch_config(settings)
    n_out = len(settings.out_channels)
    if settings.architecture == "unet25d":
        with torch.device("meta"):
            return VSUNet(settings.in_slices, n_out, arch.base_width, arch.depth), arch.depth
    kz = arch.stem_kernel_z or settings.in_slices
    if settings.in_slices % kz:
        raise ValueError(f"in_slices={settings.in_slices} must be a multiple of "
                         f"stem_kernel_z={kz}")
    z_levels = settings.in_slices // kz
    if arch.dims[0] % z_levels:
        raise ValueError(f"dims[0]={arch.dims[0]} must be divisible by the {z_levels} stem z "
                         "levels (in_slices / stem_kernel_z)")
    if arch.out_stack_depth > settings.in_slices:
        raise ValueError(f"out_stack_depth={arch.out_stack_depth} cannot exceed "
                         f"in_slices={settings.in_slices} (the output stack is centered "
                         "inside the input window)")
    with torch.device("meta"):
        net = VSUNeXt2(settings.in_slices, n_out, arch.encoder_blocks, arch.dims,
                       arch.decoder_conv_blocks, arch.stem_kernel_z,
                       arch.head_conv_expansion_ratio, arch.out_stack_depth)
    # stem 4x (2^2) and one 2x per stage after the first.
    return net, len(arch.dims) + 1


def seeded_state_dict(model: nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Weights for ``model`` from ``seed`` with flax's default initialisers:
    convolution and dense kernels LeCun normal (fan-in, normal truncated at
    two standard deviations), biases zero, LayerNorm scales one, GRN zero.
    The same seed gives the same weights on every run and device (a CPU
    generator); they are not the JAX package's weights for that seed."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rpartition(".")[0])
        t = torch.zeros(p.shape)
        if name.endswith("weight") and isinstance(owner, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            # 0.8796... is the std of a unit normal truncated at +-2.
            std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        elif name.endswith("weight") and isinstance(owner, nn.LayerNorm):
            t.fill_(1.0)
        out[name] = t
    return out


def _normalizer(vol: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The volume's mean and population std + 1e-6 (``jnp.std``)."""
    std, mean = torch.std_mean(vol, correction=0)
    return mean, std + 1e-6


@torch.inference_mode()
def infer_volume(model: nn.Module, vol_zyx: torch.Tensor, *, in_slices: int,
                 batch: int) -> torch.Tensor:
    """``_infer_volume_jit``: output plane z from the centred window
    ``[z - k//2, z + k//2]`` of the normalised volume (edge-clamped),
    ``batch`` windows a forward (the last batch ragged) -> (n_out, Z, Y, X)
    float32."""
    vol = vol_zyx.float()
    nz, ny, nx = vol.shape
    mean, std = _normalizer(vol)
    offsets = torch.arange(in_slices, device=vol.device) - in_slices // 2
    out = None
    for z0 in range(0, nz, batch):
        zs = torch.arange(z0, min(z0 + batch, nz), device=vol.device)
        y = model((vol[(zs[:, None] + offsets).clamp(0, nz - 1)] - mean) / std)
        if out is None:
            out = y.new_empty((y.shape[1], nz, ny, nx))
        out[:, z0:z0 + len(zs)] = y.transpose(0, 1)
    return out


@torch.inference_mode()
def infer_volume_stack(model: nn.Module, vol_zyx: torch.Tensor, *, in_slices: int,
                       out_stack_depth: int, step: int, n_out: int,
                       batch: int) -> torch.Tensor:
    """``_infer_volume_stack_jit`` (cytoland's ``predict_sliding_windows``):
    the window whose output planes are ``[z0, z0 + d)`` reads input planes
    ``[z0 - off, z0 - off + in_slices)`` (edge-clamped, ``off = (in_slices
    - d) // 2``); windows start every ``step`` planes, the last at
    ``Z - d``; ``batch`` windows a forward (the last batch ragged, where
    JAX pads it with zero-weight duplicates); each plane is the mean of the
    windows that cover it -> (n_out, Z, Y, X) float32."""
    vol = vol_zyx.float()
    nz, ny, nx = vol.shape
    mean, std = _normalizer(vol)
    d = out_stack_depth
    last = nz - d  # the caller checks nz >= d
    n_win = -(-last // step) + 1 if last else 1
    dev = vol.device
    starts = (torch.arange(n_win, device=dev) * step).clamp(max=last)
    offsets = torch.arange(in_slices, device=dev) - (in_slices - d) // 2
    planes = torch.arange(d, device=dev)
    acc = torch.zeros((n_out, nz, ny, nx), device=dev)
    cnt = torch.zeros(nz, device=dev)
    for i in range(0, n_win, batch):
        z0s = starts[i:i + batch]
        y = model((vol[(z0s[:, None] + offsets).clamp(0, nz - 1)] - mean) / std)
        rows = (z0s[:, None] + planes).flatten()
        acc.index_add_(1, rows, y.transpose(0, 1).reshape(n_out, -1, ny, nx))
        cnt.index_add_(0, rows, torch.ones_like(rows, dtype=cnt.dtype))
    return acc.div_(cnt[None, :, None, None])


def _fields_set(settings) -> frozenset:
    """The settings' fields given explicitly: the namespace's ``fields_set``
    or pydantic's ``model_fields_set``."""
    given = getattr(settings, "fields_set", None)
    return frozenset(settings.model_fields_set if given is None else given)


class VirtualStainer:
    """A VS net with seeded or loaded weights, applying sliding-window
    inference (counterpart of the JAX package's ``VirtualStainer``).

    ``settings`` is read by attribute. The weights are made or loaded on
    the host and go to the device of the first volume :meth:`predict`
    sees; a numpy volume goes to ``device`` (the card when None, ``"cpu"``
    asks for the CPU). ``model.compute_dtype`` is bfloat16, as in the JAX
    package; float32 makes the reference run.
    """

    def __init__(self, settings, *, device=None):
        if settings.ckpt_path:
            settings = self._reconcile_with_sidecar(settings)
        self.settings = settings
        self.device = device
        model, self.pad_exp = build_model(settings)
        if settings.ckpt_path:
            state = self._load_ckpt(Path(settings.ckpt_path))
            logger.info("virtual staining weights from %s", settings.ckpt_path)
        else:
            state = seeded_state_dict(model, settings.seed)
            logger.warning("virtual staining running with seeded (untrained) weights; set "
                           "ckpt_path for real predictions")
        load_state(model, state, settings.architecture)
        self.model = model.eval()

    @classmethod
    def from_ckpt(cls, ckpt_path: str | Path, *, device=None) -> "VirtualStainer":
        """Build from a checkpoint alone: its ``vs_model.json`` sidecar holds
        the architecture. A torch file (.ckpt/.pt/.pth, no sidecar) is taken
        as a cytoland ``unext2`` at the default widths."""
        if Path(ckpt_path).suffix in TORCH_SUFFIXES:
            return cls(vs_settings(ckpt_path=str(ckpt_path), architecture="unext2"),
                       device=device)
        return cls(vs_settings(ckpt_path=str(ckpt_path)), device=device)

    # -- checkpointing -------------------------------------------------------
    @staticmethod
    def _reconcile_with_sidecar(settings):
        """Adopt the checkpoint's architecture; reject conflicts. Fields the
        user set must match the sidecar; the others take its values, so
        ``ckpt_path`` alone rebuilds the saved net."""
        sidecar_path = Path(settings.ckpt_path) / CKPT_SIDECAR
        sidecar = read_vs_sidecar(settings.ckpt_path)
        if sidecar is None:
            return settings  # pre-schema checkpoint: trust the config
        if sidecar.get("architecture") == "unext2" and sidecar.get("format_version", 1) < 2:
            raise ValueError(
                f"checkpoint {sidecar_path} predates the cytoland-faithful unext2 architecture "
                f"(sidecar format_version {sidecar.get('format_version', 1)} < 2); retrain or "
                "re-import it")
        given = _fields_set(settings)
        merged = {k: getattr(settings, k) for k in VS_DEFAULTS}
        for field in ("architecture", "arch_config", "in_slices", "out_channels",
                      "base_width", "depth"):
            if field not in sidecar:
                continue
            if field in given:
                user_val = merged[field]
                if field == "arch_config" and user_val is not None:
                    # The sidecar holds the resolved config: resolve the
                    # user's partial dict the same way, unet25d's top-level
                    # shorthand included.
                    arch = sidecar.get("architecture", settings.architecture)
                    cfg = dict(user_val)
                    if arch == "unet25d":
                        cfg.setdefault("base_width", settings.base_width)
                        cfg.setdefault("depth", settings.depth)
                    try:
                        user_val = arch_config_dict(arch, cfg)
                    except ValueError:
                        pass  # the mismatch error below explains it
                if user_val != sidecar[field]:
                    raise ValueError(
                        f"virtual_staining.{field}={merged[field]!r} conflicts with the "
                        f"checkpoint's {field}={sidecar[field]!r} ({sidecar_path}); drop the "
                        "explicit setting or point ckpt_path at a matching checkpoint")
            merged[field] = sidecar[field]
        side_arch = sidecar.get("arch_config") or {}
        for field in ("base_width", "depth"):
            mine = getattr(settings, field)
            if field in given and field in side_arch and mine != side_arch[field]:
                raise ValueError(
                    f"virtual_staining.{field}={mine!r} conflicts with the "
                    f"checkpoint's arch_config {field}={side_arch[field]!r} ({sidecar_path})")
        return vs_settings(**merged)

    def _load_ckpt(self, path: Path) -> dict[str, torch.Tensor]:
        if path.suffix in TORCH_SUFFIXES:
            logger.info("importing torch checkpoint %s", path)
            if self.settings.architecture != "unext2":
                raise ValueError("torch import supports architecture='unext2' (cytoland "
                                 f"UNeXt2/fcmae), got {self.settings.architecture!r}")
            return load_torch_state_dict(path)
        if not (path / STATE_DICT_FILE).exists():
            raise FileNotFoundError(
                f"{path} holds no {STATE_DICT_FILE}; an orbax checkpoint of the JAX package "
                "is carried across by restoring its params there, converting them with "
                "shrimpy_tpu_torch.models.convert.state_dict_from_flax(params, settings) "
                "and writing them with VirtualStainer.save_ckpt")
        return torch.load(path / STATE_DICT_FILE, map_location="cpu", weights_only=True)

    def save_ckpt(self, path: str | Path) -> None:
        """Write ``state_dict.pt`` and the ``vs_model.json`` sidecar
        (``format_version`` 2, the JAX package's keys) into ``path``."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                   path / STATE_DICT_FILE)
        (path / CKPT_SIDECAR).write_text(json.dumps({
            "format_version": 2,
            "architecture": self.settings.architecture,
            "arch_config": vars(resolved_arch_config(self.settings)),
            "in_slices": self.settings.in_slices,
            "out_channels": list(self.settings.out_channels),
        }, indent=2))

    # -- inference -----------------------------------------------------------
    def predict(self, vol_zyx) -> dict[str, torch.Tensor]:
        """ZYX phase volume -> ``{target channel: (Z, Y, X) float32}`` on the
        volume's device."""
        vol = as_tensor(vol_zyx, self.device)
        ny, nx = vol.shape[1:]
        m = 2**self.pad_exp
        if ny % m or nx % m:
            raise ValueError(f"YX extent {(ny, nx)} must be divisible by {m} (pad or crop "
                             "upstream)")
        self.model.to(vol.device)
        d = self.model.out_stack_depth
        if d > 1:
            if vol.shape[0] < d:
                raise ValueError(f"volume depth {vol.shape[0]} is shallower than the model's "
                                 f"out_stack_depth {d}")
            step = self.settings.window_step
            if not 1 <= step <= d:
                raise ValueError(f"window_step={step} must be in [1, out_stack_depth={d}] or "
                                 "output planes would go uncovered")
            out = infer_volume_stack(self.model, vol, in_slices=self.settings.in_slices,
                                     out_stack_depth=d, step=step,
                                     n_out=len(self.settings.out_channels),
                                     batch=self.settings.batch_slices)
        else:
            out = infer_volume(self.model, vol, in_slices=self.settings.in_slices,
                               batch=min(self.settings.batch_slices, vol.shape[0]))
        return {name: out[i] for i, name in enumerate(self.settings.out_channels)}

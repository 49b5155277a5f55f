"""Deskew on the card: host plan + wrapper of ``csrc/deskew.cu``.

Counterpart of ``shrimpy_tpu/ops/deskew_pallas.py`` (TPU kernel
``_kernel``, launched by ``_deskew_pallas_jit``, host plan ``_plan``). The
TPU kernel stages a union band of raw rows by DMA and interpolates with
a banded matrix on the MXU; on Hopper the kernel gathers the raw x-rows
directly (see the note in ``csrc/deskew.cu``), so the plan here is only
the interpolation tables:

* per raw-rate output z: the tilt planes ``t0``/``t1`` (clamped) and
  their weights ``wt0``/``wt1``, zero outside ``[0, nt-1]``, with the
  ``1 / group size`` scale of ``average_n_slices`` folded in;
* per (z, y): the scan rows ``s0``/``s1`` (clamped) and their weights
  ``w00``/``w01``, zero outside ``[0, ns-1]`` (the ``keep_overhang``
  rim).

They are computed in float64, as ``_plan`` does, and cast to float32
(weights) and int32 (indices): 128 x 2888 entries per table at the
production size.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from shrimpy_tpu_torch.config import require_ratio
from shrimpy_tpu_torch.ops.deskew import _geometry
from shrimpy_tpu_torch.utils.shapes import round_up

# Largest grid.y / grid.z extent of a CUDA launch, and the output rows
# one block of csrc/deskew.cu covers (kRowsPerBlock).
_MAX_GRID_YZ = 65535
_ROWS_PER_BLOCK = 16


def plan_tables(raw_shape_szx: tuple[int, int, int], settings) -> dict:
    """Interpolation tables of the deskew kernel (numpy, host side)."""
    g = _geometry(tuple(raw_shape_szx), settings)
    ns, nt, nx = raw_shape_szx
    nz, ny = g["nz_full"], g["ny"]
    a_avg = max(1, int(settings.average_n_slices))
    n_groups = -(-nz // a_avg)

    zz = np.arange(nz, dtype=np.float64)
    yy = np.arange(ny, dtype=np.float64)
    t = zz / g["sin_t"]
    t0 = np.floor(t).astype(np.int64)
    frac_t = t - t0
    wt0 = np.where((t0 >= 0) & (t0 <= nt - 1), 1.0 - frac_t, 0.0)
    wt1 = np.where((t0 + 1 >= 0) & (t0 + 1 <= nt - 1), frac_t, 0.0)
    # Group-mean scale: the partial tail group divides by its own size
    # (matching _average_z_groups).
    group = np.arange(nz) // a_avg
    counts = np.minimum((group + 1) * a_avg, nz) - group * a_avg
    wt0 = wt0 / counts
    wt1 = wt1 / counts

    s = g["r"] * ((yy[None, :] + g["y_offset"]) - zz[:, None] / math.tan(g["theta"]))
    s0 = np.floor(s).astype(np.int64)
    ws = s - s0
    w00 = np.where((s0 >= 0) & (s0 <= ns - 1), 1.0 - ws, 0.0)
    w01 = np.where((s0 + 1 >= 0) & (s0 + 1 <= ns - 1), ws, 0.0)
    return {
        "t0": np.clip(t0, 0, nt - 1).astype(np.int32),
        "t1": np.clip(t0 + 1, 0, nt - 1).astype(np.int32),
        "wt0": wt0.astype(np.float32),
        "wt1": wt1.astype(np.float32),
        "s0": np.clip(s0, 0, ns - 1).astype(np.int32),
        "s1": np.clip(s0 + 1, 0, ns - 1).astype(np.int32),
        "w00": w00.astype(np.float32),
        "w01": w01.astype(np.float32),
        "nz": nz,
        "ny": ny,
        "nx": nx,
        "n_groups": n_groups,
        "a_avg": a_avg,
    }


_TABLE_KEYS = ("t0", "t1", "wt0", "wt1", "s0", "s1", "w00", "w01")


@functools.lru_cache(maxsize=8)
def _device_tables(shape, ls_angle_deg, ratio, keep_overhang, average_n_slices,
                   device: str) -> dict:
    """:func:`plan_tables` on ``device``, memoized per geometry: every
    volume of a run shares one plan, and uploading it per call cost
    ~0.8 ms against a ~4 ms kernel. Its users never mutate it."""
    settings = SimpleNamespace(
        ls_angle_deg=ls_angle_deg, px_to_scan_ratio=ratio,
        pixel_size_um=None, scan_step_um=None,
        keep_overhang=keep_overhang, average_n_slices=average_n_slices,
    )
    tables = plan_tables(shape, settings)
    return {**tables, **{k: torch.from_numpy(tables[k]).to(device) for k in _TABLE_KEYS}}


def deskew_cuda(raw: torch.Tensor, settings) -> torch.Tensor:
    """Deskew a float32 CUDA raw (S, T, X) volume with the CUDA kernel.

    The kernel reads the :func:`plan_tables` of ``raw``'s shape under
    ``settings``. Launches on the current stream and raises on a wrong
    input or a launch error; never falls back.
    """
    if not raw.is_cuda:
        raise ValueError("deskew_cuda needs a CUDA tensor (CPU runs deskew_plain)")
    if raw.dtype != torch.float32 or raw.dim() != 3 or not raw.is_contiguous():
        raise ValueError(
            f"deskew_cuda takes a contiguous 3-D float32 tensor, got "
            f"{raw.dtype} {tuple(raw.shape)} contiguous={raw.is_contiguous()}"
        )
    from shrimpy_tpu_torch.kernels.build import check, load_library

    dev = raw.device
    tab = _device_tables(
        tuple(raw.shape), settings.ls_angle_deg, require_ratio(settings),
        bool(settings.keep_overhang), int(settings.average_n_slices), str(dev),
    )
    ns, nt, nx = raw.shape
    ny, n_groups = tab["ny"], tab["n_groups"]
    if round_up(ny, _ROWS_PER_BLOCK) // _ROWS_PER_BLOCK > _MAX_GRID_YZ or n_groups > _MAX_GRID_YZ:
        raise ValueError(
            f"deskew_cuda: output ({n_groups}, {ny}, {nx}) exceeds the launch grid"
        )
    out = torch.empty((n_groups, ny, nx), dtype=torch.float32, device=dev)
    lib = load_library()
    code = lib.shrimpy_deskew(
        raw.data_ptr(), out.data_ptr(),
        *(tab[k].data_ptr() for k in _TABLE_KEYS),
        ns, nt, nx, tab["nz"], ny, n_groups, tab["a_avg"],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "shrimpy_deskew")
    deskew_cuda.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py reads and resets it).
deskew_cuda.launches = 0

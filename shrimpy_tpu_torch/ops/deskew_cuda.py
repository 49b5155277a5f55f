"""Deskew on the card: host plan + wrapper of ``csrc/deskew.cu``.

Counterpart of ``shrimpy_tpu/ops/deskew_pallas.py`` (TPU kernel
``_kernel``, launched by ``_deskew_pallas_jit``, host plan ``_plan``). The
TPU kernel stages a union band of raw rows by DMA and interpolates with
a banded matrix on the MXU; the kernel here stages the band of one z and
one output tile by TMA copies, a scan row each, and interpolates from
shared memory with float32 FMAs (see the note in ``csrc/deskew.cu``).
The plan is the interpolation tables:

* per raw-rate output z: the tilt planes ``t0``/``t1`` (clamped) and
  their weights ``wt0``/``wt1``, zero outside ``[0, nt-1]``, with the
  ``1 / group size`` scale of ``average_n_slices`` folded in;
* per (z, y): the scan rows ``s0``/``s1`` (clamped) and their weights
  ``w00``/``w01``, zero outside ``[0, ns-1]`` (the ``keep_overhang``
  rim).

They are computed in float64, as ``_plan`` does, and cast to float32
(weights) and int32 (indices): 128 x 2888 entries per table at the
production size. At 30 degrees ``t = z / sin`` lands an ulp past ``2 z``
in float64, so ``wt1`` is ~1e-14 and not 0 on all but the first z: both
tilt planes are read, as the tables say.

:func:`deskew_layout` is the launch's tile, chosen from the shapes and
the tables alone: ``tx`` columns (at most 256, a TMA box's width) and
the most rows ``ty`` whose bands (:func:`band_rows`) fit the shared
memory; any output shape JAX's kernel takes runs (a persistent 1-D
grid walks the tiles in 64 bits).
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from shrimpy_tpu_torch.config import require_ratio
from shrimpy_tpu_torch.ops.deskew import _geometry
from shrimpy_tpu_torch.ops.rl_fused import _SMEM_BYTES
from shrimpy_tpu_torch.utils.shapes import round_up

# csrc/deskew.cu: threads a block, band slots in shared memory, float4 sums
# a thread keeps (rows of the tile it owns), the most columns a TMA box spans.
_THREADS = 256
_SLOTS = 2
_ROWS_THREAD = 16
_BOX = 256


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


TABLE_KEYS = ("t0", "t1", "wt0", "wt1", "s0", "s1", "w00", "w01")


def band_rows(tables: dict, ty: int) -> int:
    """The most scan rows the band of one z and one ``ty``-row tile spans:
    ``s1`` at the tile's last row less ``s0`` at its first, plus one (the
    clamped indices are non-decreasing in y, since ``s`` is affine in y
    with slope ``px_to_scan_ratio``)."""
    y0 = np.arange(0, tables["ny"], ty)
    last = np.minimum(y0 + ty, tables["ny"]) - 1
    return int((tables["s1"][:, last] - tables["s0"][:, y0]).max()) + 1


def deskew_smem_bytes(rows: int, planes: int, tx: int, ty: int) -> int:
    """Dynamic shared memory of one ``csrc/deskew.cu`` block: a ring of
    slots, each the band's ``rows`` rows of planes x tx floats (a row to a
    multiple of 128 bytes), the tile's four tables of ``ty`` entries (to
    a multiple of 128 bytes) and a 128-byte header, and an 8-byte
    mbarrier a slot (the kernel's own sum is ``shrimpy_deskew_smem``)."""
    return _SLOTS * (rows * round_up(4 * planes * tx, 128) + round_up(16 * ty, 128) + 128 + 8)


def deskew_layout(raw_shape, tables: dict, *, tile=None) -> dict:
    """The launch of ``csrc/deskew.cu`` for a raw (ns, nt, nx) and its
    :func:`plan_tables`: ``{"tile": (ty, tx), "rows": n, "planes": n,
    "smem_bytes": n, "tiles": n}``. ``tx`` is ``nx`` rounded up to a
    multiple of 4, at most 256 (a TMA box's width); ``ty`` the most rows
    a thread's :data:`_ROWS_THREAD` sums cover (at most the output's),
    halved until the ring of bands fits a block's shared memory (one row
    always does). ``tile`` forces one; :class:`ValueError` where it does
    not fit."""
    _, nt, nx = raw_shape
    planes = min(nt, 2)
    if tile is None:
        tx = min(_BOX, round_up(nx, 4))
        ty = min(_THREADS // (tx // 4) * _ROWS_THREAD, tables["ny"])
        candidates = [(ty >> k, tx) for k in range(ty.bit_length())]
    else:
        candidates = [tuple(tile)]
    for ty, tx in candidates:
        cols4 = tx // 4
        if not (tx % 4 == 0 and 4 <= tx <= _BOX and ty >= 1
                and -(-ty // (_THREADS // cols4)) <= _ROWS_THREAD):
            continue
        rows = band_rows(tables, ty)
        smem = deskew_smem_bytes(rows, planes, tx, ty)
        if smem <= _SMEM_BYTES:
            tiles = tables["n_groups"] * -(-tables["ny"] // ty) * -(-nx // tx)
            return {"tile": (ty, tx), "rows": rows, "planes": planes, "smem_bytes": smem,
                    "tiles": tiles}
    raise ValueError(f"deskew_layout: tile {tile} does not fit raw {tuple(raw_shape)}: "
                     f"{_SMEM_BYTES} bytes of shared memory, at most {_BOX} columns and "
                     f"{_ROWS_THREAD} rows a thread")


@functools.lru_cache(maxsize=8)
def _device_tables(shape, ls_angle_deg, ratio, keep_overhang, average_n_slices,
                   device: str) -> dict:
    """:func:`plan_tables` (on the host, and its tables on ``device``
    under ``"dev"``) and :func:`deskew_layout`, memoized per geometry:
    every volume of a run shares one plan, and uploading it per call cost
    ~0.8 ms against a ~4 ms kernel. Its users never mutate it."""
    settings = SimpleNamespace(
        ls_angle_deg=ls_angle_deg, px_to_scan_ratio=ratio,
        pixel_size_um=None, scan_step_um=None,
        keep_overhang=keep_overhang, average_n_slices=average_n_slices,
    )
    tables = plan_tables(shape, settings)
    return {**tables, "dev": {k: torch.from_numpy(tables[k]).to(device) for k in TABLE_KEYS},
            "layout": deskew_layout(shape, tables)}


def device_plan(raw: torch.Tensor, settings) -> dict:
    """The plan of ``raw``'s shape under ``settings``: :func:`plan_tables`
    on the host, its tables on ``raw``'s device under ``"dev"`` and the
    :func:`deskew_layout` under ``"layout"`` (memoized)."""
    return _device_tables(tuple(raw.shape), settings.ls_angle_deg, require_ratio(settings),
                          bool(settings.keep_overhang), int(settings.average_n_slices),
                          str(raw.device))


def deskew_cuda(raw: torch.Tensor, settings) -> torch.Tensor:
    """Deskew a float32 CUDA raw (S, T, X) volume with the CUDA kernel.

    The kernel reads the :func:`plan_tables` of ``raw``'s shape under
    ``settings``, on the tile of :func:`deskew_layout`. Any output shape
    runs: the grid is persistent and walks the tiles in 64 bits. A raw
    whose x extent is no multiple of 4 or that is not 16-byte aligned is
    staged by cp.async instead of TMA, in the same kernel. Launches on
    the current stream and raises on a wrong input or a launch error;
    never falls back.
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
    tab = device_plan(raw, settings)
    layout = tab["layout"]
    ns, nt, nx = raw.shape
    out = torch.empty((tab["n_groups"], tab["ny"], nx), dtype=torch.float32, device=dev)
    vec = nx % 4 == 0 and raw.data_ptr() % 16 == 0
    code = load_library().shrimpy_deskew(
        raw.data_ptr(), out.data_ptr(),
        *(tab["dev"][k].data_ptr() for k in TABLE_KEYS),
        ns, nt, nx, tab["nz"], tab["ny"], tab["n_groups"], tab["a_avg"],
        *layout["tile"], layout["rows"], int(vec),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "shrimpy_deskew")
    deskew_cuda.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py reads and resets it).
deskew_cuda.launches = 0

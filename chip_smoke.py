"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the repository's ``shrimpy_tpu_torch`` package,
imports no jax and none of pydantic, tensorstore, click or yaml, and
exits non-zero without printing a result when any of these is missing
or any check fails. ``--parent-iter DIR`` names a directory holding the
``rl_iter.cu`` and ``stencil.cuh`` of the whole-iteration kernel before
its redesign (kept out of the package): phase 3 then builds it too,
checks that it gives the new kernel's bits and times the two in turns.
``--parent-convzy DIR`` does the same for the z+y kernel before the
march (``convzy.cu`` of the commit before it), on both boundaries, and
``--parent-deskew DIR`` for the deskew kernel before its redesign
(``deskew.cu``), at the production raw and at ``BASELINE.md`` config 1,
``--parent-affine DIR`` for the affine kernels before the two-launch
refine step (``affine.cu``): its gradient kernel, and a refine step
built on it, each timed beside the new one; and ``--parent-probes DIR``
for the probe kernels before their redesign (``probes.cu``): each held
to the new one (the slice bit for bit, every product mode within 1e-5)
and timed beside it in turns.
Phases:

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build every kernel from ``shrimpy_tpu_torch/csrc`` with nvcc (seconds),
   the one-launch half-step and the whole iteration once for each PSF
   geometry run below, all compilers at once;
3. each kernel against its plain PyTorch version on the card, on the
   same inputs: the deskew at the production raw (1201, 256, 1600),
   timed beside its bound from the raw rows this run's tables read,
   ``F.affine_grid`` + ``F.grid_sample`` (the same resample from
   normalized coordinates; it has no z-averaging) and, with
   ``--parent-deskew``, the kernel before its redesign, bit for bit; the
   same at ``BASELINE.md`` config 1, raw (300, 2048, 2048) with
   ``keep_overhang`` and ``average_n_slices=3``; at (300, 512, 512) with
   those settings; at (410000, 4, 8), whose (2, 1062171, 8) output has
   more rows than one launch's grid of the kernel before;
   the one-launch RL half-step (``csrc/rl_half.cu``) in ``ratio``,
   ``mult`` and ``plain`` modes and the Biggs half-step in
   ``ratio_accel`` and ``mult_accel`` modes (alpha 0.6, random bf16
   dx/g_prev; mult_accel in place), each on the production carry
   (136, 2908, 1620), on a (40, 300, 400) carry with a 2-term asymmetric
   PSF and on a (5, 37, 45) grid smaller than a tile on every axis with
   z < 2 rz + 1: bit-equal to the plain version (the kernel sums every
   output's taps in the same order), the two Biggs sums within 1e-5; the
   same kernel timed at the production carry with the streaming
   runtime's default PSF (9, 15, 15) and with two terms of (9, 21, 21);
   the three-pass route (``csrc/rl_fused.cu``, kept for geometries past
   the one-launch kernel's block) in all five modes on the (40, 300, 400)
   carry against the plain version, at the production carry timed and
   bit-equal to the one-launch kernel, then driven once through
   ``richardson_lucy`` with a (121, 9, 9) PSF that only it takes; the
   z+y step ``convzy_linear`` and ``convzy_circular`` on both of its
   routes (the march of ``csrc/convzy.cu`` and two ``conv_axis``
   passes), both tap orders, bit-equal to the plain version, on the
   production carry, the 2-term (40, 300, 400) one, a carry 4 bytes into
   its storage with an x extent of 33, a (17, 61, 3) PSF past the
   kernel before the march, and (circular) a (3, 9, 40) grid smaller
   than the radii (4, 10, 10); each route timed at the production carry
   beside the bound and ``F.conv3d`` (and beside the kernel before the
   march with ``--parent-convzy``); ``conv3_circular`` (both tap
   orders) on those carries, on a (20, 150, 256) one with blocks in the
   grid and on its seams, and past the one-launch block with a (9, 201, 3)
   PSF, its one launch (``csrc/rl_half.cu`` built with
   ``RL_HALF_WRAP=1``) bit-equal to the two-launch route (the circular z+y
   step, then the circular x pass) and both against the plain version,
   the two timed in turns at the production carry beside
   ``torch.nn.Conv3d(padding_mode="circular")`` with the dense kernel;
   the circular x pass in ``ratio``,
   ``mult`` and ``plain`` modes against the dense circulant product
   (also with a row that wraps twice); ``conv3_circular``, which no
   backend reaches, is then driven once at the production carry with
   the counts reset (one launch); the two-pass route through ``richardson_lucy`` with
   a (9, 201, 3) PSF past the march's block on ``linear_pallas`` and
   ``zy_pallas`` (RL-2 and Biggs RL-2), and the carries repaired with
   it: a (66000, 2, 6) image on ``linear_pallas`` (the y pass over more
   than 65535 planes) and a (4, 6, 60000) one on ``zy_pallas`` (x rows
   in pieces), each against its float64 plain path; a y radius of 215
   (PSF (3, 431, 3)), past the two-pass route's column, where
   ``conv_axis`` takes its taps in chunks: the z+y step bit for bit on
   both boundaries, then ``zy_pallas`` RL-2 through ``richardson_lucy``
   with the counts reset; the whole-iteration
   kernel ``rl_iter`` (``csrc/rl_iter.cu``) on the production carry, on
   the (40, 300, 400) carry with the 2-term asymmetric PSF and on a
   (5, 37, 45) grid that no tile divides and whose z extent is smaller
   than 2 rz + 1, both tap orders, bit-equal to the plain version (the
   same order of sums), timed at the production carry beside its bound
   by bytes and the bound of its own FMAs with the halo it recomputes
   (and beside the kernel before the redesign with ``--parent-iter``);
   then ``fused_iter`` RL-2 through ``richardson_lucy`` with a
   (17, 61, 61) PSF past the one-launch block, counts reset: the
   half-step route, no ``rl_iter`` launch, within 1e-3 of float64 and
   1e-4 of ``fused``; the three on-chip probes (shared-memory slice, largest
   block, split products on the tensor cores through ``wgmma``, one
   launch a mode, at the probe's shapes and three more) against their
   plain versions (1e-5; bf16x3 and 3xTF32 also against float64), each
   timed alone (back-to-back launches queued behind a spin kernel, so
   neither the host nor the read back is in the window) beside an empty
   kernel of its launch shape, and as a call of its entry, read back
   included; the largest block beside its bound at one SM's
   shared-memory rate; then driven through their entry points with the
   counts reset; the affine warp (``csrc/affine.cu``) at the deskewed volume
   (128, 2888, 1600) on four maps (a fractional translation, the refine's
   lower-triangular form, 2- and 30-degree rotations), each to the same
   shape and to (136, 2800, 1700), against the plain version in float64
   (1e-4) and float32 (1e-3: the plain float32 version rounds M u + t as
   the JAX gather does), timed beside its bound from the voxels the map
   reads and ``F.affine_grid`` + ``F.grid_sample``; the refine step's two
   launches at the refine grid (128, 722, 400) on a blob pair, ncc and
   mse, twice (the same bits), the loss and the 12 sums against the plain
   objective in float64 (within 1e-5), each launch timed beside its bound
   by voxels and by 32-byte sectors (and, with ``--parent-affine``, beside
   the gradient kernel before); the band of the ``fft2z`` RL
   (``csrc/zband.cu``) in ``conv`` and ``corr`` modes against its plain
   version within 1e-6 on the production grid (144, 3000, 961) with
   kz = 15 and on (9, 33, 17) with kz = 9 = gz, (20, 37, 45) with kz = 7
   and one plane (kz = 1), timed at the production grid beside its bound,
   the plain version and the einsum over a window view of the spectrum.
   Tolerance: max|a-b| / max|b| <= 1e-4 (float32 sums taken in
   another order); the bf16 Biggs state within one bf16 ulp, the
   step-length sums within 1e-5 relative. Beside each kernel's time the
   phase works out its bound from the shapes (bytes it must move over
   3.35 TB/s, operations over the peak for their type, the larger) and
   times the one PyTorch call that computes the same function, where
   there is one (``F.conv3d``, ``torch.matmul``);
4. the main path through ``build_reconstruct_step`` — deskew, then
   RL-20 with the (9, 21, 21) PSF — on a (1, 1201, 256, 1600) batch from
   a fixed seed, with the kernels' launch counters reset just before and
   read just after (40 half-steps, each one kernel launch, none on the
   three-pass route); the result against the same step on the plain
   versions in float64 on the card, within the BASELINE budget
   max|a-b| / max|b| <= 1e-3;
4b. the same step with ``acceleration: biggs`` and 10 iterations (the
   RL-20-equivalent), against its float64 plain path (bf16 state) by
   the two-tier gate of ``tests/test_rl_fused.py:244-245``: 99.99 % of
   voxels within 5e-4 of the scale, every voxel within 2e-2;
4c. the same two steps on ``separable_backend: linear_pallas`` (a march
   launch a z+y step): RL-20 within 1e-4 of phase 4's output, Biggs
   RL-10 within the two-tier gate of phase 4b's;
4d. the same two steps on ``separable_backend: zy_pallas`` (circular
   boundaries on the same G grid), each against its float64 plain path:
   RL-20 within 1e-3, timed against the plain float32 path; Biggs RL-10
   by the two-tier gate;
4e. deskew + RL-20 on ``separable_backend: matmul`` (circulant products
   on the block-rounded (136, 2944, 1664) grid, no kernel of the
   repository) against the same backend in float64 on the card, within
   1e-3; warm time and peak memory;
4f. deskew + RL-20 on ``separable_backend: fused_iter`` (one ``rl_iter``
   launch per iteration, no half-step launch: the production geometry
   takes the one-launch route) against its float64 plain
   path within 1e-3 and against phase 4's ``fused`` output within 1e-4,
   timed against its plain float32 path; Biggs RL-10 (generic loop) by
   the two-tier gate; the peak of Biggs RL-10 through
   ``richardson_lucy`` with and without ``donate_input``, the two
   results bit-equal;
4g. ``estimate_registration`` (``pcc+refine``, defaults) on a blob pair
   of the deskewed shape, the moving volume the float64 plain warp of a
   known lower-triangular map: first and warm seconds, the recovered map
   against the truth (offset within 0.3 px, diagonal within 0.02), the
   counts (102 sums launches, 100 gradient launches, no warp), a refine
   step's ms in the estimate and alone (beside the step before with
   ``--parent-affine``); at ``bench.py``'s (64, 256, 256) the
   kernel path's estimate against the plain path's;
4h. deskew + register-apply (a transform JSON) + RL-20 on ``fused``: one
   warp launch, against its float64 plain step within 1e-3, timed against
   the plain float32 path, peak memory;
4i. ``bench.py`` config 6: RL-20 ``algorithm: fft`` with
   ``tilted_gaussian_psf()`` (15, 31, 31), non-separable, on a
   (128, 2888, 1600) volume uniform in [0, 100) through ``richardson_lucy``
   (``fft_backend: auto`` -> ``fft2z``, grid (144, 3000, 1920)): two band
   launches an iteration, against the same call on the plain versions in
   float64 on the card within 1e-3; ms, GVox/s and peak; ``fft3`` timed
   and held within 2e-4 of ``fft2z``;
4j-4k. ``bench.py`` configs 8 (``hybrid``, 16 warm + 6 exact) and 9 (16 +
   3, Biggs on both phases) on that volume and PSF: K and the warm
   residual of the nonnegative CP terms, the separable backend of the
   warm phase and its ms, the tail's ms, the total and the peak; at a
   depth of HYBRID_CHECK (config 8: 1 warm + 1 exact iteration; config 9:
   1 + 3, its Biggs tail extrapolating), config 8 against its float64
   plain path within 1e-3, config 9 by the two-tier gate;
4l. phase: a brightfield stack (64, 2048, 2048) with the schema's
   defaults (z_padding 5), yx 0.116 um, z 0.25 um: the host transfer
   function and the card's inverse timed apart, the inverse against its
   float64 version within 1e-3, then through the reconstruct step; at
   (64, 1024, 1024) where the host has too little memory for the
   transfer function; a simulated weak phase object recovered at
   (16, 32, 32) (correlation > 0.8);
4m. tracking (DynaTrack): (a) three production raws (1201, 256, 1600) of
   seeded blobs on a camera offset with noise, drifting 2 scan steps and
   3 x pixels a timepoint, through the ``Preprocessor`` (``preprocessing: [deskew]``,
   ``csrc/deskew.cu``, four launches a method) and the ``Tracker``, each of
   the six methods: its shifts against the same tracker in float64 on the
   plain deskew (integer shifts equal, centres of mass within 1e-3 px; the
   multi-Otsu methods against float64 at the float32 run's bin pair, which
   must tie the float64 objective's maximum within 1e-5),
   ``pcc`` and ``template_matching`` within 1 px of the injected drift; the
   first update, the warm update from the card and from a host numpy
   stack, the reference's moves and the peak; the blur, multi-Otsu, NCC
   and PCC alone at the deskewed shape; (b) ``pcc`` with ``preprocessing:
   [phase]`` on two brightfield stacks of phase 4l's shape shifted in yx,
   the transfer function a hit of phase 4l's host cache, against float64;
   the focus metric's index against float64;
4n. virtual staining, every net with weights from its seed: (a) the default
   unet25d (base 64, depth 3, batch 8) through the ``Preprocessor``
   (``preprocessing: [phase, vs]``) and the ``Tracker`` (``pcc`` on
   ``vs_nuclei``) over phase 4m(b)'s two stacks, the first and warm VS and
   update ms, the peak, the shifts equal to the float32 run's (the same
   weights computing in float32, no TF32) and the bf16 ``vs_nuclei``
   within 1e-1 of it; (b) unext2 at ConvNeXt-V2 Tiny widths (blocks
   (3, 3, 9, 3), dims (96, 192, 384, 768)), the plane head (``in_slices``
   5) and the voxel-stack head (15 in, 5 out, step 1), on the phase
   volume: ms, peak, error against the float32 run on 8 planes; (c)
   ``[deskew, phase, vs]`` on a raw (427, 64, 256) (a YX the net pads): one
   deskew launch with the counts reset, against the float32 run; beside
   each net's ms its bound, its FLOPs over the dense bf16 peak;
5. timings (kernel path and plain float32 path, warm, alternated plain,
   kernel, kernel, plain), launch counts (a path's plain versions must
   have run on no CUDA tensor), peak memory, then the kernel JSON line
   (sixteen entries: the fourteen kernels, the kept three-pass half-step
   and the z+y step's two-pass route),
   the card line and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

import torch

SEED = 0
RAW_SHAPE = (1201, 256, 1600)  # bench.py::_run_headline
PSF_SHAPE, PSF_SIGMA = (9, 21, 21), (1.5, 3.0, 3.0)
ITERATIONS = 20
BIGGS_ITERATIONS = 10  # bench.py config 7, rl10_biggs_accelerated
KERNEL_RTOL = 1e-4
SUM_RTOL = 1e-5  # the Biggs step-length sums
STEP_RTOL = 1e-3  # BASELINE.md parity budget
LINEAR_RTOL = 1e-4  # linear_pallas vs fused (tests/test_rl_fused.py:186)
BULK_TOL, BULK_SHARE, MAX_TOL = 5e-4, 0.9999, 2e-2  # two-tier Biggs gate
FUSED_RTOL = 1e-4  # fused_iter vs fused: the same sums in another order, 20 iterations
# Published peaks of one H100 SXM: device memory, float32 outside the
# tensor cores, and dense TF32 and bf16 in them.
HBM_BYTES_S, FP32_FLOPS, TF32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 495e12, 989e12


def bound(bytes_moved: float, ops: float, peak: float = FP32_FLOPS) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations
    at their peak rate, whichever is larger."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def n_taps(terms) -> int:
    """Taps of every term and axis: FMAs of one separable conv3 per voxel."""
    return sum(len(w) for term in terms for w in term)


def dense_kernel(terms, axes=(0, 1, 2)) -> torch.Tensor:
    """The dense ``F.conv3d`` weight of the separable ``terms`` over
    ``axes`` (flipped: conv3d correlates), float32 on the card."""
    import numpy as np

    psf = 0.0
    for term in terms:
        w = [np.asarray(term[a], np.float64)[::-1] if a in axes else np.ones(1) for a in range(3)]
        psf = psf + np.einsum("z,y,x->zyx", *w)
    return torch.tensor(np.ascontiguousarray(psf), dtype=torch.float32, device="cuda")[None, None]


def library_conv3d(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One ``F.conv3d`` call, zero boundary: the yardstick the port never
    calls."""
    pad = tuple(k // 2 for k in weight.shape[2:])
    return torch.nn.functional.conv3d(v[None, None], weight, padding=pad)[0, 0]


def headline_settings(**deconvolve):
    """bench.py::_run_headline's ReconstructSettings, as a namespace;
    ``deconvolve`` overrides its deconvolve fields."""
    from shrimpy_tpu_torch.config import (
        deconvolve_settings,
        deskew_settings,
        reconstruct_settings,
    )

    return reconstruct_settings(
        deskew=deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386),
        deconvolve=deconvolve_settings(**{"iterations": ITERATIONS, **deconvolve}),
    )


def deskewed_shape() -> tuple[int, int, int]:
    """The deskewed volume of the production raw, (128, 2888, 1600)."""
    from shrimpy_tpu_torch.parallel.pipeline import output_shape

    return tuple(output_shape(RAW_SHAPE, headline_settings()))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def max_abs(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max|a-b|, max|b|) in float64, 2^27 elements at a time (a deskewed
    volume of BASELINE.md config 1 in float64 would take 14 GB)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    diff = top = 0.0
    for i in range(0, fa.numel(), 1 << 27):
        a64, b64 = fa[i:i + (1 << 27)].double(), fb[i:i + (1 << 27)].double()
        diff = max(diff, float((a64 - b64).abs().max()))
        top = max(top, float(b64.abs().max()))
    return diff, top


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    diff, top = max_abs(a, b)
    return diff / max(top, 1e-30)


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events), warm."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """Check max|a-b| / max|b| <= tol; returns max|a-b|."""
    err = rel_err(a, b)
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max|a-b|/max|b| = {err:.3e} (tol {tol:g}) {status}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: relative error {err:.3e} > {tol:g}")
    return max_abs(a, b)[0]


def same_bits(name: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """Check that a kernel that sums in its plain version's order gives
    its bits; returns max|a-b| (0.0)."""
    equal = bool(torch.equal(a, b))
    print(f"  {name}: {'bit-equal' if equal else f'max|a-b|/max|b| = {rel_err(a, b):.3e} FAIL'}",
          flush=True)
    if not equal:
        raise AssertionError(f"{name}: not bit-equal to the plain version")
    return 0.0


def two_tier(name: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """The Biggs gate: a share >= BULK_SHARE of voxels within BULK_TOL
    of max|b|, every voxel within MAX_TOL; returns max|a-b| / max|b|."""
    scale = float(b.double().abs().max())
    diff = (a.double() - b.double()).abs()
    share = float((diff <= BULK_TOL * scale).double().mean())
    worst = float(diff.max()) / scale
    ok = share >= BULK_SHARE and worst <= MAX_TOL
    print(f"  {name}: max|a-b|/max|b| = {worst:.3e} (tol {MAX_TOL:g}), share within "
          f"{BULK_TOL:g} = {share:.6f} (tol {BULK_SHARE}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: two-tier gate failed ({worst:.3e}, {share:.6f})")
    return worst


def bf16_within_ulp(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal, or within one bf16 ulp of ``b`` (ulp <= |b| * 2**-7)."""
    a32, b32 = a.float(), b.float()
    ulps = float(((a32 - b32).abs() / (b32.abs() * 2.0**-7).clamp_min(1e-30)).max())
    exact = bool(torch.equal(a, b))
    print(f"  {name}: {'bit-equal' if exact else f'max {ulps:.3f} bf16 ulp'}", flush=True)
    if not ulps <= 1.0:
        raise AssertionError(f"{name}: {ulps:.3f} bf16 ulp apart")


def sum_close(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    err = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    print(f"  {name}: {float(a):.9g} vs {float(b):.9g}, rel {err:.3e} (tol {SUM_RTOL:g})",
          flush=True)
    if not err <= SUM_RTOL:
        raise AssertionError(f"{name}: relative error {err:.3e} > {SUM_RTOL:g}")


def uniform(shape, gen, lo=0.0, hi=1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


def counters() -> dict:
    from shrimpy_tpu_torch.ops.conv3_cuda import (
        conv3_circular_cuda,
        conv3_circular_plain,
        conv3_one_launch,
        convzy_circular_cuda,
        convzy_circular_plain,
        convzy_linear_cuda,
        convzy_linear_plain,
        convzy_march,
        convzy_two_pass,
    )
    from shrimpy_tpu_torch.kernels import probes
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda
    from shrimpy_tpu_torch.ops.rl_fused import (
        half_step_cuda,
        half_step_one_launch,
        half_step_plain,
        half_step_three_pass,
    )
    from shrimpy_tpu_torch.ops.affine_cuda import affine_warp_cuda, refine_grad_cuda, refine_sums_cuda
    from shrimpy_tpu_torch.ops.register import affine_apply_plain
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_cuda, rl_iter_half_steps, rl_iter_plain
    from shrimpy_tpu_torch.ops.zband_cuda import zband_cuda, zband_plain

    return {
        "zband": (zband_cuda, "launches"),
        "plain_zband_on_cuda": (zband_plain, "cuda_calls"),
        "affine_warp": (affine_warp_cuda, "launches"),
        "refine_sums": (refine_sums_cuda, "launches"),
        "refine_grad": (refine_grad_cuda, "launches"),
        "plain_affine_on_cuda": (affine_apply_plain, "cuda_calls"),
        "rl_iter": (rl_iter_cuda, "launches"),
        "rl_iter_half_steps": (rl_iter_half_steps, "launches"),
        "probe_smem_slice": (probes.dynamic_smem_slice_cuda, "launches"),
        "probe_smem": (probes.smem_touch_cuda, "launches"),
        "probe_split_dot": (probes.split_dot_cuda, "launches"),
        "plain_rl_iter_on_cuda": (rl_iter_plain, "cuda_calls"),
        "plain_probe_slice_on_cuda": (probes.dynamic_smem_slice_plain, "cuda_calls"),
        "plain_split_dot_on_cuda": (probes.split_dot_plain, "cuda_calls"),
        "deskew": (deskew_cuda, "launches"),
        "rl_half_step": (half_step_cuda, "launches"),
        "rl_half_step_accel": (half_step_cuda, "accel_launches"),
        "rl_half_one_launch": (half_step_one_launch, "launches"),
        "rl_half_three_pass": (half_step_three_pass, "launches"),
        "convzy_linear": (convzy_linear_cuda, "launches"),
        "convzy_circular": (convzy_circular_cuda, "launches"),
        "convzy_march": (convzy_march, "launches"),
        "convzy_two_pass": (convzy_two_pass, "launches"),
        "conv3_circular": (conv3_circular_cuda, "launches"),
        "conv3_one_launch": (conv3_one_launch, "launches"),
        "plain_half_step_on_cuda": (half_step_plain, "cuda_calls"),
        "plain_convzy_on_cuda": (convzy_linear_plain, "cuda_calls"),
        "plain_convzy_circular_on_cuda": (convzy_circular_plain, "cuda_calls"),
        "plain_conv3_circular_on_cuda": (conv3_circular_plain, "cuda_calls"),
    }


def drive(step, batch, want: dict | None) -> tuple[torch.Tensor, dict, float]:
    """Run ``step`` once with every count set to 0 just before and read
    just after; fail unless each named kernel ran and no plain version
    saw a CUDA tensor (``want`` None: only read the counts, which the
    caller checks). Returns (output, counts, peak GiB); the peak
    counts what was allocated before (the batch, kept references), and
    the line printed also gives the step's own rise above that."""
    table = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for obj, attr in table.values():
        setattr(obj, attr, 0)
    out = step(batch)
    torch.cuda.synchronize()
    counts = {name: getattr(obj, attr) for name, (obj, attr) in table.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches: {counts}; peak allocated {peak_gib:.2f} GiB "
          f"({peak_gib - before / 2**30:.2f} above the {before / 2**30:.2f} GiB held before)",
          flush=True)
    bad = {k: v for k, v in counts.items()
           if (want is None and "plain" in k and v) or (want is not None and v != want.get(k, 0))}
    if bad:
        raise AssertionError(f"launch counts {bad}, want {want} (others 0)")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    return out, counts, peak_gib


def timed_pair(step, plain, batch, vox: int, label: str) -> dict:
    """Warm host-clock times, alternated plain, kernel, kernel, plain. Every
    caller has run both paths just before (the kernel path counted, the
    plain one in float64), so no call is spent on a warm-up."""

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain_s, kernel_s = [], []
    for fn, acc in ((plain, plain_s), (step, kernel_s), (step, kernel_s), (plain, plain_s)):
        acc.append(wall(fn))
    k, p = sum(kernel_s) / 2, sum(plain_s) / 2
    print(f"  {label} kernel path: {k * 1e3:.1f} ms/volume, {vox / k / 1e9:.4f} GVox/s  "
          f"{kernel_s}")
    print(f"  {label} plain f32 path: {p * 1e3:.1f} ms/volume, {vox / p / 1e9:.4f} GVox/s  "
          f"{plain_s}")
    return {"gvox_s": vox / k / 1e9, "plain_gvox_s": vox / p / 1e9, "ms": k * 1e3,
            "plain_ms": p * 1e3}


CONFIG1_RAW = (300, 2048, 2048)  # BASELINE.md config 1: deskew ~2048 x 2048 x 300


def config1_settings():
    """BASELINE.md config 1's deskew: the headline's angle and ratio, the
    full parallelogram kept, z averaged over 3 slices."""
    from shrimpy_tpu_torch.config import deskew_settings

    return deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386, keep_overhang=True,
                           average_n_slices=3)


@functools.lru_cache(maxsize=1)
def parent_deskew(parent_dir):
    """The deskew kernel before the redesign (a block of 128 threads
    walking 16 output rows, four 4-byte gathers an output), built from
    ``parent_dir`` (its ``deskew.cu``, kept out of the package) into a
    library of its own: a function that runs it on (raw, settings) with
    the same tables."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.deskew_cuda import TABLE_KEYS, device_plan

    lib_path = build.BUILD_DIR / "libdeskew_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "deskew.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.shrimpy_deskew.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.shrimpy_deskew.restype = ctypes.c_int

    def launch(raw, settings):
        tab = device_plan(raw, settings)
        out = torch.empty((tab["n_groups"], tab["ny"], raw.shape[2]), device=raw.device)
        build.check(lib.shrimpy_deskew(
            raw.data_ptr(), out.data_ptr(), *(tab["dev"][k].data_ptr() for k in TABLE_KEYS),
            *raw.shape, tab["nz"], tab["ny"], tab["n_groups"], tab["a_avg"],
            torch.cuda.current_stream().cuda_stream), "shrimpy_deskew (parent)")
        return out
    return launch


def deskew_bound(raw: torch.Tensor, settings) -> dict:
    """The least time of the deskew on these inputs: each raw row that an
    output reads with a nonzero weight read once, the output written once;
    9 operations a raw-rate output voxel (two 2-row lerps and the tilt
    lerp) at the float32 rate."""
    import numpy as np

    from shrimpy_tpu_torch.ops.deskew_cuda import device_plan

    tab = device_plan(raw, settings)
    ns, nt, nx = raw.shape
    need = np.zeros((ns, nt), bool)
    for wt, t in (("wt0", "t0"), ("wt1", "t1")):
        for w, row in (("w00", "s0"), ("w01", "s1")):
            z, y = np.nonzero((tab[w] != 0) & (tab[wt] != 0)[:, None])
            need[tab[row][z, y], tab[t][z]] = True
    rows = int(need.sum())
    print(f"  deskew {tuple(raw.shape)}: {rows} of {ns * nt} raw rows read with a nonzero weight",
          flush=True)
    return bound(4 * nx * (rows + tab["n_groups"] * tab["ny"]), 9 * tab["nz"] * tab["ny"] * nx)


def library_deskew(raw: torch.Tensor, settings) -> torch.Tensor:
    """The same order-1 resample as one ``F.affine_grid`` and one
    ``F.grid_sample`` (5-D, trilinear, zero padding, ``align_corners``),
    from float32 normalized coordinates: the yardstick the port never
    calls. It has no z-averaging (``average_n_slices`` 1 only)."""
    from shrimpy_tpu_torch.ops.deskew import _geometry

    if settings.average_n_slices != 1:
        raise ValueError("F.grid_sample has no z-averaging")
    ns, nt, nx = raw.shape
    g = _geometry(tuple(raw.shape), settings)
    nz, ny, r, tan_t = g["nz_full"], g["ny"], g["r"], math.tan(g["theta"])
    # Output (zo, yo, xo) at normalized (zn, yn, xn) in [-1, 1]; raw t =
    # zo / sin, s = r (yo + y_offset - zo / tan), both to [-1, 1].
    a_t = (nz - 1) / ((nt - 1) * g["sin_t"]) if nt > 1 else 0.0
    c = 2 * r / max(ns - 1, 1)
    theta = torch.tensor([[[1.0, 0.0, 0.0, 0.0],
                           [0.0, 0.0, a_t, a_t - 1.0],
                           [0.0, c * (ny - 1) / 2, -c * (nz - 1) / (2 * tan_t),
                            c * ((ny - 1) / 2 + g["y_offset"] - (nz - 1) / (2 * tan_t)) - 1.0]]],
                         dtype=torch.float32, device=raw.device)
    grid = torch.nn.functional.affine_grid(theta, [1, 1, nz, ny, nx], align_corners=True)
    return torch.nn.functional.grid_sample(raw[None, None], grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=True)[0, 0]


def time_deskew(raw, settings, old=None) -> dict:
    """The deskew kernel on ``raw`` (beside the kernel before the redesign,
    held to its bits and timed in turns, when ``old`` runs that one)."""
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda

    label = f"deskew {tuple(raw.shape)}"
    new = lambda: deskew_cuda(raw, settings)  # noqa: E731
    if old is None:
        res = {"ms": gpu_ms(new, 10)}
        print(f"  {label}: {res['ms']:.3f} ms (no --parent-deskew: the kernel before it not timed)",
              flush=True)
        return res
    same_bits(f"{label} vs the kernel before the redesign", old(raw, settings), new())
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        times[which].append(gpu_ms((lambda: old(raw, settings)) if which == "old" else new, 10))
    res = {"ms": sum(times["new"]) / 2, "ms_parent": sum(times["old"]) / 2}
    print(f"  {label}: {res['ms']:.3f} ms {times['new']}; the kernel before it "
          f"{res['ms_parent']:.3f} {times['old']}", flush=True)
    return res


def phase_deskew(gen, parent_dir=None) -> dict:
    """The deskew kernel against its plain version at the production raw and
    at BASELINE.md config 1, each timed beside its bound (and beside the
    kernel before the redesign with ``--parent-deskew``), the production
    one also beside ``F.affine_grid`` + ``F.grid_sample``; then a raw whose
    output has more rows than one launch's grid of the kernel before."""
    from shrimpy_tpu_torch.config import deskew_settings
    from shrimpy_tpu_torch.ops.deskew import deskew_plain
    from shrimpy_tpu_torch.ops.deskew_cuda import _device_tables, deskew_cuda

    old = parent_deskew(parent_dir) if parent_dir else None
    prod = headline_settings().deskew
    raw = uniform(RAW_SHAPE, gen, 0.0, 100.0)
    want = deskew_plain(raw, prod)
    err = compare(f"deskew {RAW_SHAPE}", deskew_cuda(raw, prod), want, KERNEL_RTOL)
    res = {"max_abs_err": err, **time_deskew(raw, prod, old), **deskew_bound(raw, prod)}
    res["plain_ms"] = gpu_ms(lambda: deskew_plain(raw, prod), 3)
    lib_err = rel_err(library_deskew(raw, prod), want)
    del want
    res["library_ms"] = gpu_ms(lambda: library_deskew(raw, prod), 3)
    res["library_rel_err"] = lib_err
    print(f"  deskew {RAW_SHAPE}: bound {res['bound_ms']:.3f} ms by {res['bound_by']}, plain "
          f"{res['plain_ms']:.3f} ms, F.affine_grid + F.grid_sample {res['library_ms']:.3f} ms "
          f"(max|a-b|/max|b| {lib_err:.3e} against the plain version)", flush=True)
    del raw
    torch.cuda.empty_cache()
    over = config1_settings()
    raw = uniform(CONFIG1_RAW, gen, 0.0, 100.0)
    out = deskew_cuda(raw, over)
    want = deskew_plain(raw, over)
    err = compare(f"deskew {CONFIG1_RAW} keep_overhang avg3", out, want, KERNEL_RTOL)
    res["max_abs_err"] = max(res["max_abs_err"], err)
    del out, want
    torch.cuda.empty_cache()
    c1 = {**time_deskew(raw, over, old), **deskew_bound(raw, over),
          "plain_ms": gpu_ms(lambda: deskew_plain(raw, over), 1), "library_ms": None}
    print(f"  deskew {CONFIG1_RAW} keep_overhang avg3: bound {c1['bound_ms']:.3f} ms by "
          f"{c1['bound_by']}, plain {c1['plain_ms']:.3f} ms; F.grid_sample has no z-averaging",
          flush=True)
    res.update({f"config1_{k}": v for k, v in c1.items()})
    del raw
    torch.cuda.empty_cache()
    raw2 = uniform((300, 512, 512), gen, 0.0, 100.0)
    compare("deskew (300, 512, 512) keep_overhang avg3", deskew_cuda(raw2, over),
            deskew_plain(raw2, over), KERNEL_RTOL)
    tall = deskew_settings(px_to_scan_ratio=0.386)
    raw3 = uniform((410000, 4, 8), gen, 0.0, 100.0)
    out = deskew_cuda(raw3, tall)
    if not out.shape[1] > 65535 * 16:
        raise AssertionError(f"deskew (410000, 4, 8): output {tuple(out.shape)} is not past the grid")
    compare(f"deskew (410000, 4, 8) -> {tuple(out.shape)}", out, deskew_plain(raw3, tall),
            KERNEL_RTOL)
    # The plans of these shapes (76 MB of tables at config 1 and (410000,
    # 4, 8)) would stay cached and count in every later path's peak.
    _device_tables.cache_clear()
    return res


RAGGED = (5, 37, 45)  # smaller than a tile on every axis, z < 2 rz + 1
SMALL = (40, 300, 400)


def phase_rl(gen) -> tuple[dict, dict]:
    """The half-step in ratio, mult and plain modes: the one-launch
    kernel on three grids, the three-pass route on one. Returns the two
    routes' entries."""
    from shrimpy_tpu_torch.ops.rl_fused import (
        Stencil,
        half_layout,
        half_step_cuda,
        half_step_one_launch,
        half_step_plain,
        half_step_three_pass,
    )

    terms, carry = production_terms()
    print(f"  PSF {PSF_SHAPE}: {len(terms)} separable term(s), carry {carry}")
    eps = headline_settings().deconvolve.epsilon

    def modes(shape, terms, label, step):
        """All three modes, kernel against plain; the ratio error back."""
        route = "one_launch" if step is half_step_one_launch else "three_pass"
        conv = Stencil(terms, device="cuda")
        adj = Stencil(terms, flip=True, device="cuda")
        inp = uniform(shape, gen, 0.5, 10.5)
        aux = uniform(shape, gen, 0.0, 5.0)
        if route == "one_launch":
            print(f"  rl_half {label}: {half_layout(shape, conv.radii, len(terms))}", flush=True)
        errs = {}
        for mode, st in (("ratio", conv), ("mult", adj), ("plain", conv)):
            got = step(inp, aux, st, mode, eps)
            want = half_step_plain(inp, aux, st, mode, eps)
            name = f"rl half-step {mode} {label} ({route})"
            errs[mode] = (same_bits(name, got, want) if route == "one_launch"
                          else compare(name, got, want, KERNEL_RTOL))
        return errs["ratio"], conv, adj, inp, aux

    err, conv, adj, inp, aux = modes(carry, terms, f"{carry}", half_step_one_launch)
    out = torch.empty_like(inp)
    ms = gpu_ms(lambda: half_step_cuda(inp, aux, conv, "ratio", eps, out=out), 10)
    est = aux.clone()  # in place, as the RL loop runs it
    mult_ms = gpu_ms(lambda: half_step_cuda(inp, est, adj, "mult", eps, out=est), 10)
    del est
    # The three-pass route on the same operands: the same bits (the
    # one-launch result above is the plain version's), and its time.
    scratch = [torch.empty_like(inp) for _ in range(2)]
    out3 = torch.empty_like(inp)
    three_ms = gpu_ms(lambda: half_step_three_pass(inp, aux, conv, "ratio", eps, out=out3,
                                                   scratch=scratch), 10)
    err3 = same_bits(f"rl half-step ratio {carry} (three_pass) vs one launch", out3, out)
    del out3
    print(f"  rl half-step ratio {carry}: one launch {ms:.3f} ms (mult in place {mult_ms:.3f}), "
          f"three passes {three_ms:.3f} ms", flush=True)
    other = phase_other_psf(inp, aux, eps)
    plain_ms = gpu_ms(lambda: half_step_plain(inp, aux, conv, "ratio", eps), 2)
    # inp and aux read, out written; an FMA a tap and the division.
    roof = bound(3 * 4 * inp.numel(), (2 * n_taps(terms) + 1) * inp.numel())
    del aux, out, scratch
    # The library's one call for the convolution inside the half-step:
    # F.conv3d with the dense PSF (float32, TF32 off).
    weight = dense_kernel(terms)
    compare(f"F.conv3d dense {tuple(weight.shape[2:])} vs plain conv3", library_conv3d(inp, weight),
            half_step_plain(inp, None, conv, "plain", eps), 1e-3)
    library_ms = gpu_ms(lambda: library_conv3d(inp, weight), 1)
    del inp
    modes(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_one_launch)
    modes(RAGGED, terms, f"{RAGGED} ragged, gz < 2rz+1", half_step_one_launch)
    modes(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_three_pass)
    shared = {"plain_ms": plain_ms, **roof, "library_ms": library_ms}
    return ({"max_abs_err": err, "ms": ms, "ms_mult": mult_ms, "ms_three_pass": three_ms,
             **other, **shared},
            {"max_abs_err": err3, "ms": three_ms, **shared})


OTHER_PSF = ((9, 15, 15), (1.5, 2.5, 2.5))  # runtime/stream.py's PSF when no file is given
OTHER_TERMS = 2


def other_terms() -> dict:
    """Terms of the geometries phase_other_psf runs, by name."""
    import numpy as np

    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf

    deconv = headline_settings().deconvolve
    rng = np.random.default_rng(SEED + 2)
    return {
        "other_psf": plan_terms(prepare_psf(gaussian_psf(*OTHER_PSF), deconv), deconv),
        "two_terms": [tuple(rng.random(k).astype(np.float32) / k for k in PSF_SHAPE)
                      for _ in range(OTHER_TERMS)],
    }


def phase_other_psf(inp, aux, eps) -> dict:
    """The one-launch kernel at the production carry on geometries other
    than the headline's: the streaming runtime's default PSF (9, 15, 15)
    and a PSF of OTHER_TERMS asymmetric terms of the headline's lengths,
    mode ratio, timed, each held to the three-pass route's bits (that
    route is held to the plain version on the small carry)."""
    from shrimpy_tpu_torch.ops.rl_fused import (
        Stencil,
        half_layout,
        half_step_one_launch,
        half_step_three_pass,
    )

    cases = other_terms()
    carry = tuple(inp.shape)
    out, out3 = torch.empty_like(inp), torch.empty_like(inp)
    res = {}
    for name, terms in cases.items():
        conv = Stencil(terms, device="cuda")
        lengths = tuple(2 * r + 1 for r in conv.radii)
        layout = half_layout(carry, conv.radii, len(terms))
        ms = gpu_ms(lambda: half_step_one_launch(inp, aux, conv, "ratio", eps, out=out), 10)
        half_step_three_pass(inp, aux, conv, "ratio", eps, out=out3)
        label = f"PSF {lengths} x {len(terms)} term(s) {carry}"
        same_bits(f"rl half-step ratio {label} vs three_pass", out, out3)
        roof = bound(3 * 4 * inp.numel(), (2 * n_taps(terms) + 1) * inp.numel())
        print(f"  rl half-step ratio {label}: {layout}, one launch {ms:.3f} ms "
              f"(bound {roof['bound_ms']:.3f} by {roof['bound_by']})", flush=True)
        res[f"ms_{name}"] = ms
        res[f"bound_ms_{name}"] = roof["bound_ms"]
    return res


def production_terms():
    """The headline PSF's separable terms and the production carry."""
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf

    deconv = headline_settings().deconvolve
    psf_np = prepare_psf(gaussian_psf(PSF_SHAPE, PSF_SIGMA), deconv)
    radii = tuple(k // 2 for k in psf_np.shape)
    carry = tuple(n + 2 * r for n, r in zip((128, 2888, 1600), radii))
    return plan_terms(psf_np, deconv), carry


def two_term_psf():
    """A 2-term PSF with asymmetric taps of unequal radii per axis."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [tuple(rng.random(k).astype(np.float32) for k in (7, 11, 13)) for _ in range(2)]


def phase_accel(gen) -> dict:
    """ratio_accel and mult_accel against their plain versions: the
    one-launch kernel on three grids, the three-pass route on one."""
    from shrimpy_tpu_torch.ops.rl_fused import (
        Stencil,
        half_step_cuda,
        half_step_one_launch,
        half_step_plain,
        half_step_three_pass,
        partial_rows,
    )

    eps = headline_settings().deconvolve.epsilon
    alpha = torch.tensor(0.6, device="cuda")

    def check(shape, terms, label, step):
        route = "one_launch" if step is half_step_one_launch else "three_pass"
        conv = Stencil(terms, device="cuda")
        adj = Stencil(terms, flip=True, device="cuda")
        x = uniform(shape, gen, 0.0, 10.5)
        data = uniform(shape, gen, 0.0, 5.0)
        ratio = uniform(shape, gen, 0.5, 10.5)
        dx = uniform(shape, gen, -1.0, 1.0).to(torch.bfloat16)
        gp = uniform(shape, gen, 0.0, 1.0).to(torch.bfloat16)
        label = f"{label} ({route})"
        exact = route == "one_launch"
        got = step(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha)
        want = half_step_plain(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha)
        err = (same_bits(f"ratio_accel {label}", got, want) if exact
               else compare(f"ratio_accel {label}", got, want, KERNEL_RTOL))
        want = half_step_plain(ratio, x, adj, "mult_accel", eps, dx=dx, g_prev=gp, alpha=alpha)
        got = step(ratio, x, adj, "mult_accel", eps, dx=dx, g_prev=gp, alpha=alpha)
        if got[0] is not x or got[1] is not dx or got[2] is not gp:
            raise AssertionError("mult_accel did not update x, dx and g_prev in place")
        if exact:
            same_bits(f"mult_accel x_new {label}", x, want[0])
        else:
            err = max(err, compare(f"mult_accel x_new {label}", x, want[0], KERNEL_RTOL))
        bf16_within_ulp(f"mult_accel dx {label}", dx, want[1])
        bf16_within_ulp(f"mult_accel g {label}", gp, want[2])
        sum_close(f"mult_accel <g, g_prev> {label}", got[3], want[3])
        sum_close(f"mult_accel <g, g> {label}", got[4], want[4])
        return err, conv, adj, x, data, ratio, dx, gp

    terms, carry = production_terms()
    err, conv, adj, x, data, ratio, dx, gp = check(carry, terms, f"{carry}", half_step_one_launch)
    out = torch.empty_like(x)
    parts = torch.empty((2, partial_rows(carry, conv.radii, len(terms))), device="cuda")
    r_ms = gpu_ms(lambda: half_step_cuda(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha,
                                         out=out), 10)
    r_plain = gpu_ms(lambda: half_step_plain(x, data, conv, "ratio_accel", eps, dx=dx,
                                             alpha=alpha), 2)
    # mult_accel in place: x grows by ~conv(ratio) ~ 5.5 a call, far
    # from overflow in the 33 calls of the three timings.
    m_ms = gpu_ms(lambda: half_step_cuda(ratio, x, adj, "mult_accel", eps, dx=dx, g_prev=gp,
                                         alpha=alpha, partials=parts), 10)
    m_plain = gpu_ms(lambda: half_step_plain(ratio, x, adj, "mult_accel", eps, dx=dx,
                                             g_prev=gp, alpha=alpha), 2)
    # The three-pass route on the same operands: ratio_accel to the same
    # bits as the one-launch kernel's (held to the plain version above).
    scratch = [torch.empty_like(x) for _ in range(2)]
    out3 = torch.empty_like(x)
    r3_ms = gpu_ms(lambda: half_step_three_pass(x, data, conv, "ratio_accel", eps, dx=dx,
                                                alpha=alpha, out=out3, scratch=scratch), 10)
    half_step_one_launch(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha, out=out)
    same_bits(f"ratio_accel {carry} (three_pass) vs one launch", out3, out)
    del out3
    m3_ms = gpu_ms(lambda: half_step_three_pass(ratio, x, adj, "mult_accel", eps, dx=dx,
                                                g_prev=gp, alpha=alpha, scratch=scratch), 10)
    print(f"  {carry}: ratio_accel one launch {r_ms:.3f} ms, three passes {r3_ms:.3f} ms; "
          f"mult_accel one launch {m_ms:.3f} ms, three passes {m3_ms:.3f} ms", flush=True)
    # ratio_accel reads x, data and the bf16 dx and writes the ratio (14
    # bytes a voxel); mult_accel reads the ratio, x, dx and g and writes
    # x, dx and g (20). The entry is their mean, as its times are.
    n = x.numel()
    ops = (2 * n_taps(terms) + 8) * n
    roofs = [bound(14 * n, ops), bound(20 * n, ops)]
    roof = {"bound_ms": (roofs[0]["bound_ms"] + roofs[1]["bound_ms"]) / 2,
            "bound_by": roofs[1]["bound_by"], "library_ms": None}
    del x, data, ratio, dx, gp, out, scratch, parts
    check(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_one_launch)
    check(RAGGED, terms, f"{RAGGED} ragged, gz < 2rz+1", half_step_one_launch)
    check(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_three_pass)
    return {"max_abs_err": err, "ms": (r_ms + m_ms) / 2, "plain_ms": (r_plain + m_plain) / 2,
            **roof,
            "ms_ratio_accel": r_ms, "plain_ms_ratio_accel": r_plain,
            "ms_mult_accel": m_ms, "plain_ms_mult_accel": m_plain,
            "ms_ratio_accel_three_pass": r3_ms, "ms_mult_accel_three_pass": m3_ms}


def phase_three_pass() -> dict:
    """The three-pass route through its entry point: ``richardson_lucy``
    with a (121, 9, 9) PSF, whose ring of 2 rz + 2 planes no block of the
    one-launch kernel holds, plain RL-2 and Biggs RL-2 on a (40, 64, 64)
    image, each against its float64 plain path. Returns the counts."""
    from shrimpy_tpu_torch.config import deconvolve_settings
    from shrimpy_tpu_torch.ops.deconv import (
        gaussian_psf,
        plan_terms,
        prepare_psf,
        richardson_lucy,
    )
    from shrimpy_tpu_torch.ops.rl_fused import half_step_route

    psf = gaussian_psf((121, 9, 9), (20.0, 1.5, 1.5))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    img = uniform((40, 64, 64), gen, 0.0, 100.0)
    total = {}
    for kw, name in (({}, "rl_half_step"), ({"acceleration": "biggs"}, "rl_half_step_accel")):
        s = deconvolve_settings(iterations=2, psf_crop_tol=0.0, **kw)
        psf_w = prepare_psf(psf, s)
        radii = tuple(k // 2 for k in psf_w.shape)
        n_terms = len(plan_terms(psf_w, s))
        grid = tuple(n + 2 * r for n, r in zip(img.shape, radii))
        if half_step_route(grid, radii, n_terms) != "three_pass":
            raise AssertionError(f"PSF {psf_w.shape} on {grid} does not take the three-pass route")
        out, counts, _ = drive(lambda v: richardson_lucy(v, psf, s), img,
                               {name: 4, "rl_half_three_pass": 4 * 3 * n_terms})
        ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
        if kw:
            two_tier("three-pass Biggs RL-2 vs float64 plain", out, ref)
        else:
            compare("three-pass RL-2 vs float64 plain", out, ref, STEP_RTOL)
        total[name] = counts["rl_half_three_pass"]
    return total


@functools.lru_cache(maxsize=1)
def parent_convzy(parent_dir):
    """The z+y kernel of the commit before the march (``convzy_kernel<kTy,
    kWrap>``), built from ``parent_dir`` (its ``convzy.cu``, kept out of
    the package) into a library of its own: a function that launches it
    on (v, out, kz, ky, boundary)."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    lib_path = build.BUILD_DIR / "libconvzy_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "convzy.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("shrimpy_convzy_linear", "shrimpy_convzy_circular"):
        getattr(lib, name).argtypes = [p, p, p, i32, p, i32, i64, i64, i64, p]
        getattr(lib, name).restype = i32

    def launch(v, out, kz, ky, boundary):
        name = "shrimpy_convzy_linear" if boundary == "zero" else "shrimpy_convzy_circular"
        build.check(getattr(lib, name)(v.data_ptr(), out.data_ptr(), kz.data_ptr(), kz.numel(),
                                       ky.data_ptr(), ky.numel(), *v.shape,
                                       torch.cuda.current_stream().cuda_stream), f"{name} (parent)")
    return launch


def time_convzy(v, st, boundary, old=None) -> dict:
    """The z+y step at the production carry on the march (beside the
    kernel before it, in turns, when ``old`` launches that one) and on the
    two-pass route, each held to the march's bits; returns their times."""
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_circular_cuda, convzy_linear_cuda, convzy_two_pass

    step = convzy_linear_cuda if boundary == "zero" else convzy_circular_cuda
    kz, ky, _ = st.dev[0]
    taps = st.packed()[0]
    out, other, tmp = torch.empty_like(v), torch.empty_like(v), torch.empty_like(v)
    new = lambda: step(v, kz, ky, out=out, taps=taps)  # noqa: E731
    new()
    res = {}
    if old is not None:
        run_old = lambda: old(v, other, kz, ky, boundary)  # noqa: E731
        run_old()
        same_bits(f"convzy {boundary} {tuple(v.shape)} vs the kernel before the march", other, out)
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(gpu_ms(run_old if which == "old" else new, 10))
        res["ms"], res["ms_parent"] = sum(times["new"]) / 2, sum(times["old"]) / 2
        print(f"  convzy {boundary} {tuple(v.shape)}: march {res['ms']:.3f} ms {times['new']}; the "
              f"kernel before it {res['ms_parent']:.3f} {times['old']}", flush=True)
    else:
        res["ms"] = gpu_ms(new, 10)
        print(f"  convzy {boundary} {tuple(v.shape)}: march {res['ms']:.3f} ms (no --parent-convzy: "
              "the kernel before it not timed)", flush=True)
    two = lambda: convzy_two_pass(v, kz, ky, boundary=boundary, out=other, tmp=tmp)  # noqa: E731
    two()
    same_bits(f"convzy {boundary} {tuple(v.shape)} two_pass vs march", other, out)
    res["ms_two_pass"] = gpu_ms(two, 5)
    print(f"  convzy {boundary} {tuple(v.shape)}: two passes {res['ms_two_pass']:.3f} ms",
          flush=True)
    return res


def convzy_cases(terms, carry):
    """(shape, terms, label, offset in floats) of the z+y checks: the
    production carry, a 2-term PSF, a carry that is not 16-byte aligned
    with an x extent no multiple of 4, and radii past the kernel before
    the march."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    wide = [tuple(rng.random(k).astype(np.float32) for k in (17, 61, 3))]
    return ((carry, terms, f"{carry}", 0), (SMALL, two_term_psf(), f"{SMALL} 2 terms", 0),
            ((13, 200, 33), terms, "(13, 200, 33) 4 bytes in", 1),
            ((20, 90, 40), wide, "(20, 90, 40) PSF (17, 61, 3)", 0))


def offset_carry(shape, gen, off: int) -> torch.Tensor:
    """A random carry whose first element lies ``off`` floats into its storage."""
    n = math.prod(shape)
    return uniform((n + off,), gen, 0.0, 10.0)[off:].view(shape)


def phase_convzy(gen, parent_dir=None) -> dict:
    """convzy_linear against its plain version, both tap orders and both
    routes, bit for bit; timed at the production carry (beside the kernel
    before the march with ``--parent-convzy``)."""
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_linear_cuda, convzy_linear_plain, convzy_two_pass
    from shrimpy_tpu_torch.ops.rl_fused import Stencil

    terms, carry = production_terms()
    res = {"max_abs_err": 0.0}
    for shape, tt, label, off in convzy_cases(terms, carry):
        v = offset_carry(shape, gen, off)
        for flip in (False, True):
            for t, (kz, ky, _) in enumerate(Stencil(tt, flip=flip, device="cuda").dev):
                want = convzy_linear_plain(v, kz.cpu().numpy(), ky.cpu().numpy())
                same_bits(f"convzy_linear {label} term {t} flip={flip}",
                          convzy_linear_cuda(v, kz, ky), want)
                same_bits(f"convzy_linear {label} term {t} flip={flip} (two_pass)",
                          convzy_two_pass(v, kz, ky, boundary="zero", out=torch.empty_like(v)),
                          want)
                del want
        if shape == carry:
            st = Stencil(tt, device="cuda")
            kz, ky, _ = st.host[0]
            res.update(time_convzy(v, st, "zero", parent_convzy(parent_dir) if parent_dir else None))
            res["plain_ms"] = gpu_ms(lambda: convzy_linear_plain(v, kz, ky), 2)
            res.update(bound(2 * 4 * v.numel(), 2 * (len(kz) + len(ky)) * v.numel()))
            weight = dense_kernel(tt[:1], axes=(0, 1))
            compare(f"F.conv3d {tuple(weight.shape[2:])} vs convzy_linear", library_conv3d(v, weight),
                    convzy_linear_cuda(v, kz, ky), 1e-3)
            res["library_ms"] = gpu_ms(lambda: library_conv3d(v, weight), 2)
            print(f"  convzy_linear {carry}: bound {res['bound_ms']:.3f} ms by {res['bound_by']}, "
                  f"F.conv3d {res['library_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms", flush=True)
        del v
    return res


def library_conv3d_circular(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One ``torch.nn.Conv3d(..., padding_mode="circular", bias=False)``
    call with ``weight``: the circular yardstick the port never calls."""
    conv = torch.nn.Conv3d(1, 1, tuple(weight.shape[2:]), padding=tuple(k // 2 for k in
                           weight.shape[2:]), padding_mode="circular", bias=False).cuda()
    conv.weight.data.copy_(weight)
    with torch.no_grad():
        return conv(v[None, None])[0, 0]


def time_conv3(v, st) -> dict:
    """conv3_circular at the production carry on its one launch
    (``rl_half.cu``'s circular build) and on the two-launch route it
    replaces, in turns (two, one, one, two), the first held to the
    second's bits."""
    from shrimpy_tpu_torch.ops.conv3_cuda import conv3_half_step_cuda, conv3_one_launch

    out, other, scratch = torch.empty_like(v), torch.empty_like(v), [torch.empty_like(v)]
    one = lambda: conv3_one_launch(v, st, out=out)  # noqa: E731
    two = lambda: conv3_half_step_cuda(v, None, st, "plain", boundary="circular",  # noqa: E731
                                       out=other, scratch=scratch)
    one()
    two()
    same_bits(f"conv3_circular {tuple(v.shape)} one launch vs z+y then x", out, other)
    times = {"one": [], "two": []}
    for which in ("two", "one", "one", "two"):
        times[which].append(gpu_ms(one if which == "one" else two, 10))
    res = {"ms": sum(times["one"]) / 2, "ms_zy_then_x": sum(times["two"]) / 2}
    print(f"  conv3_circular {tuple(v.shape)}: one launch {res['ms']:.3f} ms {times['one']}; "
          f"z+y then x {res['ms_zy_then_x']:.3f} {times['two']}", flush=True)
    return res


def phase_circular(gen, parent_dir=None) -> tuple[dict, dict, dict]:
    """convzy_circular (both routes, bit for bit; timed beside the kernel
    before the march with ``--parent-convzy``), conv3_circular (both
    routes, bit for bit, and against the plain version) and the circular x
    pass against their plain versions; conv3_circular past the one-launch
    block; then conv3_circular driven once with the counts reset (no
    backend reaches it). Returns the three kernels' entries: max|a-b| over
    every check, times at the production carry beside torch.nn.Conv3d
    with a circular padding (the dense (9, 21, 1) kernel of the z+y step,
    the dense sum of the terms for conv3)."""
    import numpy as np

    from shrimpy_tpu_torch.ops.conv3_cuda import (
        conv3_circular,
        conv3_circular_cuda,
        conv3_circular_plain,
        conv3_circular_route,
        conv3_half_step_cuda,
        convzy_circular_cuda,
        convzy_circular_plain,
        convzy_two_pass,
        x_circulant_plain,
    )
    from shrimpy_tpu_torch.ops.rl_fused import Stencil, _epilogue, conv_x_cuda

    eps = headline_settings().deconvolve.epsilon
    terms, carry = production_terms()
    zy, c3, xp = ({"max_abs_err": 0.0} for _ in range(3))
    for shape, tt, label, off in conv3_cases(terms, carry):
        v = offset_carry(shape, gen, off)
        for flip in (False, True):
            st = Stencil(tt, flip=flip, device="cuda")
            for t, (kz, ky, _) in enumerate(st.dev):
                want = convzy_circular_plain(v, kz.cpu().numpy(), ky.cpu().numpy())
                same_bits(f"convzy_circular {label} term {t} flip={flip}",
                          convzy_circular_cuda(v, kz, ky), want)
                same_bits(f"convzy_circular {label} term {t} flip={flip} (two_pass)",
                          convzy_two_pass(v, kz, ky, boundary="circular",
                                          out=torch.empty_like(v)), want)
                del want
            route = conv3_circular_route(shape, st.radii, len(tt))
            got = conv3_circular_cuda(v, st)
            if route == "one_launch":
                same_bits(f"conv3_circular {label} flip={flip} one launch vs z+y then x", got,
                          conv3_half_step_cuda(v, None, st, "plain", boundary="circular"))
            err = compare(f"conv3_circular {label} flip={flip} ({route})", got,
                          conv3_circular_plain(v, st), KERNEL_RTOL)
            c3["max_abs_err"] = max(c3["max_abs_err"], err)
            del got
        if shape == carry:
            st = Stencil(tt, device="cuda")
            kz, ky, _ = st.host[0]
            zy.update(time_convzy(v, st, "circular",
                                  parent_convzy(parent_dir) if parent_dir else None))
            zy["plain_ms"] = gpu_ms(lambda: convzy_circular_plain(v, kz, ky), 2)
            c3.update(time_conv3(v, st))
            c3["plain_ms"] = gpu_ms(lambda: conv3_circular_plain(v, st), 2)
            # v read, out written.
            zy.update(bound(2 * 4 * v.numel(), 2 * (len(kz) + len(ky)) * v.numel()))
            c3.update(bound(2 * 4 * v.numel(), 2 * n_taps(tt) * v.numel()))
            for entry, weight, want, name in (
                    (zy, dense_kernel(tt[:1], axes=(0, 1)),
                     convzy_circular_cuda(v, st.dev[0][0], st.dev[0][1]), "convzy_circular"),
                    (c3, dense_kernel(tt), conv3_circular_cuda(v, st), "conv3_circular")):
                compare(f"Conv3d circular {tuple(weight.shape[2:])} vs {name}",
                        library_conv3d_circular(v, weight), want, 1e-3)
                del want
                entry["library_ms"] = gpu_ms(lambda: library_conv3d_circular(v, weight),
                                             1 if name == "conv3_circular" else 2)
                print(f"  {name} {carry}: bound {entry['bound_ms']:.3f} ms by "
                      f"{entry['bound_by']}, Conv3d circular {entry['library_ms']:.3f} ms, plain "
                      f"{entry['plain_ms']:.3f} ms", flush=True)
        del v
    # Past the one-launch block: the z+y step, then the x pass.
    wide = [tuple(np.random.default_rng(SEED + 5).random(k).astype(np.float32)
                  for k in TWO_PASS_PSF[0])]
    v = uniform((6, 210, 20), gen, 0.0, 10.0)
    st = Stencil(wide, device="cuda")
    if conv3_circular_route(tuple(v.shape), st.radii) != "zy_then_x":
        raise AssertionError("conv3_circular: a (9, 201, 3) PSF should be past the block")
    err = compare("conv3_circular (6, 210, 20) PSF (9, 201, 3) (zy_then_x)",
                  conv3_circular_cuda(v, st), conv3_circular_plain(v, st), KERNEL_RTOL)
    c3["max_abs_err"] = max(c3["max_abs_err"], err)
    # The x pass alone: the production row, and a row of 21 under 45 taps.
    rng = np.random.default_rng(SEED)
    for shape, kx, label in ((carry, Stencil(terms).host[0][2], f"{carry}"),
                             ((5, 9, 21), rng.random(45).astype(np.float32), "(5, 9, 21) 45 taps")):
        h = uniform(shape, gen, 0.5, 10.5)
        aux = uniform(shape, gen, 0.0, 5.0)
        kxd = torch.tensor(np.asarray(kx, np.float32), device="cuda")
        out = torch.empty_like(h)
        for mode in ("ratio", "mult", "plain"):
            a = None if mode == "plain" else aux
            conv_x_cuda(h, None, a, out, kxd, mode, eps, wrap=True)
            err = compare(f"circular x pass {mode} {label}", out,
                          _epilogue(x_circulant_plain(h, kx), a, mode, eps), KERNEL_RTOL)
            xp["max_abs_err"] = max(xp["max_abs_err"], err)
        if shape == carry:
            xp["ms"] = gpu_ms(lambda: conv_x_cuda(h, None, aux, out, kxd, "ratio", eps,
                                                  wrap=True), 10)
            # Mode ratio, as timed: h and aux read, out written; an FMA a
            # tap and the division.
            xp.update(bound(3 * 4 * h.numel(), (2 * len(kx) + 1) * h.numel()))
            xp["plain_ms"] = gpu_ms(lambda: _epilogue(x_circulant_plain(h, kx), aux, "ratio",
                                                      eps), 2)
        del h, aux, out
    print("  conv3_circular through its entry point at the production carry:", flush=True)
    v = uniform(carry, gen, 0.0, 10.0)
    _, counts, _ = drive(lambda vol: conv3_circular(vol, terms), v,
                         {"conv3_circular": 1, "conv3_one_launch": 1})
    c3["launches"] = counts["conv3_one_launch"]
    del v
    return zy, c3, xp


def conv3_cases(terms, carry):
    """convzy_cases, and a grid smaller than the radii (wraps twice) and an
    aligned carry with interior and seam blocks of every kind."""
    return convzy_cases(terms, carry) + (((3, 9, 40), terms, "(3, 9, 40) multi-wrap", 0),
                                         ((20, 150, 256), terms, "(20, 150, 256) seams", 0))


TWO_PASS_PSF = ((9, 201, 3), (1.5, 30.0, 0.8))  # y radius 100: no tile of the march fits


def rl_drive(backend: str, image_shape, psf_spec, iterations: int, want: dict, seed: int,
             **kw) -> dict:
    """RL through ``richardson_lucy`` on ``backend`` with the counts reset,
    against its float64 plain path; returns the counts."""
    from shrimpy_tpu_torch.config import deconvolve_settings
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, richardson_lucy

    psf = gaussian_psf(*psf_spec)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = uniform(image_shape, gen, 0.0, 100.0)
    s = deconvolve_settings(iterations=iterations, psf_crop_tol=0.0, separable_backend=backend, **kw)
    out, counts, _ = drive(lambda v: richardson_lucy(v, psf, s), img, want)
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    label = f"{backend} RL-{iterations} {image_shape} PSF {psf_spec[0]}"
    if kw.get("acceleration") == "biggs":
        two_tier(f"{label} Biggs vs float64 plain", out, ref)
    else:
        compare(f"{label} vs float64 plain", out, ref, STEP_RTOL)
    return counts


def phase_routes() -> dict:
    """The z+y step's two-pass route through ``richardson_lucy``: a PSF
    past the march kernel's block on ``linear_pallas`` and ``zy_pallas``
    (RL-2 each, Biggs too); then the carries repaired in this slice,
    driven once: a z extent past a launch's grid in the two-pass y pass,
    and an x row longer than a block's shared memory in the x pass.
    Returns the two-pass route's launches."""
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_route

    radii = tuple(k // 2 for k in TWO_PASS_PSF[0])
    image = (16, 120, 64)
    grid = tuple(n + 2 * r for n, r in zip(image, radii))
    launches = 0
    for backend, boundary, name in (("linear_pallas", "zero", "convzy_linear"),
                                    ("zy_pallas", "circular", "convzy_circular")):
        if convzy_route(grid, radii[:2], boundary) != "two_pass":
            raise AssertionError(f"PSF {TWO_PASS_PSF[0]} on {grid} does not take the two-pass route")
        for kw in ({}, {"acceleration": "biggs"}):
            counts = rl_drive(backend, image, TWO_PASS_PSF, 2, {name: 4, "convzy_two_pass": 8},
                              SEED + 5, **kw)
            launches += counts["convzy_two_pass"]
    print("  repaired carries: z past a launch's grid (two-pass y pass), an x row in pieces:",
          flush=True)
    rl_drive("linear_pallas", (66000, 2, 6), TWO_PASS_PSF, 1,
             {"convzy_linear": 2, "convzy_two_pass": 4}, SEED + 6)
    rl_drive("zy_pallas", (4, 6, 60000), ((3, 5, 21), (0.8, 1.0, 3.0)), 1,
             {"convzy_circular": 2, "convzy_march": 2}, SEED + 7)
    launches += phase_wide_radius()
    return {"launches": launches}


WIDE_PSF = ((3, 431, 3), (0.8, 60.0, 0.8))  # y radius 215: past the two-pass route's column


def phase_wide_radius() -> int:
    """A y radius past 211, where the two-pass route's column of 32 + 2 r
    rows outgrows a block and conv_axis takes the taps in chunks: the z+y
    step bit for bit on both boundaries on the (6, 440, 40) grid of a
    (4, 10, 38) image, then zy_pallas RL-2 through richardson_lucy with
    the counts reset. Returns the two-pass route's launches there."""
    import numpy as np

    from shrimpy_tpu_torch.ops.conv3_cuda import (
        convzy_circular_cuda,
        convzy_circular_plain,
        convzy_linear_cuda,
        convzy_linear_plain,
    )

    print(f"  PSF {WIDE_PSF[0]}: z+y radii past the two-pass route's column", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    v = uniform((6, 440, 40), gen, 0.0, 10.0)
    wz, wy = (np.random.default_rng(k).random(k).astype(np.float32) for k in WIDE_PSF[0][:2])
    for name, step, plain in (("convzy_linear", convzy_linear_cuda, convzy_linear_plain),
                              ("convzy_circular", convzy_circular_cuda, convzy_circular_plain)):
        same_bits(f"{name} (6, 440, 40) taps {WIDE_PSF[0][:2]}", step(v, wz, wy), plain(v, wz, wy))
    counts = rl_drive("zy_pallas", (4, 10, 38), WIDE_PSF, 2,
                      {"convzy_circular": 4, "convzy_two_pass": 8}, SEED + 8)
    return counts["convzy_two_pass"]


def iter_fmas(shape, radii, tile, n_terms: int = 1) -> float:
    """FMAs of one ``csrc/rl_iter.cu`` launch on a (gz, gy, gx) carry,
    the halo it recomputes included and its windows unpadded: per block
    and plane the x pass of the est slab, the y and z passes over the
    footprint, the adjoint x pass over it and the adjoint y and z passes
    over the tile, each term."""
    (gz, gy, gx), (rz, ry, rx), (ty, tx) = shape, radii, tile
    kz, ky, kx = 2 * rz + 1, 2 * ry + 1, 2 * rx + 1
    sr, mr, mc = ty + 4 * ry, ty + 2 * ry, tx + 2 * rx
    per_plane = n_terms * (sr * mc * kx + mr * mc * (ky + kz) + mr * tx * kx + ty * tx * (ky + kz))
    return per_plane * gz * -(-gy // ty) * -(-gx // tx)


def parent_iter(parent_dir):
    """The whole-iteration kernel of the commit before the redesign, built
    from ``parent_dir`` (its ``rl_iter.cu`` and ``stencil.cuh``, kept out
    of the package) into a library of its own: a function that launches it
    on (est, data, out, taps, eps) with the tile and threads it took at the
    production carry."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    src = Path(parent_dir) / "rl_iter.cu"
    lib_path = build.BUILD_DIR / "librl_iter_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.shrimpy_rl_iter.argtypes = [p] * 4 + [i32] * 4 + [i64] * 3 + [i32] * 3 + [ctypes.c_float, p]
    lib.shrimpy_rl_iter.restype = i32

    def launch(est, data, out, taps, radii, eps, tile=(32, 48), threads=1024):
        build.check(lib.shrimpy_rl_iter(
            est.data_ptr(), data.data_ptr(), out.data_ptr(), taps.data_ptr(), taps.shape[1],
            *(2 * r + 1 for r in radii), *est.shape, *tile, threads, float(eps),
            torch.cuda.current_stream().cuda_stream), "shrimpy_rl_iter (parent)")
    return launch


ROUTE_PSF = ((17, 61, 61), (3.0, 9.0, 9.0))  # past the one-launch block: the half-step route


def phase_iter(gen, parent_dir=None) -> dict:
    """rl_iter (one launch per RL iteration) against its plain version on
    three grids, both tap orders, bit for bit; timed at the production
    carry, beside the kernel of the commit before the redesign when
    ``parent_dir`` holds its source; then the route past the block,
    driven through ``richardson_lucy`` with the counts reset."""
    from shrimpy_tpu_torch.ops.rl_fused import Stencil
    from shrimpy_tpu_torch.ops.rl_fused_iter import (
        iter_layout,
        pack_taps,
        rl_iter_cuda,
        rl_iter_plain,
    )

    eps = headline_settings().deconvolve.epsilon
    terms, carry = production_terms()
    res = {}
    for shape, tt, label in ((carry, terms, f"{carry}"),
                             (SMALL, two_term_psf(), f"{SMALL} 2 terms"),
                             (RAGGED, terms, f"{RAGGED} ragged, gz < 2rz+1")):
        conv = Stencil(tt, device="cuda")
        adj = Stencil(tt, flip=True, device="cuda")
        est = uniform(shape, gen, 0.5, 10.5)
        data = uniform(shape, gen, 0.0, 5.0)
        layout = iter_layout(shape, conv.radii, len(tt))
        print(f"  rl_iter {label}: {layout}", flush=True)
        # Both tap orders: the adjoint's taps as the convolution's and back.
        for a, b, order in ((conv, adj, "conv, adj"), (adj, conv, "adj, conv")):
            same_bits(f"rl_iter {label} ({order})", rl_iter_cuda(est, data, a, b, eps),
                      rl_iter_plain(est, data, a, b, eps))
        if shape == carry:
            res["max_abs_err"] = 0.0
            out = torch.empty_like(est)
            taps = pack_taps(conv, adj, "cuda")
            new = lambda: rl_iter_cuda(est, data, conv, adj, eps, out, taps=taps)  # noqa: E731
            if parent_dir is not None:
                old = parent_iter(parent_dir)
                old_out = torch.empty_like(est)
                run_old = lambda: old(est, data, old_out, taps, conv.radii, eps)  # noqa: E731
                new()
                run_old()
                same_bits("rl_iter vs the kernel before the redesign", out, old_out)
                times = {"old": [], "new": []}
                for which in ("old", "new", "new", "old"):
                    times[which].append(gpu_ms(run_old if which == "old" else new, 5))
                res["ms"] = sum(times["new"]) / 2
                res["ms_parent"] = sum(times["old"]) / 2
                print(f"  rl_iter {label}: {res['ms']:.3f} ms a launch {times['new']}; the kernel "
                      f"before the redesign {res['ms_parent']:.3f} {times['old']}", flush=True)
                del old_out
            else:
                res["ms"] = gpu_ms(new, 5)
                print(f"  rl_iter {label}: {res['ms']:.3f} ms a launch (no --parent-iter: the "
                      "kernel before the redesign not timed)", flush=True)
            res["plain_ms"] = gpu_ms(lambda: rl_iter_plain(est, data, conv, adj, eps), 2)
            # est and data read, out written; both conv3s' FMAs, the
            # division and the product. A whole RL iteration is no single
            # PyTorch call. Beside it the bound of the FMAs the kernel does,
            # the halo it recomputes included.
            res.update(bound(3 * 4 * est.numel(), (4 * n_taps(tt) + 2) * est.numel()),
                       library_ms=None)
            kernel_ops = 2 * iter_fmas(shape, conv.radii, layout["tile"], len(tt))
            res["bound_ms_kernel_fmas"] = bound(0, kernel_ops)["bound_ms"]
            print(f"  rl_iter {label}: bound {res['bound_ms']:.3f} ms by {res['bound_by']}; "
                  f"of its own FMAs with halo ({kernel_ops / 2 / est.numel():.1f} a voxel) "
                  f"{res['bound_ms_kernel_fmas']:.3f} ms", flush=True)
            del out
        del est, data
    res["route_launches"] = phase_iter_route()
    return res


def phase_iter_route() -> int:
    """fused_iter past the one-launch kernel's block: RL-2 through
    ``richardson_lucy`` with a (17, 61, 61) PSF takes the half-step route
    (no rl_iter launch, no plain version), against the float64 plain path
    and the ``fused`` backend's output. Returns the route's count."""
    from shrimpy_tpu_torch.config import deconvolve_settings
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf, richardson_lucy
    from shrimpy_tpu_torch.ops.rl_fused import half_step_route
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_route

    psf = gaussian_psf(*ROUTE_PSF)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    img = uniform((24, 200, 240), gen, 0.0, 100.0)
    s = deconvolve_settings(iterations=2, psf_crop_tol=0.0, separable_backend="fused_iter")
    psf_w = prepare_psf(psf, s)
    radii = tuple(k // 2 for k in psf_w.shape)
    n_terms = len(plan_terms(psf_w, s))
    grid = tuple(n + 2 * r for n, r in zip(img.shape, radii))
    route, half = rl_iter_route(grid, radii, n_terms), half_step_route(grid, radii, n_terms)
    print(f"  fused_iter RL-2, PSF {psf_w.shape} x {n_terms} term(s), carry {grid}: route {route}, "
          f"half-steps {half}", flush=True)
    if route != "half_steps":
        raise AssertionError(f"PSF {psf_w.shape} on {grid} does not take the half-step route")
    per_step = 1 if half == "one_launch" else 3 * n_terms
    out, counts, _ = drive(lambda v: richardson_lucy(v, psf, s), img,
                           {"rl_iter_half_steps": 2, "rl_half_step": 4,
                            f"rl_half_{half}": 4 * per_step})
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    compare("fused_iter RL-2 on the half-step route vs float64 plain", out, ref, STEP_RTOL)
    s.separable_backend = "fused"
    compare("fused_iter RL-2 on the half-step route vs fused", out, richardson_lucy(img, psf, s),
            FUSED_RTOL)
    return counts["rl_iter_half_steps"]


def kernel_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn``'s launches back to back, the host kept
    out of the window: a spin kernel holds the stream while the host
    queues the ``reps`` calls (longer until the window opens after the
    last of them is queued), so no launch waits for the host."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the host did not queue the launches ahead of the card")


def in_turns(new, old=None) -> dict:
    """``kernel_ms`` of ``new``; with ``old``, of both in turns (old, new,
    new, old), each the mean of its two."""
    if old is None:
        return {"ms": kernel_ms(new)}
    p1, n1, n2, p2 = kernel_ms(old), kernel_ms(new), kernel_ms(new), kernel_ms(old)
    return {"ms": (n1 + n2) / 2, "ms_parent": (p1 + p2) / 2}


def sm_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi``), the rate of the
    one-SM shared-memory bound."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


@functools.lru_cache(maxsize=1)
def parent_probes(parent_dir):
    """The probe kernels of the commit before their redesign (the
    ``nvcuda::wmma`` products, three launches a bf16 mode), built from
    ``parent_dir`` (its ``probes.cu``, kept out of the package) into a
    library of their own: (slice, touch, dot), functions that launch the
    slice into ``out``, the block of ``kb`` KB into a zeroed ``out`` and
    the product of mode ``mode`` into a new tensor."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    lib_path = build.BUILD_DIR / "libprobes_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "probes.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shrimpy_probe_smem_slice.argtypes = [p, p] + [i32] * 3 + [p]
    lib.shrimpy_probe_smem.argtypes = [p, i32, p]
    lib.shrimpy_probe_split_dot.argtypes = [p] * 7 + [i32] * 4 + [p]
    for fn in (lib.shrimpy_probe_smem_slice, lib.shrimpy_probe_smem, lib.shrimpy_probe_split_dot):
        fn.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def slice_(x, out):
        build.check(lib.shrimpy_probe_smem_slice(x.data_ptr(), out.data_ptr(), *x.shape, 128,
                                                 stream()), "shrimpy_probe_smem_slice (parent)")

    def touch(kb, out):
        build.check(lib.shrimpy_probe_smem(out.data_ptr(), kb * 1024, stream()),
                    "shrimpy_probe_smem (parent)")

    def dot(a, b, mode):
        from shrimpy_tpu_torch.kernels.probes import DOT_MODES

        (m, k), n = a.shape, b.shape[1]
        pieces = [torch.empty(shape, dtype=torch.bfloat16, device=a.device)
                  for shape in ((m, k), (m, k), (k, n), (k, n))]
        c = torch.empty((m, n), device=a.device)
        build.check(lib.shrimpy_probe_split_dot(a.data_ptr(), b.data_ptr(),
                                                *(q.data_ptr() for q in pieces), c.data_ptr(),
                                                m, n, k, DOT_MODES[mode], stream()),
                    "shrimpy_probe_split_dot (parent)")
        return c
    return slice_, touch, dot


# The split products' shapes past the probe's, (m, k, n): the smallest
# tile, ragged k and n, a deep k.
DOT_EXTRA_SHAPES = ((64, 16, 8), (192, 168, 264), (64, 1024, 256))


def phase_probes(parent_dir=None) -> tuple[dict, dict, dict]:
    """The three on-chip probes against their plain versions, each timed
    alone (``kernel_ms``: back-to-back launches, the opt-in and the read
    back outside the window) beside an empty kernel of its launch shape
    (``floor_ms``) and, under ``ms_host``, with the host (a call of the
    entry, its read back included); with ``parent_dir`` also the kernels
    before the redesign, in turns, each product mode held to theirs; then
    the probes driven through their entry points with the counts reset."""
    from shrimpy_tpu_torch.kernels import probes
    from shrimpy_tpu_torch.ops.rl_fused import _SMEM_BYTES

    t0 = time.monotonic()
    old = parent_probes(parent_dir) if parent_dir else None
    x = torch.arange(8 * 512, dtype=torch.float32, device="cuda").reshape(8, 512)
    got = probes.dynamic_smem_slice_cuda(x)
    want = probes.dynamic_smem_slice_plain(x)
    if not torch.equal(got, want):
        raise AssertionError("probe_dynamic_smem_slice differs from the same indexing in torch")
    print("  probe_dynamic_smem_slice: exact", flush=True)
    out_old = torch.empty_like(x)
    if old:
        old[0](x, out_old)
        same_bits("probe_dynamic_smem_slice vs the kernel before", got, out_old)
    sl = {"max_abs_err": 0.0,
          **in_turns(lambda: probes.dynamic_smem_slice_cuda(x),
                     old and (lambda: old[0](x, out_old))),
          "floor_ms": kernel_ms(lambda: probes.empty_launch(4, 128, 4 * x.numel())),
          "ms_host": gpu_ms(lambda: probes.dynamic_smem_slice_cuda(x), 20),
          "plain_ms": gpu_ms(lambda: probes.dynamic_smem_slice_plain(x), 20),
          **bound(2 * 4 * x.numel(), x.numel()), "library_ms": None}

    fits = {kb: probes.probe_smem(kb) for kb in probes.SMEM_KB}
    largest = probes.largest_smem()
    print(f"  probe_smem: {fits}; largest block {largest} bytes (_SMEM_BYTES {_SMEM_BYTES})",
          flush=True)
    if list(fits.values()) != [True] * 5 + [False] or largest != _SMEM_BYTES:
        raise AssertionError(f"probe_smem {fits}, largest block {largest} != {_SMEM_BYTES}")
    kb = _SMEM_BYTES // 1024
    words = _SMEM_BYTES // 4
    out = torch.empty(2, dtype=torch.int32, device="cuda")
    out_old = torch.zeros(2, dtype=torch.int32, device="cuda")
    mhz = sm_clock_mhz()
    # The block writes and reads each word once in shared memory (8 bytes
    # leave it; 2 integer operations a word at the float32 rate: bound());
    # bound_ms_smem: those bytes at one SM's 128 bytes a clock.
    sm = {"max_abs_err": 0.0,
          **in_turns(lambda: probes.smem_touch_cuda(kb, out),
                     old and (lambda: old[1](kb, out_old))),
          "floor_ms": kernel_ms(lambda: probes.empty_launch(1, 1024, _SMEM_BYTES)),
          "ms_host": gpu_ms(lambda: probes.probe_smem(kb), 5),
          "plain_ms": gpu_ms(lambda: probes.smem_touch_plain(kb), 5),
          **bound(8, 2 * words), "library_ms": None,
          "bound_ms_smem": probes.smem_bound_ms(probes.smem_touch_bytes(kb), mhz),
          "sm_clock_mhz": mhz}

    a, b = probes.dot_operands("cuda", SEED)
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    (m, k), n = a.shape, b.shape[1]
    passes = {"bf16x3": (3, BF16_FLOPS), "tf32": (1, TF32_FLOPS), "tf32x3": (3, TF32_FLOPS),
              "bf16": (1, BF16_FLOPS), "fma": (1, FP32_FLOPS)}
    dot = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "floor_ms": 0.0,
           "ms_host": 0.0, "errors": {}}
    if old:
        dot["ms_parent"] = 0.0
    for mode, (n_pass, peak) in passes.items():
        c = probes.split_dot_cuda(a, b, mode).double()
        plain = probes.split_dot_plain(a, b, mode)
        err, vs_plain = (float((c - r).abs().max()) / scale for r in (ref, plain))
        gated = mode in ("bf16x3", "tf32x3")
        print(f"  probe_split_dot {mode}: rel err vs float64 {err:.3e}"
              f"{f' (tol {probes.SPLIT_RTOL:g})' if gated else ' (reported)'}; vs its plain "
              f"version {vs_plain:.3e} (tol {probes.SPLIT_RTOL:g})", flush=True)
        if (gated and not err <= probes.SPLIT_RTOL) or not vs_plain <= probes.SPLIT_RTOL:
            raise AssertionError(f"probe_split_dot {mode}: {err:.3e} vs float64, {vs_plain:.3e} "
                                 "vs plain")
        for sm_, sk, sn in DOT_EXTRA_SHAPES:
            xa, xb = probes.dot_operands("cuda", SEED + 1, ((sm_, sk), (sk, sn)))
            got = probes.split_dot_cuda(xa, xb, mode).double()
            at = f"at ({sm_}, {sk}) @ ({sk}, {sn})"
            compare(f"probe_split_dot {mode} {at} vs plain", got,
                    probes.split_dot_plain(xa, xb, mode), probes.SPLIT_RTOL)
            if gated:
                compare(f"probe_split_dot {mode} {at} vs float64", got,
                        xa.double() @ xb.double(), probes.SPLIT_RTOL)
        if old:
            compare(f"probe_split_dot {mode} vs the kernel before", c, old[2](a, b, mode).double(),
                    probes.SPLIT_RTOL)
        dot["errors"][mode] = err
        dot["max_abs_err"] = max(dot["max_abs_err"], vs_plain * scale)
        times = in_turns(lambda: probes.split_dot_cuda(a, b, mode),
                         old and (lambda: old[2](a, b, mode)))
        blocks, threads, smem = probes.split_dot_launch(m, n, mode)
        times["floor_ms"] = kernel_ms(lambda: probes.empty_launch(blocks, threads, smem))
        times["ms_host"] = gpu_ms(lambda: probes.split_dot_cuda(a, b, mode), 20)
        for key, value in times.items():
            dot[f"{mode}_{key}"] = value
            dot[key] += value
        dot["plain_ms"] += gpu_ms(lambda: probes.split_dot_plain(a, b, mode), 5)
        dot["bound_ms"] += bound(4 * (m * k + k * n + m * n), 2 * m * n * k * n_pass,
                                 peak)["bound_ms"]
    dot["bound_by"] = bound(4 * (m * k + k * n + m * n), 2 * m * n * k, FP32_FLOPS)["bound_by"]
    # No one PyTorch call computes the five products that the entry sums.
    # torch.matmul in float32 (TF32 off) is the same function as the fma
    # mode alone, and stands beside that mode's time (timed alone, and
    # with the host).
    dot["library_ms"] = None
    dot["fma_library_ms"] = kernel_ms(lambda: torch.matmul(a, b))
    dot["fma_library_ms_host"] = gpu_ms(lambda: torch.matmul(a, b), 20)
    for name, e in (("probe_smem_slice", sl), ("probe_smem", sm), ("probe_split_dot", dot)):
        print(f"  {name}: {e['ms']:.4f} ms alone (floor {e['floor_ms']:.4f}, before "
              f"{e.get('ms_parent', 'not timed')}), {e['ms_host']:.4f} ms with the host, bound "
              f"{e['bound_ms']:.6f}" + (f", one SM's shared memory {e['bound_ms_smem']:.6f}"
                                        if "bound_ms_smem" in e else ""), flush=True)
    print("  probe_split_dot by mode: " + ", ".join(
        f"{mode} {dot[mode + '_ms']:.4f} (floor {dot[mode + '_floor_ms']:.4f}, before "
        f"{dot.get(mode + '_ms_parent', 'not timed')})" for mode in passes)
        + f"; torch.matmul {dot['fma_library_ms']:.4f}", flush=True)

    print("  the probes through their entry points:", flush=True)

    def entry(_):
        if not probes.probe_dynamic_smem_slice():
            raise AssertionError("probe_dynamic_smem_slice")
        if probes.largest_smem() != _SMEM_BYTES:
            raise AssertionError("largest_smem")
        errs = probes.probe_split_dot(seed=SEED)
        return torch.tensor([r["err"] for r in errs.values()])

    fit_count = sum(fits.values())
    _, counts, _ = drive(entry, None, {"probe_smem_slice": 1, "probe_smem": fit_count,
                                       "probe_split_dot": len(passes)})
    for entry_dict, name in ((sl, "probe_smem_slice"), (sm, "probe_smem"),
                             (dot, "probe_split_dot")):
        entry_dict["launches"] = counts[name]
    print(f"  the probes took {time.monotonic() - t0:.1f} s", flush=True)
    return sl, sm, dot


# Registration (csrc/affine.cu): the warp on four maps, its gradient at the
# refine grid, the production estimate and the registered step.
AFFINE_OTHER_SHAPE = (136, 2800, 1700)  # deeper and wider, shorter in y
REGISTER_SMALL = (64, 256, 256)  # bench.py::_config_register
DOWN = 4  # RegistrationSettings.downsample_yx: the refine's y/x stride
# The refine's default form: scale, shear and a fractional offset.
LOWER_MAP = ([[1.003, 0.0, 0.0], [0.012, 0.997, 0.0], [-0.018, 0.015, 1.002]], [0.4, -3.2, 2.6])
# The register phase's truth: a residual misalignment (the far edge moves
# by up to 0.43 px beside the translation) well inside what the default
# refine reaches in its 100 steps: an Adam step moves an entry of its dm by
# ~lr = 0.05, and a y scale of 1e-4 is 1.16 units of dm on the stride-4 grid
# of the deskewed volume (4 x 2888 x 1e-4). Scales of 4e-4 (4.6 units) left
# the offset 0.39 px from the truth after 100 steps.
TRUE_MAP = ([[1.0, 0.0, 0.0], [0.0002, 1.0001, 0.0], [-0.0001, 0.00015, 0.9999]],
            [0.4, -3.2, 2.6])


def f32_map(m, t):
    import numpy as np

    return np.asarray(m, np.float32), np.asarray(t, np.float32)


def affine_maps(shape) -> dict:
    """The maps phase affine runs: a fractional translation, the refine's
    lower-triangular form, and 2- and 30-degree rotations in the yx plane
    about the volume's center (the last, JAX's gather tier)."""
    import numpy as np

    maps = {"translate": f32_map(np.eye(3), LOWER_MAP[1]), "lower": f32_map(*LOWER_MAP)}
    center = (np.asarray(shape, np.float64) - 1) / 2
    for deg in (2, 30):
        c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
        m = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
        maps[f"rot{deg}"] = f32_map(m, center - m @ center)
    return maps


def warp_footprint(vol_shape, m, t, out_shape, step: int = 1 << 24) -> tuple[int, int]:
    """(input voxels the warp reads with a nonzero weight, 32-byte sectors
    of the input that hold them), in float64 coordinates, output z-slabs
    of ``step`` voxels at a time."""
    touched = torch.zeros(math.prod(vol_shape), dtype=torch.bool, device="cuda")
    nz, ny, nx = vol_shape
    m64 = torch.tensor(m, dtype=torch.float64, device="cuda")
    t64 = torch.tensor(t, dtype=torch.float64, device="cuda")
    oz, oy, ox = out_shape
    yy = torch.arange(oy, dtype=torch.float64, device="cuda")[:, None]
    xx = torch.arange(ox, dtype=torch.float64, device="cuda")[None, :]
    slabs = max(1, step // (oy * ox))
    for z0 in range(0, oz, slabs):
        zz = torch.arange(z0, min(z0 + slabs, oz), dtype=torch.float64, device="cuda")[:, None, None]
        c = [(m64[a, 0] * zz + m64[a, 1] * yy + m64[a, 2] * xx + t64[a]).reshape(-1)
             for a in range(3)]
        base = [torch.floor(v) for v in c]
        frac = [v - b for v, b in zip(c, base)]
        base = [b.to(torch.int64) for b in base]
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    idx = [base[0] + dz, base[1] + dy, base[2] + dx]
                    keep = torch.ones_like(idx[0], dtype=torch.bool)
                    for a, (i, n, d) in enumerate(zip(idx, vol_shape, (dz, dy, dx))):
                        keep &= (i >= 0) & (i < n) & ((frac[a] > 0) if d else True)
                    touched[((idx[0] * ny + idx[1]) * nx + idx[2])[keep]] = True
    pad = (-touched.numel()) % 8
    sectors = torch.nn.functional.pad(touched, (0, pad)).view(-1, 8).any(dim=1)
    return int(touched.sum()), int(sectors.sum())


def library_affine(vol: torch.Tensor, m, t, out_shape) -> torch.Tensor:
    """The same warp as one ``F.affine_grid`` and one ``F.grid_sample``
    (5-D, trilinear, zero padding, ``align_corners``), from float32
    normalized coordinates: the yardstick the port never calls."""
    import numpy as np

    n_in = np.asarray(vol.shape, np.float64)
    n_out = np.asarray(out_shape, np.float64)
    m, t = np.asarray(m, np.float64), np.asarray(t, np.float64)
    # in_a = sum_b M_ab u_b + t_a with u_b = (g_b + 1)(O_b - 1) / 2 and
    # g_in_a = 2 in_a / (N_a - 1) - 1; theta is in (x, y, z) order.
    lin = m * (n_out[None, :] - 1) / (n_in[:, None] - 1)
    const = (m @ (n_out - 1) + 2 * t) / (n_in - 1) - 1
    theta = np.zeros((3, 4))
    theta[:, :3] = lin[::-1, ::-1]
    theta[:, 3] = const[::-1]
    grid = torch.nn.functional.affine_grid(
        torch.tensor(theta[None], dtype=torch.float32, device=vol.device),
        [1, 1, *out_shape], align_corners=True)
    return torch.nn.functional.grid_sample(vol[None, None], grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=True)[0, 0]


def phase_affine(gen) -> dict:
    """The warp kernel on four maps, each at the deskewed volume's shape and
    at AFFINE_OTHER_SHAPE, against the plain version in float64 (within
    KERNEL_RTOL: the kernel forms coordinates in fixed point from float64)
    and in float32 (within STEP_RTOL: the plain float32 version rounds
    M u + t by up to ~2.4e-4 px, as the JAX gather does); timed beside its
    bound from the voxels the map reads, the float32 plain version and
    F.affine_grid + F.grid_sample."""
    from shrimpy_tpu_torch.ops.affine_cuda import affine_warp_cuda, map_params
    from shrimpy_tpu_torch.ops.register import affine_apply_plain

    shape = deskewed_shape()
    vol = uniform(shape, gen, 0.0, 100.0)
    res = {"max_abs_err": 0.0, "maps": {}}
    for name, (m, t) in affine_maps(shape).items():
        params = map_params(torch.from_numpy(m).cuda(), torch.from_numpy(t).cuda())
        for out_shape in (shape, AFFINE_OTHER_SHAPE):
            label = f"affine_warp {name} -> {out_shape}"
            out = affine_warp_cuda(vol, params, out_shape)
            ref = affine_apply_plain(vol, m, t, out_shape, dtype=torch.float64)
            err = compare(f"{label} vs float64 plain", out, ref, KERNEL_RTOL)
            ref32 = affine_apply_plain(vol, m, t, out_shape)
            compare(f"{label} vs float32 plain", out, ref32, STEP_RTOL)
            print(f"  {label}: float32 plain vs float64 plain {rel_err(ref32, ref):.3e}",
                  flush=True)
            del ref32
            lib = library_affine(vol, m, t, out_shape)
            lib_err = rel_err(lib, ref)
            del out, ref, lib
            entry = {"max_abs_err": err, "ms": gpu_ms(lambda: affine_warp_cuda(
                vol, params, out_shape), 10),
                "library_ms": gpu_ms(lambda: library_affine(vol, m, t, out_shape), 3),
                "library_rel_err": lib_err,
                **bound(4 * (warp_footprint(shape, m, t, out_shape)[0] + math.prod(out_shape)),
                        30 * math.prod(out_shape))}
            if out_shape == shape:
                entry["plain_ms"] = gpu_ms(lambda: affine_apply_plain(vol, m, t, out_shape), 1)
            torch.cuda.empty_cache()
            print(f"  {label}: {entry['ms']:.3f} ms, bound {entry['bound_ms']:.3f} by "
                  f"{entry['bound_by']}, plain {entry.get('plain_ms', float('nan')):.3f}, "
                  f"F.affine_grid + F.grid_sample {entry['library_ms']:.3f} "
                  f"(max|a-b|/max|b| {lib_err:.3e} against float64)", flush=True)
            res["maps"][f"{name} {out_shape}"] = entry
            res["max_abs_err"] = max(res["max_abs_err"], err)
    # The row: the refine's lower-triangular form at the volume's shape.
    main = res["maps"][f"lower {shape}"]
    res.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return res


def refine_map(m, t):
    """``(m, t)`` as the refine sees it on its y/x-strided grid."""
    import numpy as np

    return f32_map(np.asarray(m, np.float64) @ np.diag([1.0, DOWN, DOWN]), t)


@functools.lru_cache(maxsize=1)
def parent_affine(parent_dir):
    """The affine kernels of the commit before the two-launch refine step
    (``affine_warp_grad_kernel``, which reads a materialised grad_out),
    built from ``parent_dir`` (its ``affine.cu``, kept out of the package)
    into a library of its own: (warp, grad), functions that launch the
    warp with its support and the gradient."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    lib_path = build.BUILD_DIR / "libaffine_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "affine.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.shrimpy_affine_warp.argtypes = [p] * 4 + [i64] * 6 + [p]
    lib.shrimpy_affine_grad_blocks.argtypes = [i64] * 5
    lib.shrimpy_affine_warp_grad.argtypes = [p] * 5 + [i64] * 6 + [p]
    for fn in (lib.shrimpy_affine_warp, lib.shrimpy_affine_grad_blocks,
               lib.shrimpy_affine_warp_grad):
        fn.restype = ctypes.c_int

    def warp(vol, params, shape):
        out, sup = (torch.empty(shape, device="cuda") for _ in range(2))
        build.check(lib.shrimpy_affine_warp(vol.data_ptr(), out.data_ptr(), sup.data_ptr(),
                                            params.data_ptr(), *vol.shape, *shape,
                                            torch.cuda.current_stream().cuda_stream),
                    "shrimpy_affine_warp (parent)")
        return out, sup

    def grad(vol, grad_out, params):
        part = torch.empty((lib.shrimpy_affine_grad_blocks(*vol.shape, *grad_out.shape[:2]), 12),
                           dtype=torch.float64, device="cuda")
        out = torch.empty(12, dtype=torch.float64, device="cuda")
        build.check(lib.shrimpy_affine_warp_grad(
            vol.data_ptr(), grad_out.data_ptr(), params.data_ptr(), part.data_ptr(),
            out.data_ptr(), *vol.shape, *grad_out.shape, torch.cuda.current_stream().cuda_stream),
            "shrimpy_affine_warp_grad (parent)")
        return out
    return warp, grad


class ParentWarp(torch.autograd.Function):
    """The commit before's warp with its support, and its gradient kernel
    of a materialised grad_out: ``apply(matrix, offset, warp, grad)`` with
    ``warp(params) -> (out, support)`` and ``grad(grad_out, params) -> 12
    float64`` of :func:`parent_affine` (at module level: a class made in a
    function makes a reference cycle that would keep the moving volume
    until the collector runs)."""

    @staticmethod
    def forward(ctx, matrix, offset, warp, grad):
        from shrimpy_tpu_torch.ops.affine_cuda import map_params

        params = map_params(matrix, offset)
        out, sup = warp(params)
        ctx.save_for_backward(params)
        ctx.grad_of = grad
        ctx.mark_non_differentiable(sup)
        return out, sup

    @staticmethod
    def backward(ctx, g_out, _):
        (params,) = ctx.saved_tensors
        g = ctx.grad_of(g_out.contiguous(), params)
        return g[:9].reshape(3, 3).float(), g[9:].float(), None, None


def refine_step_ms(pair_of, dm0, off0, reps: int = 20) -> float:
    """Device ms of one refine step, warm: the objective, its backward and
    Adam, as ``register.py::_refine`` takes it (``pair_of(dm, offset)``
    gives the loss with its graph)."""
    dm = dm0.clone().requires_grad_()
    off = off0.clone().requires_grad_()
    opt = torch.optim.Adam([dm, off], lr=0.05, betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        pair_of(dm, off).backward()
        opt.step()

    return gpu_ms(step, reps)


def refine_steps(moving, fixed_s, parent_dir=None) -> dict:
    """The refine's objective as ``_refine`` forms it from ``dm`` and the
    offset, on ``moving`` and the strided ``fixed_s``: ``{"new": ...}``, and
    with ``parent_dir`` ``"before"``: the step of the commit before (the
    warp with its support, torch's NCC and its autograd, the gradient
    kernel of a materialised grad_out)."""
    from shrimpy_tpu_torch.ops.affine_cuda import refine_objective_cuda, refine_scratch
    from shrimpy_tpu_torch.ops.register import RefineObjective, ncc_loss

    grid = tuple(fixed_s.shape)
    scale = torch.diag(torch.tensor([1.0, float(DOWN), float(DOWN)], device="cuda"))
    coord = float(max(moving.shape))
    partials = refine_scratch(moving, grid)

    def new_pair(dm, off):
        return RefineObjective.apply(scale + torch.tril(dm) / coord, off, lambda a, b:
                                     refine_objective_cuda(moving, fixed_s, a, b, "ncc",
                                                           partials))

    runs = {"new": new_pair}
    if parent_dir:
        old_warp, old_grad = parent_affine(parent_dir)

        def old_pair(dm, off):
            warped, sup = ParentWarp.apply(scale + torch.tril(dm) / coord, off,
                                           lambda p: old_warp(moving, p, grid),
                                           lambda g, p: old_grad(moving, g, p))
            return ncc_loss(warped, fixed_s, (sup > 0.999).float())

        runs["before"] = old_pair
    return runs


def phase_refine(gen, parent_dir=None) -> tuple[dict, dict]:
    """The refine step's two launches at the production refine grid (the
    deskewed volume sampled every DOWN rows and columns) on a blob pair:
    twice (the same bits), the loss and the 12 sums against the plain
    objective in float64 (within SUM_RTOL) for ncc and mse; each launch
    timed beside its bound by the voxels it reads and by the 32-byte
    sectors that hold them and the float32 plain objective, and with
    ``--parent-affine`` in turns with the gradient kernel before (which
    reads a materialised grad_out). Returns the entries of the two
    kernels."""
    from shrimpy_tpu_torch.ops.affine_cuda import (
        map_params,
        refine_grad_cuda,
        refine_objective_cuda,
        refine_scratch,
        refine_sums_cuda,
    )
    from shrimpy_tpu_torch.ops.register import affine_apply, refine_objective_plain

    shape = deskewed_shape()
    grid = (shape[0], -(-shape[1] // DOWN), -(-shape[2] // DOWN))
    moving = blob_volume(shape, gen, 3000)
    m, t = refine_map(*LOWER_MAP)
    # fixed: the warp by a map near (m, t), so that the loss is small, not 0.
    fixed = affine_apply(moving, m, t + 0.3, grid)
    mt, tt = torch.from_numpy(m).cuda(), torch.from_numpy(t).cuda()
    params = map_params(mt, tt)
    partials = refine_scratch(moving, grid)
    sums, grads = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    for loss in ("ncc", "mse"):
        got = refine_objective_cuda(moving, fixed, mt, tt, loss, partials)
        again = refine_objective_cuda(moving, fixed, mt, tt, loss, partials)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"refine {loss}: two runs differ")
        want = refine_objective_plain(moving, fixed, mt.double(), tt.double(), loss,
                                      dtype=torch.float64)
        err_v = compare(f"refine {loss} loss at {grid} from {shape} vs float64 plain (run twice: "
                        "the same bits)", got[0].reshape(1), want[0].reshape(1), SUM_RTOL)
        g = torch.cat([got[1].reshape(9), got[2]]).double()
        err_g = compare(f"refine {loss} 12 sums vs float64 plain", g,
                        torch.cat([want[1].reshape(9), want[2]]), SUM_RTOL)
        print(f"  refine {loss}: loss {float(got[0]):.9g} (float64 {float(want[0]):.9g}), sums "
              f"{g.tolist()}", flush=True)
        sums["max_abs_err"] = max(sums["max_abs_err"], err_v)
        grads["max_abs_err"] = max(grads["max_abs_err"], err_g)
        del want
    voxels, sectors = warp_footprint(shape, m, t, grid)
    stats = refine_sums_cuda(moving, fixed, params, "ncc", partials)[1]
    run = {"sums": lambda: refine_sums_cuda(moving, fixed, params, "ncc", partials),
           "grad": lambda: refine_grad_cuda(moving, fixed, params, stats, partials)}
    if parent_dir:
        g_out = uniform(grid, gen, -1.0, 1.0)
        run["old"] = lambda: parent_affine(parent_dir)[1](moving, g_out, params)
    times = {k: [] for k in run}
    for k in list(run) + list(run)[::-1]:
        times[k].append(gpu_ms(run[k], 10))
    for entry, k, ops in ((sums, "sums", 40), (grads, "grad", 70)):
        entry["ms"] = sum(times[k]) / 2
        # The input voxels the map reads and fixed, once; or the sectors
        # that hold them (DRAM moves whole sectors). Operations: about ops
        # float32 a voxel, far below either.
        entry.update(bound(4 * (voxels + math.prod(grid)), ops * math.prod(grid)))
        entry["bound_ms_sectors"] = (32 * sectors + 4 * math.prod(grid)) / HBM_BYTES_S * 1e3
        entry["library_ms"] = None
    if parent_dir:
        grads["ms_parent"] = sum(times["old"]) / 2
    sums["plain_ms"] = gpu_ms(lambda: refine_objective_plain(moving, fixed, mt, tt, "ncc",
                                                             grad=False), 1)
    grads["plain_ms"] = gpu_ms(lambda: refine_objective_plain(moving, fixed, mt, tt, "ncc"), 1)
    for entry, name in ((sums, "sums"), (grads, "gradient")):
        print(f"  refine {name} launch at {grid}: {entry['ms']:.3f} ms, bound "
              f"{entry['bound_ms']:.3f} by {entry['bound_by']} ({voxels} input voxels), "
              f"{entry['bound_ms_sectors']:.3f} by {sectors} sectors; plain "
              f"{entry['plain_ms']:.3f} ms", flush=True)
    print("  refine kernels in turns: " + ", ".join(f"{k} {times[k]}" for k in times)
          + ("" if parent_dir else " (no --parent-affine: the gradient kernel before not timed)"),
          flush=True)
    del moving, fixed
    return sums, grads


def blob_volume(shape, gen, n_blobs: int, sigma=(3.0, 6.0, 6.0)) -> torch.Tensor:
    """A sum of ``n_blobs`` Gaussian blobs (amplitude 100, each added in its
    +-4 sigma box) at seeded positions, plus N(0, 0.5) noise, float32."""
    vol = torch.randn(shape, generator=gen, device="cuda") * 0.5
    pos = torch.rand((n_blobs, 3), generator=gen, device="cuda").cpu().numpy()
    half = [int(4 * s) for s in sigma]
    axes = [torch.arange(-h, h + 1, dtype=torch.float32, device="cuda") for h in half]
    for p in pos:
        center = [int(p[a] * (shape[a] - 1)) for a in range(3)]
        box, prof = [], []
        for a in range(3):
            lo, hi = max(0, center[a] - half[a]), min(shape[a], center[a] + half[a] + 1)
            box.append(slice(lo, hi))
            d = axes[a][lo - center[a] + half[a]:hi - center[a] + half[a]]
            prof.append(torch.exp(-0.5 * (d / sigma[a]) ** 2))
        vol[tuple(box)] += 100.0 * prof[0][:, None, None] * prof[1][None, :, None] * prof[2]
    return vol


def phase_register(gen, parent_dir=None) -> dict:
    """estimate_registration (pcc+refine, defaults) on a blob pair of the
    deskewed shape, moving = the float64 plain warp of fixed by TRUE_MAP:
    first and warm seconds, the recovered map against the truth's inverse
    (offset within 0.3 px, diagonal within 0.02), the counts (a sums
    launch a refine step and two more, a gradient launch a step, no warp
    and no plain warp), a refine step's ms (the warm estimate less one with
    no step, and a step timed alone beside the step before with
    ``--parent-affine``); then at
    bench.py's (64, 256, 256) the kernel path's estimate against the plain
    path's (matrix within 1e-4, offset within 1e-3)."""
    import numpy as np

    from shrimpy_tpu_torch.config import registration_settings
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation
    from shrimpy_tpu_torch.ops.register import affine_apply_plain, estimate_registration

    settings = registration_settings()
    m, t = f32_map(*TRUE_MAP)
    inv = np.linalg.inv(m.astype(np.float64))
    truth_m, truth_t = inv, -inv @ t.astype(np.float64)
    shape = deskewed_shape()
    fixed = blob_volume(shape, gen, 3000)
    moving = affine_apply_plain(fixed, m, t, dtype=torch.float64).float()
    result = {}

    def estimate(_):
        t0 = time.perf_counter()
        result["res"] = estimate_registration(fixed, moving, settings)
        torch.cuda.synchronize()
        result.setdefault("seconds", []).append(time.perf_counter() - t0)
        return torch.from_numpy(np.concatenate([result["res"].matrix.ravel(),
                                                result["res"].offset]))

    iters = settings.refine_iterations
    _, counts, peak = drive(estimate, None, {"refine_sums": iters + 2, "refine_grad": iters})
    estimate(None)
    # The refine's steps alone: the same estimate with no step, warm.
    none = registration_settings(refine_iterations=0)
    estimate_registration(fixed, moving, none)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    estimate_registration(fixed, moving, none)
    torch.cuda.synchronize()
    step_ms = (result["seconds"][1] - (time.perf_counter() - t0)) / iters * 1e3
    # A step timed alone (CUDA events over 20), beside the step before with
    # --parent-affine, in turns, from the PCC seed.
    runs = refine_steps(moving, fixed[:, ::DOWN, ::DOWN].contiguous(), parent_dir)
    dm0 = torch.zeros((3, 3), device="cuda")
    off0 = torch.tensor(np.asarray(result["res"].translation_seed, np.float32), device="cuda")
    alone = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        alone[k].append(refine_step_ms(runs[k], dm0, off0))
    print("  refine step alone (objective, backward, Adam), in turns: "
          + ", ".join(f"{k} {alone[k]}" for k in alone), flush=True)
    pcc = []
    for _ in range(2):
        t0 = time.perf_counter()
        phase_cross_correlation(fixed, moving, upsample="parabolic")
        pcc.append(time.perf_counter() - t0)
    res = result["res"]
    off_err = float(np.abs(res.offset - truth_t).max())
    diag_err = float(np.abs(np.diag(res.matrix) - np.diag(truth_m)).max())
    mat_err = float(np.abs(res.matrix - truth_m).max())
    corners = np.array([[z, y, x] for z in (0, shape[0] - 1) for y in (0, shape[1] - 1)
                        for x in (0, shape[2] - 1)], np.float64)
    disp = float(np.abs(corners @ (res.matrix - truth_m).T + (res.offset - truth_t)).max())
    first, warm = result["seconds"]
    print(f"  estimate_registration {shape}: first call {first:.3f} s, warm {warm:.3f} s; "
          f"seed {res.translation_seed.tolist()}, offset error {off_err:.4f} px (tol 0.3), "
          f"diagonal error {diag_err:.2e} (tol 0.02), matrix error {mat_err:.2e}, largest "
          f"displacement error at a corner "
          f"{disp:.4f} px, final loss {res.final_loss:.5f}; its PCC seed alone after it "
          f"{pcc[0]:.3f} s, then {pcc[1]:.3f} s; a refine step {step_ms:.3f} ms (the warm "
          f"estimate less one with no step, over {iters})", flush=True)
    if not (off_err <= 0.3 and diag_err <= 0.02):
        raise AssertionError(f"estimate_registration: offset {off_err:.4f} px, diagonal "
                             f"{diag_err:.2e} from the truth")
    out = {"first_s": first, "warm_s": warm, "pcc_s": pcc[1], "step_ms": step_ms,
           "step_ms_alone": sum(alone["new"]) / 2,
           **({"step_ms_parent": sum(alone["before"]) / 2} if "before" in alone else {}),
           "offset_err_px": off_err,
           "diag_err": diag_err, "matrix_err": mat_err,
           "corner_err_px": disp, "launches": counts, "peak_gib": peak}
    del fixed, moving, runs
    torch.cuda.empty_cache()
    small = blob_volume(REGISTER_SMALL, gen, 12)
    moved = affine_apply_plain(small, m, t, dtype=torch.float64).float()
    got = estimate_registration(small, moved, settings)
    ref = estimate_registration(small, moved, settings, plain=True)
    dm, dt = float(np.abs(got.matrix - ref.matrix).max()), float(np.abs(got.offset - ref.offset).max())
    print(f"  estimate_registration {REGISTER_SMALL}: kernel path vs plain path: matrix "
          f"{dm:.2e} (tol 1e-4), offset {dt:.2e} px (tol 1e-3)", flush=True)
    if not (dm <= 1e-4 and dt <= 1e-3):
        raise AssertionError(f"estimate_registration {REGISTER_SMALL}: the kernel path differs "
                             f"from the plain path ({dm:.2e}, {dt:.2e})")
    out.update({"small_matrix_diff": dm, "small_offset_diff": dt})
    return out


def warm_ms(step, steps) -> float:
    """Host-clock ms of one warm run of ``step`` on the batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(steps.batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


class Steps:
    """The production batch and the reconstruct steps of phases 4-4c."""

    def __init__(self, gen):
        from shrimpy_tpu_torch.ops.deconv import gaussian_psf
        from shrimpy_tpu_torch.parallel.pipeline import output_shape

        self.psf = gaussian_psf(PSF_SHAPE, PSF_SIGMA)
        self.batch = uniform((1, *RAW_SHAPE), gen, 0.0, 100.0)
        self.out_zyx = output_shape(RAW_SHAPE, headline_settings())
        self.vox = math.prod(self.out_zyx)

    def build(self, plain=False, dtype=torch.float32, transform=None, **deconvolve):
        """The step on the headline settings; ``transform`` (a JSON path)
        adds the registration stage."""
        from shrimpy_tpu_torch.config import registration_settings
        from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

        settings = headline_settings(**deconvolve)
        if transform is not None:
            settings.registration = registration_settings(transform_path=str(transform))
        return build_reconstruct_step(settings, psf=self.psf, device="cuda", plain=plain,
                                      dtype=dtype)

    def check_shape(self, out):
        if tuple(out.shape) != (1, *self.out_zyx):
            raise AssertionError(f"bad output shape {tuple(out.shape)}, want (1, {self.out_zyx})")


def phase_step(steps: Steps) -> dict:
    """Phase 4: deskew + RL-20 on the fused backend."""
    step = steps.build()
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "rl_half_step": 2 * ITERATIONS,
                                                  "rl_half_one_launch": 2 * ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64)(steps.batch)
    compare("whole step (deskew + RL-20) vs float64 plain", out, ref, STEP_RTOL)
    del ref
    times = timed_pair(step, steps.build(plain=True), steps.batch, steps.vox, "RL-20")
    return {"out": out, "launches": counts, "peak_gib": peak, **times}


def phase_biggs(steps: Steps) -> dict:
    """Phase 4b: deskew + Biggs RL-10 in the half-step kernels."""
    kw = {"acceleration": "biggs", "iterations": BIGGS_ITERATIONS}
    step = steps.build(**kw)
    out, counts, peak = drive(step, steps.batch,
                              {"deskew": 1, "rl_half_step_accel": 2 * BIGGS_ITERATIONS,
                               "rl_half_one_launch": 2 * BIGGS_ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, **kw)(steps.batch)
    err = two_tier("Biggs RL-10 step vs float64 plain (bf16 state)", out, ref)
    del ref
    times = timed_pair(step, steps.build(plain=True, **kw), steps.batch, steps.vox,
                       "Biggs RL-10 (RL-20-equivalent)")
    return {"out": out, "launches": counts, "peak_gib": peak, "rel_err": err, **times}


def phase_linear(steps: Steps, rl20: torch.Tensor, biggs: torch.Tensor) -> dict:
    """Phase 4c: the same steps on separable_backend linear_pallas."""
    res = {}
    for label, kw, ref, n in (
        ("RL-20", {}, rl20, 2 * ITERATIONS),
        ("Biggs RL-10", {"acceleration": "biggs", "iterations": BIGGS_ITERATIONS}, biggs,
         2 * BIGGS_ITERATIONS),
    ):
        step = steps.build(separable_backend="linear_pallas", **kw)
        out, counts, peak = drive(step, steps.batch, {"deskew": 1, "convzy_linear": n,
                                                      "convzy_march": n})
        steps.check_shape(out)
        if ref is rl20:
            err = rel_err(out, ref)
            compare("linear_pallas RL-20 vs fused kernel RL-20", out, ref, LINEAR_RTOL)
        else:
            err = two_tier("linear_pallas Biggs RL-10 vs fused kernel Biggs RL-10", out, ref)
        del out
        ms = warm_ms(step, steps)
        print(f"  linear_pallas {label}: {ms:.1f} ms/volume, "
              f"{steps.vox / ms / 1e6:.4f} GVox/s (warm)", flush=True)
        res[label] = {"launches": counts, "peak_gib": peak, "rel_err": err, "ms": ms}
    return res


def phase_zy(steps: Steps) -> dict:
    """Phase 4d: RL-20 and Biggs RL-10 on separable_backend zy_pallas,
    each against its own float64 plain path."""
    zy = {"separable_backend": "zy_pallas"}
    step = steps.build(**zy)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "convzy_circular": 2 * ITERATIONS,
                                                  "convzy_march": 2 * ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, **zy)(steps.batch)
    compare("zy_pallas RL-20 step vs float64 plain", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    times = timed_pair(step, steps.build(plain=True, **zy), steps.batch, steps.vox,
                       "zy_pallas RL-20")
    kw = {**zy, "acceleration": "biggs", "iterations": BIGGS_ITERATIONS}
    bstep = steps.build(**kw)
    bout, bcounts, bpeak = drive(bstep, steps.batch,
                                 {"deskew": 1, "convzy_circular": 2 * BIGGS_ITERATIONS,
                                  "convzy_march": 2 * BIGGS_ITERATIONS})
    steps.check_shape(bout)
    ref = steps.build(plain=True, dtype=torch.float64, **kw)(steps.batch)
    berr = two_tier("zy_pallas Biggs RL-10 step vs float64 plain (bf16 state)", bout, ref)
    del bout, ref
    bms = warm_ms(bstep, steps)
    print(f"  zy_pallas Biggs RL-10: {bms:.1f} ms/volume, {steps.vox / bms / 1e6:.4f} "
          "RL-20-equivalent GVox/s (warm)", flush=True)
    return {"launches": counts, "peak_gib": peak, "rel_err": err, **times,
            "biggs": {"launches": bcounts, "peak_gib": bpeak, "rel_err": berr, "ms": bms}}


def phase_matmul(steps: Steps) -> dict:
    """Phase 4e: RL-20 on separable_backend matmul against the same
    backend in float64 on the card."""
    mm = {"separable_backend": "matmul"}
    step = steps.build(**mm)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, **mm)(steps.batch)
    compare("matmul RL-20 step vs float64", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    ms = warm_ms(step, steps)
    print(f"  matmul RL-20: {ms:.1f} ms/volume, {steps.vox / ms / 1e6:.4f} GVox/s (warm)",
          flush=True)
    return {"launches": counts, "peak_gib": peak, "rel_err": err, "ms": ms,
            "gvox_s": steps.vox / ms / 1e6}


def phase_fused_iter(steps: Steps, rl20: torch.Tensor) -> dict:
    """Phase 4f: RL-20 and Biggs RL-10 on separable_backend fused_iter."""
    from shrimpy_tpu_torch.ops.deconv import richardson_lucy
    from shrimpy_tpu_torch.ops.deskew import deskew_volume

    fi = {"separable_backend": "fused_iter"}
    step = steps.build(**fi)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "rl_iter": ITERATIONS})
    steps.check_shape(out)
    compare("fused_iter RL-20 vs fused kernel RL-20", out, rl20, FUSED_RTOL)
    ref = steps.build(plain=True, dtype=torch.float64, **fi)(steps.batch)
    compare("fused_iter RL-20 step vs float64 plain", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    times = timed_pair(step, steps.build(plain=True, **fi), steps.batch, steps.vox,
                       "fused_iter RL-20")
    kw = {**fi, "acceleration": "biggs", "iterations": BIGGS_ITERATIONS}
    bstep = steps.build(**kw)
    bout, bcounts, bpeak = drive(bstep, steps.batch, {"deskew": 1, "rl_iter": BIGGS_ITERATIONS})
    steps.check_shape(bout)
    ref = steps.build(plain=True, dtype=torch.float64, **kw)(steps.batch)
    berr = two_tier("fused_iter Biggs RL-10 step vs float64 plain (bf16 state)", bout, ref)
    del ref
    bms = warm_ms(bstep, steps)
    print(f"  fused_iter Biggs RL-10: {bms:.1f} ms/volume, {steps.vox / bms / 1e6:.4f} "
          "RL-20-equivalent GVox/s (warm)", flush=True)
    # donate_input through richardson_lucy (the step does not read it):
    # the caller's deskewed volume is consumed once the carries exist.
    settings = headline_settings(**kw)
    peaks = {}
    for donate in (False, True):
        settings.deconvolve.donate_input = donate
        vol = deskew_volume(steps.batch[0], settings.deskew)
        got, _, peaks[donate] = drive(
            lambda v: richardson_lucy(v, steps.psf, settings.deconvolve), vol,
            {"rl_iter": BIGGS_ITERATIONS})
        if (vol.numel() == 0) != donate:
            raise AssertionError(f"donate_input={donate}: the volume has {vol.numel()} voxels")
        if not torch.equal(got, bout[0]):
            raise AssertionError(f"donate_input={donate}: differs from the step's output")
        del vol, got
    print(f"  fused_iter Biggs RL-10 through richardson_lucy: peak {peaks[False]:.2f} GiB, with "
          f"donate_input {peaks[True]:.2f} GiB", flush=True)
    return {"launches": counts, "peak_gib": peak, "rel_err": err, **times,
            "biggs": {"launches": bcounts, "peak_gib": bpeak, "rel_err": berr, "ms": bms,
                      "peak_rl_gib": peaks[False], "peak_rl_donated_gib": peaks[True]}}


def transform_json(m, t) -> str:
    """The map as the register verb writes it, in the (git-ignored) build
    directory; its path."""
    import numpy as np

    from shrimpy_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "chip_smoke_transform.json"
    path.write_text(json.dumps({"matrix_zyx": np.asarray(m, np.float32).tolist(),
                                "offset_zyx": np.asarray(t, np.float32).tolist()}))
    return str(path)


def phase_step_reg(steps: Steps) -> dict:
    """Phase 4h: deskew + register-apply (LOWER_MAP from a transform JSON)
    + RL-20 on the fused backend: one warp launch a volume, against the
    float64 plain step."""
    path = transform_json(*LOWER_MAP)
    step = steps.build(transform=path)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "affine_warp": 1,
                                                  "rl_half_step": 2 * ITERATIONS,
                                                  "rl_half_one_launch": 2 * ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, transform=path)(steps.batch)
    compare("registered step (deskew + affine + RL-20) vs float64 plain", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    times = timed_pair(step, steps.build(plain=True, transform=path), steps.batch, steps.vox,
                       "deskew + register + RL-20")
    return {"launches": counts, "peak_gib": peak, "rel_err": err, **times}


# --- The FFT paths: the band kernel (row 9), bench.py configs 6, 8, 9, and phase.

NONSEP_SHAPE = (128, 2888, 1600)  # bench.py::_config_nonsep's default volume
BAND_RTOL = 1e-6  # the band against its plain version: kz float32 products a voxel
FFT3_RTOL = 2e-4  # fft2z vs fft3 after 20 iterations (tests/test_deconv.py:94)
# Ragged grids of the band: gz = kz = 9 (the smallest gz the padded grid can
# give), a (20, 37, 45) grid with kz 7, and one plane (kz 1).
BAND_CASES = (((144, 3000, 961), 15), ((9, 33, 17), 9), ((20, 37, 45), 7), ((6, 24, 17), 1))
# The depth (warm, exact iterations) of the hybrids' float64 checks: one of
# each for config 8 (its plain warm phase takes ~3.3 s a half-step in
# float64), three exact for config 9 so its Biggs tail extrapolates.
HYBRID_CHECK = {"config8": (1, 1), "config9": (1, 3)}
PHASE_SHAPE, PHASE_SMALL_SHAPE = (64, 2048, 2048), (64, 1024, 1024)
# What the host transfer function holds at its peak, about eight complex128
# arrays of (64 + 2 * 5, 2048, 2048).
PHASE_HOST_GIB = 40


def nonsep_psf():
    """bench.py configs 6, 8 and 9's PSF: ``tilted_gaussian_psf()`` of
    ``io/synthetic.py`` (15, 31, 31), non-separable (rank-24 residual
    8.7e-2): a Gaussian with sigma (1.5, 2.5, 5.0) sheared 0.9 in zy and
    0.8 in yx. Computed here: the port's ``io/synthetic.py`` imports
    tensorstore, which a card's machine need not have."""
    import numpy as np

    zz, yy, xx = np.meshgrid(np.arange(15) - 7.0, np.arange(31) - 15.0, np.arange(31) - 15.0,
                             indexing="ij")
    psf = np.exp(-0.5 * (((zz + 0.9 * yy) / 1.5) ** 2 + ((yy + 0.8 * xx) / 2.5) ** 2
                         + (xx / 5.0) ** 2)).astype(np.float32)
    return psf / psf.sum()


def nonsep_settings(config: str):
    """The deconvolve settings of bench.py's ``_config_nonsep`` (config6,
    RL-20 ``algorithm: fft``), ``_config_nonsep_hybrid`` (config8, 16 warm
    + 6 exact) and ``_config_nonsep_hybrid_accel`` (config9, 16 + 3 with
    Biggs), as namespaces."""
    from shrimpy_tpu_torch.config import deconvolve_settings

    return deconvolve_settings(**{
        "config6": {"iterations": ITERATIONS, "algorithm": "fft"},
        "config8": {"iterations": 6, "algorithm": "hybrid", "hybrid_separable_iters": 16},
        "config9": {"iterations": 3, "algorithm": "hybrid", "hybrid_separable_iters": 16,
                    "acceleration": "biggs"},
    }[config])


def complex_uniform(shape, gen) -> torch.Tensor:
    return torch.complex(uniform(shape, gen, -1.0, 1.0), uniform(shape, gen, -1.0, 1.0))


def library_band(spec: torch.Tensor, taps: torch.Tensor, mode: str) -> torch.Tensor:
    """The band as one PyTorch call, einsum over a window view of the
    spectrum with its rz wrap planes: the yardstick the port never calls."""
    kz = taps.shape[0]
    rz = kz // 2
    h = taps.flip(0) if mode == "conv" else taps.conj()
    wrapped = torch.cat([spec[spec.shape[0] - rz:], spec, spec[:rz]]) if rz else spec
    return torch.einsum("tyx,zyxt->zyx", h, wrapped.unfold(0, kz, 1))


def phase_band(gen) -> dict:
    """The band kernel (csrc/zband.cu) in both modes against its plain
    version on the production grid and three ragged ones, within BAND_RTOL;
    timed at the production grid beside its bound, the plain version and
    the einsum."""
    from shrimpy_tpu_torch.ops.zband_cuda import zband_cuda, zband_plain

    res = {"max_abs_err": 0.0}
    for (gz, gy, gxr), kz in BAND_CASES:
        spec, taps = complex_uniform((gz, gy, gxr), gen), complex_uniform((kz, gy, gxr), gen)
        for mode in ("conv", "corr"):
            out = zband_cuda(spec, taps, mode)
            ref = zband_plain(spec, taps, mode)
            err = compare(f"zband {mode} ({gz}, {gy}, {gxr}) kz {kz} vs plain",
                          torch.view_as_real(out), torch.view_as_real(ref), BAND_RTOL)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if gz == BAND_CASES[0][0][0] and mode == "conv":
                del ref
                res["ms"] = kernel_ms(lambda: zband_cuda(spec, taps, mode, out=out), 20)
                res["ms_corr"] = kernel_ms(lambda: zband_cuda(spec, taps, "corr", out=out), 20)
                res["plain_ms"] = gpu_ms(lambda: zband_plain(spec, taps, mode), 3)
                cols = gy * gxr
                res.update(bound(8 * cols * (2 * gz + kz), 8 * kz * gz * cols))
                del out
                torch.cuda.empty_cache()
                # The einsum reads a (gz, gy, gxr, kz) copy of the window view.
                need = 8 * gz * cols * (kz + 3)
                free = torch.cuda.mem_get_info()[0]
                if free > need:
                    lib = library_band(spec, taps, mode)
                    compare("zband conv: the einsum vs the kernel", torch.view_as_real(lib),
                            torch.view_as_real(zband_cuda(spec, taps, mode)), BAND_RTOL)
                    del lib
                    torch.cuda.empty_cache()
                    res["library_ms"] = gpu_ms(lambda: library_band(spec, taps, mode), 2)
                else:
                    res["library_ms"] = None
                    print(f"  zband einsum: not timed, it needs {need / 2**30:.1f} GiB, "
                          f"{free / 2**30:.1f} free", flush=True)
                print(f"  zband ({gz}, {gy}, {gxr}) kz {kz}: conv {res['ms']:.3f} ms, corr "
                      f"{res['ms_corr']:.3f} ms, bound {res['bound_ms']:.3f} by "
                      f"{res['bound_by']}, plain {res['plain_ms']:.3f}, einsum "
                      f"{res['library_ms']}", flush=True)
        del spec, taps
        torch.cuda.empty_cache()
    return res


def wall_s(fn, *args) -> tuple[torch.Tensor, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_nonsep(vol, psf) -> dict:
    """bench.py config 6: RL-20 ``algorithm: fft`` (``auto`` -> ``fft2z``)
    through ``richardson_lucy`` at the production volume, counts reset:
    two band launches an iteration. Against the same call on the plain
    versions in float64 on the card (STEP_RTOL); then ``fft3`` timed and
    held within FFT3_RTOL of ``fft2z``."""
    from shrimpy_tpu_torch.ops.deconv import resolve_fft_backend, richardson_lucy

    s = nonsep_settings("config6")
    backend = resolve_fft_backend(s, vol.dim())
    if backend != "fft2z":
        raise AssertionError(f"fft_backend auto resolved to {backend}, want fft2z")
    out, counts, peak = drive(lambda v: richardson_lucy(v, psf, s), vol,
                              {"zband": 2 * ITERATIONS})
    _, first = wall_s(richardson_lucy, vol, psf, s)
    _, ms = wall_s(richardson_lucy, vol, psf, s)
    ms = min(first, ms) * 1e3
    t0 = time.monotonic()
    ref = richardson_lucy(vol, psf, s, plain=True, dtype=torch.float64)
    check_s = time.monotonic() - t0
    compare(f"RL-20 fft2z vs float64 plain (the float64 run {check_s:.1f} s)", out, ref,
            STEP_RTOL)
    err = rel_err(out, ref)
    del ref
    torch.cuda.empty_cache()
    s3 = nonsep_settings("config6")
    s3.fft_backend = "fft3"
    torch.cuda.reset_peak_memory_stats()
    out3, _ = wall_s(richardson_lucy, vol, psf, s3)
    peak3 = torch.cuda.max_memory_allocated() / 2**30
    _, ms3 = wall_s(richardson_lucy, vol, psf, s3)
    compare("RL-20 fft3 vs fft2z", out3, out, FFT3_RTOL)
    del out3, out
    torch.cuda.empty_cache()
    vox = math.prod(vol.shape)
    print(f"  RL-20 fft2z: {ms:.1f} ms, {vox / ms / 1e6:.4f} GVox/s, peak {peak:.2f} GiB; "
          f"fft3 {ms3 * 1e3:.1f} ms, peak {peak3:.2f} GiB", flush=True)
    return {"launches": counts, "peak_gib": peak, "ms": ms, "gvox_s": vox / ms / 1e6,
            "rel_err": err, "fft3_ms": ms3 * 1e3, "fft3_peak_gib": peak3}


def phase_hybrid(vol, psf, config: str) -> dict:
    """bench.py config 8 (hybrid, 16 warm + 6 exact) or 9 (16 + 3, Biggs on
    both phases) through ``richardson_lucy``: K and the warm residual, the
    separable backend the warm phase resolves to, the warm phase's and the
    tail's ms, the total and the peak. Counts: the warm phase alone with
    the counts reset, then the whole call, which must count exactly those
    plus two band launches a tail iteration. The float64 check runs at the
    depth of HYBRID_CHECK (the plain warm phase with K terms takes seconds
    a half-step in float64): config 8 within STEP_RTOL, config 9 by the
    two-tier Biggs gate."""
    from shrimpy_tpu_torch.ops.deconv import (
        plan_hybrid_terms,
        prepare_psf,
        resolve_separable_backend,
        richardson_lucy,
        rl_separable,
    )
    from shrimpy_tpu_torch.ops.rl_fft import rl_fft

    s = nonsep_settings(config)
    psf_w = prepare_psf(psf, s)
    t0 = time.perf_counter()
    terms, residual = plan_hybrid_terms(psf_w, s)
    plan_s = time.perf_counter() - t0
    backend = resolve_separable_backend(s.separable_backend, tuple(vol.shape), psf_w.shape)
    warm, warm_counts, _ = drive(
        lambda v: rl_separable(v, psf_w, terms, s, s.hybrid_separable_iters), vol, None)
    warm_counts = {k: v for k, v in warm_counts.items() if v}
    _, warm_s = wall_s(rl_separable, vol, psf_w, terms, s, s.hybrid_separable_iters)
    _, tail_s = wall_s(lambda: rl_fft(vol, psf_w, s, s.iterations, init=warm))
    del warm
    torch.cuda.empty_cache()
    out, counts, peak = drive(lambda v: richardson_lucy(v, psf, s), vol,
                              {**warm_counts, "zband": 2 * s.iterations})
    del out
    _, total_s = wall_s(richardson_lucy, vol, psf, s)
    torch.cuda.empty_cache()
    check = nonsep_settings(config)
    check.hybrid_separable_iters, check.iterations = HYBRID_CHECK[config]
    out = richardson_lucy(vol, psf, check)
    t0 = time.monotonic()
    ref = richardson_lucy(vol, psf, check, plain=True, dtype=torch.float64)
    label = (f"hybrid {config} at {check.hybrid_separable_iters} warm + {check.iterations} "
             f"exact (the float64 "
             f"run {time.monotonic() - t0:.1f} s)")
    if s.acceleration == "biggs":
        err = two_tier(f"{label} (Biggs) vs float64 plain (bf16 state)", out, ref)
    else:
        compare(f"{label} vs float64 plain", out, ref, STEP_RTOL)
        err = rel_err(out, ref)
    del out, ref
    torch.cuda.empty_cache()
    vox = math.prod(vol.shape)
    res = {"k": len(terms), "warm_residual": residual, "warm_backend": backend,
           "plan_s": plan_s, "warm_ms": warm_s * 1e3, "tail_ms": tail_s * 1e3,
           "ms": total_s * 1e3, "gvox_s": vox / total_s / 1e9, "peak_gib": peak,
           "launches": counts, "rel_err": err}
    print(f"  hybrid {config}: K {res['k']} (residual {residual:.4f}, planned in "
          f"{plan_s:.2f} s), warm phase on {backend} {res['warm_ms']:.1f} ms, tail "
          f"{res['tail_ms']:.1f} ms, total {res['ms']:.1f} ms ({res['gvox_s']:.4f} "
          f"RL-20-equivalent GVox/s), peak {peak:.2f} GiB", flush=True)
    return res


def host_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise AssertionError("no MemAvailable in /proc/meminfo")


def phase_phase(gen) -> dict:
    """Phase reconstruction of a brightfield stack (64, 2048, 2048) with
    the schema's defaults (z_padding 5, 0.450 um, NA 1.35 / 0.52), yx
    0.116 um, z 0.25 um: the host transfer function (float64 numpy) and
    the card's inverse timed apart, the inverse against its float64 path
    on the card (STEP_RTOL), then through the reconstruct step with the
    transfer function handed over. (64, 1024, 1024) where the host cannot
    hold the transfer function's arrays. Then a weak phase object
    recovered at (16, 32, 32), as tests/test_phase.py:65 does."""
    import numpy as np

    from shrimpy_tpu_torch.config import phase_settings, reconstruct_settings
    from shrimpy_tpu_torch.ops.phase import (
        apply_inverse_transfer_function,
        compute_transfer_function,
        simulate_defocus_stack,
        tf_tensor,
    )
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    print(subprocess.run(["free", "-g"], capture_output=True, text=True).stdout.rstrip(),
          flush=True)
    avail = host_available_gib()
    shape = PHASE_SHAPE if avail >= 1.5 * PHASE_HOST_GIB else PHASE_SMALL_SHAPE
    print(f"  host memory available {avail:.1f} GiB: phase at {shape}", flush=True)
    settings = phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.25})
    tfs, inv = settings.transfer_function, settings.apply_inverse
    t0 = time.perf_counter()
    tf = compute_transfer_function(shape, tfs)
    tf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tf_dev = tf_tensor(tf, "cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    stack = uniform(shape, gen, 0.9, 1.1)
    out = apply_inverse_transfer_function(stack, tf_dev, inv, z_padding=tfs.z_padding)
    ref = apply_inverse_transfer_function(stack, tf_dev, inv, z_padding=tfs.z_padding,
                                          dtype=torch.float64)
    compare(f"phase inverse {shape} vs float64", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = gpu_ms(lambda: apply_inverse_transfer_function(stack, tf_dev, inv,
                                                        z_padding=tfs.z_padding), 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step = build_reconstruct_step(reconstruct_settings(phase=settings), device="cuda")
    got = step(stack[None], tf_dev)
    if not torch.equal(got[0], out):
        raise AssertionError("the step's phase stage differs from the inverse")
    _, step_s = wall_s(step, stack[None], tf_dev)
    del got, out, stack
    torch.cuda.empty_cache()
    # Recovery of a simulated weak phase object (tests/test_phase.py:65).
    small = (16, 32, 32)
    zz, yy, xx = np.meshgrid(*(np.arange(n) - n / 2.0 for n in small), indexing="ij")
    phi = 0.1 * np.exp(-0.5 * ((zz / 2.0) ** 2 + (yy / 4.0) ** 2 + (xx / 4.0) ** 2))
    phi -= phi.mean()
    small_tfs = phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.2,
                                "z_padding": 0}).transfer_function
    small_tf = compute_transfer_function(small, small_tfs)
    sim = simulate_defocus_stack(phi, small_tf, background=1.0)
    recon = apply_inverse_transfer_function(
        sim, small_tf, phase_settings(apply_inverse={"regularization_strength": 1e-4})
        .apply_inverse).cpu().numpy()
    corr = float(np.corrcoef(recon.ravel(), phi.ravel())[0, 1])
    print(f"  weak phase object {small}: correlation {corr:.4f} (want > 0.8)", flush=True)
    if not corr > 0.8:
        raise AssertionError(f"phase recovery correlation {corr:.4f}")
    vox = math.prod(shape)
    print(f"  phase {shape}: host TF {tf_s:.2f} s, to the card {h2d_s:.3f} s, inverse "
          f"{ms:.3f} ms ({vox / ms / 1e6:.4f} GVox/s), peak {peak:.2f} GiB, the step "
          f"{step_s * 1e3:.1f} ms", flush=True)
    return {"shape": shape, "tf_s": tf_s, "h2d_s": h2d_s, "ms": ms, "peak_gib": peak,
            "step_ms": step_s * 1e3, "rel_err": err, "recovery_corr": corr}


# --- Tracking (DynaTrack): the tracker and its preprocessor at the production
# raw (deskew on csrc/deskew.cu), and on a brightfield stack through phase.
TRACK_TIMEPOINTS = 3
TRACK_DRIFT = (2, 3)  # raw scan steps and x pixels a timepoint
TRACK_BLOBS = 48
TRACK_SIGMA = (3.0, 6.0, 6.0)  # deskewed px
TRACK_BACKGROUND, TRACK_NOISE = 100.0, 10.0  # camera offset, shot noise of ~100 counts
TRACK_COM_ATOL = 1e-3  # px, centres of mass against float64
# Multi-Otsu's pair is the argmax of an objective whose best pairs lie within
# ~1e-6 of each other (4.6e-7 between the first and third at (500, 96, 320),
# CPU): float32 sums cannot order them. The float32 run's pair must be within
# this of the float64 objective's maximum.
OTSU_TIE_RTOL = 1e-5
TRACK_METHODS = {
    "pcc": {},
    "intensity_center_of_mass": {"roi_center": {"background_percentile": 99.0}},
    "roi_center_pcc": {"roi_center": {"blob_sigma": 10.0}},
    "multiotsu_center_of_mass": {"segmentation": {"otsu_sigma": 5.0}},
    "multiotsu_pcc": {"segmentation": {"otsu_sigma": 5.0}},
    "template_matching": {},  # slice_zyx around the first blob, from track_blobs
}
LF_SHIFT = (0, 7, -5)  # the label-free arm's yx drift, px
LF_FOCUS = 40  # its in-focus slice


def track_blobs(gen):
    """Seeded blob centres and amplitudes in the deskewed frame: centres
    inside the production volume with a margin of 4 sigma past the drift,
    amplitudes in [500, 1500) but the first blob's 4000 (one object
    dominates, so roi_center_pcc has one peak) and its companion's 2000,
    (3, 10, 8) px from it: the template window holds the pair, a pattern
    no other window has (NCC ignores amplitude, and one blob alike the
    others would match them as well as its own moved copy)."""
    nz, ny, nx = deskewed_shape()
    r = torch.rand((TRACK_BLOBS, 4), generator=gen, device="cuda").double().cpu().numpy()
    margin = [4 * s + 2 for s in TRACK_SIGMA]
    span_y = ny - 2 * margin[1] - TRACK_TIMEPOINTS * TRACK_DRIFT[0] / 0.386
    centers = [(margin[0] + p[0] * (nz - 2 * margin[0]), margin[1] + p[1] * span_y,
                margin[2] + p[2] * (nx - 2 * margin[2] - TRACK_TIMEPOINTS * TRACK_DRIFT[1]))
               for p in r]
    amps = [4000.0, 2000.0] + [500.0 + 1000.0 * p[3] for p in r[2:]]
    centers[1] = tuple(c + d for c, d in zip(centers[0], (3.0, 10.0, 8.0)))
    return centers, amps


def track_raw(centers, amps) -> torch.Tensor:
    """The production raw (scan, tilt, x) of the blobs on the camera
    offset, each rendered at the raw voxels whose deskewed coordinates lie
    within 4 sigma of it: raw (s, t, x) sits at deskewed z = t sin(theta),
    y = s / r + t cos(theta) - y_offset, x (``ops/deskew.py::_geometry``).
    No noise: each timepoint adds its own (:func:`track_raws`)."""
    from shrimpy_tpu_torch.ops.deskew import _geometry

    g = _geometry(RAW_SHAPE, headline_settings().deskew)
    ns, nt, nxr = RAW_SHAPE
    raw = torch.full(RAW_SHAPE, TRACK_BACKGROUND, device="cuda")
    sz, sy, sx = TRACK_SIGMA
    for (cz, cy, cx), amp in zip(centers, amps):
        t0 = max(0, math.floor((cz - 4 * sz) / g["sin_t"]))
        t1 = min(nt, math.ceil((cz + 4 * sz) / g["sin_t"]) + 1)
        s0 = max(0, math.floor(g["r"] * (cy - 4 * sy + g["y_offset"] - t1 * g["cos_t"])))
        s1 = min(ns, math.ceil(g["r"] * (cy + 4 * sy + g["y_offset"] - t0 * g["cos_t"])) + 1)
        x0, x1 = max(0, math.floor(cx - 4 * sx)), min(nxr, math.ceil(cx + 4 * sx) + 1)
        s = torch.arange(s0, s1, device="cuda", dtype=torch.float64)[:, None, None]
        t = torch.arange(t0, t1, device="cuda", dtype=torch.float64)[None, :, None]
        x = torch.arange(x0, x1, device="cuda", dtype=torch.float64)[None, None, :]
        zd = t * g["sin_t"]
        yd = s / g["r"] + t * g["cos_t"] - g["y_offset"]
        arg = ((zd - cz) / sz) ** 2 + ((yd - cy) / sy) ** 2 + ((x - cx) / sx) ** 2
        raw[s0:s1, t0:t1, x0:x1] += (amp * torch.exp(-0.5 * arg)).float()
    return raw


def track_raws(gen, centers, amps) -> list:
    """TRACK_TIMEPOINTS raws: the blobs rolled by TRACK_DRIFT (scan steps,
    x px) a timepoint, each with its own N(0, TRACK_NOISE) noise. Noise
    matters: on a flat background the float32 integral images of the NCC
    leave windows of no variance with a small positive one, whose NCC
    blows up (what a camera never gives)."""
    raw0 = track_raw(centers, amps)
    raws = []
    for t in range(TRACK_TIMEPOINTS):
        raw = torch.roll(raw0, (t * TRACK_DRIFT[0], t * TRACK_DRIFT[1]), dims=(0, 2))
        raws.append(raw.add_(torch.randn(RAW_SHAPE, generator=gen, device="cuda"),
                             alpha=TRACK_NOISE))
    return raws


def track_config(method: str, **extra):
    from shrimpy_tpu_torch.config import dynatrack_settings

    return dynatrack_settings(input_channel="LS", tracking_channel="LS",
                              tracking_method=method, **{**TRACK_METHODS[method], **extra})


def track_otsu_reference(method: str, cfg, raws) -> tuple[list, list]:
    """The multi-Otsu methods in float64 at the float32 run's bin pair:
    per timepoint the float32 pair (recomputed as the tracker computes it)
    and the float64 objective's own pair, the float32 pair held within
    OTSU_TIE_RTOL of the float64 maximum, then the mask, centre of mass or
    PCC of the masked blur in float64 at the float32 pair. Returns the
    shifts and (pair32, pair64, gap) a timepoint."""
    import numpy as np

    from shrimpy_tpu_torch.ops.features import center_of_mass, gaussian_blur, otsu_objective
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    seg, f64, bins = cfg.segmentation, torch.float64, 256
    pre32, pre64 = Preprocessor(cfg), Preprocessor(cfg, dtype=f64)
    shifts, pairs, anchor = [], [], None
    for raw in raws:
        _, _, v32 = otsu_objective(gaussian_blur(pre32.tracking_stack(raw), seg.otsu_sigma))
        k32 = divmod(int(torch.argmax(v32)), bins)
        del v32
        blurred = gaussian_blur(pre64.tracking_stack(raw), seg.otsu_sigma, dtype=f64)
        lo, span, v64 = otsu_objective(blurred, dtype=f64)
        top = float(v64.max())
        gap = (top - float(v64[k32])) / top
        pairs.append((k32, divmod(int(torch.argmax(v64)), bins), gap))
        if not gap <= OTSU_TIE_RTOL:
            raise AssertionError(f"{method}: the float32 Otsu pair {k32} is {gap:.2e} below the "
                                 f"float64 objective's maximum")
        thr = lo + torch.tensor(k32, dtype=f64, device="cuda") / bins * span
        mask = (blurred > thr[seg.otsu_component]).to(f64)
        if method == "multiotsu_center_of_mass":
            center = (np.asarray(blurred.shape, dtype=np.float64) - 1.0) / 2.0
            shifts.append(center_of_mass(mask, dtype=f64).cpu().numpy() - center)
        elif anchor is None:
            anchor = mask * blurred
            shifts.append(np.zeros(3))
        else:
            shifts.append(phase_cross_correlation(anchor, mask * blurred, dtype=f64)
                          .astype(np.float64))
        del blurred, mask, v64
    return shifts, pairs


def timed_update(tracker, pre, stack, t: int):
    """One update from ``stack`` (raw, on the card or the host): the result
    and its host-clock ms, launch to the shifts on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = tracker.update(pre.tracking_stack(stack), t)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def track_method(method: str, raws, host_raw, slice_zyx, expected) -> dict:
    """One method over the timepoints: the float32 tracker (t = 0 the first
    call, t = 1, t = 2 warm from the card and again from a host numpy
    stack) with the counts reset, against the float64 tracker (the plain
    deskew, the same ops in float64)."""
    import numpy as np

    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    extra = {"template": {"slice_zyx": slice_zyx}} if method == "template_matching" else {}
    cfg = track_config(method, preprocessing=["deskew"],
                       deskew=vars(headline_settings().deskew), **extra)
    table = counters()
    for obj, attr in table.values():
        setattr(obj, attr, 0)
    pre, tracker = Preprocessor(cfg), Tracker(cfg)
    got = []
    r, first_ms = timed_update(tracker, pre, raws[0], 0)
    got.append(r.shift_px_zyx)
    r, _ = timed_update(tracker, pre, raws[1], 1)
    got.append(r.shift_px_zyx)
    torch.cuda.reset_peak_memory_stats()
    r, warm_ms = timed_update(tracker, pre, raws[2], 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    got.append(r.shift_px_zyx)
    r, host_ms = timed_update(tracker, pre, host_raw, 2)
    if not np.array_equal(r.shift_px_zyx, got[2]):
        raise AssertionError(f"{method}: the host stack gave {r.shift_px_zyx}, the card's {got[2]}")
    counts = {k: getattr(obj, attr) for k, (obj, attr) in table.items()}
    bad = {k: v for k, v in counts.items() if v != (4 if k == "deskew" else 0)}
    if bad:
        raise AssertionError(f"{method}: launch counts {bad}, want 4 deskew launches, no other")
    stages = tracker.timer.as_dict()
    moves = [rec.seconds for rec in tracker.timer.records if rec.name == "reference_to_device"]
    del pre, tracker
    torch.cuda.empty_cache()
    pre64, tracker64 = Preprocessor(cfg, dtype=torch.float64), Tracker(cfg, dtype=torch.float64)
    want = [tracker64.update(pre64.tracking_stack(raw), t).shift_px_zyx
            for t, raw in enumerate(raws)]
    del pre64, tracker64
    torch.cuda.empty_cache()
    com = method.endswith("center_of_mass")
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    otsu = None
    if method.startswith("multiotsu"):
        # Held to float64 at the float32 run's pair, which must tie the
        # float64 maximum; where the float64 run picked the same pair, its
        # own shifts are that reference's.
        ref, otsu = track_otsu_reference(method, cfg, raws)
        torch.cuda.empty_cache()
        for t, (k32, k64, _) in enumerate(otsu):
            if k32 == k64 and not np.abs(ref[t] - want[t]).max() <= (
                    TRACK_COM_ATOL / 10 if com else 0.0):
                raise AssertionError(f"{method}: t={t} the reference at the tracker's pair "
                                     f"{ref[t]} differs from the float64 tracker's {want[t]}")
        err_ref = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    else:
        err_ref = err
    if (com and not err_ref <= TRACK_COM_ATOL) or (not com and err_ref != 0.0):
        raise AssertionError(f"{method}: shifts {got} against float64 {want}"
                             + (f" (at the float32 pairs: {ref}; pairs {otsu})" if otsu else ""))
    if method in ("pcc", "template_matching"):
        for t in (1, 2):
            if not np.abs(got[t] - expected[t]).max() <= 1.0:
                raise AssertionError(f"{method}: t={t} shift {got[t]}, injected {expected[t]}")
    res = {"first_ms": first_ms, "warm_ms": warm_ms, "host_ms": host_ms, "peak_gib": peak,
           "to_host_ms": stages.get("reference_to_host", 0.0) * 1e3,
           "to_device_ms": float(np.mean(moves)) * 1e3 if moves else None,
           "shifts": [s.tolist() for s in got], "max_err_f64": err, "max_err_ref": err_ref,
           "otsu_pairs": otsu}
    to_dev = (f"{res['to_device_ms']:.3f} ms" if moves else
              "none (only the template window moves)" if method == "template_matching" else
              "none (referenceless)")
    pairs = ("" if otsu is None else "; Otsu pairs float32 / float64 (gap): " + ", ".join(
        f"{k32} / {k64} ({gap:.1e})" for k32, k64, gap in otsu)
        + f", max diff at the float32 pairs {err_ref:.2e}")
    print(f"  {method}: shifts {res['shifts']} (float64: max diff {err:.2e}{' px' if com else ''}"
          f"{pairs}); "
          f"first {first_ms:.1f} ms, warm {warm_ms:.1f} ms from the card, {host_ms:.1f} ms from "
          f"a host numpy stack; reference to the host {res['to_host_ms']:.1f} ms, to the card "
          f"{to_dev}; peak {peak:.2f} GiB", flush=True)
    return res


def track_ops(stack, slice_zyx) -> dict:
    """The tracking ops alone at the deskewed shape, CUDA events, warm."""
    from shrimpy_tpu_torch.ops.features import gaussian_blur, multi_otsu
    from shrimpy_tpu_torch.ops.match import match_template
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation

    blurred = gaussian_blur(stack, 5.0)
    tmpl = stack[tuple(slice(a, b) for a, b in slice_zyx)]
    moved = torch.roll(stack, (0, 5, 3), dims=(0, 1, 2))
    res = {"blur_ms": gpu_ms(lambda: gaussian_blur(stack, 5.0), 3),
           "multi_otsu_ms": gpu_ms(lambda: multi_otsu(blurred), 3),
           "ncc_ms": gpu_ms(lambda: match_template(moved, tmpl), 3),
           "pcc_ms": gpu_ms(lambda: phase_cross_correlation(stack, moved), 3)}
    print(f"  ops alone at {tuple(stack.shape)}: blur (sigma 5) {res['blur_ms']:.3f} ms, "
          f"multi-Otsu {res['multi_otsu_ms']:.3f} ms, NCC surface {res['ncc_ms']:.3f} ms, "
          f"PCC {res['pcc_ms']:.3f} ms", flush=True)
    return res


def focus_stack(shape, gen) -> torch.Tensor:
    """A brightfield defocus stack: one sharp random texture, slice z blurred
    by a Gaussian of sigma |z - LF_FOCUS| * 0.8 + 0.01 px (by its transfer
    function), scaled to 1 +- 0.05."""
    nz, ny, nx = shape
    spec = torch.fft.rfft2(torch.rand((ny, nx), generator=gen, device="cuda"))
    fy = torch.fft.fftfreq(ny, device="cuda")[:, None]
    fx = torch.fft.rfftfreq(nx, device="cuda")[None, :]
    f2 = fy**2 + fx**2
    out = torch.empty(shape, device="cuda")
    for z in range(nz):
        sigma = abs(z - LF_FOCUS) * 0.8 + 0.01
        out[z] = torch.fft.irfft2(spec * torch.exp(-2 * math.pi**2 * sigma**2 * f2), s=(ny, nx))
    return 1.0 + 0.1 * (out - 0.5)


def phase_track(gen, phase_shape) -> dict:
    """(a) The tracker with ``preprocessing: [deskew]`` (``headline_settings``'s
    deskew) over TRACK_TIMEPOINTS production raws of seeded blobs drifting
    TRACK_DRIFT (scan steps, x px) a timepoint, every method against its
    float64 run; pcc and template_matching recover the drift within 1 px;
    the ops alone. (b) pcc with ``preprocessing: [phase]`` on two
    brightfield stacks of ``phase_shape`` (phase 4l's) shifted LF_SHIFT,
    the transfer function from phase 4l's host cache; the focus metric."""
    import numpy as np

    from shrimpy_tpu_torch.engine.autofocus import focus_from_transverse_band
    from shrimpy_tpu_torch.ops.phase import _compute_tf_cached
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    t_start = time.monotonic()
    centers, amps = track_blobs(gen)
    raws = track_raws(gen, centers, amps)
    host_raw = raws[-1].cpu().numpy()
    r = headline_settings().deskew.px_to_scan_ratio
    expected = [np.array([0.0, t * TRACK_DRIFT[0] / r, t * TRACK_DRIFT[1]])
                for t in range(TRACK_TIMEPOINTS)]
    cz, cy, cx = (int(round(c)) for c in centers[0])
    slice_zyx = ((cz - 10, cz + 10), (cy - 24, cy + 24), (cx - 24, cx + 24))
    print(f"  {TRACK_BLOBS} blobs, sigma {TRACK_SIGMA} px, on {TRACK_BACKGROUND:g} with noise of "
          f"{TRACK_NOISE:g}; injected "
          f"deskewed drift {expected[1].tolist()} px a timepoint; template {slice_zyx}",
          flush=True)
    methods = {m: track_method(m, raws, host_raw, slice_zyx, expected) for m in TRACK_METHODS}
    from shrimpy_tpu_torch.ops.deskew import deskew_volume

    ops = track_ops(deskew_volume(raws[1], headline_settings().deskew), slice_zyx)
    del raws, host_raw
    torch.cuda.empty_cache()
    ls_s = time.monotonic() - t_start

    # (b) label-free: phase, then pcc; the TF from phase 4l's host cache.
    t_lf = time.monotonic()
    stack0 = focus_stack(phase_shape, gen)
    stack1 = torch.roll(stack0, LF_SHIFT[1:], dims=(1, 2))
    phase = {"transfer_function": {"yx_pixel_size": 0.116, "z_pixel_size": 0.25}}
    cfg = track_config("pcc", preprocessing=["phase"], phase=phase)
    pre, tracker = Preprocessor(cfg), Tracker(cfg)
    before = _compute_tf_cached.cache_info()
    r0, first_ms = timed_update(tracker, pre, stack0, 0)
    after = _compute_tf_cached.cache_info()
    if not (after.hits == before.hits + 1 and after.misses == before.misses):
        raise AssertionError(f"the tracker's TF missed phase 4l's cache: {before} -> {after}")
    r1, _ = timed_update(tracker, pre, stack1, 1)
    torch.cuda.reset_peak_memory_stats()
    r1w, warm_ms = timed_update(tracker, pre, stack1, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = pre.timer.as_dict()
    del pre, tracker
    torch.cuda.empty_cache()
    pre64, tracker64 = Preprocessor(cfg, dtype=torch.float64), Tracker(cfg, dtype=torch.float64)
    want = [tracker64.update(pre64.tracking_stack(s), t).shift_px_zyx
            for t, s in enumerate((stack0, stack1))]
    del pre64, tracker64
    torch.cuda.empty_cache()
    if not (np.array_equal(r0.shift_px_zyx, want[0]) and np.array_equal(r1.shift_px_zyx, want[1])
            and np.array_equal(r1w.shift_px_zyx, r1.shift_px_zyx)):
        raise AssertionError(f"label-free pcc {r1.shift_px_zyx} against float64 {want[1]}")
    if not np.abs(r1.shift_px_zyx - np.array(LF_SHIFT)).max() <= 1.0:
        raise AssertionError(f"label-free pcc {r1.shift_px_zyx}, injected {LF_SHIFT}")
    focus = focus_from_transverse_band(stack0, pixel_size_um=0.116)
    focus64 = focus_from_transverse_band(stack0, pixel_size_um=0.116, dtype=torch.float64)
    focus_ms = gpu_ms(lambda: focus_from_transverse_band(stack0, pixel_size_um=0.116), 3)
    if focus != focus64 or focus != LF_FOCUS:
        raise AssertionError(f"focus index {focus}, float64 {focus64}, in focus {LF_FOCUS}")
    del stack0, stack1
    torch.cuda.empty_cache()
    lf = {"shape": phase_shape, "shift": r1.shift_px_zyx.tolist(), "first_ms": first_ms,
          "warm_ms": warm_ms, "peak_gib": peak, "tf_to_card_ms": stages["phase_tf"] * 1e3,
          "phase_ms": stages["phase"] * 1e3 / 3, "tf_cache": str(after),
          "focus": focus, "focus_ms": focus_ms, "seconds": time.monotonic() - t_lf}
    print(f"  label-free pcc at {phase_shape}: shift {lf['shift']} (float64 the same; injected "
          f"{list(LF_SHIFT)}); first {first_ms:.1f} ms (the TF from phase 4l's host cache, "
          f"{after.hits - before.hits} hit, to the card once: {lf['tf_to_card_ms']:.1f} ms), warm "
          f"{warm_ms:.1f} ms, the inverse {lf['phase_ms']:.1f} ms an update; peak {peak:.2f} GiB; "
          f"focus index {focus} (float64 {focus64}) in {focus_ms:.3f} ms", flush=True)
    return {"methods": methods, "ops": ops, "lf": lf, "ls_seconds": ls_s,
            "seconds": time.monotonic() - t_start}


# --- Virtual staining (ROADMAP queue 1 item 10): the default unet25d through
# the tracker, unext2 at the widths of ConvNeXt-V2 Tiny (Woo et al. 2023) with
# the plane and the voxel-stack heads, and the [deskew, phase, vs] chain; every
# net with weights from its seed, against the float32 run of the same weights.
# bf16 against the float32 run of the same weights, max|a-b| / max|b|: the
# rounding of a net ~14 layers deep (2e-2 to 6e-2 at base width 8 on the CPU,
# tests/test_torch_vs.py, where the port's error is held to twice JAX's).
VS_BF16_RTOL = 1e-1
VS_F32_BATCH = 4  # the float32 runs' batch: their activations are twice bf16's
VS_PHASE = {"transfer_function": {"yx_pixel_size": 0.116, "z_pixel_size": 0.25}}
UNEXT2_TINY = {"encoder_blocks": [3, 3, 9, 3], "dims": [96, 192, 384, 768], "stem_kernel_z": 5}
VS_NETS = {
    "unext2 plane head": {"architecture": "unext2", "in_slices": 5, "arch_config": UNEXT2_TINY},
    "unext2 voxel-stack head": {"architecture": "unext2", "in_slices": 15, "window_step": 1,
                                "arch_config": {**UNEXT2_TINY, "out_stack_depth": 5}},
}
# The chain's raw: deskewed (32, 1050, 256) with the headline deskew, y no
# multiple of 8 (reflect-padded for the net) and its host transfer function
# (42 planes with z_padding 5) seconds.
VS_CHAIN_RAW = (427, 64, 256)
VS_SLAB = slice(28, 36)  # the unext2 nets' planes held against float32
BF16_PEAK = 989e12  # dense bf16 on the tensor cores, FLOP/s


def vs_track_config(channel: str, steps, **extra):
    from shrimpy_tpu_torch.config import dynatrack_settings

    return dynatrack_settings(input_channel="LS", tracking_channel=channel,
                              tracking_method="pcc", preprocessing=list(steps),
                              phase=VS_PHASE, **extra)


def vs_float32(stainer):
    """``stainer`` made its float32 reference run (the same weights), at
    batch VS_F32_BATCH."""
    stainer.model.compute_dtype = torch.float32
    stainer.settings.batch_slices = VS_F32_BATCH
    return stainer


def vs_stage_ms(pre) -> float:
    """The last ``vs`` stage of ``pre``'s timer, ms."""
    return [r.seconds for r in pre.timer.records if r.name == "vs"][-1] * 1e3


def vs_volume_flops(stainer, shape) -> float:
    """The convolutions' and products' FLOPs of one ``predict`` of a
    ``shape`` volume: one forward's (counted by ``FlopCounterMode`` on the
    ``meta`` device) times the windows."""
    from torch.utils.flop_counter import FlopCounterMode

    from shrimpy_tpu_torch.models.vsunet import build_model

    net, _ = build_model(stainer.settings)
    with FlopCounterMode(display=False) as fc:
        net(torch.empty(1, stainer.settings.in_slices, *shape[1:], device="meta"))
    d = net.out_stack_depth
    if d == 1:
        return fc.get_total_flops() * shape[0]
    last = shape[0] - d
    return fc.get_total_flops() * (-(-last // stainer.settings.window_step) + 1)


def stamp(t_start: float, header: str) -> None:
    """A phase's header line with the script's seconds so far."""
    print(f"{header} ({time.monotonic() - t_start:.1f} s in)", flush=True)


def vs_ms(fn, *args) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_vs(gen, phase_shape) -> dict:
    """(a) The default unet25d (``VSModelSettings()``) through the
    ``Preprocessor`` (``[phase, vs]``) and the ``Tracker`` (``pcc`` on
    ``vs_nuclei``) over two brightfield stacks of ``phase_shape`` (phase
    4l's, the TF from its host cache) shifted LF_SHIFT: the first and the
    warm (second) VS and update ms and the peak; the shifts equal the
    float32 run's and the bf16 ``vs_nuclei`` within VS_BF16_RTOL of it.
    (b) unext2 at Tiny widths, plane and voxel-stack heads, on the phase
    volume: first and warm ms, peak, the error against the float32 run on
    the planes VS_SLAB. (c) ``[deskew, phase, vs]`` on VS_CHAIN_RAW: one
    deskew launch, the VS product against the float32 run."""
    import numpy as np

    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    t_start = time.monotonic()
    stack0 = focus_stack(phase_shape, gen)
    stack1 = torch.roll(stack0, LF_SHIFT[1:], dims=(1, 2))
    cfg = vs_track_config("vs_nuclei", ("phase", "vs"))
    pre, tracker = Preprocessor(cfg), Tracker(cfg)
    r0, first_ms = timed_update(tracker, pre, stack0, 0)
    first_vs = vs_stage_ms(pre)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pre.tracking_stack(stack1)
    r1 = tracker.update(got, 1)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm_vs = vs_stage_ms(pre)
    phase_vol = pre(stack0, run_vs=False)["phase"]
    flops = vs_volume_flops(pre.stainer, tuple(phase_vol.shape))
    batch = pre.stainer.settings.batch_slices
    del pre, tracker
    torch.cuda.empty_cache()
    t32 = time.monotonic()
    pre32, tracker32 = Preprocessor(cfg), Tracker(cfg)
    vs_float32(pre32.stainer)
    want0 = tracker32.update(pre32.tracking_stack(stack0), 0).shift_px_zyx
    ref = pre32.tracking_stack(stack1)
    want1 = tracker32.update(ref, 1).shift_px_zyx
    f32_s = time.monotonic() - t32
    del pre32, tracker32
    compare("unet25d vs_nuclei bf16 vs its float32 run", got, ref, VS_BF16_RTOL)
    err = rel_err(got, ref)
    del got, ref, stack0, stack1
    torch.cuda.empty_cache()
    if not (np.array_equal(r0.shift_px_zyx, want0) and np.array_equal(r1.shift_px_zyx, want1)):
        raise AssertionError(f"VS pcc {r0.shift_px_zyx}, {r1.shift_px_zyx} against the float32 "
                             f"run's {want0}, {want1}")
    unet = {"shape": phase_shape, "batch": batch, "shift": r1.shift_px_zyx.tolist(),
            "first_vs_ms": first_vs, "vs_ms": warm_vs, "first_update_ms": first_ms,
            "update_ms": warm_ms, "peak_gib": peak, "rel_err": err, "tflop": flops / 1e12,
            "bound_ms": flops / BF16_PEAK * 1e3, "float32_s": f32_s,
            "seconds": time.monotonic() - t_start}
    print(f"  unet25d (base 64, depth 3, batch {batch}) at {phase_shape}: VS {warm_vs:.1f} ms "
          f"warm, "
          f"{first_vs:.1f} first ({flops / 1e12:.1f} TFLOP, bound {unet['bound_ms']:.1f} ms at "
          f"the bf16 peak); update {warm_ms:.1f} ms warm, {first_ms:.1f} first; peak "
          f"{peak:.2f} GiB; shift {unet['shift']} (float32 run {want1.tolist()}; injected "
          f"{list(LF_SHIFT)}); vs_nuclei rel err {err:.3e} against float32 (its two updates "
          f"{f32_s:.1f} s); (a) took {unet['seconds']:.1f} s", flush=True)

    nets = {}
    for label, kw in VS_NETS.items():
        t_net = time.monotonic()
        stainer = VirtualStainer(vs_settings(**kw))
        t0 = time.perf_counter()
        _, counts, net_peak = drive(lambda v: stainer.predict(v)["vs_nuclei"], phase_vol, {})
        first = (time.perf_counter() - t0) * 1e3
        _, ms = vs_ms(stainer.predict, phase_vol)
        slab = phase_vol[VS_SLAB]
        out = stainer.predict(slab)["vs_nuclei"]
        ref = vs_float32(stainer).predict(slab)["vs_nuclei"]
        compare(f"{label} vs_nuclei bf16 vs its float32 run, planes {VS_SLAB.start}-"
                f"{VS_SLAB.stop - 1}", out, ref, VS_BF16_RTOL)
        flops = vs_volume_flops(stainer, tuple(phase_vol.shape))
        nets[label] = {"ms": ms, "first_ms": first, "peak_gib": net_peak,
                       "rel_err": rel_err(out, ref), "tflop": flops / 1e12,
                       "bound_ms": flops / BF16_PEAK * 1e3,
                       "seconds": time.monotonic() - t_net}
        print(f"  {label} (blocks {UNEXT2_TINY['encoder_blocks']}, dims "
              f"{UNEXT2_TINY['dims']}, in_slices {kw['in_slices']}): {ms:.1f} ms warm, "
              f"{first:.1f} first ({flops / 1e12:.1f} TFLOP, bound "
              f"{nets[label]['bound_ms']:.1f} ms), peak {net_peak:.2f} GiB, rel err "
              f"{nets[label]['rel_err']:.3e} against float32; took "
              f"{nets[label]['seconds']:.1f} s", flush=True)
        del stainer, out, ref
        torch.cuda.empty_cache()
    del phase_vol
    torch.cuda.empty_cache()

    t_chain = time.monotonic()
    raw = uniform(VS_CHAIN_RAW, gen, 90.0, 110.0)
    chain = vs_track_config("vs_nuclei", ("deskew", "phase", "vs"),
                            deskew=vars(headline_settings().deskew))
    pre = Preprocessor(chain)
    t0 = time.perf_counter()
    out, counts, _ = drive(lambda r: pre(r)["vs_nuclei"], raw, {"deskew": 1})
    chain_s = time.perf_counter() - t0
    _, chain_ms = vs_ms(lambda r: pre(r)["vs_nuclei"], raw)
    shape = tuple(pre(raw, run_vs=False)["phase"].shape)
    pre32 = Preprocessor(chain)
    vs_float32(pre32.stainer)
    ref = pre32(raw)["vs_nuclei"]
    compare("[deskew, phase, vs] vs_nuclei bf16 vs its float32 run", out, ref, VS_BF16_RTOL)
    res_c = {"raw": VS_CHAIN_RAW, "shape": shape, "deskew_launches": counts["deskew"],
             "first_s": chain_s, "ms": chain_ms, "rel_err": rel_err(out, ref),
             "seconds": time.monotonic() - t_chain}
    print(f"  [deskew, phase, vs] at raw {VS_CHAIN_RAW} (phase {shape}): "
          f"{counts['deskew']} deskew launch, first {chain_s:.2f} s (host TF included), warm "
          f"{chain_ms:.1f} ms, rel err {res_c['rel_err']:.3e} against float32; took "
          f"{res_c['seconds']:.1f} s", flush=True)
    del pre, pre32, raw, out, ref
    torch.cuda.empty_cache()
    return {"unet25d": unet, "unext2": nets, "chain": res_c,
            "seconds": time.monotonic() - t_start}


def build_all(build) -> None:
    """The common library and, beside it, the kernels compiled for their
    geometry (the one-launch half-step and its circular build, the whole
    iteration and the z+y march) for every geometry this script runs, all compilers at once (a
    geometry missed here is compiled at its first launch)."""
    from concurrent.futures import ThreadPoolExecutor

    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_layout
    from shrimpy_tpu_torch.ops.rl_fused import half_layout
    from shrimpy_tpu_torch.ops.rl_fused_iter import iter_layout

    terms, carry = production_terms()
    jobs = []
    for tt in (terms, two_term_psf(), *other_terms().values()):
        lengths = tuple(len(w) for w in tt[0])
        tile = half_layout(carry, tuple(k // 2 for k in lengths), len(tt))["tile"]
        jobs.append(("rl_half", (len(tt), *lengths, *tile)))
    for shape, tt in ((carry, terms), (SMALL, two_term_psf())):
        lengths = tuple(len(w) for w in tt[0])
        tile = iter_layout(shape, tuple(k // 2 for k in lengths), len(tt))["tile"]
        jobs.append(("rl_iter", (len(tt), *lengths, *tile)))
    marches = {(shape, tuple(len(w) for w in tt[0][:2])) for shape, tt, _, _ in convzy_cases(terms, carry)}
    marches.add(((4, 10, 60020), (3, 5)))  # phase_routes' x row in pieces
    for shape, lengths in sorted(marches):
        tile = convzy_layout(shape, tuple(k // 2 for k in lengths))["tile"]
        jobs += [("convzy", (*lengths, *tile, wrap)) for wrap in (0, 1)]
    wrapped = set()
    for shape, tt, _, _ in conv3_cases(terms, carry):
        lengths = tuple(len(w) for w in tt[0])
        layout = half_layout(shape, tuple(k // 2 for k in lengths), len(tt))
        if layout is not None:
            wrapped.add((len(tt), *lengths, *layout["tile"], 1))
    jobs += [("rl_half_wrap", g) for g in sorted(wrapped)]
    # The hybrid's warm phase (bench.py configs 8 and 9) on its K terms.
    from shrimpy_tpu_torch.ops.deconv import (
        plan_hybrid_terms,
        prepare_psf,
        resolve_separable_backend,
    )

    s = nonsep_settings("config8")
    psf_w = prepare_psf(nonsep_psf(), s)
    hterms, _ = plan_hybrid_terms(psf_w, s)
    if resolve_separable_backend(s.separable_backend, NONSEP_SHAPE, psf_w.shape) == "fused":
        radii = tuple(k // 2 for k in psf_w.shape)
        layout = half_layout(tuple(n + 2 * r for n, r in zip(NONSEP_SHAPE, radii)), radii,
                             len(hterms))
        if layout is not None:
            jobs.append(("rl_half", (len(hterms), *psf_w.shape, *layout["tile"])))
    with ThreadPoolExecutor(2) as pool:
        geometries = pool.submit(build.build_geometries, jobs)
        build.load_library()
        geometries.result()


def main(argv) -> int:
    t_start = time.monotonic()
    # --parent-iter DIR: the source of the whole-iteration kernel before its
    # redesign, timed beside the new one in phase 3.
    parent_dir = argv[argv.index("--parent-iter") + 1] if "--parent-iter" in argv else None
    # --parent-convzy DIR: the source of the z+y kernel before the march,
    # timed beside it in phase 3.
    parent_zy = argv[argv.index("--parent-convzy") + 1] if "--parent-convzy" in argv else None
    # --parent-deskew DIR: the source of the deskew kernel before its
    # redesign, held to the new one's bits and timed beside it in phase 3.
    parent_desk = argv[argv.index("--parent-deskew") + 1] if "--parent-deskew" in argv else None
    # --parent-affine DIR: the source of the affine kernels before the
    # two-launch refine step, timed beside it in phase 3.
    parent_aff = argv[argv.index("--parent-affine") + 1] if "--parent-affine" in argv else None
    # --parent-probes DIR: the source of the probe kernels before their
    # redesign, held to the new ones and timed beside them in phase 3.
    parent_prb = argv[argv.index("--parent-probes") + 1] if "--parent-probes" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # Fails here, before any output, where the repository is missing.
    from shrimpy_tpu_torch.kernels import build

    # The plain versions use neither; stated so no reference runs TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.monotonic()
    build_all(build)
    print(f"[2] kernels built from {build.CSRC_DIR.name}/ and loaded in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("[3] kernels against their plain versions", flush=True)
    desk = phase_deskew(gen, parent_desk)
    torch.cuda.empty_cache()
    rl, rl3 = phase_rl(gen)
    accel = phase_accel(gen)
    print("  the three-pass route through richardson_lucy:", flush=True)
    three = phase_three_pass()
    zy = phase_convzy(gen, parent_zy)
    torch.cuda.empty_cache()
    czy, c3, xcirc = phase_circular(gen, parent_zy)
    torch.cuda.empty_cache()
    print("  the z+y step's two-pass route and the repaired carries through richardson_lucy:",
          flush=True)
    routes = phase_routes()
    torch.cuda.empty_cache()
    it = phase_iter(gen, parent_dir)
    torch.cuda.empty_cache()
    p_slice, p_smem, p_dot = phase_probes(parent_prb)
    torch.cuda.empty_cache()
    print("  the affine warp and its gradient (csrc/affine.cu):", flush=True)
    aff = phase_affine(gen)
    torch.cuda.empty_cache()
    rsums, rgrad = phase_refine(gen, parent_aff)
    torch.cuda.empty_cache()
    print("  the band of the fft2z RL (csrc/zband.cu):", flush=True)
    band = phase_band(gen)
    torch.cuda.empty_cache()
    steps = Steps(gen)
    stamp(t_start, "[4] main path: deskew + RL-20 at raw (1201, 256, 1600)")
    step = phase_step(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4b] deskew + Biggs RL-10 (in-kernel) at raw (1201, 256, 1600)")
    biggs = phase_biggs(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4c] the same steps on separable_backend linear_pallas")
    rl20 = step.pop("out")
    lin = phase_linear(steps, rl20, biggs.pop("out"))
    torch.cuda.empty_cache()
    stamp(t_start, "[4d] deskew + RL-20 and Biggs RL-10 on separable_backend zy_pallas")
    zyp = phase_zy(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4e] deskew + RL-20 on separable_backend matmul")
    mmp = phase_matmul(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4f] deskew + RL-20 and Biggs RL-10 on separable_backend fused_iter")
    fip = phase_fused_iter(steps, rl20)
    del rl20
    torch.cuda.empty_cache()
    stamp(t_start, f"[4g] estimate_registration (pcc+refine, defaults) at {deskewed_shape()}")
    reg = phase_register(gen, parent_aff)
    torch.cuda.empty_cache()
    stamp(t_start, "[4h] deskew + register-apply + RL-20 at raw (1201, 256, 1600)")
    sreg = phase_step_reg(steps)
    del steps
    torch.cuda.empty_cache()
    t_fft = time.monotonic()
    stamp(t_start, f"[4i] bench.py config 6: RL-20 with tilted_gaussian_psf() (non-separable) at "
          f"{NONSEP_SHAPE}, fft_backend auto")
    nvol, npsf = uniform(NONSEP_SHAPE, gen, 0.0, 100.0), nonsep_psf()
    nonsep = phase_nonsep(nvol, npsf)
    torch.cuda.empty_cache()
    stamp(t_start, "[4j] bench.py config 8: hybrid, 16 warm + 6 exact iterations")
    hyb8 = phase_hybrid(nvol, npsf, "config8")
    torch.cuda.empty_cache()
    stamp(t_start, "[4k] bench.py config 9: hybrid with Biggs, 16 warm + 3 exact iterations")
    hyb9 = phase_hybrid(nvol, npsf, "config9")
    del nvol
    torch.cuda.empty_cache()
    stamp(t_start, "[4l] phase reconstruction of a brightfield stack")
    ph = phase_phase(gen)
    fft_s = time.monotonic() - t_fft
    stamp(t_start, f"[4m] tracking: deskew + each method at raw {RAW_SHAPE}; phase + pcc at "
          f"{ph['shape']}")
    trk = phase_track(gen, ph["shape"])
    torch.cuda.empty_cache()
    stamp(t_start, f"[4n] virtual staining: unet25d through the tracker at {ph['shape']}; "
          f"unext2 at ConvNeXt-V2 Tiny widths; [deskew, phase, vs] at raw {VS_CHAIN_RAW}")
    vs = phase_vs(gen, ph["shape"])
    print(f"[5] {card}: RL-20 kernel path {step['gvox_s']:.4f} GVox/s (plain f32 "
          f"{step['plain_gvox_s']:.4f}); Biggs RL-10 kernel path {biggs['gvox_s']:.4f} "
          f"RL-20-equivalent GVox/s (plain f32 {biggs['plain_gvox_s']:.4f}), max rel err "
          f"{biggs['rel_err']:.3e}; linear_pallas RL-20 {lin['RL-20']['ms']:.1f} ms, "
          f"Biggs RL-10 {lin['Biggs RL-10']['ms']:.1f} ms; deskew kernel {desk['ms']:.3f} ms "
          f"(before the redesign {desk.get('ms_parent', 'not timed')}, plain "
          f"{desk['plain_ms']:.3f}, bound {desk['bound_ms']:.3f}, F.grid_sample "
          f"{desk['library_ms']:.3f}; config 1 {desk['config1_ms']:.3f}, before "
          f"{desk.get('config1_ms_parent', 'not timed')}, bound {desk['config1_bound_ms']:.3f}); "
          f"RL half-step {rl['ms']:.3f} ms in one launch (three "
          f"passes {rl['ms_three_pass']:.3f}, plain {rl['plain_ms']:.3f}; PSF {OTHER_PSF[0]} "
          f"{rl['ms_other_psf']:.3f}, {OTHER_TERMS} terms of {PSF_SHAPE} "
          f"{rl['ms_two_terms']:.3f}); ratio_accel "
          f"{accel['ms_ratio_accel']:.3f} ms (three passes "
          f"{accel['ms_ratio_accel_three_pass']:.3f}, plain "
          f"{accel['plain_ms_ratio_accel']:.3f}); mult_accel {accel['ms_mult_accel']:.3f} ms "
          f"(three passes {accel['ms_mult_accel_three_pass']:.3f}, plain "
          f"{accel['plain_ms_mult_accel']:.3f}); convzy_linear {zy['ms']:.3f} ms (before the "
          f"march {zy.get('ms_parent', 'not timed')}, two passes {zy['ms_two_pass']:.3f}, plain "
          f"{zy['plain_ms']:.3f}, bound {zy['bound_ms']:.3f}); peak {step['peak_gib']:.2f} / "
          f"{biggs['peak_gib']:.2f} / {lin['RL-20']['peak_gib']:.2f} / "
          f"{lin['Biggs RL-10']['peak_gib']:.2f} GiB", flush=True)
    print(f"[5] {card}: zy_pallas RL-20 {zyp['ms']:.1f} ms, {zyp['gvox_s']:.4f} GVox/s (plain "
          f"f32 {zyp['plain_ms']:.1f} ms), rel err {zyp['rel_err']:.3e}, peak "
          f"{zyp['peak_gib']:.2f} GiB; its Biggs RL-10 {zyp['biggs']['ms']:.1f} ms, max rel err "
          f"{zyp['biggs']['rel_err']:.3e}, peak {zyp['biggs']['peak_gib']:.2f} GiB; matmul RL-20 "
          f"{mmp['ms']:.1f} ms, {mmp['gvox_s']:.4f} GVox/s, rel err {mmp['rel_err']:.3e}, peak "
          f"{mmp['peak_gib']:.2f} GiB; convzy_circular {czy['ms']:.3f} ms (before the march "
          f"{czy.get('ms_parent', 'not timed')}, two passes {czy['ms_two_pass']:.3f}, plain "
          f"{czy['plain_ms']:.3f}); circular x pass {xcirc['ms']:.3f} ms (plain "
          f"{xcirc['plain_ms']:.3f}, bound {xcirc['bound_ms']:.3f} by {xcirc['bound_by']}); "
          f"conv3_circular {c3['ms']:.3f} ms (plain "
          f"{c3['plain_ms']:.3f})", flush=True)
    print(f"[5] {card}: fused_iter RL-20 {fip['ms']:.1f} ms, {fip['gvox_s']:.4f} GVox/s (fused "
          f"{step['ms']:.1f} ms; plain f32 {fip['plain_ms']:.1f} ms), rel err {fip['rel_err']:.3e}, "
          f"peak {fip['peak_gib']:.2f} GiB (fused {step['peak_gib']:.2f}); its Biggs RL-10 "
          f"{fip['biggs']['ms']:.1f} ms, max rel err {fip['biggs']['rel_err']:.3e}, peak "
          f"{fip['biggs']['peak_gib']:.2f} GiB; through richardson_lucy "
          f"{fip['biggs']['peak_rl_gib']:.2f} GiB, with donate_input "
          f"{fip['biggs']['peak_rl_donated_gib']:.2f} GiB; rl_iter {it['ms']:.3f} ms (before the "
          f"redesign {it.get('ms_parent', 'not timed')}, plain {it['plain_ms']:.3f}, bound "
          f"{it['bound_ms']:.3f} by {it['bound_by']}, of its own FMAs "
          f"{it['bound_ms_kernel_fmas']:.3f}); split-dot "
          f"errors vs float64 {p_dot['errors']}; probes alone: slice {p_slice['ms']:.4f} ms "
          f"(floor {p_slice['floor_ms']:.4f}), largest block {p_smem['ms']:.4f} ms (floor "
          f"{p_smem['floor_ms']:.4f}, one SM's bound {p_smem['bound_ms_smem']:.4f}), five "
          f"products {p_dot['ms']:.4f} ms (before {p_dot.get('ms_parent', 'not timed')}), fma "
          f"{p_dot['fma_ms']:.4f} ms beside torch.matmul {p_dot['fma_library_ms']:.4f}",
          flush=True)
    print(f"[5] {card}: deskew + register + RL-20 {sreg['ms']:.1f} ms, {sreg['gvox_s']:.4f} GVox/s "
          f"(without the registration {step['ms']:.1f} ms; plain f32 {sreg['plain_ms']:.1f} ms), "
          f"rel err {sreg['rel_err']:.3e}, peak {sreg['peak_gib']:.2f} GiB (without "
          f"{step['peak_gib']:.2f}); affine_warp {aff['ms']:.3f} ms (bound {aff['bound_ms']:.3f}, "
          f"plain {aff['plain_ms']:.3f}, F.grid_sample {aff['library_ms']:.3f}; "
          + ", ".join(f"{k} {v['ms']:.3f}" for k, v in aff["maps"].items())
          + f"); refine sums {rsums['ms']:.3f} ms, gradient {rgrad['ms']:.3f} ms (before "
          f"{rgrad.get('ms_parent', 'not timed')}; bounds {rsums['bound_ms']:.3f} by voxels, "
          f"{rsums['bound_ms_sectors']:.3f} by sectors); estimate "
          f"{reg['first_s']:.3f} s first, {reg['warm_s']:.3f} s warm, refine step "
          f"{reg['step_ms']:.3f} ms in it, {reg['step_ms_alone']:.3f} alone (before "
          f"{reg.get('step_ms_parent', 'not timed')}), offset error "
          f"{reg['offset_err_px']:.4f} px, peak "
          f"{reg['peak_gib']:.2f} GiB", flush=True)
    print(f"[5] {card}: RL-20 fft2z (config 6) {nonsep['ms']:.1f} ms, {nonsep['gvox_s']:.4f} "
          f"GVox/s, rel err {nonsep['rel_err']:.3e}, peak {nonsep['peak_gib']:.2f} GiB; fft3 "
          f"{nonsep['fft3_ms']:.1f} ms, peak {nonsep['fft3_peak_gib']:.2f} GiB; hybrid config 8 "
          f"{hyb8['ms']:.1f} ms (warm {hyb8['warm_ms']:.1f} on {hyb8['warm_backend']}, K "
          f"{hyb8['k']}, tail {hyb8['tail_ms']:.1f}), rel err {hyb8['rel_err']:.3e}, peak "
          f"{hyb8['peak_gib']:.2f} GiB; config 9 {hyb9['ms']:.1f} ms (warm "
          f"{hyb9['warm_ms']:.1f}, tail {hyb9['tail_ms']:.1f}), max rel err "
          f"{hyb9['rel_err']:.3e}, peak {hyb9['peak_gib']:.2f} GiB; band {band['ms']:.3f} ms "
          f"(corr {band['ms_corr']:.3f}, bound {band['bound_ms']:.3f}, plain "
          f"{band['plain_ms']:.3f}, einsum {band['library_ms']}); phase {ph['shape']}: host TF "
          f"{ph['tf_s']:.2f} s, inverse {ph['ms']:.3f} ms, rel err {ph['rel_err']:.3e}, peak "
          f"{ph['peak_gib']:.2f} GiB; the FFT phases took {fft_s:.1f} s", flush=True)
    print(f"[5] {card}: tracking at raw {RAW_SHAPE} (deskewed {deskewed_shape()}), warm update "
          "ms from the card / from a host numpy stack: "
          + ", ".join(f"{m} {v['warm_ms']:.1f} / {v['host_ms']:.1f}" for m, v in
                      trk["methods"].items())
          + f"; blur {trk['ops']['blur_ms']:.3f} ms, multi-Otsu {trk['ops']['multi_otsu_ms']:.3f}, "
          f"NCC {trk['ops']['ncc_ms']:.3f}, PCC {trk['ops']['pcc_ms']:.3f}; label-free pcc at "
          f"{trk['lf']['shape']} {trk['lf']['warm_ms']:.1f} ms warm, {trk['lf']['first_ms']:.1f} "
          f"first; focus {trk['lf']['focus_ms']:.3f} ms; phase 4m took {trk['seconds']:.1f} s",
          flush=True)
    print(f"[5] {card}: virtual staining at {vs['unet25d']['shape']}: unet25d VS "
          f"{vs['unet25d']['vs_ms']:.1f} ms warm (bound {vs['unet25d']['bound_ms']:.1f}), "
          f"{vs['unet25d']['first_vs_ms']:.1f} first, update {vs['unet25d']['update_ms']:.1f} ms, "
          f"peak {vs['unet25d']['peak_gib']:.2f} GiB at batch {vs['unet25d']['batch']}, rel err "
          f"{vs['unet25d']['rel_err']:.3e}; "
          + ", ".join(f"{k} {v['ms']:.1f} ms (bound {v['bound_ms']:.1f}), peak "
                      f"{v['peak_gib']:.2f} GiB, rel err {v['rel_err']:.3e}"
                      for k, v in vs["unext2"].items())
          + f"; chain {vs['chain']['ms']:.1f} ms, rel err {vs['chain']['rel_err']:.3e}; phase 4n "
          f"took {vs['seconds']:.1f} s", flush=True)
    kernels = [
        {"name": "deskew", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/deskew.cu",
         "replaces": "shrimpy_tpu/ops/deskew_pallas.py:293",
         "launches": step["launches"]["deskew"], **desk},
        {"name": "rl_half_step", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_half.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": step["launches"]["rl_half_one_launch"], **rl},
        {"name": "rl_half_step_accel", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_half.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": biggs["launches"]["rl_half_one_launch"], **accel},
        {"name": "rl_half_step_three_pass", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_fused.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": three["rl_half_step"] + three["rl_half_step_accel"], **rl3},
        {"name": "convzy_linear", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/convzy.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:356",
         "launches": lin["RL-20"]["launches"]["convzy_march"], **zy},
        {"name": "convzy_circular", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/convzy.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:175",
         "launches": zyp["launches"]["convzy_march"], **czy,
         "x_pass_max_abs_err": xcirc["max_abs_err"], "x_pass_ms": xcirc["ms"],
         "x_pass_plain_ms": xcirc["plain_ms"], "x_pass_bound_ms": xcirc["bound_ms"],
         "x_pass_bound_by": xcirc["bound_by"]},
        {"name": "convzy_two_pass", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_fused.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:356",
         "launches": routes["launches"], "max_abs_err": 0.0, "ms": zy["ms_two_pass"],
         "ms_circular": czy["ms_two_pass"],
         **{k: zy[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "conv3_circular", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_half.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:104", **c3},
        {"name": "rl_iter", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/rl_iter.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused_iter.py:246",
         "launches": fip["launches"]["rl_iter"], **it},
        {"name": "affine_warp", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/affine.cu",
         "replaces": "shrimpy_tpu/ops/register.py:472 (XLA, no TPU kernel)",
         "launches": sreg["launches"]["affine_warp"], **aff},
        {"name": "affine_refine_sums", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/affine.cu",
         "replaces": "shrimpy_tpu/ops/register.py:609 (XLA, no TPU kernel)",
         "launches": reg["launches"]["refine_sums"], **rsums},
        {"name": "affine_refine_grad", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/affine.cu",
         "replaces": "shrimpy_tpu/ops/register.py:609 (XLA, no TPU kernel)",
         "launches": reg["launches"]["refine_grad"], **rgrad},
        {"name": "probe_smem_slice", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/probe_mosaic.py:22", **p_slice},
        {"name": "probe_smem", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/probe_mosaic.py:47", **p_smem},
        {"name": "probe_split_dot", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/probe_mosaic.py:65", **p_dot},
        {"name": "zband", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/zband.cu",
         "replaces": "shrimpy_tpu/ops/deconv.py:445 (XLA band of _rl_fft2z_jit :340, no TPU "
                     "kernel)",
         "launches": nonsep["launches"]["zband"], **band},
    ]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for entry in kernels:
        if keys - set(entry) or not entry["launches"] > 0:
            raise AssertionError(f"kernel entry {entry.get('name')}: missing "
                                 f"{sorted(keys - set(entry))} or never launched")
    print(f"[5] chip_smoke.py total {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

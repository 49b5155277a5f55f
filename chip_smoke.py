"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the repository's ``shrimpy_tpu_torch`` package,
imports no jax and none of pydantic, tensorstore, click or yaml, and
exits non-zero without printing a result when any of these is missing
or any check fails. Phases:

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build every kernel from ``shrimpy_tpu_torch/csrc`` with nvcc (seconds);
3. each kernel against its plain PyTorch version on the card, on the
   same inputs: the deskew at the production raw (1201, 256, 1600) and
   at (300, 512, 512) with ``keep_overhang`` and ``average_n_slices=3``;
   the RL half-step in ``ratio``, ``mult`` and ``plain`` modes on the
   production carry (136, 2908, 1620) and on a smaller carry with a
   2-term PSF. Tolerance: max|a-b| / max|b| <= 1e-4 (float32 sums taken
   in another order);
4. the main path through ``build_reconstruct_step`` — deskew, then
   RL-20 with the (9, 21, 21) PSF — on a (1, 1201, 256, 1600) batch from
   a fixed seed, with the kernels' launch counters reset just before and
   read just after; the result against the same step on the plain
   versions in float64 on the card, within the BASELINE budget
   max|a-b| / max|b| <= 1e-3;
5. timings (kernel path and plain float32 path, warm, alternated plain,
   kernel, kernel, plain), launch counts, peak memory, then the kernel
   JSON line, the card line and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

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
KERNEL_RTOL = 1e-4
STEP_RTOL = 1e-3  # BASELINE.md parity budget


def headline_settings():
    """bench.py::_run_headline's ReconstructSettings, as a namespace."""
    from shrimpy_tpu_torch.config import (
        deconvolve_settings,
        deskew_settings,
        reconstruct_settings,
    )

    return reconstruct_settings(
        deskew=deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386),
        deconvolve=deconvolve_settings(iterations=ITERATIONS),
    )


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a64, b64 = a.double(), b.double()
    return float((a64 - b64).abs().max() / b64.abs().max().clamp_min(1e-30))


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
    return float((a.double() - b.double()).abs().max())


def uniform(shape, gen, lo=0.0, hi=1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


def phase_deskew(gen) -> dict:
    from shrimpy_tpu_torch.config import deskew_settings
    from shrimpy_tpu_torch.ops.deskew import deskew_plain
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda

    prod = headline_settings().deskew
    raw = uniform(RAW_SHAPE, gen, 0.0, 100.0)
    err = compare("deskew (1201, 256, 1600)", deskew_cuda(raw, prod),
                  deskew_plain(raw, prod), KERNEL_RTOL)
    ms = gpu_ms(lambda: deskew_cuda(raw, prod), 20)
    plain_ms = gpu_ms(lambda: deskew_plain(raw, prod), 3)
    del raw
    over = deskew_settings(px_to_scan_ratio=0.386, keep_overhang=True, average_n_slices=3)
    raw2 = uniform((300, 512, 512), gen, 0.0, 100.0)
    compare("deskew (300, 512, 512) keep_overhang avg3", deskew_cuda(raw2, over),
            deskew_plain(raw2, over), KERNEL_RTOL)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_rl(gen) -> dict:
    import numpy as np

    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf
    from shrimpy_tpu_torch.ops.rl_fused import Stencil, half_step_cuda, half_step_plain

    deconv = headline_settings().deconvolve
    psf_np = prepare_psf(gaussian_psf(PSF_SHAPE, PSF_SIGMA), deconv)
    terms = plan_terms(psf_np, deconv)
    radii = tuple(k // 2 for k in psf_np.shape)
    print(f"  PSF {psf_np.shape}: {len(terms)} separable term(s), radii {radii}")

    eps = deconv.epsilon

    def modes(shape, terms, label):
        """All three modes, kernel against plain; the ratio error back."""
        conv = Stencil(terms, device="cuda")
        adj = Stencil(terms, flip=True, device="cuda")
        inp = uniform(shape, gen, 0.5, 10.5)
        aux = uniform(shape, gen, 0.0, 5.0)
        errs = {
            mode: compare(f"rl half-step {mode} {label}",
                          half_step_cuda(inp, aux, st, mode, eps),
                          half_step_plain(inp, aux, st, mode, eps), KERNEL_RTOL)
            for mode, st in (("ratio", conv), ("mult", adj), ("plain", conv))
        }
        return errs["ratio"], conv, inp, aux

    carry = tuple(n + 2 * r for n, r in zip((128, 2888, 1600), radii))
    err, conv, inp, aux = modes(carry, terms, f"{carry}")
    out = torch.empty_like(inp)
    scratch = [torch.empty_like(inp) for _ in range(2)]
    ms = gpu_ms(lambda: half_step_cuda(inp, aux, conv, "ratio", eps, out=out, scratch=scratch), 10)
    plain_ms = gpu_ms(lambda: half_step_plain(inp, aux, conv, "ratio", eps), 2)
    del inp, aux, out, scratch

    # A 2-term PSF with asymmetric taps of unequal radii per axis.
    rng = np.random.default_rng(SEED)
    two = [tuple(rng.random(k).astype(np.float32) for k in (7, 11, 13)) for _ in range(2)]
    modes((40, 300, 400), two, "(40, 300, 400) 2 terms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_step(gen) -> dict:
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda
    from shrimpy_tpu_torch.ops.rl_fused import half_step_cuda
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step, output_shape

    settings = headline_settings()
    psf = gaussian_psf(PSF_SHAPE, PSF_SIGMA)
    batch = uniform((1, *RAW_SHAPE), gen, 0.0, 100.0)
    step = build_reconstruct_step(settings, psf=psf, device="cuda")
    plain32 = build_reconstruct_step(settings, psf=psf, device="cuda", plain=True)
    out_zyx = output_shape(RAW_SHAPE, settings)
    vox = math.prod(out_zyx)

    # The main path: counters reset just before, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    deskew_cuda.launches = 0
    half_step_cuda.launches = 0
    out = step(batch)
    torch.cuda.synchronize()
    launches = {"deskew": deskew_cuda.launches, "rl_half_step": half_step_cuda.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  main path launches: {launches}; peak allocated {peak_gib:.2f} GiB")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if tuple(out.shape) != (1, *out_zyx) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, want (1, {out_zyx})")

    ref = build_reconstruct_step(settings, psf=psf, device="cuda", plain=True,
                                 dtype=torch.float64)(batch)
    compare("whole step (deskew + RL-20) vs float64 plain", out, ref, STEP_RTOL)
    del ref

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain32(batch)  # warm
    plain_s, kernel_s = [], []
    for fn, acc in ((plain32, plain_s), (step, kernel_s), (step, kernel_s), (plain32, plain_s)):
        acc.append(wall(fn))
    k, p = sum(kernel_s) / 2, sum(plain_s) / 2
    print(f"  kernel path: {k * 1e3:.1f} ms/volume, {vox / k / 1e9:.4f} GVox/s  {kernel_s}")
    print(f"  plain f32 path: {p * 1e3:.1f} ms/volume, {vox / p / 1e9:.4f} GVox/s  {plain_s}")
    return {"launches": launches, "gvox_s": vox / k / 1e9, "plain_gvox_s": vox / p / 1e9,
            "peak_gib": peak_gib}


def main() -> int:
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
    build.load_library()
    print(f"[2] kernels built from {build.CSRC_DIR.name}/ and loaded in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("[3] kernels against their plain versions", flush=True)
    desk = phase_deskew(gen)
    rl = phase_rl(gen)
    torch.cuda.empty_cache()
    print("[4] main path: deskew + RL-20 at raw (1201, 256, 1600)", flush=True)
    step = phase_step(gen)
    print(f"[5] {card}: kernel path {step['gvox_s']:.4f} GVox/s, plain f32 path "
          f"{step['plain_gvox_s']:.4f} GVox/s; deskew kernel {desk['ms']:.3f} ms "
          f"(plain {desk['plain_ms']:.3f}); RL half-step kernel {rl['ms']:.3f} ms "
          f"(plain {rl['plain_ms']:.3f}); peak {step['peak_gib']:.2f} GiB", flush=True)
    kernels = [
        {"name": "deskew", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/deskew.cu",
         "replaces": "shrimpy_tpu/ops/deskew_pallas.py:293",
         "launches": step["launches"]["deskew"], **desk},
        {"name": "rl_half_step", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_fused.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": step["launches"]["rl_half_step"], **rl},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

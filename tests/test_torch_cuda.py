"""The port's CUDA kernels against their plain PyTorch versions (GPU).

Marked ``cuda``: each test skips unless a CUDA card is visible (decided
in the ``cuda`` fixture, never at import). This file imports neither
jax nor the JAX package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports jax.)
Tolerances: relative error ``max|a-b| / max|b|`` <= 1e-5 for one kernel
launch against its plain version (float32 sums taken in another order),
1e-4 for whole RL runs against the float64 plain path.
"""

import numpy as np
import pytest
import torch

from shrimpy_tpu_torch.config import (
    deconvolve_settings,
    deskew_settings,
    reconstruct_settings,
)
from shrimpy_tpu_torch.ops.deconv import gaussian_psf, richardson_lucy
from shrimpy_tpu_torch.ops.deskew import deskew_plain, deskew_volume
from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda
from shrimpy_tpu_torch.ops.rl_fused import Stencil, half_step, half_step_cuda, half_step_plain
from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step
from shrimpy_tpu_torch.runtime.feed import DeviceFeed
from shrimpy_tpu_torch.utils.timing import StageTimer

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _rand(shape, seed, device, lo=0.0, hi=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.random(shape) * (hi - lo) + lo).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape,keep_overhang,avg,angle", [
    ((40, 32, 24), False, 1, 30.0),
    ((40, 32, 24), True, 1, 30.0),
    ((41, 30, 130), True, 3, 30.0),
    ((40, 32, 16), False, 4, 45.0),
    ((180, 64, 64), True, 1, 30.0),
    ((180, 64, 64), False, 2, 60.0),
])
def test_deskew_kernel_matches_plain(cuda, shape, keep_overhang, avg, angle):
    s = deskew_settings(ls_angle_deg=angle, px_to_scan_ratio=0.386,
                        keep_overhang=keep_overhang, average_n_slices=avg)
    raw = _rand(shape, 1, cuda, 0.0, 100.0)
    before = deskew_cuda.launches
    out = deskew_volume(raw, s)
    torch.cuda.synchronize()
    assert deskew_cuda.launches == before + 1
    ref = deskew_plain(raw, s)
    assert out.shape == ref.shape and out.is_cuda
    assert _rel(out, ref) <= 1e-5


def _asym_terms(n_terms, lengths, seed):
    rng = np.random.default_rng(seed)
    return [tuple(rng.random(k).astype(np.float32) + 0.1 for k in lengths)
            for _ in range(n_terms)]


@pytest.mark.parametrize("mode", ["ratio", "mult", "plain"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("n_terms,lengths,shape", [
    (1, (9, 21, 21), (20, 150, 170)),
    (2, (7, 11, 13), (70, 41, 37)),
    (3, (1, 3, 5), (5, 6, 300)),
])
def test_half_step_kernel_matches_plain(cuda, mode, flip, n_terms, lengths, shape):
    terms = _asym_terms(n_terms, lengths, seed=n_terms)
    st = Stencil(terms, flip=flip, device=cuda)
    inp = _rand(shape, 2, cuda, 0.5, 10.5)
    aux = _rand(shape, 3, cuda, 0.0, 5.0)
    out = half_step(inp, aux, st, mode, 1e-6)
    torch.cuda.synchronize()
    assert _rel(out, half_step_plain(inp, aux, st, mode, 1e-6)) <= 1e-5


def test_half_step_in_place_mult_and_scratch_reuse(cuda):
    terms = _asym_terms(2, (5, 9, 9), seed=4)
    st = Stencil(terms, flip=True, device=cuda)
    inp = _rand((16, 40, 50), 5, cuda, 0.5, 2.0)
    est = _rand((16, 40, 50), 6, cuda, 0.5, 2.0)
    want = half_step_plain(inp, est, st, "mult")
    scratch = [torch.empty_like(inp) for _ in range(3)]
    got = half_step_cuda(inp, est, st, "mult", out=est, scratch=scratch)
    torch.cuda.synchronize()
    assert got.data_ptr() == est.data_ptr()
    assert _rel(est, want) <= 1e-5
    with pytest.raises(ValueError, match="alias"):
        half_step_cuda(inp, est, st, "mult", out=inp, scratch=scratch)
    with pytest.raises(ValueError, match="scratch"):
        half_step_cuda(inp, est, st, "mult", scratch=scratch[:2])


def test_kernel_wrappers_refuse_what_they_cannot_take(cuda):
    st = Stencil(_asym_terms(1, (5, 5, 5), 0), device=cuda)
    v64 = torch.ones((6, 20, 20), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        half_step_cuda(v64, v64, st, "ratio")
    with pytest.raises(ValueError, match="float32"):
        deskew_cuda(v64, deskew_settings(px_to_scan_ratio=0.386))
    big = Stencil(_asym_terms(1, (901, 3, 3), 0), device=cuda)
    v = torch.ones((6, 20, 20), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        half_step_cuda(v, v, big, "ratio")


@pytest.mark.parametrize("pad_mode", ["reflect", "edge", "constant"])
def test_rl_kernel_path_matches_float64_plain(cuda, pad_mode):
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _rand((12, 60, 70), 7, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=5, pad_mode=pad_mode)
    before = half_step_cuda.launches
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    assert half_step_cuda.launches == before + 10
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    assert _rel(out, ref) <= 1e-4


def test_step_on_cuda_matches_cpu(cuda):
    settings = reconstruct_settings(
        deskew=deskew_settings(px_to_scan_ratio=0.386),
        deconvolve=deconvolve_settings(iterations=3),
    )
    psf = gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    raw = (np.random.default_rng(9).random((2, 60, 24, 40)) * 100).astype(np.float32)
    gpu = build_reconstruct_step(settings, psf=psf, device=cuda)(raw)
    cpu = build_reconstruct_step(settings, psf=psf, device="cpu")(raw)
    assert gpu.is_cuda and gpu.shape == cpu.shape
    assert _rel(gpu.cpu(), cpu) <= 1e-4


def test_device_feed_round_trip_on_cuda(cuda):
    """The streaming loop's order: each batch's D2H starts inside the
    timed compute stage and is collected one batch later."""
    feed = DeviceFeed(cuda, (2, 8, 9, 10))
    timer = StageTimer()
    handles = []
    for i in range(3):
        batch = np.full((2, 8, 9, 10), float(i), np.float32)
        with timer.stage("h2d", log=False):
            dev = feed.to_device(batch)
        assert dev.is_cuda
        with timer.stage("compute", log=False):
            handles.append(feed.start_to_host(dev * 2 + 1))
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(feed.collect(h), np.full((2, 8, 9, 10), 2.0 * i + 1))
    assert len(timer.records) == 6

"""The port's CUDA kernels against their plain PyTorch versions (GPU).

Marked ``cuda``: each test skips unless a CUDA card is visible (decided
in the ``cuda`` fixture, never at import). This file imports neither
jax nor the JAX package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports jax.)
Tolerances: relative error ``max|a-b| / max|b|`` <= 1e-5 for one kernel
launch against its plain version (float32 sums taken in another order),
1e-4 for whole RL runs against the float64 plain path. The bf16 Biggs
state agrees within one bf16 ulp, the step-length sums within 1e-5;
Biggs runs against the float64 plain path pass the two-tier gate of
``tests/test_rl_fused.py:244-245`` (an eps clamp may flip at isolated
voxels): 99.99 % of voxels within 5e-4 of the scale, all within 2e-2.
"""

import numpy as np
import pytest
import torch

from shrimpy_tpu_torch.config import (
    deconvolve_settings,
    deskew_settings,
    reconstruct_settings,
)
from shrimpy_tpu_torch.ops.conv3_cuda import (
    CONVZY_TILES,
    conv3_circular,
    conv3_circular_cuda,
    conv3_circular_plain,
    conv3_circular_route,
    conv3_half_step,
    conv3_half_step_cuda,
    conv3_half_step_plain,
    conv3_one_launch,
    convzy_circular,
    convzy_circular_cuda,
    convzy_circular_plain,
    convzy_linear,
    convzy_linear_cuda,
    convzy_linear_plain,
    convzy_march,
    convzy_route,
    convzy_smem_bytes,
    convzy_two_pass,
    x_circulant_plain,
    x_toeplitz_plain,
    zy_taps,
)
from shrimpy_tpu_torch.io.synthetic import tilted_gaussian_psf
from shrimpy_tpu_torch.ops.deconv import gaussian_psf, richardson_lucy
from shrimpy_tpu_torch.ops.deskew import deskew_plain, deskew_volume
from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda
from shrimpy_tpu_torch.ops.rl_fused import (
    HALF_TILES,
    Stencil,
    _conv_axis_circular_plain,
    _conv_axis_plain,
    _epilogue,
    axis_pass_cuda,
    axis_pass_route,
    conv_axis_cuda,
    conv_x_cuda,
    extrapolate,
    half_layout,
    half_smem_bytes,
    half_step,
    half_step_cuda,
    half_step_one_launch,
    half_step_plain,
    half_step_route,
    half_step_three_pass,
    x_pass_accel_cuda,
    x_pass_cuda,
    x_pass_route,
    x_pass_smem_bytes,
    x_piece,
)
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


# (raw shape, keep_overhang, average_n_slices, angle, px_to_scan_ratio,
# offset in floats of raw in its storage): the JAX tests' geometries, then
# the tile edges of csrc/deskew.cu: x extents of 1, 13 and 130 (the last
# two no multiple of 4: the cp.async path), a y extent no tile divides, a
# scan extent shorter than a band (the TMA box reaches past raw), a ratio
# of 1.5, a partial tail group of 4, a raw 4 bytes into its storage.
DESKEW_CASES = [
    ((40, 32, 24), False, 1, 30.0, 0.386, 0),
    ((40, 32, 24), True, 1, 30.0, 0.386, 0),
    ((41, 30, 130), True, 3, 30.0, 0.386, 0),
    ((40, 32, 16), False, 4, 45.0, 0.386, 0),
    ((180, 64, 64), True, 1, 30.0, 0.386, 0),
    ((180, 64, 64), False, 2, 60.0, 0.386, 0),
    ((40, 32, 1), True, 1, 30.0, 0.386, 0),
    ((40, 32, 13), False, 1, 30.0, 0.386, 0),
    ((40, 32, 130), False, 1, 30.0, 0.386, 0),
    ((200, 64, 256), False, 1, 30.0, 0.386, 0),
    ((6, 32, 24), True, 1, 30.0, 0.386, 0),
    ((3, 64, 32), True, 2, 30.0, 0.386, 0),
    ((60, 16, 24), True, 1, 30.0, 1.5, 0),
    ((41, 27, 64), True, 4, 30.0, 0.386, 0),
    ((40, 32, 24), True, 1, 30.0, 0.386, 1),
    ((40, 32, 16), False, 3, 30.0, 0.386, 1),
]


def _raw(shape, seed, device, off=0):
    """A random raw volume whose first element lies ``off`` floats into its storage."""
    n = int(np.prod(shape))
    return _rand((n + off,), seed, device, 0.0, 100.0)[off:].view(shape)


@pytest.mark.parametrize("shape,keep_overhang,avg,angle,ratio,off", DESKEW_CASES)
def test_deskew_kernel_matches_plain(cuda, shape, keep_overhang, avg, angle, ratio, off):
    s = deskew_settings(ls_angle_deg=angle, px_to_scan_ratio=ratio,
                        keep_overhang=keep_overhang, average_n_slices=avg)
    raw = _raw(shape, 1, cuda, off)
    assert (raw.data_ptr() % 16 == 0) == (off == 0)
    before = deskew_cuda.launches
    out = deskew_volume(raw, s)
    torch.cuda.synchronize()
    assert deskew_cuda.launches == before + 1
    ref = deskew_plain(raw, s)
    assert out.shape == ref.shape and out.is_cuda
    assert _rel(out, ref) <= 1e-5


def _deskew_on_tile(raw, settings, tile):
    """``csrc/deskew.cu`` launched on a forced ``tile``: the arguments
    ``deskew_cuda`` passes, from ``device_plan`` and ``deskew_layout``
    (which raises where the tile does not fit)."""
    from shrimpy_tpu_torch.kernels.build import check, load_library
    from shrimpy_tpu_torch.ops.deskew_cuda import TABLE_KEYS, deskew_layout, device_plan

    tab = device_plan(raw, settings)
    layout = deskew_layout(raw.shape, tab, tile=tile)
    out = torch.empty((tab["n_groups"], tab["ny"], raw.shape[2]), device=raw.device)
    vec = raw.shape[2] % 4 == 0 and raw.data_ptr() % 16 == 0
    check(load_library().shrimpy_deskew(
        raw.data_ptr(), out.data_ptr(), *(tab["dev"][k].data_ptr() for k in TABLE_KEYS),
        *raw.shape, tab["nz"], tab["ny"], tab["n_groups"], tab["a_avg"], *layout["tile"],
        layout["rows"], int(vec), torch.cuda.current_stream(raw.device).cuda_stream),
        "shrimpy_deskew")
    return out


@pytest.mark.parametrize("tile", [(64, 256), (32, 256), (16, 128), (8, 64), (1, 256), (48, 4),
                                  (13, 12)])
@pytest.mark.parametrize("shape,off", [((200, 64, 256), 0), ((200, 64, 250), 0),
                                       ((200, 64, 256), 1)])
def test_deskew_kernel_on_every_tile(cuda, shape, off, tile):
    """Every tile gives the chosen tile's bits: the same sums in the same
    order, whatever band and rows a thread takes."""
    s = deskew_settings(px_to_scan_ratio=0.386, keep_overhang=True, average_n_slices=3)
    raw = _raw(shape, 2, cuda, off)
    want = deskew_cuda(raw, s)
    got = _deskew_on_tile(raw, s, tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _rel(got, deskew_plain(raw, s)) <= 1e-5


@pytest.mark.parametrize("shape,keep_overhang", [((410000, 4, 8), False), ((410000, 2, 8), True)])
def test_deskew_past_the_old_launch_grid(cuda, shape, keep_overhang):
    """Outputs of (2, 1062171, 8) and (2, 1062176, 8): more rows than the
    kernel before the redesign took in one launch's grid (65535 x 16),
    which raised; the persistent grid walks them."""
    s = deskew_settings(px_to_scan_ratio=0.386, keep_overhang=keep_overhang)
    raw = _raw(shape, 3, cuda)
    out = deskew_cuda(raw, s)
    torch.cuda.synchronize()
    ref = deskew_plain(raw, s)
    assert out.shape == ref.shape and out.shape[1] > 65535 * 16
    assert _rel(out, ref) <= 1e-5


def test_deskew_shared_memory_sum_is_the_kernels(cuda):
    from shrimpy_tpu_torch.kernels.build import load_library
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_smem_bytes

    lib = load_library()
    for rows, planes, tx, ty in ((27, 2, 256, 64), (1, 1, 4, 3), (200, 2, 8, 512),
                                 (256, 2, 256, 1), (14, 2, 256, 32)):
        assert lib.shrimpy_deskew_smem(rows, planes, tx, ty) == deskew_smem_bytes(rows, planes,
                                                                                tx, ty)


def test_deskew_kernel_refuses_a_tile_that_does_not_fit(cuda):
    s = deskew_settings(px_to_scan_ratio=0.386)
    raw = _raw((200, 64, 256), 4, cuda)
    for tile in ((128, 256), (64, 260), (64, 6), (1024, 64)):
        with pytest.raises(ValueError, match="does not fit"):
            _deskew_on_tile(raw, s, tile)


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
    # The scratch carries are the three-pass route's.
    for step, kw in ((half_step_one_launch, {}), (half_step_three_pass, {"scratch": scratch}),
                     (half_step_cuda, {"scratch": scratch})):
        x = est.clone()
        got = step(inp, x, st, "mult", out=x, **kw)
        torch.cuda.synchronize()
        assert got.data_ptr() == x.data_ptr()
        assert _rel(x, want) <= 1e-5
        with pytest.raises(ValueError, match="alias"):
            step(inp, est, st, "mult", out=inp, **kw)
    with pytest.raises(ValueError, match="scratch"):
        half_step_three_pass(inp, est, st, "mult", scratch=scratch[:2])


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


# (n_terms, PSF lengths, grid) for the one-launch half-step kernel: the
# production PSF on a grid whose x rows take 16-byte copies and on one
# that does not; two asymmetric terms; grids smaller than a tile on every
# axis with z < 2 rz + 1; odd radii; a z list longer than the planes a
# thread keeps in registers; a 1 x 1 x 1 PSF.
HALF_CASES = [
    (1, (9, 21, 21), (20, 100, 132)),
    (1, (9, 21, 21), (5, 37, 45)),
    (2, (7, 11, 13), (40, 70, 136)),
    (2, (7, 11, 13), (7, 70, 33)),
    (1, (9, 21, 21), (3, 9, 40)),
    (3, (7, 19, 23), (9, 50, 68)),
    (1, (21, 5, 7), (30, 40, 52)),
    (1, (1, 1, 1), (4, 9, 13)),
]


def _half_all_modes(step, shape, st, adj, seed, device, **route):
    """Every mode of the half-step ``step`` on one set of operands, as a
    dict of the tensors each writes; ``mult`` runs in place."""
    inp = _rand(shape, seed, device, 0.5, 10.5)
    aux = _rand(shape, seed + 1, device, 0.0, 5.0)
    dx, gp, alpha = _accel_operands(shape, seed + 2, device)
    ops = (inp, aux, dx, gp, alpha)
    out = {}
    for mode, s in (("plain", st), ("ratio", st)):
        out[mode] = step(inp, aux, s, mode, 1e-6, **route)
    x = aux.clone()
    assert step(inp, x, adj, "mult", 1e-6, out=x, **route).data_ptr() == x.data_ptr()
    out["mult"] = x
    out["ratio_accel"] = step(inp, aux, st, "ratio_accel", 1e-6, dx=dx, alpha=alpha, **route)
    x, d, g = aux.clone(), dx.clone(), gp.clone()
    got = step(inp, x, adj, "mult_accel", 1e-6, dx=d, g_prev=g, alpha=alpha, **route)
    assert tuple(t.data_ptr() for t in got[:3]) == (x.data_ptr(), d.data_ptr(), g.data_ptr())
    out["mult_accel"] = got
    torch.cuda.synchronize()
    return ops, out


@pytest.mark.parametrize("tile", [None, (16, 32), (8, 32)])
@pytest.mark.parametrize("n_terms,lengths,shape", HALF_CASES)
def test_one_launch_half_step_matches_plain_bitwise(cuda, n_terms, lengths, shape, tile):
    """All five modes of ``csrc/rl_half.cu`` against ``half_step_plain``:
    the kernel sums each output's taps in the plain version's order, so
    float32 results are equal bit for bit on every tile (the bf16 state
    too); the two Biggs sums, added in another order, within 1e-5."""
    terms = _asym_terms(n_terms, lengths, seed=n_terms)
    st, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    assert half_step_route(shape, st.radii, n_terms) == "one_launch"
    before = (half_step_one_launch.launches, half_step_three_pass.launches)
    (inp, aux, dx, gp, alpha), got = _half_all_modes(half_step_one_launch, shape, st, adj, 20,
                                                    cuda, tile=tile)
    # One kernel launch a half-step, none on the other route.
    assert (half_step_one_launch.launches, half_step_three_pass.launches) == (
        before[0] + 5, before[1])
    for mode, s in (("plain", st), ("ratio", st), ("mult", adj)):
        want = half_step_plain(inp, aux, s, mode, 1e-6)
        torch.testing.assert_close(got[mode], want, rtol=0, atol=0, msg=mode)
    want = half_step_plain(inp, aux, st, "ratio_accel", 1e-6, dx=dx, alpha=alpha)
    torch.testing.assert_close(got["ratio_accel"], want, rtol=0, atol=0)
    want = half_step_plain(inp, aux, adj, "mult_accel", 1e-6, dx=dx, g_prev=gp, alpha=alpha)
    for k in range(3):
        torch.testing.assert_close(got["mult_accel"][k], want[k], rtol=0, atol=0)
    for k in (3, 4):
        assert got["mult_accel"][k].dtype == torch.float32 and got["mult_accel"][k].shape == ()
        assert abs(float(got["mult_accel"][k]) - float(want[k])) <= 1e-5 * abs(float(want[k]))


@pytest.mark.parametrize("n_terms,lengths,shape", HALF_CASES[:4])
def test_both_half_step_routes_give_the_same_bits(cuda, n_terms, lengths, shape):
    terms = _asym_terms(n_terms, lengths, seed=n_terms)
    st, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    before = (half_step_three_pass.launches, half_step_cuda.launches,
              half_step_cuda.accel_launches)
    _, one = _half_all_modes(half_step_cuda, shape, st, adj, 30, cuda)
    # The dispatch takes the one-launch route here and counts the half-steps.
    assert (half_step_three_pass.launches, half_step_cuda.launches,
            half_step_cuda.accel_launches) == (before[0], before[1] + 3, before[2] + 2)
    _, three = _half_all_modes(half_step_three_pass, shape, st, adj, 30, cuda)
    assert half_step_three_pass.launches == before[0] + 5 * 3 * n_terms
    for mode in ("plain", "ratio", "mult", "ratio_accel"):
        torch.testing.assert_close(one[mode], three[mode], rtol=0, atol=0, msg=mode)
    for k in range(3):
        torch.testing.assert_close(one["mult_accel"][k], three["mult_accel"][k], rtol=0, atol=0)


def test_one_launch_half_step_on_carries_that_are_not_16_byte_aligned(cuda):
    """gx % 4 == 0 but the carries start 4 bytes past a 16-byte boundary:
    the kernel takes its 4-byte copies, with the same bits."""
    shape, n = (6, 40, 64), 6 * 40 * 64
    terms = _asym_terms(1, (5, 9, 9), seed=3)
    st = Stencil(terms, device=cuda)
    inp, aux = _rand(shape, 40, cuda, 0.5, 10.5), _rand(shape, 41, cuda, 0.0, 5.0)
    want = half_step_one_launch(inp, aux, st, "ratio")

    def shifted(t):
        buf = torch.empty(n + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        return view

    got = half_step_one_launch(shifted(inp), shifted(aux), st, "ratio", out=shifted(aux))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_one_launch_half_step_refusals(cuda):
    st = Stencil(_asym_terms(1, (5, 9, 9), seed=4), device=cuda)
    shape = (8, 30, 40)
    inp, aux = _rand(shape, 50, cuda, 0.5, 2.0), _rand(shape, 51, cuda, 0.5, 2.0)
    dx, gp, alpha = _accel_operands(shape, 52, cuda)
    with pytest.raises(ValueError, match="alias"):
        half_step_one_launch(inp, aux, st, "mult", out=inp)
    with pytest.raises(ValueError, match="alias"):
        half_step_one_launch(inp, aux, st, "mult_accel", dx=dx, g_prev=dx, alpha=alpha)
    with pytest.raises(ValueError, match="mode"):
        half_step_one_launch(inp, aux, st, "divide")
    with pytest.raises(ValueError, match="does not fit"):
        half_step_one_launch(inp, aux, st, "ratio", tile=(128, 128))
    with pytest.raises(ValueError, match="partials"):
        half_step_one_launch(inp, aux, st, "mult_accel", dx=dx, g_prev=gp, alpha=alpha,
                             partials=torch.empty((2, shape[0] * shape[1]), device=cuda))
    big = Stencil(_asym_terms(1, (121, 9, 9), 0), device=cuda)   # past the block: three passes
    v = torch.ones((130, 20, 20), device=cuda)
    assert half_step_route(v.shape, big.radii) == "three_pass"
    with pytest.raises(ValueError, match="exceed the one-launch kernel"):
        half_step_one_launch(v, v, big, "ratio")
    before = half_step_three_pass.launches
    out = half_step_cuda(v, v, big, "ratio")
    torch.cuda.synchronize()
    assert half_step_three_pass.launches == before + 3
    assert _rel(out, half_step_plain(v, v, big, "ratio")) <= 1e-5


@pytest.mark.parametrize("n_terms", [1, 3])
@pytest.mark.parametrize("radii", [(4, 10, 10), (0, 0, 0), (3, 5, 6), (1, 20, 2), (3, 9, 11)])
def test_half_step_shared_memory_sum_is_the_kernels(cuda, radii, n_terms):
    from shrimpy_tpu_torch.kernels.build import load_library

    lengths = tuple(2 * r + 1 for r in radii)
    for tile in HALF_TILES + ((64, 32), (4, 8)):
        assert load_library().shrimpy_rl_half_smem(n_terms, *lengths, *tile) == half_smem_bytes(
            tile, radii, n_terms)
    layout = half_layout((40, 300, 400), radii, n_terms)
    assert layout is not None and layout["smem_bytes"] <= 232448


def _bf16_close(a, b) -> bool:
    """Equal, or within one bf16 ulp of ``b``."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= b.abs() * 2.0**-7 + 1e-30).all())


def _two_tier(out, ref) -> None:
    scale = float(ref.abs().max())
    diff = (out.double() - ref.double()).abs()
    assert float((diff <= 5e-4 * scale).double().mean()) >= 0.9999
    assert float(diff.max()) <= 2e-2 * scale


def _accel_operands(shape, seed, device):
    g = np.random.default_rng(seed)
    dx = torch.from_numpy(g.uniform(-1, 1, shape).astype(np.float32)).to(device, torch.bfloat16)
    gp = torch.from_numpy(g.uniform(0, 1, shape).astype(np.float32)).to(device, torch.bfloat16)
    return dx, gp, torch.tensor(0.6, device=device)


@pytest.mark.parametrize("n_terms,lengths,shape", [
    (1, (9, 21, 21), (20, 150, 170)),
    (2, (7, 11, 13), (37, 41, 67)),
])
def test_ratio_accel_kernel_matches_plain(cuda, n_terms, lengths, shape):
    st = Stencil(_asym_terms(n_terms, lengths, seed=n_terms), device=cuda)
    x = _rand(shape, 2, cuda, 0.0, 10.5)
    data = _rand(shape, 3, cuda, 0.0, 5.0)
    dx, _, alpha = _accel_operands(shape, 4, cuda)
    before = half_step_cuda.accel_launches
    out = half_step(x, data, st, "ratio_accel", 1e-6, dx=dx, alpha=alpha)
    torch.cuda.synchronize()
    assert half_step_cuda.accel_launches == before + 1
    ref = half_step_plain(x, data, st, "ratio_accel", 1e-6, dx=dx, alpha=alpha)
    assert _rel(out, ref) <= 1e-5


@pytest.mark.parametrize("n_terms,lengths,shape", [
    (1, (9, 21, 21), (20, 150, 170)),
    (2, (7, 11, 13), (37, 41, 67)),
])
def test_mult_accel_kernel_in_place_matches_plain(cuda, n_terms, lengths, shape):
    st = Stencil(_asym_terms(n_terms, lengths, seed=n_terms), flip=True, device=cuda)
    ratio = _rand(shape, 5, cuda, 0.5, 10.5)
    x = _rand(shape, 6, cuda, 0.0, 5.0)
    dx, gp, alpha = _accel_operands(shape, 7, cuda)
    want = half_step_plain(ratio, x, st, "mult_accel", dx=dx, g_prev=gp, alpha=alpha)
    ptrs = (x.data_ptr(), dx.data_ptr(), gp.data_ptr())
    got = half_step_cuda(ratio, x, st, "mult_accel", dx=dx, g_prev=gp, alpha=alpha)
    torch.cuda.synchronize()
    assert tuple(t.data_ptr() for t in got[:3]) == ptrs  # x, dx, g_prev updated in place
    assert _rel(x, want[0]) <= 1e-5
    assert _bf16_close(dx, want[1]) and _bf16_close(gp, want[2])
    for k in (3, 4):
        assert got[k].dtype == torch.float32 and got[k].shape == ()
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k]))
    with pytest.raises(ValueError, match="out must be aux"):
        half_step_cuda(ratio, x, st, "mult_accel", dx=dx, g_prev=gp, alpha=alpha,
                       out=torch.empty_like(x))
    with pytest.raises(ValueError, match="bfloat16"):
        half_step_cuda(ratio, x, st, "mult_accel", dx=dx.float(), g_prev=gp, alpha=alpha)


def test_accel_half_steps_at_alpha_zero_are_plain_bitwise(cuda):
    """The alpha-0 startup: ratio_accel/mult_accel with alpha = 0 give
    the plain modes' results bit for bit (x >= eps > 0)."""
    st = Stencil(_asym_terms(2, (5, 9, 9), seed=8), device=cuda)
    adj = Stencil(_asym_terms(2, (5, 9, 9), seed=8), flip=True, device=cuda)
    shape = (19, 33, 45)
    x = _rand(shape, 9, cuda, 1e-6, 5.0)
    data = _rand(shape, 10, cuda, 0.0, 5.0)
    dx, gp, _ = _accel_operands(shape, 11, cuda)
    zero = torch.zeros((), device=cuda)
    ratio = half_step(x, data, st, "ratio_accel", dx=dx, alpha=zero)
    torch.testing.assert_close(ratio, half_step(x, data, st, "ratio"), rtol=0, atol=0)
    want = half_step(ratio, x, adj, "mult")
    x_new = half_step(ratio, x.clone(), adj, "mult_accel", dx=dx, g_prev=gp, alpha=zero)[0]
    torch.testing.assert_close(x_new, want, rtol=0, atol=0)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("lengths,shape", [
    ((9, 21, 21), (20, 150, 170)),
    ((7, 11, 13), (37, 41, 67)),
    ((1, 3, 5), (5, 6, 300)),
    ((17, 21, 3), (30, 90, 40)),
    ((17, 61, 3), (20, 90, 40)),  # past the slab of the kernel before the march
])
def test_convzy_linear_kernel_matches_plain(cuda, flip, lengths, shape):
    """The zero-boundary z+y step on its route against the plain version,
    bit for bit (each output sums its z taps, then its y taps, in the
    plain version's order)."""
    wz, wy, _ = Stencil(_asym_terms(1, lengths, seed=12), flip=flip).host[0]
    v = _rand(shape, 13, cuda, 0.0, 10.0)
    before = convzy_linear_cuda.launches, convzy_march.launches
    out = convzy_linear(v, wz, wy)
    torch.cuda.synchronize()
    assert (convzy_linear_cuda.launches, convzy_march.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, convzy_linear_plain(v, wz, wy), rtol=0, atol=0)
    # A y radius of 212 (refused before the two-pass route took its taps in
    # chunks) runs, bit for bit.
    wide = np.random.default_rng(425).random(425).astype(np.float32)
    torch.testing.assert_close(convzy_linear_cuda(v, np.ones(3), wide),
                               convzy_linear_plain(v, np.ones(3), wide), rtol=0, atol=0)


# (boundary, tap lengths, grid, offset in floats of the carry's start):
# the production lengths, a grid smaller than the radii on z and y (taps
# wrap more than once), carries that are not 16-byte aligned or whose x
# extent is no multiple of 4, and radii past the kernel before the march.
ROUTE_CASES = [
    (b, lengths, shape, off)
    for b in ("zero", "circular")
    for lengths, shape, off in (((9, 21), (20, 150, 170), 0), ((9, 21), (3, 9, 40), 0),
                                ((9, 21), (13, 200, 33), 1), ((7, 11), (37, 41, 68), 1),
                                ((1, 1), (4, 33, 40), 0), ((17, 61), (12, 90, 40), 0),
                                ((9, 83), (6, 170, 36), 0))
]


def _offset_carry(shape, seed, device, off):
    """A carry whose first element lies ``off`` floats into its storage."""
    n = int(np.prod(shape))
    return _rand((n + off,), seed, device, 0.0, 10.0)[off:].view(shape)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("boundary,lengths,shape,off", ROUTE_CASES)
def test_convzy_routes_match_plain_bitwise(cuda, boundary, lengths, shape, off, flip):
    """The march kernel and the two-pass route each give the plain
    version's bits, on both boundaries and both tap orders."""
    rng = np.random.default_rng(sum(lengths))
    wz, wy = (rng.random(k).astype(np.float32) + 0.1 for k in lengths)
    if flip:
        wz, wy = wz[::-1].copy(), wy[::-1].copy()
    v = _offset_carry(shape, 40, cuda, off)
    plain = (convzy_linear_plain if boundary == "zero" else convzy_circular_plain)(v, wz, wy)
    kz, ky = (torch.tensor(w, device=cuda) for w in (wz, wy))
    assert convzy_route(shape, (len(wz) // 2, len(wy) // 2), boundary) == "march"
    march = convzy_march(v, zy_taps(kz, ky), len(wz), len(wy), boundary=boundary,
                         out=torch.empty_like(v))
    before = convzy_two_pass.launches
    two = convzy_two_pass(v, kz, ky, boundary=boundary, out=torch.empty_like(v))
    torch.cuda.synchronize()
    assert convzy_two_pass.launches == before + 2
    torch.testing.assert_close(march, plain, rtol=0, atol=0)
    torch.testing.assert_close(two, plain, rtol=0, atol=0)


@pytest.mark.parametrize("boundary", ["zero", "circular"])
@pytest.mark.parametrize("tile", list(CONVZY_TILES))
def test_convzy_march_on_every_tile(cuda, boundary, tile):
    wz, wy, _ = _asym_terms(1, (9, 21, 1), seed=41)[0]
    for shape in ((11, 150, 70), (3, 9, 40)):
        v = _rand(shape, 42, cuda, 0.0, 10.0)
        out = convzy_march(v, zy_taps(*(torch.tensor(w, device=cuda) for w in (wz, wy))), 9, 21,
                           boundary=boundary, out=torch.empty_like(v), tile=tile)
        torch.cuda.synchronize()
        plain = (convzy_linear_plain if boundary == "zero" else convzy_circular_plain)(v, wz, wy)
        torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("radii", [(4, 10), (0, 0), (8, 30), (4, 41), (1, 96), (3, 5)])
def test_convzy_shared_memory_sum_is_the_kernels(cuda, radii):
    from shrimpy_tpu_torch.kernels.build import load_library

    lib = load_library()
    for tile in CONVZY_TILES:
        assert lib.shrimpy_convzy_smem(2 * radii[0] + 1, 2 * radii[1] + 1, *tile) == \
            convzy_smem_bytes(tile, radii)


@pytest.mark.parametrize("mode", ["ratio", "mult", "plain"])
@pytest.mark.parametrize("wrap", [False, True])
def test_x_pass_in_pieces_matches_plain(cuda, mode, wrap):
    """A row of 60000 floats does not fit a block's shared memory: the x
    pass takes it in pieces, each with its halo (wrapped when circular)."""
    assert x_piece(60000, 10) < 60000
    kx = np.random.default_rng(43).random(21).astype(np.float32)
    h = _rand((2, 3, 60000), 44, cuda, 0.5, 10.5)
    prev = _rand((2, 3, 60000), 45, cuda, 0.0, 1.0)
    aux = _rand((2, 3, 60000), 46, cuda, 0.0, 5.0)
    out = torch.empty_like(h)
    conv_x_cuda(h, prev, None if mode == "plain" else aux, out, torch.tensor(kx, device=cuda),
                mode, 1e-6, wrap=wrap)
    torch.cuda.synchronize()
    x_plain = x_circulant_plain if wrap else x_toeplitz_plain
    want = _epilogue(x_plain(h.double(), kx) + prev.double(), aux.double(), mode, 1e-6)
    assert _rel(out, want) <= 1e-5


@pytest.mark.parametrize("shape", [(66000, 4, 8), (4, 2_100_000, 8), (2, 6, 60000)])
def test_three_pass_route_past_the_launch_grid(cuda, shape):
    """The three passes on carries past a launch's grid (gz > 65535 in the
    y pass, gy past 65535 tiles of 32) and with x rows in pieces: the
    plain version's bits, mult_accel's state and sums beside it."""
    st = Stencil(_asym_terms(1, (3, 5, 7), seed=47), device=cuda)
    inp = _rand(shape, 48, cuda, 0.5, 10.5)
    aux = _rand(shape, 49, cuda, 0.0, 5.0)
    got = half_step_three_pass(inp, aux, st, "ratio", 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, half_step_plain(inp, aux, st, "ratio", 1e-6), rtol=0, atol=0)
    dx, gp, alpha = _accel_operands(shape, 50, cuda)
    want = half_step_plain(inp, aux, st, "mult_accel", 1e-6, dx=dx, g_prev=gp, alpha=alpha)
    got = half_step_three_pass(inp, aux, st, "mult_accel", 1e-6, dx=dx, g_prev=gp, alpha=alpha)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert _bf16_close(got[1], want[1]) and _bf16_close(got[2], want[2])
    for a, b in zip(got[3:], want[3:]):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))


# (tap count, (outer, n, inner)) of the compiled axis pass: BASELINE.md
# config 2's z (31) and y (41) lists on small views, with whole columns,
# tiles, a column shorter than the radius, an inner extent no warp fills,
# and one tap.
AXIS_CASES = [(31, (1, 158, 300)), (41, (6, 700, 37)), (41, (3, 9, 40)), (37, (2, 50, 129)),
              (9, (5, 13, 1)), (1, (2, 7, 33)), (63, (2, 300, 64))]


@pytest.mark.parametrize("boundary", ["zero", "circular", "accel"])
@pytest.mark.parametrize("nk,view", AXIS_CASES)
def test_compiled_axis_pass_matches_plain_bitwise(cuda, nk, view, boundary):
    """``csrc/rl_pass.cu::axis_pass_kernel`` (compiled for ``nk``) gives
    the plain pass's bits on both boundaries and with the extrapolated
    input of ratio_accel (y formed on load)."""
    assert axis_pass_route(nk) == "compiled"
    taps = np.random.default_rng(nk).random(nk).astype(np.float32) + 0.1
    outer, n, inner = view
    v = _rand(view, nk + 1, cuda, 0.0, 10.0)
    kw = {}
    if boundary == "accel":
        dx, _, alpha = _accel_operands(view, nk + 2, cuda)
        kw = {"dx": dx, "alpha": alpha}
    out = torch.full_like(v, float("nan"))
    before = axis_pass_cuda.launches
    conv_axis_cuda(v, out, torch.tensor(taps, device=cuda), taps, outer, n, inner,
                   wrap=boundary == "circular", **kw)
    torch.cuda.synchronize()
    assert axis_pass_cuda.launches == before + 1
    plain = _conv_axis_circular_plain if boundary == "circular" else _conv_axis_plain
    src = extrapolate(v, kw["dx"], kw["alpha"]) if kw else v
    torch.testing.assert_close(out, plain(src, taps.astype(np.float64), 1), rtol=0, atol=0)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("nk,shape", [(37, (2, 3, 1636)), (37, (1, 2, 1635)), (21, (3, 5, 1620)),
                                      (41, (2, 3, 33)), (45, (2, 2, 21)), (1, (2, 3, 9)),
                                      (63, (1, 2, 70)), (21, (1, 2, 60000))])
def test_compiled_x_pass_matches_plain_bitwise(cuda, nk, shape, wrap):
    """``csrc/rl_pass.cu::x_pass_kernel`` in every mode, with and without
    earlier terms, on rows that are and are not a multiple of 4 (the
    16-byte and the 4-byte epilogue) and in pieces (60000): the plain x
    pass's bits, then the sum and the epilogue as the plain half-step
    takes them."""
    assert x_pass_route(shape[2], nk) == "compiled"
    kx = np.random.default_rng(nk).random(nk).astype(np.float32) + 0.1
    h = _rand(shape, 60, cuda, 0.5, 10.5)
    prev = _rand(shape, 61, cuda, 0.0, 1.0)
    aux = _rand(shape, 62, cuda, 0.0, 5.0)
    plain = _conv_axis_circular_plain if wrap else _conv_axis_plain
    x = plain(h, kx.astype(np.float64), 2)
    for mode in ("ratio", "mult", "plain"):
        for p in (None, prev):
            out = torch.full_like(h, float("nan"))
            before = x_pass_cuda.launches
            conv_x_cuda(h, p, None if mode == "plain" else aux, out, torch.tensor(kx, device=cuda),
                        mode, 1e-6, wrap=wrap, host=kx)
            torch.cuda.synchronize()
            assert x_pass_cuda.launches == before + 1
            want = _epilogue(x if p is None else x + p, aux, mode, 1e-6)
            torch.testing.assert_close(out, want, rtol=0, atol=0, msg=f"{mode} prev={p is not None}")


@pytest.mark.parametrize("nk", [3, 37, 63])
def test_compiled_and_runtime_passes_give_the_same_bits(cuda, nk):
    """The compiled passes against csrc/rl_fused.cu's runtime-length
    kernels, which still run tap lists past 63: z, y and x passes on
    both boundaries give equal bits."""
    from shrimpy_tpu_torch.kernels.build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    taps = np.random.default_rng(nk).random(nk).astype(np.float32) + 0.1
    k = torch.tensor(taps, device=cuda)
    gz, gy, gx = 12, 70, 44
    v = _rand((gz, gy, gx), 63, cuda, 0.0, 10.0)
    for wrap in (0, 1):
        for view in ((1, gz, gy * gx), (gz, gy, gx)):
            a, b = torch.empty_like(v), torch.empty_like(v)
            conv_axis_cuda(v, a, k, taps, *view, wrap=bool(wrap))
            assert lib.shrimpy_conv_axis(v.data_ptr(), b.data_ptr(), k.data_ptr(), nk, *view,
                                         None, None, wrap, stream) == 0
            torch.cuda.synchronize()
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        a, b = torch.empty_like(v), torch.empty_like(v)
        conv_x_cuda(v, None, None, a, k, "plain", 1e-6, wrap=bool(wrap), host=taps)
        assert lib.shrimpy_conv_x(v.data_ptr(), None, None, b.data_ptr(), k.data_ptr(), nk,
                                  gz * gy, gx, gx, 0, 1e-6, wrap, stream) == 0
        torch.cuda.synchronize()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(22, 48, 44), (9, 30, 37)])
def test_three_pass_half_step_with_24_terms_matches_plain(cuda, shape):
    """BASELINE.md config 2's plan: 24 terms of (31, 41, 37) on the
    three-pass route, every pass on the compiled kernels: all five modes
    give the plain half-step's bits (the Biggs sums within 1e-5)."""
    terms = _asym_terms(24, (31, 41, 37), seed=64)
    st, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    before = (half_step_three_pass.launches, axis_pass_cuda.launches, x_pass_cuda.launches,
              x_pass_accel_cuda.launches)
    (inp, aux, dx, gp, alpha), got = _half_all_modes(half_step_three_pass, shape, st, adj, 65,
                                                    cuda)
    assert (half_step_three_pass.launches, axis_pass_cuda.launches, x_pass_cuda.launches,
            x_pass_accel_cuda.launches) == (before[0] + 5 * 3 * 24, before[1] + 5 * 2 * 24,
                                            before[2] + 5 * 24 - 1, before[3] + 1)
    for mode, s in (("plain", st), ("ratio", st), ("mult", adj)):
        torch.testing.assert_close(got[mode], half_step_plain(inp, aux, s, mode, 1e-6),
                                   rtol=0, atol=0, msg=mode)
    want = half_step_plain(inp, aux, st, "ratio_accel", 1e-6, dx=dx, alpha=alpha)
    torch.testing.assert_close(got["ratio_accel"], want, rtol=0, atol=0)
    want = half_step_plain(inp, aux, adj, "mult_accel", 1e-6, dx=dx, g_prev=gp, alpha=alpha)
    for k in range(3):
        torch.testing.assert_close(got["mult_accel"][k], want[k], rtol=0, atol=0)
    for k in (3, 4):
        assert abs(float(got["mult_accel"][k]) - float(want[k])) <= 1e-5 * abs(float(want[k]))


@pytest.mark.parametrize("nk", [1, 9, 37, 63])
def test_x_pass_shared_memory_sum_is_the_kernels(cuda, nk):
    from shrimpy_tpu_torch.kernels.build import load_library

    for length in (1, 4, 5, 130, 1636, 16384):
        assert load_library().shrimpy_rl_pass_smem(nk, length) == x_pass_smem_bytes(nk, length)


@pytest.mark.parametrize("mode", ["ratio", "mult", "plain"])
@pytest.mark.parametrize("n_terms", [1, 2])
def test_linear_half_step_kernels_match_plain(cuda, mode, n_terms):
    st = Stencil(_asym_terms(n_terms, (7, 11, 13), seed=14), flip=mode == "mult", device=cuda)
    shape = (23, 57, 75)
    inp = _rand(shape, 15, cuda, 0.5, 10.5)
    aux = _rand(shape, 16, cuda, 0.0, 5.0)
    out = conv3_half_step(inp, aux, st, mode, 1e-6, boundary="zero")
    torch.cuda.synchronize()
    assert _rel(out, conv3_half_step_plain(inp, aux, st, mode, 1e-6,
                                                   boundary="zero")) <= 1e-5


# The launch counter each backend's RL path advances, two per iteration.
PATH_COUNTERS = {"fused": (half_step_cuda, "accel_launches"),
                 "linear_pallas": (convzy_linear_cuda, "launches"),
                 "zy_pallas": (convzy_circular_cuda, "launches")}
PLAIN_COUNTERS = (half_step_plain, convzy_linear_plain, convzy_circular_plain, conv3_circular_plain)


@pytest.mark.parametrize("backend", ["fused", "linear_pallas", "zy_pallas"])
def test_biggs_rl_kernel_path_matches_float64_plain(cuda, backend):
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _rand((12, 60, 70), 17, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=6, acceleration="biggs", separable_backend=backend)
    obj, attr = PATH_COUNTERS[backend]
    before = getattr(obj, attr)
    for f in PLAIN_COUNTERS:
        f.cuda_calls = 0
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    assert [f.cuda_calls for f in PLAIN_COUNTERS] == [0] * len(PLAIN_COUNTERS)
    assert getattr(obj, attr) == before + 12
    _two_tier(out, richardson_lucy(img, psf, s, plain=True, dtype=torch.float64))


def test_linear_rl_kernel_path_matches_float64_plain_and_fused(cuda):
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _rand((12, 60, 70), 18, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=5, separable_backend="linear_pallas")
    out = richardson_lucy(img, psf, s)
    assert _rel(out, richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)) <= 1e-4
    assert _rel(out, richardson_lucy(img, psf, deconvolve_settings(iterations=5))) <= 1e-4


@pytest.mark.parametrize("backend", ["fused", "linear_pallas", "zy_pallas"])
def test_biggs_startup_equals_plain_rl_on_the_card(cuda, backend):
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _rand((12, 60, 70), 19, cuda, 0.0, 100.0)
    for n in (1, 2):
        s = deconvolve_settings(iterations=n, separable_backend=backend)
        plain = richardson_lucy(img, psf, s)
        s.acceleration = "biggs"
        torch.testing.assert_close(richardson_lucy(img, psf, s), plain, rtol=0, atol=0)


# (tap lengths, shape): the production radii, a 2-term-style odd set, a
# tiny radius, and a grid smaller than its radii (gz 3 < rz 4, gy 9 <
# ry 10): taps wrap more than once.
CIRCULAR_CASES = [
    ((9, 21, 21), (20, 150, 170)),
    ((7, 11, 13), (37, 41, 67)),
    ((1, 3, 5), (5, 6, 300)),
    ((9, 21, 21), (3, 9, 40)),
]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("lengths,shape", CIRCULAR_CASES)
def test_convzy_circular_kernel_matches_plain(cuda, flip, lengths, shape):
    wz, wy, _ = _asym_terms(1, lengths, seed=20)[0]
    v = _rand(shape, 21, cuda, 0.0, 10.0)
    before = convzy_circular_cuda.launches
    out = convzy_circular(v, wz, wy, flip=flip)
    torch.cuda.synchronize()
    assert convzy_circular_cuda.launches == before + 1
    kz, ky = (w[::-1] if flip else w for w in (wz, wy))
    torch.testing.assert_close(out, convzy_circular_plain(v, kz, ky), rtol=0, atol=0)


def test_convzy_circular_refuses_radii_past_shared_memory(cuda):
    """Radii the kernel before the march refused (y radius past 40 at z
    radius 4) now run: on the march where its ring fits, past that on
    the two-pass route, and past a radius of 211, where the two-pass
    column outgrows shared memory, with its taps in chunks (JAX's
    zy_pallas has no bound either). Only an aliased output is refused."""
    v = _rand((6, 90, 40), 22, cuda)
    for nkz, nky, route in ((9, 83, "march"), (9, 85, "march"), (9, 201, "two_pass"),
                            (17, 251, "two_pass"), (3, 423, "two_pass"), (9, 425, "two_pass"),
                            (3, 851, "two_pass"), (425, 3, "two_pass")):
        assert convzy_route(v.shape, (nkz // 2, nky // 2), "circular") == route
        wz, wy = (np.random.default_rng(nky).random(k).astype(np.float32) for k in (nkz, nky))
        before = convzy_march.launches, convzy_two_pass.launches
        out = convzy_circular_cuda(v, wz, wy)
        torch.cuda.synchronize()
        step = (1, 0) if route == "march" else (0, 2)
        assert (convzy_march.launches, convzy_two_pass.launches) == (before[0] + step[0],
                                                                     before[1] + step[1])
        torch.testing.assert_close(out, convzy_circular_plain(v, wz, wy), rtol=0, atol=0)
    with pytest.raises(ValueError, match="alias"):
        convzy_circular_cuda(v, np.ones(3), np.ones(3), out=v)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("lengths,shape", [((3, 431), (6, 440, 40)), ((431, 3), (440, 6, 40)),
                                           ((5, 901), (4, 300, 33)), ((425, 425), (8, 12, 36))])
def test_convzy_radius_past_the_two_pass_column_matches_plain(cuda, lengths, shape, flip):
    """z or y radii of 212 and more (the two-pass route's taps in chunks of
    423) on both boundaries, bit-equal to the plain versions: a chunk goes
    on from the partial sums the one before wrote. (5, 901) on a 300-row
    grid and (425, 425) on (8, 12, 36) wrap the circular axis many times."""
    wz, wy = (np.random.default_rng(k).random(k).astype(np.float32) for k in lengths)
    if flip:
        wz, wy = wz[::-1].copy(), wy[::-1].copy()
    v = _rand(shape, 23, cuda, 0.0, 10.0)
    for boundary, step, plain in (("zero", convzy_linear_cuda, convzy_linear_plain),
                                  ("circular", convzy_circular_cuda, convzy_circular_plain)):
        assert convzy_route(v.shape, tuple(k // 2 for k in lengths), boundary) == "two_pass"
        out = step(v, wz, wy)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, plain(v, wz, wy), rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["linear_pallas", "zy_pallas"])
def test_rl_with_a_psf_past_the_two_pass_column(cuda, backend):
    """RL-2 with a (3, 431, 3) PSF (y radius 215) through richardson_lucy
    on a (4, 10, 38) image, whose G grid is (6, 440, 40): four two-pass z+y
    steps of two launches each, within 1e-4 of the float64 plain path."""
    psf = gaussian_psf((3, 431, 3), (0.8, 60.0, 0.8))
    img = _rand((4, 10, 38), 24, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=2, psf_crop_tol=0.0, separable_backend=backend)
    before = convzy_two_pass.launches
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    assert convzy_two_pass.launches == before + 8
    assert _rel(out, richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)) <= 1e-4


@pytest.mark.parametrize("mode", ["ratio", "mult", "plain"])
@pytest.mark.parametrize("kx_len,shape", [(21, (7, 33, 170)), (45, (5, 9, 21))])
def test_circular_x_pass_matches_plain(cuda, mode, kx_len, shape):
    """conv_x with wrapped rows against the dense circulant product and
    the epilogue; (45, gx 21): the row wraps more than once."""
    kx = np.random.default_rng(kx_len).random(kx_len).astype(np.float32)
    h = _rand(shape, 23, cuda, 0.5, 10.5)
    aux = _rand(shape, 24, cuda, 0.0, 5.0)
    out = torch.empty_like(h)
    conv_x_cuda(h, None, None if mode == "plain" else aux, out,
                torch.tensor(kx, device=cuda), mode, 1e-6, wrap=True)
    torch.cuda.synchronize()
    want = _epilogue(x_circulant_plain(h.double(), kx), aux.double(), mode, 1e-6)
    assert _rel(out, want) <= 1e-5


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("n_terms", [1, 2])
@pytest.mark.parametrize("lengths,shape", CIRCULAR_CASES[:2] + CIRCULAR_CASES[3:])
def test_conv3_circular_kernels_match_plain(cuda, flip, n_terms, lengths, shape):
    terms = _asym_terms(n_terms, lengths, seed=25)
    v = _rand(shape, 26, cuda, 0.0, 10.0)
    one = conv3_circular_route(shape, tuple(k // 2 for k in lengths), n_terms) == "one_launch"
    before = conv3_circular_cuda.launches, convzy_circular_cuda.launches, conv3_one_launch.launches
    out = conv3_circular(v, terms, flip=flip)
    torch.cuda.synchronize()
    assert (conv3_circular_cuda.launches, convzy_circular_cuda.launches,
            conv3_one_launch.launches) == (before[0] + 1, before[1] + (0 if one else n_terms),
                                           before[2] + one)
    assert _rel(out, conv3_circular_plain(v, Stencil(terms, flip=flip))) <= 1e-5


# (PSF lengths, carry, offset of the carry in floats): an aligned carry with
# interior blocks (the TMA copy) and seam blocks (16-byte cp.async), x
# extents no multiple of 4, a grid smaller than the radii (wraps twice), a
# carry 4 bytes into its storage.
CONV3_ONE_LAUNCH_CASES = [
    ((9, 21, 21), (20, 150, 256), 0),
    ((7, 11, 13), (37, 41, 67), 0),
    ((5, 7, 9), (9, 40, 41), 0),
    ((9, 21, 21), (3, 9, 40), 0),
    ((9, 21, 21), (13, 200, 32), 1),
]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("n_terms", [1, 2])
@pytest.mark.parametrize("lengths,shape,off", CONV3_ONE_LAUNCH_CASES)
def test_conv3_one_launch_gives_the_two_launch_route_s_bits(cuda, flip, n_terms, lengths, shape,
                                                           off):
    """rl_half.cu's circular build against the route it replaces (the
    circular z+y step, then the circular x pass), bit for bit, and the
    plain version within 1e-5."""
    st = Stencil(_asym_terms(n_terms, lengths, seed=30), flip=flip, device=cuda)
    n = int(np.prod(shape))
    v = _rand((n + off,), 31, cuda, 0.0, 10.0)[off:].view(shape)
    assert conv3_circular_route(shape, st.radii, n_terms) == "one_launch"
    before = conv3_one_launch.launches
    out = conv3_one_launch(v, st)
    torch.cuda.synchronize()
    assert conv3_one_launch.launches == before + 1
    two = conv3_half_step_cuda(v, None, st, "plain", boundary="circular")
    torch.testing.assert_close(out, two, rtol=0, atol=0)
    assert _rel(out, conv3_circular_plain(v, st)) <= 1e-5


def test_conv3_circular_past_the_block_takes_two_launches(cuda):
    """A (9, 201, 3) PSF fits no tile of the one-launch block: the z+y
    step on its own route, then the x pass; against the plain version."""
    terms = _asym_terms(1, (9, 201, 3), seed=32)
    shape = (6, 210, 20)
    v = _rand(shape, 33, cuda, 0.0, 10.0)
    assert conv3_circular_route(shape, (4, 100, 1)) == "zy_then_x"
    before = conv3_one_launch.launches, convzy_circular_cuda.launches
    out = conv3_circular(v, terms)
    torch.cuda.synchronize()
    assert (conv3_one_launch.launches, convzy_circular_cuda.launches) == (before[0],
                                                                         before[1] + 1)
    assert _rel(out, conv3_circular_plain(v, Stencil(terms))) <= 1e-5
    with pytest.raises(ValueError, match="fit no tile"):
        conv3_one_launch(v, Stencil(terms, device=cuda))


@pytest.mark.parametrize("mode", ["ratio", "mult", "plain"])
@pytest.mark.parametrize("n_terms", [1, 2])
def test_circular_half_step_kernels_match_plain(cuda, mode, n_terms):
    st = Stencil(_asym_terms(n_terms, (7, 11, 13), seed=27), flip=mode == "mult", device=cuda)
    shape = (23, 57, 75)
    inp = _rand(shape, 28, cuda, 0.5, 10.5)
    aux = _rand(shape, 29, cuda, 0.0, 5.0)
    out = conv3_half_step(inp, aux, st, mode, 1e-6, boundary="circular")
    torch.cuda.synchronize()
    want = conv3_half_step_plain(inp, aux, st, mode, 1e-6, boundary="circular")
    assert _rel(out, want) <= 1e-5


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
def test_zy_rl_kernel_path_matches_float64_plain(cuda, pad_mode):
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _rand((12, 60, 70), 30, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=5, pad_mode=pad_mode, separable_backend="zy_pallas")
    before = convzy_circular_cuda.launches
    for f in PLAIN_COUNTERS:
        f.cuda_calls = 0
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    assert convzy_circular_cuda.launches == before + 10
    assert [f.cuda_calls for f in PLAIN_COUNTERS] == [0] * len(PLAIN_COUNTERS)
    assert _rel(out, richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)) <= 1e-4


def test_matmul_rl_on_the_card_matches_float64(cuda, monkeypatch):
    """matmul launches no kernel of the repository: float32 products with
    TF32 off within 1e-4 of float64; TF32 switched on raises."""
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _rand((12, 60, 70), 31, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=5, separable_backend="matmul")
    before = [getattr(o, a) for o, a in PATH_COUNTERS.values()]
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    assert [getattr(o, a) for o, a in PATH_COUNTERS.values()] == before
    assert out.is_cuda and out.dtype == torch.float32
    assert _rel(out, richardson_lucy(img, psf, s, dtype=torch.float64)) <= 1e-4
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        richardson_lucy(img, psf, s)


ITER_CASES = [
    # terms, tap lengths (z, y, x), carry shape
    *((n, (9, 21, 21), (20, 100, 132)) for n in (1, 2)),  # the slab by TMA
    *((n, (9, 21, 21), (20, 100, 130)) for n in (1, 2)),  # gx % 4 != 0: by cp.async
    *((n, (7, 11, 13), (40, 61, 77)) for n in (1, 2)),
    *((n, (9, 21, 21), (5, 37, 45)) for n in (1, 2)),  # z < 2 rz + 1, no tile divides y or x
    *((n, (1, 1, 1), (6, 20, 33)) for n in (1, 2)),    # zero radii
    *((n, (3, 41, 5), (9, 50, 40)) for n in (1, 2)),   # a y radius past the tile
    (1, (17, 3, 3), (30, 20, 24)),  # 16 adjoint z planes in registers; odd rx by TMA
]


@pytest.mark.parametrize("n_terms,lengths,shape", ITER_CASES)
def test_rl_iter_kernel_matches_plain(cuda, n_terms, lengths, shape):
    """One launch against the plain iteration, both tap orders (the
    adjoint's taps as the convolution's and back): the kernel sums in
    the plain version's order, so the bits are equal."""
    from shrimpy_tpu_torch.ops.rl_fused_iter import (
        rl_iter,
        rl_iter_cuda,
        rl_iter_half_steps,
        rl_iter_plain,
        rl_iter_route,
    )

    terms = _asym_terms(n_terms, lengths, seed=32)
    conv, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    assert rl_iter_route(shape, conv.radii, n_terms) == "one_launch"
    est = _rand(shape, 33, cuda, 0.5, 10.5)
    data = _rand(shape, 34, cuda, 0.0, 5.0)
    keep = est.clone()
    before = rl_iter_cuda.launches, rl_iter_half_steps.launches
    for a, b in ((conv, adj), (adj, conv)):
        out = rl_iter(est, data, a, b, 1e-6)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, rl_iter_plain(est, data, a, b, 1e-6), rtol=0, atol=0)
    assert (rl_iter_cuda.launches, rl_iter_half_steps.launches) == (before[0] + 2, before[1])
    assert torch.equal(est, keep)  # the kernel never writes its input
    with pytest.raises(ValueError, match="alias"):
        rl_iter_cuda(est, data, conv, adj, 1e-6, est)


@pytest.mark.parametrize("tile", [(32, 48), (48, 32), (40, 40), (24, 64), (32, 32), (24, 32),
                                  (16, 64), (16, 32), (8, 32), (8, 16), (4, 8)])
def test_rl_iter_kernel_on_every_tile(cuda, tile):
    from shrimpy_tpu_torch.ops.rl_fused_iter import TILES, rl_iter_cuda, rl_iter_plain

    assert tile in TILES
    terms = _asym_terms(2, (5, 9, 11), seed=35)
    conv, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    # gx % 4 == 0: the slab by TMA, with an odd x radius (walked one wider).
    est = _rand((11, 45, 72), 36, cuda, 0.5, 10.5)
    data = _rand((11, 45, 72), 37, cuda, 0.0, 5.0)
    out = rl_iter_cuda(est, data, conv, adj, 1e-6, tile=tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, rl_iter_plain(est, data, conv, adj, 1e-6), rtol=0, atol=0)


def test_rl_iter_kernel_on_a_carry_that_is_not_16_byte_aligned(cuda):
    """gx % 4 == 0 but est starts 4 bytes past a 16-byte boundary: the
    slab comes by cp.async, with the same bits."""
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_cuda

    shape, n = (9, 40, 64), 9 * 40 * 64
    terms = _asym_terms(1, (5, 9, 9), seed=3)
    conv, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    est, data = _rand(shape, 43, cuda, 0.5, 10.5), _rand(shape, 44, cuda, 0.0, 5.0)
    want = rl_iter_cuda(est, data, conv, adj)
    buf = torch.empty(n + 1, device=cuda)
    shifted = buf[1:].view(shape)
    shifted.copy_(est)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    got = rl_iter_cuda(shifted, data, conv, adj)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n_terms", [1, 2])
@pytest.mark.parametrize("radii", [(4, 10, 10), (0, 0, 0), (3, 5, 6), (1, 20, 2), (8, 3, 3)])
def test_rl_iter_shared_memory_sum_is_the_kernels(cuda, radii, n_terms):
    """The wrapper's bound and the launch's request are one number."""
    from shrimpy_tpu_torch.kernels.build import load_library
    from shrimpy_tpu_torch.ops.rl_fused_iter import TILES, iter_layout, iter_smem_bytes

    lengths = [2 * r + 1 for r in radii]
    for tile in TILES + ((64, 64), (4, 4)):
        assert load_library().shrimpy_rl_iter_smem(n_terms, *lengths, *tile) == iter_smem_bytes(
            tile, radii, n_terms)
    # Every tile's shared memory fits these radii; two terms of rz 8 keep
    # 32 adjoint z planes a thread, past the 16 a block's registers hold.
    layout = iter_layout((40, 300, 400), radii, n_terms)
    assert (layout is not None) == (n_terms * 2 * radii[0] <= 16)
    assert layout is None or layout["smem_bytes"] <= 232448


def test_rl_iter_kernel_refuses_what_it_cannot_take(cuda):
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_cuda

    terms = [(np.ones(17, np.float32), np.ones(113, np.float32), np.ones(129, np.float32))]
    conv, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    vol = torch.ones((4, 30, 30), device=cuda)
    before = rl_iter_cuda.launches
    with pytest.raises(ValueError, match="one-launch kernel's block.*TMA box"):
        rl_iter_cuda(vol, vol.clone(), conv, adj)
    with pytest.raises(ValueError, match="does not fit"):
        rl_iter_cuda(vol, vol.clone(), Stencil(_asym_terms(1, (3, 3, 3), 0), device=cuda),
                     Stencil(_asym_terms(1, (3, 3, 3), 0), flip=True, device=cuda), tile=(6, 8))
    assert rl_iter_cuda.launches == before


def test_rl_iter_half_step_route_past_the_block(cuda):
    """A (17, 61, 61) PSF is past every tile's block: ``rl_iter`` runs the
    two half-steps (here on their three-pass route), launches no
    ``rl_iter`` kernel and calls no plain version; the result is the
    half-steps' bit for bit and the plain iteration's to round-off (the
    axes in another order)."""
    from shrimpy_tpu_torch.ops.rl_fused_iter import (
        rl_iter,
        rl_iter_cuda,
        rl_iter_half_steps,
        rl_iter_plain,
        rl_iter_route,
    )

    terms = _asym_terms(1, (17, 61, 61), seed=45)
    conv, adj = Stencil(terms, device=cuda), Stencil(terms, flip=True, device=cuda)
    shape = (40, 200, 260)
    assert rl_iter_route(shape, conv.radii, 1) == "half_steps"
    est, data = _rand(shape, 46, cuda, 0.5, 10.5), _rand(shape, 47, cuda, 0.0, 5.0)
    keep = est.clone()
    before = (rl_iter_cuda.launches, rl_iter_half_steps.launches, half_step_cuda.launches,
              half_step_three_pass.launches)
    rl_iter_plain.cuda_calls = half_step_plain.cuda_calls = 0
    with pytest.raises(ValueError, match="one-launch kernel's block"):
        rl_iter_cuda(est, data, conv, adj)
    out = rl_iter(est, data, conv, adj, 1e-6)
    torch.cuda.synchronize()
    assert (rl_iter_cuda.launches, rl_iter_half_steps.launches, half_step_cuda.launches,
            half_step_three_pass.launches) == (before[0], before[1] + 1, before[2] + 2,
                                               before[3] + 6)
    assert rl_iter_plain.cuda_calls == half_step_plain.cuda_calls == 0
    assert torch.equal(est, keep)
    ratio = half_step_cuda(est, data, conv, "ratio", 1e-6)
    torch.testing.assert_close(out, half_step_cuda(ratio, est, adj, "mult", 1e-6), rtol=0, atol=0)
    assert _rel(out, rl_iter_plain(est, data, conv, adj, 1e-6)) <= 1e-5


@pytest.mark.parametrize("acceleration,iterations", [("none", 3), ("biggs", 4)])
def test_fused_iter_rl_on_the_half_step_route_matches_float64_plain(cuda, acceleration,
                                                                     iterations):
    """``fused_iter`` through ``richardson_lucy`` with a PSF past the
    one-launch block: the half-step route every iteration, alternating
    two carries (Biggs reads the step's input after it returns)."""
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_cuda, rl_iter_half_steps

    psf = gaussian_psf((17, 61, 61), (3.0, 9.0, 9.0))
    img = _rand((24, 150, 170), 48, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=iterations, separable_backend="fused_iter",
                            acceleration=acceleration, psf_crop_tol=0.0)
    before = rl_iter_cuda.launches, rl_iter_half_steps.launches
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    assert (rl_iter_cuda.launches, rl_iter_half_steps.launches) == (before[0],
                                                                    before[1] + iterations)
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    if acceleration == "biggs":
        _two_tier(out, ref)
    else:
        assert _rel(out, ref) <= 1e-4


@pytest.mark.parametrize("acceleration,iterations", [("none", 5), ("biggs", 6)])
def test_fused_iter_rl_kernel_path_matches_float64_plain(cuda, acceleration, iterations):
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_cuda, rl_iter_plain

    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _rand((12, 60, 70), 38, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=iterations, separable_backend="fused_iter",
                            acceleration=acceleration)
    before = rl_iter_cuda.launches, half_step_cuda.launches
    rl_iter_plain.cuda_calls = 0
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    # The one-launch route: a kernel launch an iteration, no half-step.
    assert (rl_iter_cuda.launches, half_step_cuda.launches) == (before[0] + iterations, before[1])
    assert rl_iter_plain.cuda_calls == 0
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    if acceleration == "biggs":
        _two_tier(out, ref)
    else:
        assert _rel(out, ref) <= 1e-4
        fused = richardson_lucy(img, psf, deconvolve_settings(iterations=iterations))
        assert _rel(out, fused) <= 1e-5


@pytest.mark.parametrize("backend", ["fused_iter", "fused"])
def test_donate_input_frees_the_volume_on_the_card(cuda, backend):
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    s = deconvolve_settings(iterations=4, separable_backend=backend, acceleration="biggs")
    img = _rand((24, 200, 260), 39, cuda, 0.0, 100.0)
    peaks, outs = {}, {}
    for donate in (False, True):
        s.donate_input = donate
        vol = img.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # with the first run's output, the second time
        outs[donate] = richardson_lucy(vol, psf, s)
        torch.cuda.synchronize()
        peaks[donate] = torch.cuda.max_memory_allocated() - held
        assert (vol.numel() == 0) == donate
    assert torch.equal(outs[True], outs[False])
    assert peaks[True] <= peaks[False]


def test_numpy_input_goes_to_the_card(cuda):
    """No ``device``: a host array runs on the card, a CPU tensor stays."""
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = np.random.default_rng(40).random((8, 30, 34)).astype(np.float32) * 50
    s = deconvolve_settings(iterations=2)
    out = richardson_lucy(img, psf, s)
    assert out.is_cuda
    assert not richardson_lucy(torch.from_numpy(img), psf, s).is_cuda
    desk = deskew_settings(px_to_scan_ratio=0.386)
    raw = np.random.default_rng(41).random((40, 24, 20)).astype(np.float32)
    assert deskew_volume(raw, desk).is_cuda
    assert not deskew_volume(raw, desk, device="cpu").is_cuda


def test_probes_on_the_card(cuda):
    from shrimpy_tpu_torch.kernels import probes
    from shrimpy_tpu_torch.ops.rl_fused import _SMEM_BYTES

    x = _rand((8, 512), 42, cuda)
    assert torch.equal(probes.dynamic_smem_slice_cuda(x), probes.dynamic_smem_slice_plain(x))
    assert probes.probe_dynamic_smem_slice(cuda)
    assert [probes.probe_smem(kb, cuda) for kb in probes.SMEM_KB] == [True] * 5 + [False]
    assert probes.largest_smem(cuda) == _SMEM_BYTES


@pytest.mark.parametrize("mode", ["bf16x3", "tf32", "tf32x3", "bf16", "fma"])
def test_split_dot_kernels_match_their_plain_versions(cuda, mode):
    """Each hand-written product within 1e-5 of its split taken with exact
    accumulation; bf16x3 and 3xTF32 within 1e-5 of float64 too."""
    from shrimpy_tpu_torch.kernels import probes

    a, b = probes.dot_operands(cuda, 1)
    got = probes.split_dot_cuda(a, b, mode).double()
    torch.cuda.synchronize()
    assert _rel(got, probes.split_dot_plain(a, b, mode)) <= 1e-5
    if mode in ("bf16x3", "tf32x3"):
        assert _rel(got, a.double() @ b.double()) <= probes.SPLIT_RTOL


def test_probes_entry_point_runs(cuda):
    from shrimpy_tpu_torch.kernels import probes

    assert probes.main() == 0


@pytest.mark.parametrize("mode", ["bf16x3", "tf32", "tf32x3", "bf16", "fma"])
@pytest.mark.parametrize("m,k,n", [(64, 16, 8), (192, 168, 264), (64, 1024, 256)])
def test_split_dot_on_every_tile_shape(cuda, mode, m, k, n):
    """Past the probe's shapes: one tile, k and n that no tile or k-chunk
    divides, a deep k; within 1e-5 of the plain version, bf16x3 and 3xTF32
    within SPLIT_RTOL of float64."""
    from shrimpy_tpu_torch.kernels import probes

    a, b = probes.dot_operands(cuda, 1, ((m, k), (k, n)))
    got = probes.split_dot_cuda(a, b, mode).double()
    torch.cuda.synchronize()
    assert _rel(got, probes.split_dot_plain(a, b, mode)) <= 1e-5
    if mode in ("bf16x3", "tf32x3"):
        assert _rel(got, a.double() @ b.double()) <= probes.SPLIT_RTOL


@pytest.mark.parametrize("mode", ["bf16x3", "tf32", "tf32x3", "bf16", "fma"])
def test_split_dot_is_one_launch(cuda, mode):
    """Every mode, split included, is one kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    from shrimpy_tpu_torch.kernels import probes

    a, b = probes.dot_operands(cuda, 0)
    probes.split_dot_cuda(a, b, mode)
    torch.cuda.synchronize()
    before = probes.split_dot_cuda.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        probes.split_dot_cuda(a, b, mode)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    want = "dot_fma_kernel" if mode == "fma" else f"dot_split_kernel<{probes.DOT_MODES[mode]}>"
    assert len(kernels) == 1 and want in kernels[0], kernels
    assert probes.split_dot_cuda.launches == before + 1


def test_largest_smem_reads_back_once(cuda, monkeypatch):
    """Every size is queued, then one synchronisation and one read."""
    from shrimpy_tpu_torch.kernels import probes
    from shrimpy_tpu_torch.ops.rl_fused import _SMEM_BYTES

    syncs = []
    real = torch.cuda.synchronize

    def counted(*args, **kwargs):
        syncs.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    before = probes.smem_touch_cuda.launches
    assert probes.largest_smem(cuda) == _SMEM_BYTES
    assert len(syncs) == 1
    assert probes.smem_touch_cuda.launches == before + 5  # 228 KB is refused


def test_slice_kernel_takes_width_128(cuda):
    from shrimpy_tpu_torch.kernels import probes

    x = _rand((8, 512), 43, cuda)
    with pytest.raises(ValueError, match="width 128"):
        probes.dynamic_smem_slice_cuda(x, 256)


# The affine warp (csrc/affine.cu). Maps: a fractional translation, the
# refine's near-identity lower-triangular form, a 2-degree and a 30-degree
# rotation in the yx plane about the volume's center. Against the float64
# plain version within 1e-5 of max|ref| (the kernel forms coordinates in
# float64 and sums the corners in float32); the warp of ones (support)
# within 1e-6.
def _affine_map(kind: str, shape):
    import math

    if kind == "translate":
        return np.eye(3, dtype=np.float32), np.array([0.4, -3.2, 2.6], np.float32)
    if kind == "lower":
        m = np.array([[1.003, 0.0, 0.0], [0.012, 0.997, 0.0], [-0.018, 0.015, 1.002]],
                     np.float32)
        return m, np.array([0.4, -3.2, 2.6], np.float32)
    deg = {"rot2": 2.0, "rot30": 30.0}[kind]
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    m = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
    center = (np.asarray(shape, np.float64) - 1) / 2
    return m.astype(np.float32), (center - m @ center).astype(np.float32)


AFFINE_KINDS = ("translate", "lower", "rot2", "rot30")


@pytest.mark.parametrize("out_shape", [None, (7, 29, 70), (3, 50, 17)])
@pytest.mark.parametrize("kind", AFFINE_KINDS)
def test_affine_warp_matches_plain(cuda, kind, out_shape):
    from shrimpy_tpu_torch.ops.affine_cuda import affine_warp_cuda, map_params
    from shrimpy_tpu_torch.ops.register import affine_apply_plain

    vol = _rand((5, 37, 45), 50, cuda, 0.0, 50.0)
    shape = out_shape or tuple(vol.shape)
    m, t = _affine_map(kind, vol.shape)
    params = map_params(torch.from_numpy(m).to(cuda), torch.from_numpy(t).to(cuda))
    out = affine_warp_cuda(vol, params, shape)
    sup = affine_warp_cuda(torch.ones_like(vol), params, shape)
    torch.cuda.synchronize()
    assert tuple(out.shape) == shape
    ref = affine_apply_plain(vol, m, t, shape, dtype=torch.float64)
    assert _rel(out, ref) <= 1e-5
    ones = affine_apply_plain(torch.ones_like(vol), m, t, shape, dtype=torch.float64)
    assert float((sup.double() - ones).abs().max()) <= 1e-6
    assert torch.equal(affine_warp_cuda(vol, params, shape), out)


@pytest.mark.parametrize("vol_shape,out_shape", [((3, 6, 8), (2, 40000, 8)),
                                                 ((70000, 2, 3), (70000, 2, 3))])
def test_affine_warp_past_65535_rows(cuda, vol_shape, out_shape):
    from shrimpy_tpu_torch.ops.register import affine_apply, affine_apply_plain

    vol = _rand(vol_shape, 51, cuda, 0.0, 10.0)
    m, t = _affine_map("lower", vol_shape)
    out = affine_apply(vol, m, t, out_shape)
    torch.cuda.synchronize()
    assert out.shape[0] * out.shape[1] > 65535
    assert _rel(out, affine_apply_plain(vol, m, t, out_shape, dtype=torch.float64)) <= 1e-5


def _refine_case(kind, cuda, seed=52):
    """A blob-and-noise volume, fixed on a stride-2 refine grid from its
    shifted copy, and a map of ``kind`` scaled to that grid."""
    vol = _rand((9, 61, 53), seed, cuda, 0.0, 50.0)
    fixed = torch.roll(vol, (1, -2, 3), (0, 1, 2))[:, ::2, ::2].contiguous()
    m, t = _affine_map(kind, vol.shape)
    m = m @ np.diag([1.0, 2.0, 2.0]).astype(np.float32)  # the stride-2 refine grid
    return vol, fixed, torch.from_numpy(m).to(cuda), torch.from_numpy(t).to(cuda)


@pytest.mark.parametrize("loss", ["ncc", "mse"])
@pytest.mark.parametrize("kind", AFFINE_KINDS)
def test_refine_pair_matches_float64_plain_and_repeats_its_bits(cuda, kind, loss):
    """The sums launch and the gradient launch against the plain objective
    in float64 (loss and the 12 sums within 1e-5 relative), the same bits
    on two runs, and the loss within 1e-5 of the float32 plain version's.
    (Its 12 sums are not held to the float32 version's: the derivative is
    one-sided at integer coordinates, and the decimal entries of "lower"
    put many voxels on one, e.g. the x coordinate -0.018 z + 0.03 y + 2.004 x + 2.6 at
    z = 0, y = 10, x = 25, where float32 and float64 coordinates fall on
    either side: 5.5e-2 between the two plain versions themselves.)"""
    from shrimpy_tpu_torch.ops.affine_cuda import refine_objective_cuda, refine_scratch
    from shrimpy_tpu_torch.ops.register import refine_objective_plain

    vol, fixed, m, t = _refine_case(kind, cuda)
    partials = refine_scratch(vol, fixed.shape)
    first = refine_objective_cuda(vol, fixed, m, t, loss, partials)
    second = refine_objective_cuda(vol, fixed, m, t, loss, partials)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    value, dm, dt = first
    assert value.dtype == dm.dtype == dt.dtype == torch.float32 and value.shape == ()
    want = refine_objective_plain(vol, fixed, m.double(), t.double(), loss, dtype=torch.float64)
    assert abs(float(value) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    got = torch.cat([dm.reshape(9), dt]).double()
    assert _rel(got, torch.cat([want[1].reshape(9), want[2]])) <= 1e-5
    plain32 = refine_objective_plain(vol, fixed, m, t, loss, grad=False)[0]
    assert abs(float(value) - float(plain32)) <= 1e-5 * abs(float(plain32))


def test_refine_sums_mask_is_the_warp_kernel_s_support(cuda):
    """The sums launch's n = sum w counts the voxels whose support, the
    warp kernel's warp of a volume of ones, exceeds 0.999; its mse sum is
    that of the warp kernel's output, within float64 rounding."""
    from shrimpy_tpu_torch.ops.affine_cuda import (
        affine_warp_cuda,
        map_params,
        refine_scratch,
        refine_sums_cuda,
    )

    vol, fixed, m, t = _refine_case("rot30", cuda)
    params = map_params(m, t)
    out = affine_warp_cuda(vol, params, fixed.shape)
    sup = affine_warp_cuda(torch.ones_like(vol), params, fixed.shape)
    partials = refine_scratch(vol, fixed.shape)
    value, stats = refine_sums_cuda(vol, fixed, params, "mse", partials)
    w = (sup > 0.999).double()
    assert 0 < float(stats[5]) == float(w.sum()) < fixed.numel()
    want = float((w * (out.double() - fixed.double()) ** 2).sum() / w.sum())
    assert abs(float(stats[0]) - want) <= 1e-12 * want and float(value) == float(stats[0].float())


def test_refine_step_makes_no_tensor_of_the_grid(cuda):
    """RefineObjective on the card: the loss, the map's gradient through
    autograd, and no allocation of the refine grid's size in a step (the
    scratch is made once an estimate)."""
    from shrimpy_tpu_torch.ops.affine_cuda import refine_objective_cuda, refine_scratch
    from shrimpy_tpu_torch.ops.register import RefineObjective

    vol = _rand((16, 256, 256), 57, cuda, 0.0, 50.0)
    fixed = torch.roll(vol, (1, -2, 3), (0, 1, 2))[:, ::4, ::4].contiguous()
    partials = refine_scratch(vol, fixed.shape)
    scale = torch.diag(torch.tensor([1.0, 4.0, 4.0], device=cuda))

    def pair(mm, tt):
        return refine_objective_cuda(vol, fixed, mm, tt, "ncc", partials)

    dm = torch.zeros((3, 3), device=cuda, requires_grad=True)
    off = torch.tensor([0.5, -1.0, 1.5], device=cuda, requires_grad=True)
    RefineObjective.apply(scale + torch.tril(dm) / 256.0, off, pair).backward()  # warm
    dm.grad = off.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    value = RefineObjective.apply(scale + torch.tril(dm) / 256.0, off, pair)
    value.backward()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 4 * fixed.numel() // 4
    want = pair(scale + torch.tril(dm.detach()) / 256.0, off.detach())
    assert torch.equal(value.detach(), want[0])
    assert torch.equal(dm.grad, torch.tril(want[1]) / 256.0) and torch.equal(off.grad, want[2])


def test_registration_on_the_card_never_reaches_the_plain_version(cuda, tmp_path):
    """affine_apply, estimate_registration and the registered step on CUDA
    tensors launch the kernels (counted) and never the plain version; the
    plain path on the card agrees with the kernel path."""
    import json

    from shrimpy_tpu_torch.config import registration_settings
    from shrimpy_tpu_torch.ops.affine_cuda import affine_warp_cuda, refine_grad_cuda, refine_sums_cuda
    from shrimpy_tpu_torch.ops.register import (
        affine_apply,
        affine_apply_plain,
        estimate_registration,
    )

    shape = (16, 64, 64)
    rng = np.random.default_rng(55)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape), indexing="ij")
    fixed = sum(100.0 * np.exp(-0.5 * (((z - cz) / 2.0) ** 2 + ((y - cy) / 4.0) ** 2
                                       + ((x - cx) / 4.0) ** 2))
                for cz, cy, cx in rng.uniform(4, np.array(shape) - 4, (12, 3)))
    fixed = torch.from_numpy(fixed.astype(np.float32)).to(cuda)
    m, t = _affine_map("lower", shape)
    moving = affine_apply_plain(fixed, m, t, dtype=torch.float64).float()
    affine_warp_cuda.launches = refine_sums_cuda.launches = refine_grad_cuda.launches = 0
    affine_apply_plain.cuda_calls = 0
    s = registration_settings(refine_iterations=7)
    got = estimate_registration(fixed, moving, s)
    # The seed's loss, 7 steps of two launches, the final loss: no warp.
    assert (affine_warp_cuda.launches, refine_sums_cuda.launches,
            refine_grad_cuda.launches) == (0, 9, 7)
    assert affine_apply_plain.cuda_calls == 0
    ref = estimate_registration(fixed, moving, s, plain=True)
    assert affine_apply_plain.cuda_calls > 0
    np.testing.assert_allclose(got.matrix, ref.matrix, atol=1e-4)
    np.testing.assert_allclose(got.offset, ref.offset, atol=1e-3)
    affine_warp_cuda.launches = 0
    affine_apply_plain.cuda_calls = 0
    assert affine_apply(fixed, m, t).is_cuda and affine_warp_cuda.launches == 1
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"matrix_zyx": m.tolist(), "offset_zyx": t.tolist()}))
    settings = reconstruct_settings(deskew=deskew_settings(px_to_scan_ratio=0.386),
                                    registration=registration_settings(transform_path=str(path)))
    raw = _rand((1, 40, 24, 20), 56, cuda, 0.0, 100.0)
    out = build_reconstruct_step(settings)(raw)
    assert out.is_cuda and affine_warp_cuda.launches == 2
    assert affine_apply_plain.cuda_calls == 0
    ref = build_reconstruct_step(settings, plain=True, dtype=torch.float64)(raw)
    assert _rel(out, ref) <= 1e-5


# (gz, gy, gxr, kz) of the band: gz = kz = 9, the smallest gz the padded grid
# gives; a ragged (20, 37, 45) with kz 7; one plane; kz past gz (wraps
# twice); an even kz and one past 31 (the kernel that reads its window from
# memory); columns past one block with z split into segments.
ZBAND_CASES = [(9, 33, 17, 9), (20, 37, 45, 7), (6, 24, 17, 1), (4, 3, 5, 9), (12, 8, 6, 4),
               (40, 30, 21, 33), (30, 64, 100, 15)]


@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("gz,gy,gxr,kz", ZBAND_CASES)
def test_zband_kernel_matches_plain(cuda, mode, gz, gy, gxr, kz):
    from shrimpy_tpu_torch.ops.zband_cuda import zband, zband_cuda, zband_plain

    rng = np.random.default_rng(gz * 1000 + kz)

    def crand(shape):
        return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                                .astype(np.complex64)).to(cuda)

    spec, taps = crand((gz, gy, gxr)), crand((kz, gy, gxr))
    before = zband_cuda.launches
    out = zband(spec, taps, mode)
    torch.cuda.synchronize()
    assert zband_cuda.launches == before + 1 and zband_plain.cuda_calls == 0
    ref = zband_plain(spec, taps, mode)
    zband_plain.cuda_calls = 0
    assert _rel(torch.view_as_real(out), torch.view_as_real(ref)) <= 1e-6


def test_zband_cuda_guards(cuda):
    from shrimpy_tpu_torch.ops.zband_cuda import zband_cuda

    spec = torch.zeros((6, 4, 3), dtype=torch.complex64, device=cuda)
    taps = torch.zeros((3, 4, 3), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="complex64"):
        zband_cuda(spec.to(torch.complex128), taps.to(torch.complex128), "conv")
    with pytest.raises(ValueError, match="apart"):
        zband_cuda(spec, taps, "conv", out=spec)


@pytest.mark.parametrize("settings", [
    {"algorithm": "fft"},
    {"algorithm": "fft", "fft_backend": "dft2z", "fft_z_chunk": 3},
    {"algorithm": "fft", "acceleration": "biggs"},
    {"algorithm": "hybrid", "hybrid_separable_iters": 4},
    {"algorithm": "hybrid", "hybrid_separable_iters": 4, "acceleration": "biggs"},
])
def test_fft_rl_on_card_matches_float64_plain(cuda, settings):
    """RL-3 fft2z (auto) and hybrid through richardson_lucy on the card:
    two band launches an iteration, no plain band on a CUDA tensor; against
    the float64 plain path on the card (Biggs: the two-tier gate)."""
    from shrimpy_tpu_torch.ops.zband_cuda import zband_cuda, zband_plain

    img = _rand((12, 40, 44), 61, cuda, 0.0, 100.0)
    s = deconvolve_settings(iterations=3, **settings)
    psf = tilted_gaussian_psf((7, 9, 9))
    from shrimpy_tpu_torch.ops import fft_cuda

    zband_cuda.launches = zband_plain.cuda_calls = 0
    out = richardson_lucy(img, psf, s)
    torch.cuda.synchronize()
    assert zband_cuda.launches == 6 and zband_plain.cuda_calls == 0
    assert [fn.cuda_calls for fn in fft_cuda.PLAIN] == [0] * 4
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    assert zband_plain.cuda_calls == 6
    zband_plain.cuda_calls = 0
    for fn in fft_cuda.PLAIN:
        fn.cuda_calls = 0
    if s.acceleration == "biggs":
        scale = float(ref.abs().max())
        diff = (out.double() - ref).abs()
        assert float((diff <= 5e-4 * scale).double().mean()) >= 0.9999
        assert float(diff.max()) <= 2e-2 * scale
    else:
        assert _rel(out, ref) <= 1e-4


def _zero_fft_counts():
    from shrimpy_tpu_torch.ops import fft_cuda

    for fn in (fft_cuda.r2c_cuda, fft_cuda.c2r_cuda, fft_cuda.ratio_cuda, fft_cuda.scale_cuda):
        fn.launches = 0
    for fn in fft_cuda.PLAIN:
        fn.cuda_calls = 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,off", [(1, 0), (3, 0), (7, 0), (4097, 0), (1 << 20, 0), (4099, 1),
                                   (1000, 3)])
def test_ratio_and_scale_kernels_equal_the_torch_chain_bitwise(cuda, dtype, n, off):
    """``rl_ratio_kernel`` and ``rl_scale_kernel`` give the bits of
    ``div(data, x.clamp_min_(eps))`` and ``v.mul_(x)``: lengths that are no
    multiple of the vector width, arrays off the 16-byte grid (``off``
    elements in), eps hits, zeros of either sign, infinities and a NaN."""
    from shrimpy_tpu_torch.ops import fft_cuda

    eps = 1e-3
    g = np.random.default_rng(n + off)
    x = torch.from_numpy(g.uniform(-0.01, 2.0, n + off)).to(cuda, dtype)[off:]
    data = torch.from_numpy(g.uniform(0.0, 100.0, n + off)).to(cuda, dtype)[off:]
    edge = torch.tensor([float("nan"), 0.0, -0.0, eps, eps / 2, float("inf"), -1.0, 1e-30],
                        dtype=dtype, device=cuda)[:n]
    x[:edge.numel()] = edge
    data[-min(n, 3):] = 0.0
    _zero_fft_counts()
    before = (fft_cuda.ratio_cuda.launches, fft_cuda.scale_cuda.launches)
    got = fft_cuda.ratio_(x.clone(), data, eps)
    want = torch.div(data, x.clone().clamp_min_(eps))
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    got = fft_cuda.scale_(x.clone(), data)
    assert torch.equal(_bits(got), _bits(x.clone().mul_(data)))
    assert (fft_cuda.ratio_cuda.launches, fft_cuda.scale_cuda.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    assert fft_cuda.ratio_plain.cuda_calls == fft_cuda.scale_plain.cuda_calls == 0
    fft_cuda.ratio_plain(x.clone(), data, eps)
    assert fft_cuda.ratio_plain.cuda_calls == 1
    fft_cuda.ratio_plain.cuda_calls = 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 33, 40), (8, 33, 45), (8, 96, 120), (1, 729, 480)])
def test_cufft_plans_match_torch_fft(cuda, dtype, shape):
    """R2C and C2R through the port's plans against ``torch.fft.rfft2`` and
    ``irfft2(norm="forward")`` within 1e-6, batch 1 and 8, an odd gx; R2C
    keeps its input, each counts one launch, no plain call on the card."""
    from shrimpy_tpu_torch.ops import fft_cuda

    x = torch.from_numpy(np.random.default_rng(sum(shape)).uniform(-1, 1, shape)).to(cuda, dtype)
    kept = x.clone()
    n, gy, gx = shape
    _zero_fft_counts()
    spec = torch.empty((n, gy, gx // 2 + 1), dtype=fft_cuda.COMPLEX[dtype], device=cuda)
    before = (fft_cuda.r2c_cuda.launches, fft_cuda.c2r_cuda.launches)
    fft_cuda.r2c(x, spec)
    r2c_gap = _rel(torch.view_as_real(spec), torch.view_as_real(torch.fft.rfft2(x)))
    assert r2c_gap <= 1e-6
    assert torch.equal(x, kept)
    back = torch.empty_like(x)
    want = torch.fft.irfft2(spec, s=(gy, gx), norm="forward")
    fft_cuda.c2r_(spec, back)  # destroys spec
    print(f"{shape} {dtype}: r2c against torch.fft {r2c_gap:.3e}, c2r {_rel(back, want):.3e}")
    assert _rel(back, want) <= 1e-6
    assert _rel(back, x * (gy * gx)) <= 1e-5
    assert (fft_cuda.r2c_cuda.launches, fft_cuda.c2r_cuda.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert fft_cuda.r2c_plain.cuda_calls == fft_cuda.c2r_plain.cuda_calls == 0


@pytest.mark.parametrize("case", ["small", "chunks", "init", "biggs", "ragged"])
def test_fft2z_kernel_path_matches_plain(cuda, monkeypatch, case):
    """``rl_fft2z`` on the plans and kernels after RL-5: within 1e-5 of the
    same loop with the four operations' plain versions (the band kernel in
    both), and of ``plain=True`` (the plain band too; with Biggs, whose
    bf16 state turns the band's float32 reordering into bf16 steps, by the
    two-tier gate). One chunk, several, a warm start, Biggs, and a chunk
    that does not divide the grid's z. The kernel path counts two
    transforms each way and one launch of each kernel a chunk an
    iteration, the plain versions as many calls."""
    from shrimpy_tpu_torch.ops import fft_cuda
    from shrimpy_tpu_torch.ops.deconv import _padded_grid_shape
    from shrimpy_tpu_torch.ops.rl_fft import rl_fft2z

    img = _rand((12, 40, 44), 63, cuda, 0.0, 100.0)
    psf = tilted_gaussian_psf((7, 9, 9))
    psf = psf / psf.sum()
    grid, pads = _padded_grid_shape(tuple(img.shape), psf.shape)
    z_chunk = {"small": grid[0], "chunks": 4, "ragged": 5}.get(case, 8)
    chunks = -(-grid[0] // z_chunk)
    s = deconvolve_settings(algorithm="fft", acceleration="biggs" if case == "biggs" else "none")
    init = _rand((12, 40, 44), 64, cuda, 1.0, 90.0) if case == "init" else None
    cuda_fns = (fft_cuda.r2c_cuda, fft_cuda.c2r_cuda, fft_cuda.ratio_cuda, fft_cuda.scale_cuda)
    want = [10 * chunks, 10 * chunks, 5 * chunks, 5 * chunks]

    def run(**kw):
        return rl_fft2z(img, psf, s, 5, grid=grid, pads=pads, z_chunk=z_chunk, init=init, **kw)

    _zero_fft_counts()
    out = run()
    torch.cuda.synchronize()
    assert [fn.launches for fn in cuda_fns] == want
    assert [fn.cuda_calls for fn in fft_cuda.PLAIN] == [0] * 4
    assert bool(torch.isfinite(out).all())
    monkeypatch.setattr(fft_cuda, "WRAPPERS", fft_cuda.PLAIN)
    mixed = run()
    monkeypatch.undo()
    assert [fn.cuda_calls for fn in fft_cuda.PLAIN] == want
    print(f"{case}: against the plain operations {_rel(out, mixed):.3e}")
    assert _rel(out, mixed) <= 1e-5
    ref = run(plain=True)
    assert [fn.cuda_calls for fn in fft_cuda.PLAIN] == [2 * w for w in want]
    _zero_fft_counts()
    if s.acceleration == "biggs":
        scale = float(ref.abs().max())
        diff = (out.double() - ref.double()).abs()
        assert float((diff <= 5e-4 * scale).double().mean()) >= 0.9999
        assert float(diff.max()) <= 2e-2 * scale
    else:
        assert _rel(out, ref) <= 1e-5


def test_cufft_work_area_comes_from_the_caching_allocator(cuda):
    """At the production chunk each plan needs a work area, and the
    allocator's count rises by at least that much while a transform runs,
    then falls back: cuFFT allocates none itself."""
    from shrimpy_tpu_torch.ops import fft_cuda

    x = torch.rand((8, 2916, 1920), device=cuda)
    spec = torch.empty((8, 2916, 961), dtype=torch.complex64, device=cuda)
    for kind, fn, args in ((fft_cuda.R2C, fft_cuda.r2c_cuda, (x, spec)),
                           (fft_cuda.C2R, fft_cuda.c2r_cuda, (spec, x))):
        _, work = fft_cuda.plan(kind, x)
        assert work > 0
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(*args)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before >= work
        assert torch.cuda.memory_allocated() == before


def test_kernel_library_shares_the_cufft_torch_loaded(cuda):
    """The kernel library links ``libcufft.so.11`` and the process maps one
    cuFFT: the copy PyTorch loaded, not a second one from the toolkit."""
    from pathlib import Path

    from shrimpy_tpu_torch.kernels.build import load_library
    from shrimpy_tpu_torch.ops import fft_cuda

    torch.fft.rfft2(torch.rand((2, 8, 8), device=cuda))
    load_library()
    x = torch.rand((1, 8, 8), device=cuda)
    fft_cuda.r2c_cuda(x, torch.empty((1, 8, 5), dtype=torch.complex64, device=cuda))
    torch.cuda.synchronize()
    maps = Path("/proc/self/maps").read_text().splitlines()
    cufft = {line.split()[-1] for line in maps if "libcufft" in line.split()[-1]}
    assert len(cufft) == 1, cufft


def test_phase_stage_on_card_matches_float64(cuda):
    from shrimpy_tpu_torch.config import phase_settings
    from shrimpy_tpu_torch.ops.phase import (
        apply_inverse_transfer_function,
        compute_transfer_function,
    )

    settings = phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.25})
    raw = _rand((1, 40, 24, 20), 62, cuda, 0.0, 100.0)
    full = reconstruct_settings(deskew=deskew_settings(px_to_scan_ratio=0.386),
                                phase=settings)
    out = build_reconstruct_step(full)(raw)
    ref = build_reconstruct_step(full, plain=True, dtype=torch.float64)(raw)
    assert out.is_cuda and _rel(out, ref) <= 1e-5
    stack = _rand((8, 32, 30), 63, cuda, 0.9, 1.1)
    tf = compute_transfer_function((8, 32, 30), settings.transfer_function)
    got = apply_inverse_transfer_function(stack, tf, settings.apply_inverse, z_padding=5)
    want = apply_inverse_transfer_function(stack, tf, settings.apply_inverse, z_padding=5,
                                           dtype=torch.float64)
    assert _rel(got, want) <= 1e-5


# --- Tracking (no kernel of the repository: PyTorch ops, held to float64) ---

TRACK_METHODS = {
    "pcc": {},
    "intensity_center_of_mass": {"roi_center": {"blur_sigma": 1.0, "background_percentile": 20.0}},
    "roi_center_pcc": {"roi_center": {"blob_sigma": 4.0}},
    "multiotsu_center_of_mass": {},
    "multiotsu_pcc": {"segmentation": {"otsu_sigma": 1.0}},
    # Around the first blob: deskewed (10, 158, 24) (raw (s, t, x) sits at
    # z = t sin 30, y = s / 0.386 + (t - 47) cos 30, x).
    "template_matching": {"template": {"slice_zyx": ((4, 16), (134, 182), (12, 36))}},
}


def _blobs(shape, centers, device):
    """Gaussian blobs (sigma (2, 3, 3), amplitude 200) on a flat background
    of 10. No noise: a blurred noise floor puts many voxels within float32
    roundoff of an Otsu threshold, and the float32 and float64 masks then
    differ there (0.027 px of centre in one of ten seeded volumes of
    (24, 372, 64) on the CPU)."""
    vol = torch.full(shape, 10.0, device=device)
    grids = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    for c in centers:
        g = [torch.exp(-0.5 * ((x - ci) / s) ** 2) for x, ci, s in zip(grids, c, (2.0, 3.0, 3.0))]
        vol += 200.0 * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
    return vol


def test_tracking_blur_on_card_is_float64_with_tf32_allowed(cuda):
    """The blur sets cuDNN's TF32 off itself: with the global flag on, the
    float32 blur is within 1e-6 of float64 (TF32 would give ~1e-3), and the
    flag is left as it was."""
    from shrimpy_tpu_torch.ops.features import gaussian_blur

    vol = _rand((20, 64, 48), 70, cuda, 0.0, 100.0)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for sigma in ((1.0, 2.0, 5.0), 5.0, (0.0, 3.0, 0.7)):
            got = gaussian_blur(vol, sigma)
            assert got.is_cuda and got.dtype == torch.float32
            assert _rel(got, gaussian_blur(vol, sigma, dtype=torch.float64)) <= 1e-6
            assert _rel(got.cpu(), gaussian_blur(vol.cpu(), sigma)) <= 1e-6
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_tracking_histogram_ops_on_card_match_cpu_and_float64(cuda):
    """Counts, percentiles and multi-Otsu thresholds on the card equal the
    CPU's (the same IEEE operations a step); against float64 within a bin."""
    from shrimpy_tpu_torch.ops.features import _histogram, histogram_percentile, multi_otsu

    vol = _blobs((24, 64, 56), [(12.0, 30.0, 20.0), (8.0, 12.0, 40.0)], cuda)
    vol += _rand(vol.shape, 71, cuda, 0.0, 10.0)
    for bins in (256, 4096):
        _, _, counts = _histogram(vol.reshape(-1), bins)
        _, _, cpu = _histogram(vol.cpu().reshape(-1), bins)
        assert torch.equal(counts.cpu(), cpu)
    span = float(vol.max() - vol.min())
    for q in (20.0, 50.0, 99.9):
        got = histogram_percentile(vol, q)
        assert got.is_cuda and float(got) == float(histogram_percentile(vol.cpu(), q))
        assert abs(float(got) - float(histogram_percentile(vol, q, dtype=torch.float64))) \
            <= span / 4096 * 1.001
    got = multi_otsu(vol)
    assert torch.equal(got.cpu(), multi_otsu(vol.cpu()))
    ref = multi_otsu(vol, dtype=torch.float64)
    assert float((got.double() - ref).abs().max()) <= span / 256 * 1.001


def test_tracking_ncc_com_pcc_and_focus_on_card_match_float64(cuda):
    from shrimpy_tpu_torch.engine.autofocus import focus_from_transverse_band, focus_power
    from shrimpy_tpu_torch.ops.features import center_of_mass
    from shrimpy_tpu_torch.ops.match import match_template, template_match_shift
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation

    g = np.random.default_rng(72)
    mov = torch.from_numpy(g.normal(size=(16, 48, 40)).astype(np.float32) * 10 + 50).to(cuda)
    tmpl = mov[3:9, 10:22, 5:17].clone()
    got = match_template(mov, tmpl)
    ref = match_template(mov, tmpl, dtype=torch.float64)
    assert got.is_cuda and float((got.double() - ref).abs().max()) <= 1e-4
    shifted = torch.roll(mov, (2, -3, 5), dims=(0, 1, 2))
    sl = ((3, 9), (10, 22), (5, 17))
    for ref_vol in (mov, mov.cpu()):  # the reference may stay on the host
        np.testing.assert_array_equal(template_match_shift(ref_vol, shifted, sl), (2, -3, 5))
    np.testing.assert_array_equal(phase_cross_correlation(mov, shifted), (2, -3, 5))
    np.testing.assert_array_equal(phase_cross_correlation(mov, shifted, dtype=torch.float64),
                                  (2, -3, 5))
    blobs = _blobs((24, 64, 56), [(14.5, 30.0, 20.0)], cuda)
    com = center_of_mass(blobs)
    assert float((com.double() - center_of_mass(blobs, dtype=torch.float64)).abs().max()) <= 1e-4
    stack = _rand((9, 96, 80), 74, cuda, 0.9, 1.1)
    power = focus_power(stack, pixel_size_um=0.116)
    assert _rel(power, focus_power(stack, pixel_size_um=0.116, dtype=torch.float64)) <= 1e-5
    assert focus_from_transverse_band(stack, pixel_size_um=0.116) == \
        focus_from_transverse_band(stack, pixel_size_um=0.116, dtype=torch.float64)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("method", list(TRACK_METHODS))
def test_tracker_on_card_matches_float64(cuda, method):
    """deskew (``csrc/deskew.cu``) then each method over a drifting raw
    stack with noise, against the same tracker in float64 (the plain
    deskew): integer shifts equal, centres of mass within 1e-3 px. The
    multi-Otsu methods against ``chip_smoke.py::track_otsu_reference``:
    float64 at the float32 run's bin pair, which must tie the float64
    objective's maximum (its best pairs lie within ~1e-6). References on
    the host, in pinned memory."""
    from shrimpy_tpu_torch.config import dynatrack_settings
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    cfg = dynatrack_settings(tracking_method=method, preprocessing=["deskew"],
                             deskew={"px_to_scan_ratio": 0.386}, **TRACK_METHODS[method])
    # The first two blobs make the template's pattern, which the third alone
    # does not repeat (NCC ignores amplitude, and the blobs are alike).
    raw0 = _blobs((160, 48, 64), [(70.0, 20.0, 24.0), (72.0, 24.0, 30.0), (90.0, 30.0, 36.0)],
                  cuda)
    gen = torch.Generator(device=cuda).manual_seed(75)
    raws = [torch.roll(raw0, (2 * t, 3 * t), dims=(0, 2))
            + torch.randn(raw0.shape, generator=gen, device=cuda) for t in range(3)]
    pre, pre64 = Preprocessor(cfg), Preprocessor(cfg, dtype=torch.float64)
    tracker, tracker64 = Tracker(cfg), Tracker(cfg, dtype=torch.float64)
    got, want = [], []
    for t, raw in enumerate(raws):
        deskew_cuda.launches = 0
        got.append(tracker.update(pre.tracking_stack(raw), t).shift_px_zyx)
        assert deskew_cuda.launches == 1
        want.append(tracker64.update(pre64.tracking_stack(raw), t).shift_px_zyx)
        assert deskew_cuda.launches == 1
    if method.startswith("multiotsu"):
        want, _ = _chip_smoke().track_otsu_reference(method, cfg, raws)
    for a, b in zip(got, want):
        if method.endswith("center_of_mass"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b)
    if method in ("pcc", "template_matching", "multiotsu_pcc"):
        np.testing.assert_allclose(got[2], [0.0, 4 / 0.386, 6.0], atol=1.0)
    for ref in tracker._references.values():
        assert ref.device.type == "cpu" and ref.is_pinned()


def test_position_loop_on_card_matches_cpu_run(cuda):
    """DynaTrack's closed loop (``tracking/position.py``) with the card's
    ``Preprocessor([deskew])`` and ``Tracker("pcc")`` on a small raw whose
    sample drifts (2 scan steps, 3 x px a timepoint), through
    ``chip_smoke.py``'s stage seam: every correction applied, no "updater
    failed" or "no baseline" record, one deskew launch a timepoint, and the
    stored positions those of the same loop on the CPU (the shifts are whole
    pixels, so the sums are the same numbers)."""
    from shrimpy_tpu_torch.config import dynatrack_settings
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.position import PositionStore, PositionUpdateManager
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    smoke = _chip_smoke()
    desk = deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386)
    scale = smoke.loop_raw_scale(desk)
    cfg = dynatrack_settings(tracking_method="pcc", preprocessing=["deskew"], deskew=vars(desk),
                             image_to_stage_matrix_xyz=smoke.loop_matrix(desk, scale))
    shape, drift = (160, 48, 64), (2, 0, 3)
    raw0 = _blobs(shape, [(70.0, 20.0, 24.0), (72.0, 24.0, 30.0), (90.0, 30.0, 36.0)], "cpu")
    noise = [torch.from_numpy(np.random.default_rng((75, t)).normal(0.0, 1.0, shape)
                              .astype(np.float32)) for t in range(5)]
    runs = {}
    for device in ("cpu", cuda):
        def sample(t, offset, device=device):
            raw = torch.roll(raw0, tuple(t * d - o for d, o in zip(drift, offset)), (0, 1, 2))
            return (raw + noise[t]).to(device)

        pre = Preprocessor(cfg, device=device)
        tracker = Tracker(cfg, scale_zyx_um=pre.tracking_scale_zyx(shape, scale), device=device)
        manager = PositionUpdateManager(
            PositionStore(), lambda st, t, p: tracker.update(pre.tracking_stack(st), t,
                                                             p).stage_shift_xyz)
        deskew_cuda.launches = 0
        try:
            with smoke.LoopLog() as log:
                runs[str(device)] = smoke.closed_loop(manager, sample, 5, scale)
        finally:
            manager.shutdown()
        assert not log.bad
        assert deskew_cuda.launches == (0 if device == "cpu" else 5)
    card, cpu = runs["cuda"], runs["cpu"]
    for a, b in zip(card, cpu):
        assert a["applied"] is True and b["applied"] is True and a["drained"]
        np.testing.assert_allclose(a["position_um"], b["position_um"], rtol=0, atol=1e-6)
    _, after = smoke.loop_residuals(card, drift)
    assert all(max(abs(v) for v in r) <= 1 for r in after[2:]), after


# Virtual staining: the nets of tests/test_torch_vs.py on the card.
VS_NETS = {
    "unet25d": {"architecture": "unet25d", "base_width": 8, "depth": 2, "in_slices": 3},
    "unext2": {"architecture": "unext2", "in_slices": 3,
               "arch_config": {"encoder_blocks": [1, 1], "dims": [8, 16]}},
    "unext2_stack": {"architecture": "unext2", "in_slices": 15, "window_step": 2,
                     "arch_config": {"encoder_blocks": [1, 1], "dims": [12, 24],
                                     "stem_kernel_z": 5, "out_stack_depth": 5}},
}
# bf16 against the float32 run of the same weights: the rounding of a net
# ~10 layers deep at these narrow widths (5e-2 of the scale on the CPU).
VS_BF16_RTOL = 1e-1


@pytest.mark.parametrize("name", list(VS_NETS))
def test_vs_predict_on_card_matches_float32_run(cuda, name):
    """bf16 ``predict`` on the card against the float32-compute run of the
    same weights on the card; that float32 run within 1e-4 of the CPU's,
    with TF32 allowed globally (the nets turn it off: TF32 would give
    ~1e-3); the outputs stay on the card."""
    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer

    stainer = VirtualStainer(vs_settings(**VS_NETS[name], batch_slices=4))
    vol = _rand((11, 64, 96), 80, cuda, 0.0, 5.0)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = stainer.predict(vol)
        stainer.model.compute_dtype = torch.float32
        ref = stainer.predict(vol)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True,
                                                                                            True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    cpu = stainer.predict(vol.cpu())
    for key in ("vs_nuclei", "vs_membrane"):
        assert got[key].is_cuda and got[key].shape == vol.shape
        assert _rel(got[key], ref[key]) <= VS_BF16_RTOL
        assert _rel(ref[key].cpu(), cpu[key]) <= 1e-4


class _VSWindows(torch.nn.Module):
    """A stand-in voxel-stack net: its window's centre planes as normalised
    (``tests/test_torch_vs.py::_Windows``)."""

    out_stack_depth = 5

    def forward(self, x):
        off = (x.shape[1] - self.out_stack_depth) // 2
        centre = x[:, off:off + self.out_stack_depth]
        return torch.stack([centre, -centre], 1)


@pytest.mark.parametrize("step", [1, 2, 5])
def test_infer_volume_stack_counts_on_card(cuda, step):
    """The window sums by ``index_add_`` on the card divide out to the
    normalised input plane for plane, every step up to d."""
    from shrimpy_tpu_torch.models.vsunet import infer_volume_stack

    vol = _rand((37, 16, 24), 81 + step, cuda)
    out = infer_volume_stack(_VSWindows(), vol, in_slices=9, out_stack_depth=5, step=step,
                             n_out=2, batch=4)
    norm = (vol - vol.mean()) / (vol.std(correction=0) + 1e-6)
    assert out.is_cuda and _rel(out[0], norm) <= 1e-6 and _rel(-out[1], norm) <= 1e-6


def test_vs_step_keeps_its_products_on_the_card(cuda):
    """``[phase, vs]`` on a card tensor and on a host array (which goes to
    the card): every product on the card, the VS products the size of the
    phase (reflect-padded to the net's multiple and cropped back)."""
    from shrimpy_tpu_torch.config import dynatrack_settings
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    cfg = dynatrack_settings(
        input_channel="BF", tracking_channel="vs_nuclei", preprocessing=["phase", "vs"],
        phase={"transfer_function": {"yx_pixel_size": 0.116, "z_pixel_size": 0.25}},
        virtual_staining=VS_NETS["unet25d"])
    pre = Preprocessor(cfg)
    raw = _rand((9, 30, 42), 82, cuda, 0.9, 1.1)
    for stack in (raw, raw.cpu().numpy()):
        out = pre(stack)
        assert set(out) == {"raw", "phase", "vs_nuclei", "vs_membrane"}
        assert all(v.is_cuda for v in out.values())
        assert out["vs_nuclei"].shape == out["phase"].shape == raw.shape
    assert pre.tracking_stack(raw).is_cuda


# Virtual-staining training (models/train.py) on the card.
TRAIN_BULK_SHARE, TRAIN_ADAM_MAX = 0.999, 1e-3  # tests/test_torch_train.py's gate


@pytest.mark.parametrize("name", ["unet25d", "unext2"])
def test_train_steps_on_card_match_the_cpu_float32_run(cuda, name):
    """Two AdamW steps (``models/train.py``'s ``adamw`` and ``train_step``)
    of the float32 net from the same seeded weights on the same batches:
    on the card (no TF32) and on the CPU, each loss within 1e-4 relative;
    the weights by the CPU tests' gate (99.9 % of each parameter within 1e-4
    of its max, all within 1e-3: Adam turns a near-zero gradient's rounding
    into a share of the learning rate)."""
    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models import train
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer

    settings = vs_settings(**VS_NETS[name], out_channels=["vs_nuclei"])
    rng = np.random.default_rng(83)
    batches = [(rng.standard_normal((3, 32, 32, 3), dtype=np.float32),
                rng.standard_normal((3, 32, 32, 1), dtype=np.float32)) for _ in range(2)]
    runs = {}
    for dev in ("cuda", "cpu"):
        stainer = VirtualStainer(settings, device=dev)
        model = stainer.model.to(dev).train()
        model.compute_dtype = torch.float32
        opt = train.adamw(model, 1e-2)
        losses = [float(train.train_step(model, opt, train.to_nchw(x, dev), train.to_nchw(y, dev)))
                  for x, y in batches]
        runs[dev] = (losses, {k: v.cpu() for k, v in model.state_dict().items()})
    (card, card_w), (cpu, cpu_w) = runs["cuda"], runs["cpu"]
    assert max(abs(a - b) / abs(b) for a, b in zip(card, cpu)) <= 1e-4
    for k, w in cpu_w.items():
        err = (card_w[k] - w).abs() / float(w.abs().max())
        assert float((err <= 1e-4).double().mean()) >= TRAIN_BULK_SHARE, k
        assert float(err.max()) <= TRAIN_ADAM_MAX, k


def test_measure_psf_on_card_matches_the_cpu(cuda, tmp_path):
    """``psf.py::measure_volume_psf`` of a light-sheet bead stack
    (``chip_smoke.bead_raw``, ``synthetic_ls_stack``'s beads) with the deskew
    kernel against the plain deskew on the CPU, then the same host code:
    equal bead counts, the PSF within 1e-5 of its max."""
    import chip_smoke
    from shrimpy_tpu_torch.psf import measure_volume_psf

    raw, _ = chip_smoke.bead_raw((120, 100, 96), 10, device="cpu")
    settings = deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386)
    scale = (0.116 / 0.386, 0.116, 0.116)
    reports = {dev: measure_volume_psf(raw.numpy(), scale, tmp_path / dev, geometry="lightsheet",
                                       deskew=settings, device=dev) for dev in ("cuda", "cpu")}
    assert reports["cuda"].n_beads == reports["cpu"].n_beads >= 2
    got, want = np.load(tmp_path / "cuda.npy"), np.load(tmp_path / "cpu.npy")
    assert np.abs(got - want).max() <= 1e-5 * want.max()


ENGINE_RAW = (120, 64, 160)  # raw (scan, tilt, x)
ENGINE_DRIFT = (2, 0, 3)  # raw px (scan, tilt, x) a timepoint
ENGINE_KEYS = ("0/0/000", "0/1/001")


def _engine_source(device: str):
    """``chip_smoke.MemorySource`` over two positions of seeded blobs, rendered
    at the raw voxels from their deskewed coordinates and drifting
    ENGINE_DRIFT a timepoint, two channels, noise of each volume's seed; the
    volumes made on the CPU and moved to ``device``."""
    import chip_smoke
    from shrimpy_tpu_torch.ops.deskew import _geometry

    g = _geometry(ENGINE_RAW, deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386))
    ns, nt, nx = ENGINE_RAW
    s = np.arange(ns, dtype=np.float64)[:, None, None]
    t = np.arange(nt, dtype=np.float64)[None, :, None]
    x = np.arange(nx, dtype=np.float64)[None, None, :]
    zd, yd = t * g["sin_t"], s / g["r"] + t * g["cos_t"] - g["y_offset"]
    bases = []
    for i in range(len(ENGINE_KEYS)):
        rng = np.random.default_rng(17 + i)
        raw = np.full(ENGINE_RAW, 100.0)
        for b in range(6):
            c = [m + rng.random() * (n - 2 * m)
                 for n, m in zip((g["nz_full"], g["ny"], nx), (6.0, 30.0, 20.0))]
            amp = 4000.0 if b == 0 else 500.0 + 1000.0 * rng.random()
            raw += amp * np.exp(-0.5 * (((zd - c[0]) / 2.0) ** 2 + ((yd - c[1]) / 4.0) ** 2
                                        + ((x - c[2]) / 4.0) ** 2))
        bases.append(raw.astype(np.float32))

    def render(p, t, c):
        i = ENGINE_KEYS.index(p)
        moved = np.roll(bases[i], tuple(t * d for d in ENGINE_DRIFT), axis=(0, 1, 2))
        noise = np.random.default_rng((i, t, c)).normal(0.0, 10.0, ENGINE_RAW)
        return torch.from_numpy((moved * (0.5 if c else 1.0) + noise).astype(np.float32)).to(
            device)

    scale = (0.116 / 0.386, 0.116, 0.116)
    return chip_smoke.MemorySource(render, (4, 2, *ENGINE_RAW), scale, ["LS", "GFP"],
                                   ENGINE_KEYS)


@pytest.mark.parametrize("matrix", ["minus_identity", "loop_matrix"])
def test_engine_on_card_matches_the_cpu(cuda, tmp_path, matrix):
    """``AcquisitionEngine(device="cuda")`` over a plan namespace
    (``config.acquisition_plan``) and ``chip_smoke.py``'s in-memory source and
    store, DynaTrack ``pcc`` after ``[deskew]`` (the deskew kernel, one launch
    an update): the journal's shifts and the stage positions equal those of
    the same run on the CPU (plain deskew), every volume written the one
    served."""
    import csv

    import chip_smoke

    deskew = deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386)
    scale = chip_smoke.loop_raw_scale(deskew)
    m = ([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]] if matrix == "minus_identity"
         else chip_smoke.loop_matrix(deskew, scale))
    runs = {}
    for dev in ("cuda", "cpu"):
        source = _engine_source(dev)
        store = chip_smoke.MemoryStore(dev)
        plan = chip_smoke.engine_plan(deskew, m, 4, ("LS", "GFP"))
        deskew_cuda.launches = 0
        out, records, stage, log = chip_smoke.run_engine(source, store, plan, dev,
                                                         tmp_path / dev)
        launches = deskew_cuda.launches
        assert not log.bad and all(f.result(timeout=0) is True for _, _, f in records["futures"])
        assert launches == (8 if dev == "cuda" else 0)
        written = {(p, t, c): d for (_, p), pos in store.positions.items()
                   for (t, c), d in pos.written.items()}
        assert written == {k: v[-1][1] for k, v in source.served.items()} and len(written) == 16
        with open(tmp_path / dev / "smoke_dynatrack_log.csv") as f:
            journal = [r[1:] for r in csv.reader(f)]
        runs[dev] = (journal, {k: stage.get(k).as_array() for k in ENGINE_KEYS})
    assert runs["cuda"][0] == runs["cpu"][0] and len(runs["cuda"][0]) == 9
    for k in ENGINE_KEYS:
        np.testing.assert_allclose(runs["cuda"][1][k], runs["cpu"][1][k], rtol=0, atol=1e-6)

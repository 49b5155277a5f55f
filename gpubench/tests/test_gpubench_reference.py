"""The float64 reference against the program's plain path at tiny
shapes (the test calls the program; the reference never does)."""

import numpy as np
import pytest
import torch

from gpubench import geometry, inputs, reference, spec
from shrimpy_tpu_torch.ops.deskew import deskew_plain
from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step


def _settings(config):
    from gpubench.cell import port_settings

    return port_settings(config)


def _raw(shape=(64, 16, 24), seed=3):
    params = spec.load_named("traffic", "ring4-closed")["raw"] | {"structures": 40}
    return inputs.camera_raw(shape, params, seed, "cpu")


def _config(name, **deconvolve):
    c = spec.load_named("configs", name)
    c["deconvolve"].update(iterations=4, **deconvolve)
    return c


@pytest.mark.parametrize("keep_overhang", [False, True])
@pytest.mark.parametrize("n_avg", [1, 3])
def test_deskew_against_the_program(keep_overhang, n_avg):
    c = _config("mantis-ls-sep")
    c["deskew"].update(keep_overhang=keep_overhang, average_n_slices=n_avg)
    raw = _raw()
    ref = reference.deskew(raw, c["deskew"])
    got = deskew_plain(raw, _settings(c).deskew, dtype=torch.float64)
    assert tuple(ref.shape) == geometry.deskewed_shape(raw.shape, c["deskew"])
    assert reference.max_rel_err(got, ref) < 1e-12


PSFS = {
    "gaussian": {"kind": "gaussian", "shape_zyx": [3, 5, 5], "sigma_zyx": [0.8, 1.2, 1.5]},
    "tilted": {"kind": "tilted_gaussian", "shape_zyx": [5, 9, 9], "shears": [0.9, 0.8],
               "sigma_zyx": [1.0, 1.5, 2.5]},
}


@pytest.mark.parametrize("psf, algorithm, pad_mode", [
    ("gaussian", "auto", "reflect"), ("gaussian", "auto", "constant"),
    ("gaussian", "fft", "reflect"), ("tilted", "fft", "reflect"), ("tilted", "fft", "edge"),
    ("lopsided", "auto", "reflect"),
])
def test_step_against_the_program(psf, algorithm, pad_mode):
    """The separable route in float64 (the program's taps are float32:
    1e-6), the FFT route in float32 (PyTorch's CPU inverse transform in
    double precision is unsound): a wrong boundary, grid or orientation
    is off by far more."""
    c = _config("mantis-ls-sep", algorithm=algorithm, pad_mode=pad_mode)
    if psf == "lopsided":  # rank 1 but not symmetric: fixes the convolution's orientation
        p = np.einsum("z,y,x->zyx", [0.2, 0.5, 0.3], [0.1, 0.2, 0.4, 0.2, 0.1],
                      [0.05, 0.1, 0.5, 0.25, 0.1]).astype(np.float32)
    else:
        p = inputs.make_psf(PSFS[psf])
    raw = _raw()
    dtype = torch.float32 if algorithm == "fft" else torch.float64
    step = build_reconstruct_step(_settings(c), psf=p, device="cpu", plain=True, dtype=dtype)
    got = step(raw[None], None)[0]
    ref = reference.reconstruct(raw, p, c)
    assert reference.max_rel_err(got, ref) < (1e-5 if algorithm == "fft" else 1e-6)


def test_float32_program_and_bf16_control_against_the_reference():
    c = _config("mantis-ls-sep")
    p = inputs.make_psf(PSFS["gaussian"])
    raw = _raw(seed=8)
    ref = reference.reconstruct(raw, p, c)
    got = build_reconstruct_step(_settings(c), psf=p, device="cpu")(raw[None], None)[0]
    control = reference.reconstruct(raw, p, c, torch.float32, torch.bfloat16)
    assert reference.max_rel_err(got, ref) < 1e-5
    assert reference.max_rel_err(control, ref) > 1e-3


def test_max_rel_err():
    a = torch.tensor([1.0, 2.0, 4.0])
    assert reference.max_rel_err(a, a.double()) == 0
    assert reference.max_rel_err(a + torch.tensor([0, 0.04, 0]), a) == pytest.approx(0.01)
    assert reference.max_rel_err(torch.tensor([1.0, float("nan"), 4.0]), a) == float("inf")
    assert reference.max_rel_err(a[:2], a) == float("inf")

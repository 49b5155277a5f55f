"""The port's public entry points take JAX's keywords.

For every public function or class of a ``shrimpy_tpu_torch`` module whose
counterpart in the same ``shrimpy_tpu`` module has the same name, the
parameter names (in order) must be JAX's, once a named list of the port's
own extras is set aside. Each allowance carries its reason; an allowance
that no longer matches a difference fails the gate too, so the list cannot
go stale. Also the two entry points that rejected JAX's keywords (ROADMAP
queue 3, F3): ``build_reconstruct_step(..., donate=False)`` and
``deskew_volume(raw_szx=..., settings=...)``, each against JAX's output.
"""

import importlib
import inspect
import pkgutil

import jax
import numpy as np
import pytest
import torch

import shrimpy_tpu_torch

torch.set_num_threads(1)

# Parameters any port entry point may add: where it runs and in what
# precision, the plain reference path, a precomputed separable plan, a
# stage timer.
PORT_EXTRAS = {"device", "dtype", "plain", "terms", "timer"}

# (module below the package, name) -> (the port's extra parameters, JAX's
# parameters the port does not take, why).
ALLOWED = {
    **{("ops.deconv", f): ({"donate"}, set(), "donate_input: the image is consumed once the "
                                               "carries exist (rl_fused.py::consume)")
       for f in ("rl_separable", "rl_hybrid")},
    ("ops.rl_fused", "rl_fused"): ({"donate"}, set(), "donate_input's consume"),
    ("ops.rl_fused_iter", "rl_fused_iter"): ({"donate"}, set(), "donate_input's consume"),
    ("models.vsunet", "VSUNet"): ({"in_slices", "compute_dtype"}, {"parent", "name"},
                                  "a torch.nn.Module builds its layers from its input depth "
                                  "and precision; flax's module tree names are not modules"),
    ("models.vsunet", "VSUNeXt2"): ({"in_slices"}, {"parent", "name"},
                                    "the torch net's stem is sized at build time"),
    ("ops.rl_fused_iter", "iter_layout"): ({"tile"}, {"bz", "bx"},
                                           "the card's (ty, tx) tile in place of the TPU's "
                                           "z and x block"),
    ("parallel.mesh", "init_distributed"): ({"backend"}, set(),
                                            "torch.distributed's backend: NCCL on the cards, "
                                            "gloo on the CPU or for ranks that share a card"),
    ("parallel.mesh", "Mesh"): ({"rank", "backend", "groups"}, {"axis_types"},
                                "one process a device: the mesh holds this rank, the backend "
                                "and the process groups of its axes; torch has no axis types"),
}

# The mesh slice's entry points, each among the pairs checked.
MESH_NAMES = {("parallel.mesh", "init_distributed"), ("parallel.mesh", "make_mesh"),
              ("parallel.mesh", "Mesh"), ("parallel.fft", "fft3_sharded"),
              ("parallel.fft", "ifft3_sharded"), ("parallel.pipeline", "build_reconstruct_step"),
              ("parallel.pipeline", "reconstruct_batch")}


def _public_pairs():
    """(module suffix, name, port object, JAX object) for every public
    function or class the port defines whose JAX module has one of the
    same name."""
    pairs = []
    for info in pkgutil.walk_packages(shrimpy_tpu_torch.__path__, "shrimpy_tpu_torch."):
        suffix = info.name[len("shrimpy_tpu_torch."):]
        port = importlib.import_module(info.name)
        try:
            ref = importlib.import_module(f"shrimpy_tpu.{suffix}")
        except ModuleNotFoundError:
            continue
        for name, obj in vars(port).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != info.name:
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            other = getattr(ref, name, None)
            if inspect.isfunction(other) or inspect.isclass(other):
                pairs.append((suffix, name, obj, other))
    return pairs


def _has_signature(obj) -> bool:
    """False for a class with no Python signature of its own (an exception
    class such as ``engine.control.AbortRun`` takes ``BaseException``'s)."""
    try:
        inspect.signature(obj)
    except ValueError:
        return False
    return True


def test_every_shared_entry_point_takes_jax_s_parameter_names():
    pairs = _public_pairs()
    assert len(pairs) >= 25, [p[:2] for p in pairs]
    assert MESH_NAMES <= {p[:2] for p in pairs}
    used, wrong = set(), []
    for suffix, name, obj, other in pairs:
        if not (_has_signature(obj) and _has_signature(other)):
            if _has_signature(obj) or _has_signature(other):
                wrong.append((f"{suffix}.{name}", "one side has no signature"))
            continue
        extra, missing, _ = ALLOWED.get((suffix, name), (set(), set(), ""))
        full_ours = set(inspect.signature(obj).parameters)
        full_theirs = set(inspect.signature(other).parameters)
        # An extra is the port's only where JAX's entry lacks it.
        ours = [p for p in inspect.signature(obj).parameters
                if p in full_theirs or p not in PORT_EXTRAS | extra]
        theirs = [p for p in inspect.signature(other).parameters if p not in missing]
        if ours != theirs:
            wrong.append((f"{suffix}.{name}", ours, theirs))
        if (suffix, name) in ALLOWED and (extra <= full_ours - full_theirs
                                          and missing <= full_theirs - full_ours):
            used.add((suffix, name))
    assert not wrong, wrong
    assert used == set(ALLOWED), f"allowances that match no difference: {set(ALLOWED) - used}"


def _raw(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 100).astype(np.float32)


def test_deskew_volume_takes_raw_szx_as_jax_does():
    from shrimpy_tpu.config.schemas import DeskewSettings
    from shrimpy_tpu.ops.deskew import deskew_volume as jax_deskew

    from shrimpy_tpu_torch.config import deskew_settings
    from shrimpy_tpu_torch.ops.deskew import deskew_volume

    raw = _raw((40, 32, 24), 1)
    ours = deskew_volume(raw_szx=raw, settings=deskew_settings(px_to_scan_ratio=0.386),
                         device="cpu")
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax_deskew(raw_szx=raw,
                                    settings=DeskewSettings(px_to_scan_ratio=0.386)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("donate", [False, True])
def test_build_reconstruct_step_takes_donate_and_leaves_the_batch_intact(donate):
    """``donate`` as JAX's keyword: the step's output is JAX's (whose own
    callers pass ``donate=False``), and under both values the caller's
    batch is neither written nor emptied, so it can be deskewed again."""
    from shrimpy_tpu.config.schemas import (
        DeconvolveSettings,
        DeskewSettings,
        ReconstructSettings,
    )
    from shrimpy_tpu.ops.deconv import gaussian_psf
    from shrimpy_tpu.parallel.pipeline import build_reconstruct_step as jax_build

    from shrimpy_tpu_torch.config import (
        deconvolve_settings,
        deskew_settings,
        reconstruct_settings,
    )
    from shrimpy_tpu_torch.ops.deskew import deskew_volume
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    psf = np.asarray(gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5)))
    raw = _raw((2, 40, 16, 24), 2)
    settings = reconstruct_settings(deskew=deskew_settings(px_to_scan_ratio=0.386),
                                    deconvolve=deconvolve_settings(
                                        iterations=2, separable_backend="linear_pallas"))
    batch = torch.from_numpy(raw.copy())
    out = build_reconstruct_step(settings, psf=psf, device="cpu", donate=donate)(batch)
    assert torch.equal(batch, torch.from_numpy(raw))
    again = deskew_volume(batch[1], settings.deskew)
    assert again.shape == out.shape[1:]
    jset = ReconstructSettings(deskew=DeskewSettings(px_to_scan_ratio=0.386),
                               deconvolve=DeconvolveSettings(
                                   iterations=2, separable_backend="linear_pallas"))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax_build(jset, psf=psf, donate=False)(raw, np.zeros((1, 1, 1))))
    assert out.shape == ref.shape
    assert float(np.abs(out.numpy() - ref).max() / np.abs(ref).max()) <= 1e-4

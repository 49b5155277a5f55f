"""PyTorch port of the dual-arm session (ROADMAP item 12c) against the JAX
package (CPU).

``shrimpy_tpu_torch/engine/dual.py`` is JAX's ``engine/dual.py`` but for the
``device`` it hands to every arm's engine
(``tests/test_torch_config.py::test_dual_is_the_original_but_for_device``).
Here the JAX tests of it (``tests/test_dual.py``: the shared stage, a
tracking arm moving the passive one, the barrier's stall abort, the family
auto-increment, one shared instrument and the config's checks) run on both
packages, the port's arms on the CPU.
"""

import json
import time

import numpy as np
import pytest
import torch

from tests.acq_pkgs import PACKAGES, Pkg, package_logging  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


def _blob_source(pkg, path, *, drift=(0.0, 0.0, 0.0), n_t=3, noise=0.0):
    pkg("io.synthetic").synthetic_blob_fov(path, shape_zyx=(8, 48, 48), n_timepoints=n_t,
                                           drift_zyx=drift, noise=noise,
                                           zyx_scale=(1.0, 1.0, 1.0))
    return pkg.source(path)


def _read(pkg, path):
    return pkg("io.ngff").open_ngff(path).position().read()


def test_preseeded_shared_stage_offsets_every_arm(pkg, tmp_path):
    """A stage position set before the run shifts both arms' volumes, to
    the voxel."""
    src_a = _blob_source(pkg, tmp_path / "a.zarr")
    src_b = _blob_source(pkg, tmp_path / "b.zarr")
    plan = pkg.plan(time={"n_timepoints": 2})
    session = pkg.dual({"lf": (src_a, plan), "ls": (src_b, plan.model_copy(deep=True))},
                       barrier_timeout_s=30.0)
    session.stage.set("0", 5.0, 3.0, 0.0)  # x=5, y=3, z=0 um at 1 um a px
    results = session.run(tmp_path / "out", "dual")
    assert all(r.error is None for r in results.values()), results
    for arm, src in [("lf", src_a), ("ls", src_b)]:
        data = _read(pkg, tmp_path / "out" / f"dual_{arm}.zarr")
        np.testing.assert_array_equal(data[0, 0], src.volume("0", 0, 0, offset_px_zyx=(0, 3, 5)))
    summary = json.loads((tmp_path / "out" / "dual_dualarm_summary.json").read_text())
    assert summary["stage_final_um"]["0"] == [5.0, 3.0, 0.0]
    assert set(summary["arms"]) == {"lf", "ls"}


def test_tracking_arm_moves_the_passive_arm(pkg, tmp_path):
    """DynaTrack on one arm corrects the drift; the other arm, with no
    tracking of its own, follows the same stage."""
    ls = _blob_source(pkg, tmp_path / "ls.zarr", drift=(0.0, 0.0, -6.0), n_t=4, noise=0.5)
    lf = _blob_source(pkg, tmp_path / "lf.zarr", n_t=4)
    track_plan = pkg.plan(time={"n_timepoints": 4}, metadata={"dynatrack": {
        "input_channel": "BF", "tracking_channel": "BF", "tracking_method": "pcc",
        "image_to_stage_matrix_xyz": [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]]}})
    session = pkg.dual({"ls": (ls, track_plan), "lf": (lf, pkg.plan(time={"n_timepoints": 4}))},
                       barrier_timeout_s=60.0)
    results = session.run(tmp_path / "out", "dual")
    assert all(r.error is None for r in results.values()), results
    stage = session.stage.get("0")
    assert stage is not None and abs(stage.x) > 2.0
    data = _read(pkg, tmp_path / "out" / "dual_lf.zarr")
    peak0 = np.unravel_index(np.argmax(data[0, 0]), data[0, 0].shape)
    peak3 = np.unravel_index(np.argmax(data[3, 0]), data[3, 0].shape)
    assert peak0[2] == 24
    dx = peak3[2] - peak0[2]
    assert dx != 0 and np.sign(dx) == -np.sign(stage.x)
    assert abs(abs(dx) - abs(round(stage.x))) <= 6


def test_stalled_arm_aborts_every_arm(pkg, tmp_path):
    src_a = _blob_source(pkg, tmp_path / "a.zarr", n_t=3)
    src_b = _blob_source(pkg, tmp_path / "b.zarr", n_t=3)
    plan = pkg.plan(time={"n_timepoints": 3})

    def stall_hook(vol, t, p, channel):
        if t == 1:
            time.sleep(2.0)

    session = pkg.dual({"fast": (src_a, plan), "slow": (src_b, plan.model_copy(deep=True))},
                       barrier_timeout_s=0.4, viewer_hooks={"slow": [stall_hook]})
    results = session.run(tmp_path / "out", "dual")
    assert results["fast"].error is not None
    assert results["slow"].error is not None
    summary = json.loads((tmp_path / "out" / "dual_dualarm_summary.json").read_text())
    assert all(a["error"] for a in summary["arms"].values())


def test_family_auto_increment_moves_arms_together(pkg, tmp_path):
    src_a = _blob_source(pkg, tmp_path / "a.zarr", n_t=2)
    src_b = _blob_source(pkg, tmp_path / "b.zarr", n_t=2)
    plan = pkg.plan(time={"n_timepoints": 2})

    def make():
        return pkg.dual({"lf": (src_a, plan), "ls": (src_b, plan.model_copy(deep=True))},
                        barrier_timeout_s=30.0)

    r1 = make().run(tmp_path / "out", "dual")
    r2 = make().run(tmp_path / "out", "dual")
    assert r1["lf"].output.endswith("dual_lf.zarr")
    assert r2["lf"].output.endswith("dual_lf_1.zarr")
    assert r2["ls"].output.endswith("dual_ls_1.zarr")


def test_dual_arms_share_one_hardware_instrument(pkg, tmp_path):
    """Both arms drive one laser port: the emulator's lock keeps the two
    engines' round trips intact, and both device journals land."""
    bus = pkg("devices.bus")
    bus.unbind_all()
    src_a = _blob_source(pkg, tmp_path / "a.zarr")
    src_b = _blob_source(pkg, tmp_path / "b.zarr")

    def hw_plan():
        return pkg.plan(time={"n_timepoints": 3}, hardware={
            "enabled": True, "lasers": [{"channel": "BF", "wavelength_nm": 488,
                                         "power_mw": 12.0, "port": "COM-shared"}]})

    try:
        results = pkg.dual({"lf": (src_a, hw_plan()), "ls": (src_b, hw_plan())},
                           barrier_timeout_s=30.0).run(tmp_path / "out", "dual")
    finally:
        bus.unbind_all()
    assert all(r.error is None for r in results.values()), results
    for arm in ("lf", "ls"):
        summary = json.loads((tmp_path / "out" / f"dual_{arm}_summary_metadata.json").read_text())
        hw = summary["hardware"]
        assert hw is not None and not hw["aborted"]
        assert hw["lasers"]["BF"]["port"] == "COM-shared"
        kinds = [e[0] for e in hw["events"]]
        assert "laser_on" in kinds and "shutter_reset" in kinds


def test_dual_config_validation(pkg):
    dual = pkg("engine.dual")
    with pytest.raises(ValueError, match="at least two"):
        dual.DualReplayConfig(arms={"only": dual.ArmConfig(input="x.zarr")})
    with pytest.raises(ValueError, match="timepoint"):
        dual.DualReplayConfig(arms={
            "a": dual.ArmConfig(input="a.zarr", plan=pkg.plan(time={"n_timepoints": 2})),
            "b": dual.ArmConfig(input="b.zarr", plan=pkg.plan(time={"n_timepoints": 3})),
        })

"""The CLI's verbs as ``chip_smoke.py`` phase 4v runs them, on the CPU.

* **Store-mode ``monitor`` without matplotlib.** The card's machine has no
  matplotlib; the port's ``monitor`` then draws no PNG, logs the
  ``ImportError`` and prints the status line the JAX verb prints.
* **4v's chain at a small size.** ``chip_smoke.py``'s own pieces (the store
  builder ``verb_inputs``, the YAMLs of ``verb_configs``, the command lines
  of ``verb_runs`` and ``run_cli``) drive the port's CLI with ``--device
  cpu`` and the JAX CLI on the same stores: measure-psf, register,
  reconstruct with the measured PSF and with the transform, track, replay
  and replay-dual, each link a case of one parametrised test. The smoke's
  replay checks (``stage_offsets``, ``replayed_as_served``) run on the
  port's outputs.
* **The device rule.** Every verb that computes exits non-zero naming
  ``torch.cuda.is_available()`` and writes nothing when the card is
  missing and ``--device`` is left at its default.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import chip_smoke
from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.io.ngff import create_fov
from shrimpy_tpu_torch.io.synthetic import synthetic_ls_stack
from tests.test_torch_replay import _same_outputs
from tests.test_torch_tracking import _rows_match

torch.set_num_threads(1)

N_T = 3  # the replay's third frame is the first a correction moves
BEAD_RAW, N_BEADS = (120, 100, 96), 10  # tests/test_torch_psf.py's: the (31, 41, 41) patch fits
REG_SHAPE = (16, 48, 48)
RAW = (40, 24, 64)  # the raw both reconstructs deskew
SESSION_RAW = (24, 24, 48)  # (scan, tilt, x) of the tracked session
LF_FRAME = (8, 32, 32)  # the label-free arm's frames
PSF_RTOL = 1e-5  # tests/test_torch_psf.py's budget against JAX's PSF
MAP_ATOL = 1e-4  # tests/test_torch_register.py's budget against JAX's map
RECON_RTOL = 1e-4  # the port's budget against JAX's step (tests/test_torch_chunkstore.py)
MATMUL = "  separable_backend: matmul\n"  # JAX's auto off the TPU; the port's is fused


def _blobs(shape, centers, rng, sigma=2.0, amp=400.0, background=100.0, noise=5.0):
    grid = np.indices(shape, dtype=np.float64)
    vol = np.full(shape, background) + rng.normal(0.0, noise, shape)
    for c in centers:
        vol += amp * np.exp(-0.5 * sum((g - x) ** 2 for g, x in zip(grid, c)) / sigma ** 2)
    return vol


def _data() -> dict:
    """Small inputs for every store of ``verb_inputs`` (``bf`` and ``pairs``
    written but not run: phase and train-vs are not in the chain)."""
    rng = np.random.default_rng(23)
    beads, _ = synthetic_ls_stack(raw_shape_szx=BEAD_RAW, n_beads=N_BEADS, seed=3)
    fixed = _blobs(REG_SHAPE, [(5, 14, 20), (9, 30, 12), (11, 24, 36)], rng).astype(np.float32)
    base = _blobs(SESSION_RAW, [(8, 10, 14), (14, 14, 30), (18, 8, 22)], rng)
    return {
        "beads": beads.astype(np.float32),
        "lf": fixed,
        "ls": np.roll(fixed, (1, -2, 3), axis=(0, 1, 2)),
        "cfg2_raw": (rng.random(RAW) * 100).astype(np.float32),
        "session": [np.roll(base, (2 * t, 0, 3 * t), axis=(0, 1, 2)).round().astype(np.uint16)
                    for t in range(N_T)],
        "lf_session": [rng.integers(900, 1100, LF_FRAME, dtype=np.uint16) for _ in range(N_T)],
        "bf": rng.random(LF_FRAME, dtype=np.float32),
        "pairs": [rng.standard_normal(LF_FRAME, dtype=np.float32) for _ in range(2)],
    }


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """4v's links run by both CLIs on the same stores: the port through
    ``chip_smoke.run_cli`` with ``--device cpu``, JAX through its CLI. The
    reconstructs of both read the port's PSF and transform."""
    tmp = tmp_path_factory.mktemp("verbs")
    (tmp / "in").mkdir()
    inputs = chip_smoke.verb_inputs(tmp / "in", _data())
    paths = {**inputs["paths"], "raw1": inputs["paths"]["cfg2_raw"]}
    cfgs = chip_smoke.verb_configs(tmp / "in", tmp / "torch" / "psf.npy",
                                   tmp / "torch" / "transform.json", N_T, deconvolve=MATMUL)
    links = ("a", "b", "c", "d", "i", "h", "j")
    runs = {"torch": chip_smoke.verb_runs(tmp / "torch", paths, cfgs, device="cpu"),
            "jax": chip_smoke.verb_runs(tmp / "jax", paths, cfgs)}
    out = {"tmp": tmp, "paths": paths, "runs": runs, "jax": {}}
    for name in ("torch", "jax"):
        (tmp / name).mkdir()
    out["torch"], _ = chip_smoke.run_cli([(args, None) for k in links
                                          for args in runs["torch"][k]])
    for k in links:
        for args in runs["jax"][k]:
            result = CliRunner().invoke(jax_cli, args)
            assert result.exit_code == 0, (args, result.output)
            out["jax"][tuple(args)] = result.stdout
    return out


def _store(path):
    from shrimpy_tpu_torch.io.ngff import open_ngff

    return open_ngff(path).position().read()


def _measure_psf(tmp, chain):
    got = json.loads(chain["torch"][0]["out"])
    want = chain["jax"][tuple(chain["runs"]["jax"]["a"][0])]
    want = json.loads(want[want.index("{"):])
    assert got["n_beads"] == want["n_beads"] > 0 and got["shape"] == want["shape"]
    wpsf, gpsf = np.load(tmp / "jax" / "psf.npy"), np.load(tmp / "torch" / "psf.npy")
    assert np.abs(gpsf - wpsf).max() <= PSF_RTOL * wpsf.max()


def _register(tmp, chain):
    got, want = (json.loads((tmp / name / "transform.json").read_text())
                 for name in ("torch", "jax"))
    assert list(got) == list(want)
    for key in ("matrix_zyx", "offset_zyx", "translation_seed_zyx"):
        np.testing.assert_allclose(got[key], want[key], atol=MAP_ATOL)
    np.testing.assert_allclose(got["translation_seed_zyx"], [1.0, -2.0, 3.0], atol=0.5)


def _reconstruct(tmp, chain):
    for store in ("cfg2.zarr", "cfg4.zarr"):
        got, want = _store(tmp / "torch" / store), _store(tmp / "jax" / store)
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= RECON_RTOL * np.abs(want).max(), store
    # The transform was applied: (d) differs from a run without it, (c).
    assert not np.array_equal(_store(tmp / "torch" / "cfg4.zarr"), _store(tmp / "torch" /
                                                                          "cfg2.zarr"))


def _track(tmp, chain):
    from shrimpy_tpu.tracking import core as jcore
    from shrimpy_tpu_torch.tracking import core

    for csv_name in ("shifts.csv", "shifts_deskew.csv"):
        ours = core.ShiftJournal(tmp / "torch" / csv_name).rows()
        assert len(ours) == N_T
        _rows_match(ours, jcore.ShiftJournal(tmp / "jax" / csv_name).rows(), 0.0)
    shifts = chip_smoke.journal_shifts(chip_smoke.journal_rows(tmp / "torch" / "shifts.csv"))
    baked = [[2.0 * t, 0.0, 3.0 * t] for t in range(N_T)]
    assert np.abs(np.array(shifts) - baked).max() <= chip_smoke.DRIFT_ATOL


def _replay(tmp, chain):
    _same_outputs(tmp, ["replay/demo.zarr"],
                  ["replay/demo_summary_metadata.json", "replay/demo_dynatrack_log.csv"])
    rows = chip_smoke.journal_rows(tmp / "torch" / "replay" / "demo_dynatrack_log.csv")
    offsets = chip_smoke.stage_offsets(rows, chip_smoke.loop_raw_scale(
        chip_smoke.headline_settings().deskew), N_T)
    # The frames before the first correction as stored; the third moved.
    assert offsets[:2] == [(0, 0, 0)] * 2 and any(offsets[2])
    moved = chip_smoke.replayed_as_served(chip_smoke.store_frames(chain["paths"]["session"], "cpu"),
                                          tmp / "torch" / "replay" / "demo.zarr", offsets)
    assert moved == offsets[2:]
    track = chip_smoke.journal_shifts(chip_smoke.journal_rows(tmp / "torch" / "shifts.csv"))
    shifts = chip_smoke.journal_shifts(rows)
    assert shifts[:2] == track[:2]
    assert np.abs(np.array(shifts[2]) - (np.array(track[2]) - offsets[2])).max() \
        <= chip_smoke.DRIFT_ATOL


def _replay_dual(tmp, chain):
    """The tracking arm's store and every sidecar equal JAX's; the label-free
    arm shares the stage and reads it at its own pace (before or after the
    tracking arm's update of the same timepoint lands, in either package),
    so each package's is held to the smoke's check instead."""
    _same_outputs(tmp, ["dual/session_lightsheet.zarr"],
                  ["dual/session_labelfree_summary_metadata.json",
                   "dual/session_lightsheet_summary_metadata.json",
                   "dual/session_lightsheet_dynatrack_log.csv",
                   "dual/session_dualarm_summary.json"])
    for name in ("torch", "jax"):
        rows = chip_smoke.journal_rows(tmp / name / "dual" / "session_lightsheet_dynatrack_log.csv")
        summary = json.loads((tmp / name / "dual" / "session_dualarm_summary.json").read_text())
        (final,) = summary["stage_final_um"].values()
        np.testing.assert_allclose(final, chip_smoke.stage_position(rows), rtol=0,
                                   atol=chip_smoke.JOURNAL_UM_ATOL * N_T)
        for arm, scale in (("labelfree", chip_smoke.VERB_PHASE_SCALE),
                           ("lightsheet", chip_smoke.loop_raw_scale(
                               chip_smoke.headline_settings().deskew))):
            src = chain["paths"]["lf_session" if arm == "labelfree" else "session"]
            later = chip_smoke.stage_offsets(rows, scale, N_T, lag=1) if arm == "labelfree" \
                else None
            chip_smoke.replayed_as_served(chip_smoke.store_frames(src, "cpu"),
                                          tmp / name / "dual" / f"session_{arm}.zarr",
                                          chip_smoke.stage_offsets(rows, scale, N_T), later)


LINKS = {"measure-psf": _measure_psf, "register": _register, "reconstruct": _reconstruct,
         "track": _track, "replay": _replay, "replay-dual": _replay_dual}


@pytest.mark.parametrize("link", list(LINKS))
def test_chain_link_matches_the_jax_cli(chain, link):
    """One link of 4v's chain: the port's outputs against the JAX CLI's on
    the same stores (PSF within PSF_RTOL of its max, map within MAP_ATOL,
    reconstructs within RECON_RTOL of the max, journals, replayed stores and
    sidecars equal), and the smoke's own checks of the link on the port's."""
    LINKS[link](chain["tmp"], chain)


def test_chain_runs_write_what_4v_reads(chain):
    """The verbs printed what 4v parses: the PSF report and the replay's
    store path."""
    by_verb = {r["args"][0]: r for r in chain["torch"]}
    assert json.loads(by_verb["measure-psf"]["out"])["n_beads"] > 0
    assert by_verb["replay"]["out"].strip().splitlines()[-1] == str(
        chain["tmp"] / "torch" / "replay" / "demo.zarr")
    assert json.loads(by_verb["plan"]["out"]) == {"valid": True,
                                                   "plan": chain["runs"]["torch"]["h"][0][2]}
    assert all(r["launches"] == {} and r["peak_gib"] == 0.0 for r in chain["torch"])


# -- store-mode monitor without matplotlib -------------------------------------------------

def test_monitor_without_matplotlib_prints_the_jax_status(tmp_path, monkeypatch):
    """A growing store (tests/test_torch_replay.py's): the JAX verb with its
    matplotlib draws its PNG; the port's with matplotlib unimportable exits
    0, prints the same status line, logs the ImportError and writes no PNG."""
    pos = create_fov(tmp_path / "grow.zarr", shape=(5, 1, 4, 16, 16), dtype="float32",
                     channel_names=["c"], zyx_scale=(1.0, 1.0, 1.0))
    pos.write((0, 0), np.ones((4, 16, 16), np.float32))
    pos.write((2, 0), np.ones((4, 16, 16), np.float32))
    args = ["monitor", str(tmp_path / "grow.zarr"), "--once", "--preview-dir"]
    want = CliRunner().invoke(jax_cli, [*args, str(tmp_path / "jax")])
    assert want.exit_code == 0, want.output
    assert (tmp_path / "jax" / "0.png").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = CliRunner().invoke(cli, [*args, str(tmp_path / "torch")])
    assert got.exit_code == 0, got.output
    status = json.loads(got.stdout.strip().splitlines()[-1])
    assert status == json.loads(want.stdout.strip().splitlines()[-1]) \
        == {"0": {"timepoints_written": 2, "latest": 2, "of": 5}}
    assert "no preview PNGs" in got.stderr
    assert not list((tmp_path / "torch").glob("*.png"))


def test_monitor_without_matplotlib_still_serves_its_state(tmp_path, monkeypatch):
    """``--serve`` without matplotlib: ``state.json`` holds the status."""
    pos = create_fov(tmp_path / "s.zarr", shape=(2, 1, 4, 16, 16), dtype="float32",
                     channel_names=["c"])
    pos.write((0, 0), np.ones((4, 16, 16), np.float32))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = CliRunner().invoke(cli, ["monitor", str(tmp_path / "s.zarr"), "--once", "--serve", "0",
                                   "--preview-dir", str(tmp_path / "p")])
    assert got.exit_code == 0, got.output
    status = json.loads(got.stdout.strip().splitlines()[-1])
    assert status == {"0": {"timepoints_written": 1, "latest": 0, "of": 2}}
    assert json.loads((tmp_path / "p" / "state.json").read_text()) == status
    assert not list((tmp_path / "p").glob("*.png"))


# -- the device rule ------------------------------------------------------------------------

def _device_rule_args(tmp, verb: str) -> tuple[list, str]:
    """A verb's command line on existing inputs with ``--device`` at its
    default, and the output it must not write."""
    store, cfg = str(tmp / "in.zarr"), str(tmp / "cfg.yml")
    out = str(tmp / "out")
    return {
        "register": (["register", store, "--fixed-channel", "c", "--moving-channel", "c", "-o",
                      out], out),
        "track": (["track", store, "-c", cfg, "-o", out], out),
        "phase": (["phase", store, "-o", out], out),
        "measure-psf": (["measure-psf", store, "-o", out, "--geometry", "lightsheet"], out),
        "train-vs": (["train-vs", store, "--input-channel", "c", "--target-channels", "c", "-o",
                      out], out),
        "replay": (["replay", store, "-o", out], out),
        "replay-dual": (["replay-dual", cfg, "-o", out], out),
        "reconstruct --devices 1": (["reconstruct", store, "-o", out, "-c", str(
            Path(chip_smoke.__file__).parent / chip_smoke.DEMO_CONFIG), "--devices", "1"], out),
    }[verb]


@pytest.mark.parametrize("verb", ["register", "track", "phase", "measure-psf", "train-vs",
                                  "replay", "replay-dual", "reconstruct --devices 1"])
def test_verb_without_a_card_exits_naming_it(tmp_path, monkeypatch, verb):
    """tests/test_torch_pipeline.py's rule for ``deskew``, for every other
    verb that computes: no silent CPU run in the card's place."""
    create_fov(tmp_path / "in.zarr", shape=(1, 1, 8, 16, 16), dtype="float32",
               channel_names=["c"]).write((0, 0), np.ones((8, 16, 16), np.float32))
    (tmp_path / "cfg.yml").write_text("input_channel: c\ntracking_channel: c\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, out = _device_rule_args(tmp_path, verb)
    result = CliRunner().invoke(cli, args)
    assert result.exit_code != 0 and "is_available" in result.output, result.output
    assert not Path(out).exists()

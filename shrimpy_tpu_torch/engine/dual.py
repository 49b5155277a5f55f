"""Dual-instance acquisition: two arms, one stage, one clock.

The mantis production engine runs TWO Micro-Manager instances — the
label-free arm and the light-sheet arm — acquiring simultaneously,
coordinated by NI-DAQ hardware triggers off one timepoint loop and one
physical stage (reference
``shrimpy/mantis/archive/pycromanager/acq_engine.py:98-183`` for the
dual instances over ZMQ ports 4827/5827, ``:601-687`` for the DAQ
counter chain that starts both cameras, ``:1373-1519`` for the shared
t→p loop). This module emulates that topology hardware-free:

* each arm is a full :class:`AcquisitionEngine` with its OWN replay
  source and OWN output store (the two instances), run on its own
  thread (the reference's two acquisition processes);
* a :class:`threading.Barrier` at every timepoint boundary stands in
  for the DAQ trigger: no arm enters timepoint ``t`` until every arm
  finished ``t-1`` — and the barrier's timeout is the stall detector
  (reference ``:1547-1616``): one stuck arm breaks the barrier and
  aborts the whole run instead of letting the arms drift apart;
* one shared :class:`PositionStore` is the one physical stage: the
  tracking arm's DynaTrack corrections shift every arm's subsequent
  volumes (the reference applies ``xyz_positions_shift`` to both
  acquisitions since both image the same wells).

The port's own copy of ``shrimpy_tpu/engine/dual.py``, pinned statement for
statement by ``tests/test_torch_config.py`` but for ``device``, which
:class:`DualArmAcquisition` hands to every arm's engine. Its configs
(``ArmConfig``, ``DualReplayConfig``, ``ArmResult``) are pydantic models, so
this module runs on a host with pydantic only, as the CLI does; an arm's
engine alone (``engine/engine.py``) also runs where pydantic is missing.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path

from pydantic import BaseModel, ConfigDict, Field, model_validator

from shrimpy_tpu_torch.engine.engine import AcquisitionEngine
from shrimpy_tpu_torch.engine.plan import AcquisitionPlan
from shrimpy_tpu_torch.engine.replay import ReplaySource
from shrimpy_tpu_torch.tracking.position import PositionStore

logger = logging.getLogger(__name__)


class ArmConfig(BaseModel):
    """One acquisition arm: its source dataset and its plan."""

    model_config = ConfigDict(extra="forbid")

    input: str
    plan: AcquisitionPlan = Field(default_factory=AcquisitionPlan)


class DualReplayConfig(BaseModel):
    """YAML surface for a dual-arm replay session (``arms:`` mapping,
    same shape as the reconstruction side's ``ReconstructArms``)."""

    model_config = ConfigDict(extra="forbid")

    arms: dict[str, ArmConfig]
    # Stall detector: how long one arm may wait for the others at a
    # timepoint boundary before the run aborts (reference sequence
    # stall watchdog, archive acq_engine.py:1547-1616).
    barrier_timeout_s: float = 120.0

    @model_validator(mode="after")
    def _check(self):
        if len(self.arms) < 2:
            raise ValueError(
                "a dual-arm session needs at least two arms; use plain "
                "`replay` for one"
            )
        n_t = {a.plan.time.n_timepoints for a in self.arms.values()}
        if len(n_t) != 1:
            raise ValueError(
                f"arms must share one timepoint loop; got n_timepoints={n_t}"
            )
        ivals = {a.plan.time.interval_s for a in self.arms.values()}
        if len(ivals) != 1:
            # The barrier forces one physical clock: a faster arm would
            # log a spurious latency overrun every timepoint while
            # waiting on the slower cadence.
            raise ValueError(
                f"arms must share one interval_s; got {sorted(ivals)}"
            )
        return self


class ArmResult(BaseModel):
    name: str
    output: str | None = None
    error: str | None = None
    # True when run control aborted this arm mid-run (its output store
    # holds the volumes acquired before the cut).
    aborted: bool = False


class DualArmAcquisition:
    """Run every arm's engine concurrently under one barrier + stage."""

    def __init__(
        self,
        arms: dict[str, tuple[ReplaySource, AcquisitionPlan]],
        *,
        barrier_timeout_s: float = 120.0,
        viewer_hooks: dict[str, list] | None = None,
        run_control=None,
        device=None,
    ):
        if len(arms) < 2:
            raise ValueError("need >= 2 arms")
        n_t = {plan.time.n_timepoints for _, plan in arms.values()}
        if len(n_t) != 1:
            raise ValueError(f"arms disagree on n_timepoints: {n_t}")
        ivals = {plan.time.interval_s for _, plan in arms.values()}
        if len(ivals) != 1:
            raise ValueError(f"arms disagree on interval_s: {sorted(ivals)}")
        self.arms = arms
        self.stage = PositionStore()
        self.barrier = threading.Barrier(len(arms))
        self.barrier_timeout_s = barrier_timeout_s
        self.viewer_hooks = viewer_hooks or {}
        # ONE shared RunControl: pause/abort applies to every arm at
        # its pre-barrier timepoint checkpoint, so the arms pause and
        # abort in lockstep (engine/control.py; the engine skips its
        # position-level checkpoints when a timepoint_hook is set).
        self.run_control = run_control
        # Every arm's tracking and refocus metric run there (the card when
        # None).
        self.device = device

    def run(self, output_dir: str | Path, name: str) -> dict[str, ArmResult]:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        # Each arm's base name is "{name}_{arm}"; the ENGINE's own
        # resolve_acquisition_name appends the chunk index at the END
        # ("{name}_{arm}" -> "{name}_{arm}_1"). That keeps re-runs
        # inside the engine's chunk-family scheme (base or
        # base_<digits>), so remote-refocus offsets restore across
        # dual-arm chunks exactly like single-arm ones (an index in the
        # MIDDLE, "{name}_1_{arm}", would never match the previous
        # chunk's summary glob). Arms that always run together count
        # the same existing outputs, so their indices stay in lockstep.
        final = name

        results: dict[str, ArmResult] = {}
        threads = []

        def run_arm(arm: str, source: ReplaySource, plan: AcquisitionPlan):
            def on_timepoint(t: int) -> float | None:
                # The DAQ-trigger stand-in. A broken barrier (another
                # arm died or stalled past the timeout) aborts this arm
                # too — the arms never drift out of lockstep.
                self.barrier.wait(timeout=self.barrier_timeout_s)
                if self.run_control is not None:
                    # Pause POST-barrier so every arm blocks together —
                    # pausing before it would let a partner already
                    # inside the barrier burn the stall timeout. The
                    # returned paused seconds stay out of the engine's
                    # pacing clock; an abort raises in every arm's hook
                    # for a lockstep cut.
                    return self.run_control.checkpoint()
                return None

            engine = AcquisitionEngine(
                source,
                viewer_hooks=self.viewer_hooks.get(arm),
                position_store=self.stage,
                timepoint_hook=on_timepoint,
                hook_handles_run_control=self.run_control is not None,
                device=self.device,
            )
            try:
                out = engine.acquire(
                    output_dir, f"{final}_{arm}", plan,
                    run_control=self.run_control,
                )
                aborted = engine.aborted_at is not None
                results[arm] = ArmResult(
                    name=arm, output=str(out), aborted=aborted
                )
                if aborted:
                    # Release any partner still waiting at the barrier
                    # instead of letting it ride out the stall timeout.
                    self.barrier.abort()
            except threading.BrokenBarrierError:
                # The engine auto-increments its store name, so locate
                # this run's (the newest) output in the arm's family.
                candidates = sorted(
                    output_dir.glob(f"{final}_{arm}*.zarr"),
                    key=lambda p: p.stat().st_mtime,
                )
                out_path = candidates[-1] if candidates else None
                if (
                    self.run_control is not None
                    and self.run_control.command == "abort"
                ):
                    # Clean lockstep cut: a partner saw the operator's
                    # abort first and released this arm via
                    # barrier.abort() while it was already waiting.
                    # That is the REQUESTED outcome, not a stall — keep
                    # the partial output on the record.
                    results[arm] = ArmResult(
                        name=arm,
                        output=str(out_path) if out_path else None,
                        aborted=True,
                    )
                    logger.warning(
                        "arm %s aborted by run control at the barrier "
                        "(partial output remains on disk)", arm,
                    )
                else:
                    results[arm] = ArmResult(
                        name=arm,
                        error="aborted: timepoint barrier broken (another "
                              "arm stalled or failed)",
                    )
                    logger.error(
                        "arm %s aborted at the timepoint barrier", arm
                    )
            except Exception as e:
                # Break the barrier so the other arms abort instead of
                # waiting out the stall timeout on a dead partner.
                self.barrier.abort()
                results[arm] = ArmResult(name=arm, error=repr(e))
                logger.exception("arm %s failed", arm)

        for arm, (source, plan) in self.arms.items():
            th = threading.Thread(
                target=run_arm, args=(arm, source, plan),
                name=f"arm-{arm}", daemon=True,
            )
            threads.append(th)
            th.start()
        for th in threads:
            th.join()

        # The dual summary gets its own auto-increment (the per-arm
        # stores are incremented inside each engine).
        summary_name = final
        i = 1
        while (output_dir / f"{summary_name}_dualarm_summary.json").exists():
            summary_name = f"{final}_{i}"
            i += 1
        summary = {
            "name": summary_name,
            "arms": {
                arm: results.get(
                    arm, ArmResult(name=arm, error="thread died")
                ).model_dump()
                for arm in self.arms
            },
            "stage_final_um": {
                k: [pos.x, pos.y, pos.z]
                for k, pos in self.stage.snapshot().items()
            },
        }
        with open(output_dir / f"{summary_name}_dualarm_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        return results

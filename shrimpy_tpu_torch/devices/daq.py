"""Finite pulse-train counter model (the NI-DAQ triggering role).

The reference paces its cameras and stages with NI cDAQ counter-output
tasks: a channel counter emits ``num_channels`` pulses at the channel
acquisition rate, and a retriggerable z counter, started by the channel
counter's edge, emits ``num_slices`` pulses at the slice rate per
channel pulse (reference
``shrimpy/mantis/archive/pycromanager/acq_engine.py:600-688`` and
``microscope_operations.py:184-232``). Expected frames per burst is the
PRODUCT of chained task sample counts
(``get_total_num_daq_counter_samples``, ``:223-232``).

There is no instrument bus on a GPU host, so the hardware clock is
replaced by an explicit pulse-schedule model: :class:`CounterTask`
computes the exact pulse times a finite counter would emit, trigger
chaining composes schedules, and the engine's camera timing model can
be cross-checked against the schedule a real DAQ would produce
(tests/test_devices.py asserts the two models agree). The API surface
mirrors the nidaqmx subset the reference uses so the code reads the
same: ``co_pulse_chan``, implicit finite timing, start triggers,
``start/stop/is_task_done``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass
class CounterTask:
    """One counter-output task: ``samples`` pulses at ``freq`` Hz with
    ``duty_cycle`` high fraction on ``pulse_terminal``."""

    name: str
    co_channel: str = ""
    freq: float = 0.0
    duty_cycle: float = 0.1
    samples: int = 0
    pulse_terminal: str = ""
    # Trigger chaining: when set, this task fires one finite pulse
    # train per RISING edge of the parent task (requires retriggerable,
    # acq_engine.py:680-688).
    trigger_source: "CounterTask | None" = None
    retriggerable: bool = False
    _started: bool = field(default=False, repr=False)
    _closed: bool = field(default=False, repr=False)
    starts: int = field(default=0, repr=False)

    # -- setup (mirrors microscope_operations.setup_daq_counter) ------
    def configure(self, co_channel: str, freq: float, duty_cycle: float,
                  samples_per_channel: int, pulse_terminal: str) -> None:
        if freq <= 0:
            raise ValueError(f"{self.name}: counter frequency must be > 0")
        if not 0.0 < duty_cycle < 1.0:
            raise ValueError(f"{self.name}: duty cycle must be in (0, 1)")
        if samples_per_channel < 1:
            raise ValueError(f"{self.name}: need >= 1 sample")
        self.co_channel = co_channel
        self.freq = float(freq)
        self.duty_cycle = float(duty_cycle)
        self.samples = int(samples_per_channel)
        self.pulse_terminal = pulse_terminal
        logger.debug(
            "%s on %s: %d pulses at %.6f Hz (duty %.2f) -> %s",
            self.name, co_channel, self.samples, self.freq,
            self.duty_cycle, pulse_terminal,
        )

    def cfg_dig_edge_start_trig(self, source: "CounterTask") -> None:
        self.trigger_source = source

    # -- run control ---------------------------------------------------
    def start(self) -> None:
        self._ensure_open()
        self._started = True
        self.starts += 1

    def stop(self) -> None:
        self._ensure_open()
        self._started = False

    def is_task_done(self) -> bool:
        """A retriggerable chained counter never reports done while
        armed (the reference comments this trap twice,
        acq_engine.py:676-686); a software-started finite train is done
        as soon as its schedule would have elapsed — callers gate on
        wall time via the schedule, not on polling loops here."""
        self._ensure_open()
        if self.retriggerable and self._started:
            return False
        return not self._started

    def close(self) -> None:
        self._closed = True

    def _ensure_open(self) -> None:
        if self._closed:
            raise RuntimeError(f"{self.name}: task is closed")

    # -- the schedule model -------------------------------------------
    def burst_seconds(self) -> float:
        """Wall time of one finite pulse train."""
        return self.samples / self.freq

    def pulse_times(self, t0: float = 0.0) -> list[float]:
        """Rising-edge times of one train started at ``t0``."""
        return [t0 + i / self.freq for i in range(self.samples)]

    def chained_pulse_times(self, t0: float = 0.0) -> list[float]:
        """Rising edges including trigger chaining: one train per
        parent pulse (the LF channel-counter -> z-counter topology)."""
        if self.trigger_source is None:
            return self.pulse_times(t0)
        if not self.retriggerable and self.trigger_source.samples > 1:
            raise RuntimeError(
                f"{self.name}: chained to a {self.trigger_source.samples}"
                "-pulse parent but not retriggerable — only the first "
                "train would fire"
            )
        out: list[float] = []
        for edge in self.trigger_source.chained_pulse_times(t0):
            out.extend(self.pulse_times(edge))
        return out


def setup_daq_counter(task: CounterTask, co_channel: str, freq: float,
                      duty_cycle: float, samples_per_channel: int,
                      pulse_terminal: str) -> CounterTask:
    """Reference-shaped setup helper (``microscope_operations.py:184-199``)."""
    task.configure(co_channel, freq, duty_cycle, samples_per_channel,
                   pulse_terminal)
    return task


def start_daq_counters(tasks: "CounterTask | list[CounterTask]") -> None:
    """Stop-then-start each finished task (a counter must be stopped
    before restarting, ``microscope_operations.py:213-221``)."""
    if not isinstance(tasks, list):
        tasks = [tasks]
    for task in tasks:
        if task.is_task_done():
            task.stop()
            task.start()


def get_daq_counter_names(tasks: "CounterTask | list[CounterTask]") -> list[str]:
    if not isinstance(tasks, list):
        tasks = [tasks]
    return [t.name for t in tasks]


def get_total_num_daq_counter_samples(
    tasks: "CounterTask | list[CounterTask]",
) -> int:
    """Expected frames from one burst of chained counters — the product
    of per-task sample counts (``microscope_operations.py:223-232``)."""
    if not isinstance(tasks, list):
        tasks = [tasks]
    total = 1
    for task in tasks:
        total *= task.samples
    return total

"""User-initiated run control: pause / resume / abort for acquisitions.

The reference exposes run/pause of a live acquisition through the Qt
widget (reference ``shrimpy/mantis/mantis_acquisition_widget.py:604-657``
drives ``run_mda(block=False)`` whose runner honors pause/cancel) and
sequence abort in the archived production engine (reference
``shrimpy/mantis/archive/pycromanager/acq_engine.py:1547-1616``). On a
headless accelerator host there is no Qt main loop, so the control surface is a
watched JSON file — the same file-protocol idiom as the live monitor's
``view.json``: any process (the browser monitor, a script, an operator
with an editor) writes ``{"command": "pause" | "run" | "abort"}`` and
the engine honors it at safe boundaries (between position visits /
timepoints), where hardware could actually be paused.

The port's own copy of ``shrimpy_tpu/engine/control.py`` over the port's
``utils/fileio.atomic_write_text``, pinned statement for statement by
``tests/test_torch_config.py`` (``COPIES``).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path

from shrimpy_tpu_torch.utils.fileio import atomic_write_text

logger = logging.getLogger(__name__)

COMMANDS = ("run", "pause", "abort")


class AbortRun(Exception):
    """Raised by :meth:`RunControl.checkpoint` when an abort was requested."""


class RunControl:
    """Pause/resume/abort switch for a running acquisition.

    Commands arrive either in-process (:meth:`request`) or through the
    watched ``path`` (re-read whenever its mtime moves). ``checkpoint``
    is called by the engine at safe boundaries: it blocks while paused
    and raises :class:`AbortRun` on abort, returning the seconds spent
    paused so the caller can exclude them from timepoint pacing.
    """

    def __init__(self, path: str | Path | None = None, *,
                 poll_s: float = 0.2):
        self.path = Path(path) if path is not None else None
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._command = "run"
        self._mtime: float | None = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._init_file()

    def _init_file(self) -> None:
        """Adopt or reset the control file.

        A pre-existing ``pause`` is honored (start-paused); a stale
        ``abort`` left by a previous run in the same directory is reset
        to ``run`` so re-runs don't abort on arrival. A missing or
        unreadable file is (re)written as ``run``.
        """
        cmd = self._read_file()
        if cmd == "pause":
            self._command = "pause"
            logger.info("run control %s: starting paused", self.path)
            return
        if cmd != "run":
            self._write_file("run")

    def _read_file(self) -> str | None:
        try:
            stat = self.path.stat()
        except OSError:
            self._mtime = None
            return None
        self._mtime = stat.st_mtime
        try:
            data = json.loads(self.path.read_text())
            cmd = data.get("command")
        except (OSError, json.JSONDecodeError, AttributeError):
            return None
        return cmd if cmd in COMMANDS else None

    def _write_file(self, command: str) -> None:
        atomic_write_text(self.path, json.dumps({"command": command}))
        try:
            self._mtime = self.path.stat().st_mtime
        except OSError:
            self._mtime = None

    def _poll_file(self) -> None:
        if self.path is None:
            return
        try:
            mtime = self.path.stat().st_mtime
        except OSError:
            return
        if mtime == self._mtime:
            return
        cmd = self._read_file()
        if cmd is None:
            # The file changed but carries no valid command (truncated
            # JSON, or e.g. {"command": "stop"}). Say so loudly: the
            # mtime is recorded, so the content won't be re-read and a
            # silent swallow would leave the operator believing their
            # command took effect.
            logger.warning(
                "run control %s: changed but unreadable or unknown "
                "command (expected one of %s); ignoring",
                self.path, COMMANDS,
            )
            return
        if cmd != self._command:
            logger.info("run control %s -> %s", self.path, cmd)
            self._command = cmd

    # -- command side (tests, library callers, coordinators) ----------------
    def request(self, command: str) -> None:
        if command not in COMMANDS:
            raise ValueError(f"command must be one of {COMMANDS}, got {command!r}")
        with self._lock:
            self._command = command
            if self.path is not None:
                self._write_file(command)

    def pause(self) -> None:
        self.request("pause")

    def resume(self) -> None:
        self.request("run")

    def abort(self) -> None:
        self.request("abort")

    @property
    def command(self) -> str:
        with self._lock:
            self._poll_file()
            return self._command

    # -- engine side --------------------------------------------------------
    def checkpoint(self) -> float:
        """Honor the current command at a safe boundary.

        Returns the seconds spent paused (0.0 when not paused); raises
        :class:`AbortRun` when an abort was requested (also while
        paused — abort wins over pause).
        """
        cmd = self.command
        if cmd == "abort":
            raise AbortRun()
        if cmd != "pause":
            return 0.0
        t0 = time.monotonic()
        logger.info("acquisition paused (write {'command': 'run'} to resume)")
        while True:
            time.sleep(self.poll_s)
            cmd = self.command
            if cmd == "abort":
                raise AbortRun()
            if cmd == "run":
                paused = time.monotonic() - t0
                logger.info("acquisition resumed after %.1fs", paused)
                return paused

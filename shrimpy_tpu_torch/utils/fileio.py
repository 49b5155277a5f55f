"""Atomic file publication for the control/state file protocol.

The port's own copy of ``shrimpy_tpu/utils/fileio.py`` (used by ``io/ngff.py``).

The monitor/engine surfaces communicate through small JSON files
(``view.json``, ``state.json``, ``run_control.json``, ...) that one
process writes while others read concurrently. A plain ``write_text``
truncates then writes, so a concurrent reader can observe an empty or
torn file; writing to a unique temp name and ``os.replace``-ing makes
every read see either the old or the new content, never a mix. The
temp name must be unique PER WRITER (threads in a ThreadingHTTPServer
can publish concurrently — a shared fixed temp name could publish a
truncated file between one writer's open and another's replace).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path


def atomic_write_text(path: str | Path, text: str) -> None:
    """Publish ``text`` at ``path`` atomically (same-directory temp +
    ``os.replace``)."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(
        prefix=path.name + ".", suffix=".tmp", dir=path.parent
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise

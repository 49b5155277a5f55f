"""Logging bootstrap (reference ``shrimpy/_logging.py`` parity): the
port's copy of ``shrimpy_tpu/utils/logging.py``.

Console INFO / file DEBUG with distinct formatters, timestamped
per-acquisition log files under ``<output>/logs/``, and environment
provenance logging — the observable behaviors of the reference's
fileConfig-based setup (``_logging.py:23-89``, ``config/logging.ini``).
The port imports no jax, so its provenance records torch and the CUDA
build in the place of jax and jaxlib; everything else is the original's
statement for statement (``tests/test_torch_config.py``).
"""

from __future__ import annotations

import logging
import logging.handlers
import sys
import threading
import time
from pathlib import Path

CONSOLE_FORMAT = "%(levelname).4s %(name)s: %(message)s"
FILE_FORMAT = "%(asctime)s %(levelname)-8s %(name)s [%(processName)s] %(message)s"

_ROOT = "shrimpy_tpu_torch"
_LOCK = threading.Lock()


def configure_logging(
    level: int = logging.INFO,
    *,
    log_dir: str | Path | None = None,
    acquisition_name: str | None = None,
) -> Path | None:
    """Configure console logging; optionally add a per-acquisition file.

    Returns the log file path when ``log_dir`` is given. Repeated calls
    reconfigure idempotently (the console handler is replaced, not
    stacked). File handlers belonging to OTHER acquisitions are left
    alone — dual-arm engines configure concurrently from their own
    threads, and closing a partner's live handler would truncate its
    log mid-run (messages then land in every attached file; callers
    release their own with :func:`release_log_file` when done).
    """
    logger = logging.getLogger(_ROOT)
    with _LOCK:
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler):
                if getattr(h, "_shrimpy_acq", None) != acquisition_name:
                    continue  # another acquisition's live log file
            logger.removeHandler(h)
            h.close()  # flush + release the fd

        console = logging.StreamHandler(sys.stderr)
        console.setLevel(level)
        console.setFormatter(logging.Formatter(CONSOLE_FORMAT))
        logger.addHandler(console)

        if log_dir is None:
            return None
        log_dir = Path(log_dir) / "logs"
        log_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S")
        name = acquisition_name or "shrimpy_tpu_torch"
        log_file = log_dir / f"{stamp}_{name}.log"
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)  # file gets DEBUG, console stays at `level`
        fh.setFormatter(logging.Formatter(FILE_FORMAT))
        fh._shrimpy_acq = acquisition_name
        logger.addHandler(fh)
    log_environment(logger)
    return log_file


def release_log_file(log_file: str | Path) -> None:
    """Detach and close the per-acquisition file handler for ``log_file``.

    Called by the engine when its acquisition finishes so sequential
    acquisitions in one process don't keep appending to earlier files.
    """
    logger = logging.getLogger(_ROOT)
    with _LOCK:
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler) and Path(
                getattr(h, "baseFilename", "")
            ) == Path(log_file):
                logger.removeHandler(h)
                h.close()


def environment_provenance() -> dict:
    """Structured software provenance (reference ``_logging.py:92-136``
    records the conda env into the log; here the versions that determine
    the kernels' build and IO behavior). Recorded into the acquisition
    summary sidecar and the bench record so cross-round number
    archaeology can tell a toolchain change from a regression.

    NEVER initializes CUDA (see :func:`log_environment`).
    """
    import platform

    env: dict = {
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    from importlib import metadata

    for mod in ("torch", "numpy"):
        try:
            v = getattr(__import__(mod), "__version__", None)
            if v is None:  # a version kept in dist metadata only
                v = metadata.version(mod)
            env[mod] = v
        except Exception:  # pragma: no cover - absent optional dep
            continue
    try:
        import torch

        env["cuda"] = torch.version.cuda
    except Exception:  # pragma: no cover - absent torch
        pass
    return env


def log_environment(logger: logging.Logger) -> None:
    """Environment provenance (reference ``_logging.py:92-136``)."""
    import platform

    logger.debug("python %s on %s", sys.version.split()[0], platform.platform())
    try:
        import torch

        # NEVER call torch.cuda.get_device_name() here unless CUDA is
        # already initialized: logging setup must not create a context.
        if torch.cuda.is_initialized():
            logger.debug(
                "torch %s (CUDA %s) devices=%s",
                torch.__version__,
                torch.version.cuda,
                [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
            )
        else:
            logger.debug(
                "torch %s (CUDA %s; not initialized yet)",
                torch.__version__,
                torch.version.cuda,
            )
    except Exception:  # torch internals moved / torch absent
        logger.debug("torch device provenance unavailable at configure time")

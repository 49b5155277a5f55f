"""Retrying call wrapper, copied from ``shrimpy_tpu/utils/retry.py``.

Copied rather than imported: importing ``shrimpy_tpu.utils`` runs its
``__init__``, which imports ``utils/fft.py`` and with it ``jax``.
``tests/test_torch_pipeline.py`` pins this copy to the original.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

logger = logging.getLogger(__name__)

DEFAULT_ATTEMPTS = 3
DEFAULT_WAIT_S = 5.0


def robust_call(
    fn: Callable,
    *args,
    attempts: int = DEFAULT_ATTEMPTS,
    wait_s: float = DEFAULT_WAIT_S,
    no_retry: tuple[type[BaseException], ...] = (),
    **kwargs,
):
    """Call ``fn``; on exception retry up to ``attempts`` times.

    ``no_retry`` exceptions propagate immediately. The last failure
    re-raises.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    last: BaseException | None = None
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except no_retry:
            raise
        except Exception as e:  # noqa: BLE001 — policy is retry-anything
            last = e
            if attempt < attempts:
                logger.warning(
                    "%s failed (attempt %d/%d): %s; retrying in %.1fs",
                    getattr(fn, "__name__", fn),
                    attempt,
                    attempts,
                    e,
                    wait_s,
                )
                time.sleep(wait_s)
    assert last is not None
    raise last

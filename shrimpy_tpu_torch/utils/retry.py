"""Retrying call wrapper (reference ``RobustCMMCore`` parity).

The port's own copy of ``shrimpy_tpu/utils/retry.py``, pinned statement for
statement by ``tests/test_torch_config.py`` (``COPIES``): importing
``shrimpy_tpu.utils`` would run its ``__init__``, which imports jax.

The reference wraps every public MMCore method with 3-attempt / 5 s
retry via ``__getattribute__`` interception, with no-retry exclusion
lists (``shrimpy/robust_cmmcore.py:13-84``). Here the production
wiring is :func:`robust_call` around the streaming runtime's
store's read/write futures (``runtime/stream.py``, per-item
failure containment). :class:`RobustProxy` is the reference-shaped
general wrapper for METHOD calls only — dunder-dispatched protocols
(indexing, iteration) bypass ``__getattr__`` and are not retried.
"""

from __future__ import annotations

import functools
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

    ``no_retry`` exceptions propagate immediately (the reference's
    exclusion lists, ``robust_cmmcore.py:17-21``). The last failure
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


def retry(
    attempts: int = DEFAULT_ATTEMPTS,
    wait_s: float = DEFAULT_WAIT_S,
    no_retry: tuple[type[BaseException], ...] = (),
):
    """Decorator form of :func:`robust_call`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # Close over the wrapped call: forwarding the user kwargs
            # into robust_call alongside its own attempts/wait_s/
            # no_retry keywords would TypeError on any wrapped callable
            # that itself takes a kwarg by those names.
            return robust_call(
                lambda: fn(*args, **kwargs),
                attempts=attempts, wait_s=wait_s, no_retry=no_retry,
            )

        return wrapper

    return deco


class RobustProxy:
    """Wrap an object so every public method call retries.

    The ``__getattribute__``-interception design of the reference's
    ``RobustCMMCore`` (``robust_cmmcore.py:56-84``): attribute lookups
    for callables return retrying wrappers; ``no_retry_methods`` are
    passed through untouched.
    """

    def __init__(
        self,
        target,
        *,
        attempts: int = DEFAULT_ATTEMPTS,
        wait_s: float = DEFAULT_WAIT_S,
        no_retry_methods: frozenset[str] = frozenset(),
        no_retry_exceptions: tuple[type[BaseException], ...] = (),
    ):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_attempts", attempts)
        object.__setattr__(self, "_wait_s", wait_s)
        object.__setattr__(self, "_no_retry_methods", no_retry_methods)
        object.__setattr__(self, "_no_retry_exceptions", no_retry_exceptions)

    def __setattr__(self, name: str, value) -> None:
        # Attribute WRITES must reach the wrapped target too: landing
        # on the proxy would silently shadow the target's value (the
        # proxy's internals are set via object.__setattr__ in __init__).
        setattr(object.__getattribute__(self, "_target"), name, value)

    def __getattr__(self, name: str):
        target = object.__getattribute__(self, "_target")
        attr = getattr(target, name)
        if not callable(attr) or name.startswith("_"):
            return attr
        if name in object.__getattribute__(self, "_no_retry_methods"):
            return attr

        attempts = object.__getattribute__(self, "_attempts")
        wait_s = object.__getattribute__(self, "_wait_s")
        no_retry = object.__getattribute__(self, "_no_retry_exceptions")

        @functools.wraps(attr)
        def robust(*args, **kwargs):
            return robust_call(
                lambda: attr(*args, **kwargs),
                attempts=attempts, wait_s=wait_s, no_retry=no_retry,
            )

        return robust

"""Alignment helper (counterpart of ``shrimpy_tpu/utils/shapes.py``)."""

from __future__ import annotations


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return -(-n // m) * m

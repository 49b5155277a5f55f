"""Bounded LRU mapping: the port's copy of ``shrimpy_tpu/utils/cache.py``,
pinned statement for statement by ``tests/test_torch_config.py``. The
training bank (``models/train.py::_VolumeBank``) keeps its normalised
volumes in one.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class LruCache:
    """Minimal dict-like LRU (get touches, set evicts oldest)."""

    def __init__(self, maxsize: int = 8):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._data: OrderedDict[Hashable, Any] = OrderedDict()

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def __getitem__(self, key: Hashable) -> Any:
        value = self._data[key]
        self._data.move_to_end(key)
        return value

    def __setitem__(self, key: Hashable, value: Any) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()

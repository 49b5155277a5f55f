"""Lazy in-tree build + ctypes loader for the native helpers.

The repo ships C sources (no prebuilt binaries); the first import
compiles them with the host C compiler into a content-hashed shared
object under the user cache, so rebuilds happen exactly when the
source changes and concurrent processes race benignly (both write the
same bytes to a temp file and rename into place). No compiler, or a
failed compile, degrades gracefully: callers fall back to their pure
Python/numpy paths (``load(...)`` returns None).

This mirrors how the reference leans on native circular-buffer /
writer cores (Micro-Manager MMCore, acquire-zarr) without shipping a
build system: the only toolchain requirement is ``cc``. A copy of the JAX
package's loader; its objects go under ``shrimpy_tpu_torch/native`` in
the user cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

logger = logging.getLogger(__name__)

_SRC_DIR = Path(__file__).resolve().parent
_CACHE: dict[str, ctypes.CDLL | None] = {}


def _cache_dir() -> Path:
    root = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    d = Path(root) / "shrimpy_tpu_torch" / "native"
    d.mkdir(parents=True, exist_ok=True)
    return d


def load(name: str) -> ctypes.CDLL | None:
    """Load (building if needed) ``<name>.c`` -> CDLL, or None.

    Failures are logged once and cached — a box without a compiler
    must not retry the build on every FrameRing construction.
    """
    if name in _CACHE:
        return _CACHE[name]
    lib = None
    try:
        src = _SRC_DIR / f"{name}.c"
        code = src.read_bytes()
        tag = hashlib.sha256(code).hexdigest()[:16]
        out = _cache_dir() / f"{name}-{tag}.so"
        if not out.exists():
            cc = os.environ.get("CC", "cc")
            with tempfile.NamedTemporaryFile(
                dir=out.parent, suffix=".so", delete=False
            ) as tmp:
                tmp_path = Path(tmp.name)
            try:
                subprocess.run(
                    [
                        cc, "-O3", "-std=c11", "-shared", "-fPIC",
                        str(src), "-o", str(tmp_path),
                    ],
                    check=True,
                    capture_output=True,
                    text=True,
                    timeout=120,
                )
                tmp_path.replace(out)  # atomic publish
            finally:
                tmp_path.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(out))
    except Exception:
        logger.warning(
            "native %s build/load failed; using the pure-Python path",
            name,
            exc_info=True,
        )
        lib = None
    _CACHE[name] = lib
    return lib


def load_ring() -> ctypes.CDLL | None:
    """The seqlock frame-ring core (ring.c), with argtypes declared."""
    if os.environ.get("SHRIMPY_NATIVE_RING", "1") == "0":
        return None
    lib = load("ring")
    if lib is None:
        return None
    i64 = ctypes.c_int64
    ptr = ctypes.c_void_p  # raw addresses from numpy's .ctypes.data
    lib.shrimpy_ring_write.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.shrimpy_ring_write.restype = None
    lib.shrimpy_ring_read.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.shrimpy_ring_read.restype = i64
    lib.shrimpy_ring_read_rows.argtypes = [ptr, i64, i64, i64, ptr, i64, ptr]
    lib.shrimpy_ring_read_rows.restype = None
    return lib

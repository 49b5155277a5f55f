"""Build and load the port's hand-written CUDA kernels.

Every ``shrimpy_tpu_torch/csrc/*.cu`` is compiled at first use, one
``nvcc`` process per source, all started together (the ``*.cuh`` headers
beside them are what the sources share), and the objects are linked
into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu     # each, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/libshrimpy_kernels_<hash>.so <objs> -lcufft

linked against cuFFT (``-lcufft``: ``csrc/rl_fft.cu`` makes and runs the
FFT RL's plans; the soname ``libcufft.so.11`` resolves to the copy that
PyTorch has already loaded) and loaded with :mod:`ctypes`. The sources
include no PyTorch header, so the build takes seconds (PyTorch's ``cpp_extension.load`` builds
against torch's headers and takes minutes). The library lands in
``shrimpy_tpu_torch/build/`` under a name keyed by a hash of the
sources and flags, so an edited kernel is never served a stale build.

Four kernels are compiled for their geometry: ``csrc/rl_half.cu`` and
``csrc/rl_iter.cu`` take the number of terms, the PSF lengths and the
tile as macros (``RL_HALF_TERMS`` .. ``RL_HALF_TX``, ``RL_ITER_TERMS`` ..
``RL_ITER_TX``; kind ``rl_half_wrap`` is ``rl_half.cu``'s circular build
with ``RL_HALF_WRAP=1``, ``conv3_circular``'s one launch),
``csrc/convzy.cu`` the z and y tap lengths, the tile
and the boundary (``CONVZY_NKZ`` .. ``CONVZY_WRAP``), and
``csrc/rl_pass.cu`` (the three-pass route's axis and x passes) the length
of one tap list (``RL_PASS_NK``), so that their tap loops unroll.
:func:`load_geometry_library` compiles one at its first
launch with a geometry into a library of its own beside the other
(``lib<kind>_<hash>_<geometry>.so``, one nvcc run);
:func:`build_geometries` starts several runs together. In the common
library each file leaves only its shared-memory sum
(``shrimpy_rl_half_smem``, ``shrimpy_rl_iter_smem``,
``shrimpy_convzy_smem``, ``shrimpy_rl_pass_smem``).

Calling convention of every C entry point: device pointers and the
CUDA stream are ``void*`` (``ctypes.c_void_p``: a plain int argument
would be cut to 32 bits), extents are ``long long`` and the function
returns ``cudaGetLastError()`` as an ``int``; :func:`check` raises on a
non-zero code. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# Libraries the common library links (the geometry libraries link none).
LINK_FLAGS = ["-lcufft"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# C signature of every entry point in csrc/ (argtypes; restype is int: a
# CUDA error code, but for the shrimpy_*_smem functions, which return bytes,
# and shrimpy_affine_refine_blocks, which returns a count).
SIGNATURES: dict[str, list] = {
    # raw, out, t0, t1, wt0, wt1, s0, s1, w00, w01,
    # ns, nt, nx, nz, ny, n_groups, a_avg, ty, tx, rows, vec, stream
    "shrimpy_deskew": [_P] * 10 + [_I64] * 6 + [_I32] * 5 + [_P],
    # rows, planes, tx, ty -> bytes of shared memory a block takes
    "shrimpy_deskew_smem": [_I32] * 4,
    # in, out, taps, k, outer, n, inner, dx, alpha, wrap, stream
    "shrimpy_conv_axis": [_P, _P, _P, _I32, _I64, _I64, _I64, _P, _P, _I32, _P],
    # in, prev, aux, out, taps, k, rows, n, piece, mode, eps, wrap, stream
    "shrimpy_conv_x": [_P] * 5 + [_I32, _I64, _I64, _I64, _I32, _F32, _I32, _P],
    # in, prev, x, dx, g, alpha, partials, taps, k, rows, n, piece, stream
    "shrimpy_conv_x_accel": [_P] * 8 + [_I32, _I64, _I64, _I64, _P],
    # n_terms, nkz, nky, nkx, ty, tx -> bytes of shared memory a block takes
    "shrimpy_rl_half_smem": [_I32] * 6,
    # nkz, nky, ty, tx -> bytes of shared memory a block takes
    "shrimpy_convzy_smem": [_I32] * 4,
    # nk, columns of a row piece -> bytes of shared memory an x-pass block takes
    "shrimpy_rl_pass_smem": [_I32, _I64],
    # n_terms, nkz, nky, nkx, ty, tx -> bytes of shared memory a block takes
    "shrimpy_rl_iter_smem": [_I32] * 6,
    # x, out, rows, cols, width, stream
    "shrimpy_probe_smem_slice": [_P, _P, _I32, _I32, _I32, _P],
    # out, bytes, stream
    "shrimpy_probe_smem": [_P, _I32, _P],
    # a, b, c, m, n, k, mode, stream
    "shrimpy_probe_split_dot": [_P] * 3 + [_I32] * 4 + [_P],
    # m, n, mode, shape (3 int32: blocks, threads, bytes of shared memory)
    "shrimpy_probe_split_dot_launch": [_I32] * 3 + [_P],
    # blocks, threads, bytes of dynamic shared memory, stream
    "shrimpy_probe_empty": [_I32] * 3 + [_P],
    # vol, out, params, nz, ny, nx, oz, oy, ox, stream
    "shrimpy_affine_warp": [_P] * 3 + [_I64] * 6 + [_P],
    # nz, ny, nx, oz, oy -> partial rows of the refine's launches (negative: an error)
    "shrimpy_affine_refine_blocks": [_I64] * 5,
    # vol, fixed, params, partials, capacity, stats, loss, nz, ny, nx, oz, oy, ox, mse, stream
    "shrimpy_affine_refine_sums": [_P] * 4 + [_I32] + [_P] * 2 + [_I64] * 6 + [_I32, _P],
    # vol, fixed, params, stats, partials, capacity, grad, nz, ny, nx, oz, oy, ox, stream
    "shrimpy_affine_refine_grad": [_P] * 5 + [_I32, _P] + [_I64] * 6 + [_P],
    # spec, taps, out, gz, kz, cols, corr, stream
    "shrimpy_zband": [_P] * 3 + [_I64] * 3 + [_I32, _P],
    # kind, dbl, batch, gy, gx, handle (int*), work bytes (long long*)
    "shrimpy_fft_plan": [_I32, _I32] + [_I64] * 3 + [ctypes.POINTER(_I32), ctypes.POINTER(_I64)],
    # handle, kind, dbl, in, out, work, stream
    "shrimpy_fft_exec": [_I32] * 3 + [_P] * 4,
    # x, data, n, eps, dbl, stream
    "shrimpy_rl_ratio": [_P, _P, _I64, ctypes.c_double, _I32, _P],
    # v, x, n, dbl, stream
    "shrimpy_rl_scale": [_P, _P, _I64, _I32, _P],
}

# The macros of a geometry of rl_half and rl_iter (n_terms, nkz, nky, nkx,
# ty, tx; rl_half's circular build also wrap, 1), of convzy (nkz, nky,
# ty, tx, wrap) and of rl_pass (nk), after the prefix.
GEOMETRY_MACROS = ("TERMS", "NKZ", "NKY", "NKX", "TY", "TX")
CONVZY_MACROS = ("NKZ", "NKY", "TY", "TX", "WRAP")
_RL_HALF_ARGS = [_P] * 8 + [_I32] * 4 + [_I64] * 3 + [_I32] * 4 + [_F32, _P]
# The kernels compiled for a geometry, by kind: source, macro prefix, entry
# points with their argtypes, and the macros. shrimpy_rl_half: in, aux, out,
# dx, g, alpha, partials, taps, n_terms, nkz, nky, nkx, gz, gy, gx, ty, tx,
# mode, vec, eps, stream. shrimpy_rl_iter: est, data, out, taps, partials,
# n_terms, nkz, nky, nkx, gz, gy, gx, ty, tx, vec, eps, stream.
# shrimpy_convzy: in, out, taps, nkz, nky, gz, gy, gx, ty, tx, wrap, vec,
# clocks, stream. shrimpy_axis_pass: in, out, host taps, nk, outer, n,
# inner, tile, dx, alpha, wrap, stream. shrimpy_x_pass: in, prev, aux, out,
# host taps, nk, rows, n, piece, mode, eps, wrap, vec, stream.
# shrimpy_x_pass_accel: in, prev, x, dx, g, alpha, partials, host taps, nk,
# rows, n, piece, stream.
GEOMETRY_KERNELS = {
    "rl_half": ("rl_half.cu", "RL_HALF", {"shrimpy_rl_half": _RL_HALF_ARGS}, GEOMETRY_MACROS),
    "rl_half_wrap": ("rl_half.cu", "RL_HALF", {"shrimpy_rl_half": _RL_HALF_ARGS},
                     GEOMETRY_MACROS + ("WRAP",)),
    "rl_iter": ("rl_iter.cu", "RL_ITER", {"shrimpy_rl_iter": [_P] * 5 + [_I32] * 4 + [_I64] * 3
                                          + [_I32] * 3 + [_F32, _P]}, GEOMETRY_MACROS),
    "convzy": ("convzy.cu", "CONVZY", {"shrimpy_convzy": [_P] * 3 + [_I32] * 2 + [_I64] * 3
                                       + [_I32] * 4 + [_P, _P]}, CONVZY_MACROS),
    "rl_pass": ("rl_pass.cu", "RL_PASS", {
        "shrimpy_axis_pass": [_P] * 3 + [_I32] + [_I64] * 4 + [_P, _P, _I32, _P],
        "shrimpy_x_pass": [_P] * 5 + [_I32, _I64, _I64, _I64, _I32, _F32, _I32, _I32, _P],
        "shrimpy_x_pass_accel": [_P] * 8 + [_I32, _I64, _I64, _I64, _P],
    }, ("NK",)),
}
# A C entry point reports a refusal by libcuda (cuTensorMapEncodeTiled) as
# this plus the CUresult, and a cuFFT status as CUFFT_ERROR plus the
# cufftResult.
ENCODE_ERROR = 100000
CUFFT_ERROR = 200000

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_GEOMETRY_LIBS: dict[tuple, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH): the CUDA kernels are built from "
            f"{CSRC_DIR} at first use and need the CUDA toolkit"
        )
    return found


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libshrimpy_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` into the keyed library (if absent):
    one nvcc per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"objs.{os.getpid()}"
    work.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [work / f"{src.stem}.o" for src in sources()]
    procs = []
    try:
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs), *LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.unlink(missing_ok=True)
        shutil.rmtree(work, ignore_errors=True)
    return out


def geometry_library_path(kind: str, geometry, flags=()) -> Path:
    source = GEOMETRY_KERNELS[kind][0]
    h = hashlib.sha256()
    for src in [CSRC_DIR / source, *headers()]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([*ARCH_FLAGS, *NVCC_FLAGS, *flags]).encode())
    return BUILD_DIR / f"lib{kind}_{h.hexdigest()[:16]}_{'x'.join(map(str, geometry))}.so"


def build_geometries(jobs, flags=()) -> list[Path]:
    """Compile each ``(kind, geometry)`` of ``jobs`` whose library is
    absent, all nvcc runs started together; ``kind`` is a key of
    :data:`GEOMETRY_KERNELS`, ``geometry`` the values of its macros in
    order, ``flags`` are more nvcc flags. Returns the libraries' paths."""
    jobs = [(kind, tuple(int(v) for v in g)) for kind, g in jobs]
    paths = [geometry_library_path(kind, g, flags) for kind, g in jobs]
    todo = {p: job for p, job in zip(paths, jobs) if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for out, (kind, geometry) in todo.items():
            source, prefix, _, macros = GEOMETRY_KERNELS[kind]
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *flags,
                   *(f"-D{prefix}_{m}={v}" for m, v in zip(macros, geometry)),
                   "-shared", "-o", str(tmp), str(CSRC_DIR / source)]
            procs.append((cmd, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, tmp, out, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    return paths


def open_geometry_library(kind: str, path) -> ctypes.CDLL:
    """Load a library of ``kind`` built by :func:`build_geometries`."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in GEOMETRY_KERNELS[kind][2].items():
        entry = getattr(lib, name)
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    return lib


def load_geometry_library(kind: str, geometry) -> ctypes.CDLL:
    """The library of ``csrc/<kind>.cu`` compiled for ``geometry`` (the
    values of its macros, :data:`GEOMETRY_KERNELS`): built on the first
    call with it, cached per process and on disk."""
    key = (kind, tuple(int(v) for v in geometry))
    with _LOCK:
        lib = _GEOMETRY_LIBS.get(key)
        if lib is None:
            lib = open_geometry_library(kind, build_geometries([key])[0])
            _GEOMETRY_LIBS[key] = lib
        return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and cached per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.shrimpy_error_string.argtypes = [ctypes.c_int]
            lib.shrimpy_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(code: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code >= CUFFT_ERROR:
        raise RuntimeError(f"{name}: cuFFT error {code - CUFFT_ERROR} (cufftResult)")
    if code >= ENCODE_ERROR:
        raise RuntimeError(f"{name}: libcuda refused the tensor map of the carry "
                           f"(cuTensorMapEncodeTiled, CUresult {code - ENCODE_ERROR})")
    if code != 0:
        msg = load_library().shrimpy_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")

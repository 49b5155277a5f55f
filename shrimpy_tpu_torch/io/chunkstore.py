"""A zarr chunk engine: the part of tensorstore's API the port's stores use.

``io/ngff.py`` imports this module as ``ts`` and calls it as it would call
tensorstore:

* ``open(spec).result()`` with the ``zarr`` (zarr v2, the blosc compressor;
  ``dimension_separator`` ``"/"`` or ``"."``) and ``zarr3`` (regular chunk
  grid, the ``default`` chunk key encoding, the ``bytes`` + ``blosc`` codec
  chain) drivers over a ``file`` kvstore, little-endian and C-ordered, with ``create``, ``delete_existing`` and
  ``metadata``. Opening a missing array raises ``NOT_FOUND``; ``create`` over
  an existing one without ``delete_existing`` raises ``ALREADY_EXISTS``. The
  metadata written for a spec is, as parsed JSON, what tensorstore writes.
* the array: ``.shape``, ``.dtype.name``,
  ``.chunk_layout.read_chunk_template.shape``; numpy basic indexing (ints,
  slices of step 1, ``Ellipsis``) gives a view; ``.read()`` and
  ``.write(data)`` give futures whose ``.result()`` waits.

Reads decode the chunks a selection overlaps and copy out the
intersection; a chunk not on disk reads as the fill value. Writes
read-modify-write a chunk they cover in part, and publish each chunk file
atomically (a temporary file in its directory, fsynced, then
``os.replace``), so a reader of a growing store never sees half a chunk. As
in tensorstore, a chunk equal to a non-null fill value everywhere is not
stored (its file is removed).

The codec is ``native/zarrcodec.c``, built with ``cc`` on first use and
called through ``ctypes`` (which releases the GIL): blosc 1 around zstd,
encoded and decoded in ranges of blocks on a thread pool of the engine's
own. A chunk is written as tensorstore writes it for the same codec: where
the array's blosc codec names ``zstd`` at ``clevel`` 1 or more without
bitshuffle, blosc-zstd (flags 0x91 with byte shuffle, c-blosc's block
size), else, and where that would not be smaller, blosc's uncompressed
("memcpyed") form, which every blosc reader takes. A chunk in that form is
read from its file a run of bytes at a time; a compressed one decodes whole.
The encoder runs zstd levels 1-3 (a higher ``clevel`` runs level 3's
search; c-blosc maps ``clevel`` 3 to zstd's level 5), so its chunks are
near, not equal to, tensorstore's bytes. A chunk past blosc 1's
2,147,483,631 bytes cannot be written (tensorstore refuses it too). Where
the codec cannot be built or loaded, or fails on a chunk, the engine
raises; there is no other codec.
"""

from __future__ import annotations

import builtins
import ctypes
import json
import math
import os
import shutil
import struct
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from shrimpy_tpu_torch.native import build

BLOSC_MAX_BUFFERSIZE = 2**31 - 1 - 16

# The decoder's counters, in the order of zarrcodec.c's slots.
COUNTERS = (
    "frames", "skippable_frames", "checksums", "block_raw", "block_rle", "block_compressed",
    "literals_raw", "literals_rle", "literals_huffman_1", "literals_huffman_4",
    "literals_treeless", "huffman_weights_direct", "huffman_weights_fse",
    "ll_predefined", "ll_rle", "ll_fse", "ll_repeat",
    "of_predefined", "of_rle", "of_fse", "of_repeat",
    "ml_predefined", "ml_rle", "ml_fse", "ml_repeat",
    "sequences", "blosc_blocks", "blosc_raw_streams", "blosc_memcpyed",
)
_ERRORS = {
    -1: "input truncated", -2: "corrupt stream", -3: "output larger than the chunk",
    -4: "zstd content checksum mismatch", -5: "zstd frame needs a dictionary",
    -6: "blosc compressor not supported", -7: "blosc bitshuffle not supported",
    -8: "invalid blosc header", -9: "out of memory", -10: "decoded size mismatch",
    -11: "bad argument",
}
BLOSC_COMPRESSORS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_CNAME_CODE = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2, "zlib": 3, "zstd": 4}

# Blocks a chunk is split into for the codec pool: below this many bytes a
# chunk is encoded or decoded in one call.
_PARALLEL_MIN_BYTES = 4 << 20
# c-blosc stores a buffer under this many bytes in its uncompressed form.
BLOSC_MIN_BUFFERSIZE = 128

_lib = None
_lib_lock = threading.Lock()
_counts = np.zeros(len(COUNTERS), np.int64)
_counts_lock = threading.Lock()
_pools: dict[str, ThreadPoolExecutor] = {}
_pools_lock = threading.Lock()
_chunk_locks = [threading.Lock() for _ in range(64)]


class ChunkStoreError(ValueError):
    """An engine failure; the message starts with tensorstore's status name
    (``NOT_FOUND``, ``ALREADY_EXISTS``, ``INVALID_ARGUMENT``,
    ``DATA_LOSS``, ...), and, for a chunk, names its key."""


def codec() -> ctypes.CDLL:
    """The codec library, built on first use; raises where it cannot be."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("zarrcodec")
            if lib is None:
                raise RuntimeError(
                    "the chunk codec shrimpy_tpu_torch/native/zarrcodec.c could not be built or "
                    "loaded with the host's C compiler (cc, or $CC); the compiler's error is in "
                    "the warning 'native zarrcodec build/load failed' logged by "
                    "shrimpy_tpu_torch.native.build")
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.zc_counter_count.restype = i64
            lib.zc_zstd_decompress.argtypes = [ptr, i64, ptr, i64, ptr]
            lib.zc_zstd_decompress.restype = i64
            lib.zc_blosc_info.argtypes = [ptr, i64, ptr]
            lib.zc_blosc_info.restype = i64
            lib.zc_blosc_decode.argtypes = [ptr, i64, ptr, i64, i64, i64, ptr]
            lib.zc_blosc_decode.restype = i64
            lib.zc_blosc_memcpyed.argtypes = [i64, i64, i64, ptr, i64]
            lib.zc_blosc_memcpyed.restype = i64
            lib.zc_all_equal.argtypes = [ptr, i64, ptr, i64]
            lib.zc_all_equal.restype = i64
            lib.zc_zstd_compress.argtypes = [ptr, i64, ptr, i64, i64]
            lib.zc_zstd_compress.restype = i64
            lib.zc_blosc_blocksize.argtypes = [i64, i64, i64]
            lib.zc_blosc_blocksize.restype = i64
            lib.zc_blosc_encode.argtypes = [ptr, i64, i64, i64, i64, i64, i64, ptr, i64, ptr]
            lib.zc_blosc_encode.restype = i64
            lib.zc_blosc_header.argtypes = [i64, i64, i64, i64, ptr, i64, ptr, i64]
            lib.zc_blosc_header.restype = i64
            if lib.zc_counter_count() != len(COUNTERS):
                raise RuntimeError("zarrcodec.c and chunkstore.COUNTERS disagree")
            _lib = lib
        return _lib


def counters() -> dict[str, int]:
    """The decoder's counters since the last :func:`reset_counters`."""
    with _counts_lock:
        return dict(zip(COUNTERS, (int(v) for v in _counts)))


def reset_counters() -> None:
    with _counts_lock:
        _counts[:] = 0


def _add_counts(c: np.ndarray) -> None:
    with _counts_lock:
        _counts[:] += c


def _pool(kind: str) -> ThreadPoolExecutor:
    """``"io"`` runs the futures; ``"codec"`` runs block ranges of one chunk's
    encode or decode (its jobs never wait on another job, so neither pool can
    deadlock)."""
    with _pools_lock:
        if kind not in _pools:
            n = os.cpu_count() or 1
            _pools[kind] = ThreadPoolExecutor(
                max_workers=min(8, n) if kind == "io" else n,
                thread_name_prefix=f"chunkstore-{kind}")
        return _pools[kind]


def _done(fn, *args) -> Future:
    """A future already resolved to ``fn(*args)`` (or its exception)."""
    fut: Future = Future()
    try:
        fut.set_result(fn(*args))
    except BaseException as e:  # noqa: BLE001 — surfaces at .result()
        fut.set_exception(e)
    return fut


def _check(rc: int, key: str, what: str, status: str = "DATA_LOSS") -> None:
    if rc < 0:
        raise ChunkStoreError(f"{status}: {what} of chunk {key!r}: {_ERRORS.get(rc, rc)}")


# ---------------------------------------------------------------------------
# Codec entry points
# ---------------------------------------------------------------------------


def zstd_decompress(data, capacity: int) -> bytes:
    """Decode a zstd stream (one or more frames) of at most ``capacity``
    bytes; counts into :func:`counters`."""
    lib = codec()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(capacity, 1), np.uint8)
    c = np.zeros(len(COUNTERS), np.int64)
    n = lib.zc_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, capacity,
                               c.ctypes.data)
    _add_counts(c)
    _check(n, "<zstd>", "zstd decode")
    return out[:n].tobytes()


def blosc_info(data, key: str = "<blosc>") -> dict:
    """The blosc header of a container, with the compressor's name."""
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(8, np.int64)
    rc = codec().zc_blosc_info(src.ctypes.data, src.size, info.ctypes.data)
    _check(rc, key, "blosc header")
    names = ("version", "versionlz", "flags", "typesize", "nbytes", "blocksize", "cbytes",
             "units")
    out = dict(zip(names, (int(v) for v in info)))
    out["compressor"] = BLOSC_COMPRESSORS.get(out["flags"] >> 5, f"code {out['flags'] >> 5}")
    return out


def _parts(units: int, nbytes: int) -> list[tuple[int, int]]:
    """Ranges of ``units`` blocks for the codec pool: one below
    _PARALLEL_MIN_BYTES."""
    parts = 1 if nbytes < _PARALLEL_MIN_BYTES else min(units, 4 * (os.cpu_count() or 1))
    bounds = [units * i // parts for i in range(parts + 1)]
    return [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]


def blosc_decode(data, out: np.ndarray | None = None, key: str = "<blosc>") -> np.ndarray:
    """Decode a blosc 1 container into ``out`` (uint8, at least its bytes) or
    a new buffer; a large one's blocks on the decode pool."""
    lib = codec()
    src = np.frombuffer(data, np.uint8)
    info = blosc_info(src, key)
    flags = info["flags"]
    if not flags & 0x02:
        if flags & 0x04:
            raise ChunkStoreError(f"INVALID_ARGUMENT: chunk {key!r} is blosc with bitshuffle, "
                                  "which this engine does not decode")
        if flags >> 5 != 4:
            raise ChunkStoreError(f"INVALID_ARGUMENT: chunk {key!r} is blosc with the "
                                  f"{info['compressor']} compressor; this engine decodes zstd "
                                  "only")
    n = info["nbytes"]
    if out is None:
        out = np.empty(n, np.uint8)
    dst = out.reshape(-1).view(np.uint8)
    if dst.size < n:
        raise ChunkStoreError(f"DATA_LOSS: chunk {key!r} holds {n} bytes, more than "
                              f"its {dst.size}")
    units = info["units"]

    def run(a: int, b: int) -> None:
        c = np.zeros(len(COUNTERS), np.int64)
        rc = lib.zc_blosc_decode(src.ctypes.data, src.size, dst.ctypes.data, dst.size, a, b,
                                 c.ctypes.data)
        _add_counts(c)
        _check(rc, key, "blosc decode")

    ranges = _parts(units, n)
    if len(ranges) <= 1:
        run(0, units)
    else:
        jobs = [_pool("codec").submit(run, a, b) for a, b in ranges]
        for j in jobs:
            j.result()
    return dst[:n]


def zstd_compress(data, level: int = 3) -> bytes:
    """One zstd frame of ``data`` (levels 1-3; a higher level runs level
    3's search)."""
    src = np.frombuffer(data, np.uint8)
    cap = src.size + 3 * (src.size // (1 << 17) + 1) + 18
    out = np.empty(cap, np.uint8)
    n = codec().zc_zstd_compress(src.ctypes.data, src.size, out.ctypes.data, cap, level)
    _check(n, "<zstd>", "zstd encode", "INTERNAL")
    return out[:n].tobytes()


def blosc_encode(chunk, typesize: int, shuffle: bool, clevel: int,
                 key: str = "<blosc>") -> list:
    """The blosc 1 container of ``chunk``'s bytes, blosc-zstd at ``clevel``
    (at least 1) with byte shuffle where ``shuffle``, as pieces to write in
    turn: the header with the block starts, then each range's blocks (a
    large chunk's ranges encoded at once on the codec pool, each into its
    own buffer; no full-size copy is made). Where the container would not
    be smaller than the chunk and a 16-byte header, or the chunk is under
    BLOSC_MIN_BUFFERSIZE bytes, blosc's uncompressed form: its header, then
    the chunk's own bytes. An encoder failure raises, naming ``key``."""
    lib = codec()
    src = np.ascontiguousarray(chunk).reshape(-1).view(np.uint8)
    n = src.size
    flags = (4 << 5) | 0x10 | int(bool(shuffle))
    if n < BLOSC_MIN_BUFFERSIZE or n > BLOSC_MAX_BUFFERSIZE:
        return [blosc_memcpyed_header(n, typesize, flags), src]
    bs = lib.zc_blosc_blocksize(n, typesize, clevel)
    nblocks = -(-n // bs)
    sizes = np.zeros(nblocks, np.int64)

    def run(a: int, b: int) -> np.ndarray:
        cap = (b - a) * (bs + 4)
        buf = np.empty(cap, np.uint8)  # pages are touched only as far as written
        got = lib.zc_blosc_encode(src.ctypes.data, n, typesize, int(bool(shuffle)), clevel, a, b,
                                  buf.ctypes.data, cap, sizes[a:].ctypes.data)
        _check(got, key, "blosc encode", "INTERNAL")
        return buf[:got]

    ranges = _parts(nblocks, n)
    if len(ranges) == 1:
        bodies = [run(*ranges[0])]
    else:
        jobs = [_pool("codec").submit(run, a, b) for a, b in ranges]
        bodies = [j.result() for j in jobs]
    if 16 + 4 * nblocks + int(sizes.sum()) >= n + 16:
        return [blosc_memcpyed_header(n, typesize, flags), src]
    head = np.empty(16 + 4 * nblocks, np.uint8)
    rc = lib.zc_blosc_header(n, typesize, int(bool(shuffle)), clevel, sizes.ctypes.data, nblocks,
                             head.ctypes.data, head.size)
    _check(rc, key, "blosc encode", "INTERNAL")
    return [head, *bodies]


def blosc_memcpyed_header(nbytes: int, typesize: int, flags: int) -> bytes:
    """The 16-byte header of blosc's uncompressed container of ``nbytes``
    raw bytes; ``flags`` the shuffle and compressor bits it names."""
    if nbytes > BLOSC_MAX_BUFFERSIZE:
        raise ChunkStoreError(f"INVALID_ARGUMENT: Blosc compression input of {nbytes} bytes "
                              f"exceeds maximum size of {BLOSC_MAX_BUFFERSIZE}")
    head = np.zeros(16, np.uint8)
    rc = codec().zc_blosc_memcpyed(nbytes, typesize, flags, head.ctypes.data, 16)
    _check(rc, "<header>", "blosc encode")
    return head.tobytes()


def _all_equal(buf: np.ndarray, item: np.ndarray) -> bool:
    b = buf.reshape(-1).view(np.uint8)
    i = np.ascontiguousarray(item).reshape(-1).view(np.uint8)
    return codec().zc_all_equal(b.ctypes.data, b.size, i.ctypes.data, i.size) == 1


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------


def _fill_json(value, dtype: np.dtype):
    if value is None:
        return None
    if dtype.kind == "f":
        v = float(value)
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return v
    return int(value)


def _fill_value(value, dtype: np.dtype) -> np.ndarray:
    """The fill value as a 0-d array of ``dtype`` (null reads as 0)."""
    if value is None:
        return np.zeros((), dtype)
    special = {"NaN": float("nan"), "Infinity": float("inf"), "-Infinity": float("-inf")}
    return np.array(special.get(value, value) if isinstance(value, str) else value, dtype)


class _Meta:
    """One array's metadata, parsed: the shape, chunks, dtype, fill value,
    the blosc codec's compressor name, level and shuffle, and the chunk
    keys' layout. What this engine does not read (another codec or compressor,
    big-endian or Fortran-ordered chunks, filters, another grid or key
    encoding) raises, naming it."""

    def __init__(self, driver: str, meta: dict, where: str):
        def refuse(what) -> ChunkStoreError:
            return ChunkStoreError(f"INVALID_ARGUMENT: {where}: {what} is not supported")

        self.driver = driver
        self.shape = tuple(int(n) for n in meta["shape"])
        if driver == "zarr":
            self.chunks = tuple(int(n) for n in meta["chunks"])
            self.dtype = np.dtype(meta["dtype"])
            if meta.get("order", "C") != "C":
                raise refuse(f"order {meta['order']!r}")
            if meta.get("filters"):
                raise refuse(f"filters {meta['filters']!r}")
            blosc = meta.get("compressor") or {"id": None}
            if blosc["id"] != "blosc":
                raise refuse(f"compressor {blosc['id']!r} (blosc only)")
            self.fill = meta.get("fill_value")
            self.sep, self.prefix = meta.get("dimension_separator", "."), None
        else:
            grid = meta["chunk_grid"]
            if grid.get("name") != "regular":
                raise refuse(f"chunk grid {grid.get('name')!r}")
            self.chunks = tuple(int(n) for n in grid["configuration"]["chunk_shape"])
            self.dtype = np.dtype(meta["data_type"])
            codecs = [(c["name"], c.get("configuration", {})) for c in meta["codecs"]]
            if [n for n, _ in codecs] != ["bytes", "blosc"]:
                raise refuse(f"codecs {[n for n, _ in codecs]} (bytes, then blosc)")
            if codecs[0][1].get("endian", "little") != "little":
                raise refuse("big-endian bytes")
            blosc = codecs[1][1]
            self.fill = meta.get("fill_value", 0)
            enc = meta.get("chunk_key_encoding", {"name": "default"})
            if enc["name"] != "default":
                raise refuse(f"chunk key encoding {enc['name']!r}")
            self.sep, self.prefix = enc.get("configuration", {}).get("separator", "/"), "c"
        if self.dtype.byteorder == ">":
            raise refuse(f"big-endian data type {self.dtype.str}")
        if len(self.chunks) != len(self.shape) or min(self.chunks, default=1) < 1:
            raise refuse(f"chunks {self.chunks} for shape {self.shape}")
        self.dtype = self.dtype.newbyteorder("=")
        shuffle = blosc.get("shuffle", -1)
        self.shuffle = {"noshuffle": 0, "shuffle": 1, "bitshuffle": 2}.get(shuffle, shuffle)
        self.cname = blosc.get("cname", "lz4")
        self.clevel = int(blosc.get("clevel", 5))
        # blosc's -1 (zarr v2) is bitshuffle for one-byte types, else byte shuffle.
        self.byte_shuffle = self.shuffle == 1 or (self.shuffle == -1 and self.dtype.itemsize > 1)
        self.bitshuffle = self.shuffle == 2 or (self.shuffle == -1 and self.dtype.itemsize == 1)
        self.fill_array = _fill_value(self.fill, self.dtype)
        # tensorstore stores no chunk equal to a non-null fill value.
        self.skip_fill = self.fill is not None
        self.chunk_bytes = int(np.prod(self.chunks)) * self.dtype.itemsize

    def key(self, idx: tuple[int, ...]) -> str:
        parts = [str(i) for i in idx]
        return self.sep.join([self.prefix, *parts] if self.prefix else parts) or "0"


def _normalized(driver: str, md: dict) -> dict:
    """The metadata JSON tensorstore writes for a ``create`` spec's
    ``metadata``: its defaults filled in."""
    md = json.loads(json.dumps(md))
    if driver == "zarr":
        dtype = np.dtype(md["dtype"])
        comp = md.get("compressor", {"id": "blosc"})
        if comp is not None and comp.get("id") == "blosc":
            comp = {"cname": "lz4", "clevel": 5, "shuffle": -1, "blocksize": 0, **comp}
        return {"zarr_format": 2, "shape": md["shape"], "chunks": md["chunks"],
                "dtype": md["dtype"], "compressor": comp,
                "fill_value": _fill_json(md.get("fill_value"), dtype),
                "filters": md.get("filters"), "order": md.get("order", "C"),
                "dimension_separator": md.get("dimension_separator", ".")}
    dtype = np.dtype(md["data_type"])
    codecs = []
    for c in md.get("codecs", [{"name": "bytes"}]):
        c = dict(c)
        conf = dict(c.pop("configuration", {}))
        if c["name"] == "bytes" and dtype.itemsize > 1:
            conf.setdefault("endian", "little")
        elif c["name"] == "bytes":
            conf.pop("endian", None)  # one byte has no order
        if c["name"] == "blosc":
            conf = {"cname": "lz4", "clevel": 5, "blocksize": 0, **conf}
            conf.setdefault("shuffle", "bitshuffle" if dtype.itemsize == 1 else "shuffle")
            if conf["shuffle"] != "noshuffle":
                conf.setdefault("typesize", dtype.itemsize)
        if conf:
            c["configuration"] = conf
        codecs.append(c)
    return {"zarr_format": 3, "node_type": "array", "shape": md["shape"],
            "data_type": md["data_type"], "chunk_grid": md["chunk_grid"],
            "chunk_key_encoding": md.get("chunk_key_encoding", {"name": "default"}),
            "fill_value": _fill_json(md.get("fill_value", 0), dtype), "codecs": codecs}


def _meta_path(driver: str, root: Path) -> Path:
    return root / (".zarray" if driver == "zarr" else "zarr.json")


def _write_file(path: Path, pieces) -> None:
    """Atomic publish: a temporary file beside ``path``, fsynced, renamed."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            for p in pieces:
                f.write(p)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def _open(spec: dict) -> "TensorStore":
    driver = spec.get("driver")
    if driver not in ("zarr", "zarr3"):
        raise ChunkStoreError(f"INVALID_ARGUMENT: driver {driver!r} is not supported "
                              "(zarr, zarr3)")
    kv = spec.get("kvstore", {})
    if isinstance(kv, str) or kv.get("driver") != "file":
        raise ChunkStoreError(f"INVALID_ARGUMENT: kvstore {kv!r} is not supported (file)")
    root = Path(kv["path"])
    mpath = _meta_path(driver, root)
    if spec.get("create"):
        if "metadata" not in spec:
            raise ChunkStoreError(f"INVALID_ARGUMENT: creating {root} needs metadata")
        if mpath.exists():
            if not spec.get("delete_existing"):
                raise ChunkStoreError(f"ALREADY_EXISTS: Error opening {driver!r} driver: "
                                      f"metadata at {mpath} already exists")
        if spec.get("delete_existing") and root.exists():
            shutil.rmtree(root)
        meta = _normalized(driver, spec["metadata"])
        parsed = _Meta(driver, meta, str(root))
        _write_file(mpath, [json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()])
        return TensorStore(_Array(parsed, root))
    if not mpath.exists():
        raise ChunkStoreError(f"NOT_FOUND: Error opening {driver!r} driver: metadata at "
                              f"{mpath} does not exist")
    meta = json.loads(mpath.read_text())
    if driver == "zarr3" and meta.get("node_type") != "array":
        raise ChunkStoreError(f"FAILED_PRECONDITION: {mpath} is not an array "
                              f"(node_type {meta.get('node_type')!r})")
    return TensorStore(_Array(_Meta(driver, meta, str(root)), root))


def open(spec: dict) -> Future:  # noqa: A001 — tensorstore's name
    """Open (or create) an array; ``.result()`` gives a :class:`TensorStore`."""
    return _done(_open, spec)


# ---------------------------------------------------------------------------
# Arrays
# ---------------------------------------------------------------------------


class _Array:
    """One array on disk: its chunks read and written whole."""

    def __init__(self, meta: _Meta, root: Path):
        self.meta = meta
        self.root = root

    def chunk_path(self, idx) -> Path:
        return self.root / self.meta.key(idx)

    def chunk_box(self, idx) -> tuple[tuple[int, int], ...]:
        return tuple((i * c, min((i + 1) * c, n))
                     for i, c, n in zip(idx, self.meta.chunks, self.meta.shape))

    def chunks_over(self, lo, hi):
        ranges = [range(a // c, (b + c - 1) // c) if b > a else range(0)
                  for a, b, c in zip(lo, hi, self.meta.chunks)]
        return np.ndindex(*map(len, ranges)), ranges

    def decode(self, idx, out: np.ndarray | None = None) -> np.ndarray | None:
        """The chunk as an array of the chunk shape (into ``out`` where
        given), or None where it is not on disk."""
        m = self.meta
        path = self.chunk_path(idx)
        key = str(path)
        try:
            f = builtins.open(path, "rb")
        except FileNotFoundError:
            return None
        with f:
            size = os.fstat(f.fileno()).st_size
            raw = np.empty(size, np.uint8)
            if f.readinto(memoryview(raw)) != size:
                raise ChunkStoreError(f"DATA_LOSS: chunk {key!r} changed while read")
        info = blosc_info(raw, key)
        if info["nbytes"] != m.chunk_bytes:
            raise ChunkStoreError(f"DATA_LOSS: chunk {key!r} decodes to {info['nbytes']} bytes, "
                                  f"not {m.chunk_bytes}")
        if out is None:
            out = np.empty(m.chunks, m.dtype)
        blosc_decode(raw, out.reshape(-1).view(np.uint8), key)
        return out

    def read_run(self, idx, box, dst: np.ndarray) -> bool | None:
        """Read ``box`` (an axis's (start, stop) within the chunk) of a chunk
        in blosc's uncompressed form (clevel 0, another compressor, or a
        chunk that did not compress) straight from its file into ``dst``
        (C-contiguous), where the box is one run of the chunk's bytes: no
        decode buffer, and only the bytes the box holds.
        None: the chunk is not on disk; False: this does not apply (a
        compressed chunk, or a box of several runs)."""
        m = self.meta
        k = next((i for i, (a, b) in enumerate(box) if b - a > 1), len(box) - 1)
        if any(a != 0 or b != c for (a, b), c in zip(box[k + 1:], m.chunks[k + 1:])):
            return False
        start = int(np.ravel_multi_index([a for a, _ in box], m.chunks)) * m.dtype.itemsize
        path = self.chunk_path(idx)
        try:
            f = builtins.open(path, "rb")
        except FileNotFoundError:
            return None
        with f:
            head = f.read(16)
            if len(head) < 16 or not head[2] & 0x02:
                return False
            nbytes, _, cbytes = struct.unpack("<III", head[4:16])
            if nbytes != m.chunk_bytes or cbytes != nbytes + 16 \
                    or os.fstat(f.fileno()).st_size != cbytes:
                return False
            f.seek(16 + start)
            if f.readinto(memoryview(dst).cast("B")) != dst.nbytes:
                raise ChunkStoreError(f"DATA_LOSS: chunk {str(path)!r} changed while read")
        return True

    def encode_and_store(self, idx, chunk: np.ndarray) -> None:
        """Publish ``chunk`` blosc-zstd where the codec names zstd at clevel
        1 or more without bitshuffle (:func:`blosc_encode`), else in blosc's
        uncompressed form (the header, then its bytes), which the engine's
        decoder and every blosc reader take; or remove its file where it
        equals the fill value."""
        m = self.meta
        path = self.chunk_path(idx)
        if m.skip_fill and _all_equal(chunk, m.fill_array):
            path.unlink(missing_ok=True)
            return
        chunk = np.ascontiguousarray(chunk)
        if m.cname == "zstd" and m.clevel >= 1 and not m.bitshuffle:
            pieces = blosc_encode(chunk, m.dtype.itemsize, m.byte_shuffle, m.clevel, str(path))
        else:
            body = memoryview(chunk).cast("B")
            flags = (_CNAME_CODE.get(m.cname, 4) << 5) | 0x10 | int(m.byte_shuffle)
            pieces = [blosc_memcpyed_header(body.nbytes, m.dtype.itemsize, flags), body]
        _write_file(path, pieces)


class TensorStore:
    """An array or a view of one (tensorstore's ``TensorStore``): the box
    ``[lo, hi)`` of the array's index space, the dimensions an integer index
    took out dropped from its shape."""

    def __init__(self, arr: _Array, lo=None, hi=None, keep=None):
        self._arr = arr
        n = len(arr.meta.shape)
        self._lo = tuple(lo) if lo is not None else (0,) * n
        self._hi = tuple(hi) if hi is not None else arr.meta.shape
        self._keep = tuple(keep) if keep is not None else (True,) * n

    # -- tensorstore's attributes --------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(b - a for a, b, k in zip(self._lo, self._hi, self._keep) if k)

    @property
    def dtype(self) -> np.dtype:
        return self._arr.meta.dtype

    @property
    def chunk_layout(self):
        return SimpleNamespace(read_chunk_template=SimpleNamespace(
            shape=self._arr.meta.chunks))

    def __getitem__(self, sel) -> "TensorStore":
        if not isinstance(sel, tuple):
            sel = (sel,)
        dims = [d for d, k in enumerate(self._keep) if k]
        if sum(s is Ellipsis for s in sel) > 1:
            raise IndexError("an index can only have a single ellipsis ('...')")
        if Ellipsis in sel:
            i = next(i for i, s in enumerate(sel) if s is Ellipsis)
            sel = sel[:i] + (slice(None),) * (len(dims) - len(sel) + 1) + sel[i + 1:]
        if len(sel) > len(dims):
            raise IndexError(f"too many indices: {len(sel)} for {len(dims)} dimensions")
        sel = sel + (slice(None),) * (len(dims) - len(sel))
        lo, hi, keep = list(self._lo), list(self._hi), list(self._keep)
        for d, s in zip(dims, sel):
            n = hi[d] - lo[d]
            if isinstance(s, (int, np.integer)) and not isinstance(s, (bool, np.bool_)):
                i = int(s) + (n if int(s) < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"index {int(s)} is out of bounds for size {n}")
                lo[d] += i
                hi[d] = lo[d] + 1
                keep[d] = False
            elif isinstance(s, slice):
                start, stop, step = s.indices(n)
                if step != 1:
                    raise IndexError(f"slice step {step} is not supported (1 only)")
                hi[d] = lo[d] + max(stop, start)
                lo[d] += start
            else:
                raise TypeError(f"index {s!r} is not supported (int, slice, Ellipsis)")
        return TensorStore(self._arr, lo, hi, keep)

    # -- IO ----------------------------------------------------------------------
    def read(self) -> Future:
        """The view's values (a numpy array) as a future."""
        return _pool("io").submit(self._read)

    def write(self, data) -> Future:
        """Store ``data`` (broadcast to the view's shape, cast to its dtype)
        as a future. The array is not copied: leave it unchanged until the
        future resolves."""
        data = np.asarray(data, self.dtype)
        try:
            data = np.broadcast_to(data, self.shape)
        except ValueError as e:
            raise ChunkStoreError(f"INVALID_ARGUMENT: cannot write shape {data.shape} to "
                                  f"{self.shape}") from e
        return _pool("io").submit(self._write, data)

    def stored_chunks(self) -> tuple[int, int]:
        """(chunks of the view on disk, chunks the view overlaps)."""
        cells, ranges = self._arr.chunks_over(self._lo, self._hi)
        present = total = 0
        for cell in cells:
            idx = tuple(r[i] for r, i in zip(ranges, cell))
            total += 1
            present += self._arr.chunk_path(idx).exists()
        return present, total

    def _full_shape(self) -> tuple[int, ...]:
        return tuple(b - a for a, b in zip(self._lo, self._hi))

    def _read(self) -> np.ndarray:
        arr, m = self._arr, self._arr.meta
        out = np.empty(self._full_shape(), m.dtype)
        cells, ranges = arr.chunks_over(self._lo, self._hi)
        for cell in cells:
            idx = tuple(r[i] for r, i in zip(ranges, cell))
            box = arr.chunk_box(idx)
            inter = [(max(a, lo), min(b, hi)) for (a, b), lo, hi in zip(box, self._lo, self._hi)]
            dst = out[tuple(slice(a - lo, b - lo) for (a, b), lo in zip(inter, self._lo))]
            local = [(a - ca, b - ca) for (a, b), (ca, _) in zip(inter, box)]
            if dst.flags.c_contiguous:
                got = arr.read_run(idx, local, dst)
                if got is None:
                    dst[...] = m.fill_array
                    continue
                if got:
                    continue
                if all(a == 0 and b == c for (a, b), c in zip(local, m.chunks)):
                    if arr.decode(idx, dst) is None:
                        dst[...] = m.fill_array
                    continue
            chunk = arr.decode(idx)
            if chunk is None:
                dst[...] = m.fill_array
            else:
                dst[...] = chunk[tuple(slice(a, b) for a, b in local)]
        return out.reshape(self.shape)

    def _write(self, data: np.ndarray) -> None:
        arr, m = self._arr, self._arr.meta
        full = data.reshape(self._full_shape())
        cells, ranges = arr.chunks_over(self._lo, self._hi)
        for cell in cells:
            idx = tuple(r[i] for r, i in zip(ranges, cell))
            box = arr.chunk_box(idx)
            inter = [(max(a, lo), min(b, hi)) for (a, b), lo, hi in zip(box, self._lo, self._hi)]
            src = full[tuple(slice(a - lo, b - lo) for (a, b), lo in zip(inter, self._lo))]
            covers = all(i == b for i, b in zip(inter, box))
            inside = all(b - a == c for (a, b), c in zip(box, m.chunks))
            local = tuple(slice(a - ca, b - ca) for (a, b), (ca, _) in zip(inter, box))
            with _chunk_locks[hash(str(arr.chunk_path(idx))) % len(_chunk_locks)]:
                if covers and inside:
                    chunk = src
                else:  # the chunk's other voxels: the fill value, or read back
                    chunk = None if covers else arr.decode(idx)
                    if chunk is None:
                        chunk = np.full(m.chunks, m.fill_array, m.dtype)
                    chunk[local] = src
                arr.encode_and_store(idx, np.ascontiguousarray(chunk, m.dtype))

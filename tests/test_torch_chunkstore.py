"""PyTorch port: its own zarr chunk engine, ``io/chunkstore.py``, and its
codec, ``native/zarrcodec.c``, against tensorstore and ``zstandard`` (CPU).

tensorstore and ``zstandard`` are the oracles here; the port imports
neither. The zstd decoder is held to ``zstandard``'s encoder over
hypothesis-drawn buffers (levels 1, 3 and 19, with and without checksum and
content size, multi-block and concatenated frames) and over a corpus that
takes every literal type and every sequence mode; corrupt frames and wrong
checksums raise. Blosc chunks tensorstore wrote (zarr v2 with both
separators and v3; uint8, uint16, float32, float64; partial edge chunks)
read equal to tensorstore's read, the port's chunks read back equal through
tensorstore, and the metadata JSON of a spec is tensorstore's. The JAX
package's stores and the port's cross-read both ways (FOV, plate, pyramid
levels, ``written_timepoints`` of a half-written store), the committed
fixtures of ``tests/data/ts_fixtures/`` decode to their hashes, the
engine's errors name what they found, a resumed run redoes a volume whose
chunk was deleted, and the CLI runs ``reconstruct`` with tensorstore
unimportable to JAX's output.
"""

import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import tensorstore
import torch
import zstandard
from click.testing import CliRunner
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu.io import ngff as jngff
from shrimpy_tpu.io.synthetic import coordinate_encoded_plate, synthetic_ls_stack
from shrimpy_tpu_torch.io import chunkstore as cs
from shrimpy_tpu_torch.io import ngff as tngff
from shrimpy_tpu_torch.native import build as native_build
from shrimpy_tpu_torch.runtime import stream as tstream
from tests.acq_pkgs import package_logging  # noqa: F401 — restores both packages' loggers

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests/data/ts_fixtures"
LITERAL_TYPES = ("literals_raw", "literals_rle", "literals_huffman_1", "literals_huffman_4",
                 "literals_treeless")
SEQUENCE_MODES = tuple(f"{code}_{mode}" for code in ("ll", "of", "ml")
                       for mode in ("predefined", "rle", "fse", "repeat"))


def _zstd(data: bytes, level: int, checksum: bool = False, content_size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


@st.composite
def buffers(draw, max_pieces: int = 24):
    """Bytes built of random runs, runs of one byte, and copies of what came
    before: what zstd finds matches and literals in."""
    out = bytearray()
    for _ in range(draw(st.integers(1, max_pieces))):
        kind = draw(st.sampled_from(["random", "run", "copy", "text"]))
        if kind == "random":
            out += draw(st.binary(min_size=1, max_size=300))
        elif kind == "run":
            out += bytes([draw(st.integers(0, 255))]) * draw(st.integers(1, 2000))
        elif kind == "text":
            out += draw(st.text(alphabet="abcde fgh", min_size=1, max_size=400)).encode()
        elif out:
            start = draw(st.integers(0, len(out) - 1))
            n = draw(st.integers(1, 3000))
            out += (bytes(out[start:]) * (n // max(1, len(out) - start) + 1))[:n]
    return bytes(out)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=buffers(), level=st.sampled_from([1, 3, 19]), checksum=st.booleans(),
       content_size=st.booleans())
def test_zstd_decoder_agrees_with_zstandard(data, level, checksum, content_size):
    frame = _zstd(data, level, checksum, content_size)
    assert cs.zstd_decompress(frame, len(data)) == data


@settings(max_examples=8, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=buffers(max_pieces=8), level=st.sampled_from([1, 3, 19]))
def test_zstd_multi_block_and_concatenated_frames(data, level):
    """Past zstd's 128 KiB block: several blocks a frame; two frames and a
    skippable frame in one stream decode to the concatenation."""
    big = (data + bytes(range(256))) * (300_000 // (len(data) + 256) + 1)
    frame = _zstd(big, level, checksum=True)
    assert cs.zstd_decompress(frame, len(big)) == big
    skip = struct.pack("<II", 0x184D2A5A, 3) + b"abc"
    stream = skip + _zstd(data, 1) + frame + skip
    assert cs.zstd_decompress(stream, len(data) + len(big)) == data + big


def _corpus() -> list[bytes]:
    """Buffers whose frames take every literal type and sequence mode at
    levels 1, 3 and 19 (found by looking at the counters)."""
    rng = np.random.default_rng(1)
    b = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    with_z = bytearray(b * 3000)
    for i in range(0, len(with_z), 64):
        with_z[i + int(rng.integers(0, 64))] = ord("Z")
    text = (b"Huffman coding is a lossless data compression algorithm; the idea is to assign "
            b"variable-length codes to input characters, lengths of the assigned codes are "
            b"based on the frequencies of corresponding characters.")
    return [
        b"\x00" * 400_000,  # RLE blocks
        bytes(with_z),  # RLE and treeless literals
        text,  # one Huffman stream
        b"".join(bytes([int(rng.integers(0, 256))]) + b[:15] for _ in range(5000)),
        b"".join(bytes(rng.integers(0, 256, 2, dtype=np.uint8)) + b[:8] for _ in range(3000)),
        bytes(rng.integers(0, 4, 300_000, dtype=np.uint8)),
        (np.sin(np.arange(400_000) / 50.0) * 1000).astype(np.int16).tobytes(),
        bytes(rng.geometric(0.3, 250_000).astype(np.uint8)),
        os.urandom(5000),
        # A random walk: repeat modes of all three codes at level 19.
        np.cumsum(np.random.default_rng(7).integers(-2, 3, 400_000)).astype(np.int16).tobytes(),
    ]


def test_zstd_corpus_takes_every_literal_type_and_sequence_mode():
    cs.reset_counters()
    for data in _corpus():
        for level in (1, 3, 19):
            for checksum in (False, True):
                assert cs.zstd_decompress(_zstd(data, level, checksum), len(data)) == data
    seen = cs.counters()
    missing = [k for k in (*LITERAL_TYPES, *SEQUENCE_MODES, "huffman_weights_direct",
                           "huffman_weights_fse", "block_raw", "block_rle", "block_compressed",
                           "checksums") if seen[k] == 0]
    assert not missing, (missing, seen)


def test_zstd_corrupt_frames_and_wrong_checksums_raise():
    data = b"the quick brown fox jumps over the lazy dog; " * 200
    frame = _zstd(data, 3, checksum=True)
    bad_sum = bytearray(frame)
    bad_sum[-1] ^= 0x01
    with pytest.raises(cs.ChunkStoreError, match="checksum"):
        cs.zstd_decompress(bytes(bad_sum), len(data))
    with pytest.raises(cs.ChunkStoreError, match="DATA_LOSS"):
        cs.zstd_decompress(frame[: len(frame) // 2], len(data))
    with pytest.raises(cs.ChunkStoreError, match="larger than"):
        cs.zstd_decompress(frame, len(data) - 1)
    with pytest.raises(cs.ChunkStoreError, match="dictionary"):
        dict_frame = bytearray(frame)
        dict_frame[4] |= 0x01  # a one-byte dictionary ID follows
        cs.zstd_decompress(bytes(dict_frame[:5]) + b"\x07" + bytes(dict_frame[5:]), len(data))
    # Every flipped byte either decodes to something or raises: never a crash.
    rng = np.random.default_rng(0)
    for i in rng.integers(4, len(frame), 200):
        flipped = bytearray(frame)
        flipped[i] ^= int(rng.integers(1, 256))
        try:
            cs.zstd_decompress(bytes(flipped), len(data))
        except cs.ChunkStoreError:
            pass


def _blosc_split(data: bytes, typesize: int, blocksize: int, shuffle: bool,
                 raw_stream: bool = False) -> bytes:
    """A blosc 1 container written by hand: split streams (flag 0x10 off),
    one zstd frame each, or stored raw; the leftover block whole."""
    n = len(data)
    nblocks = -(-n // blocksize)
    blocks = []
    for k in range(nblocks):
        blk = data[k * blocksize:(k + 1) * blocksize]
        if shuffle:
            m = len(blk) // typesize * typesize
            a = np.frombuffer(blk[:m], np.uint8).reshape(-1, typesize).T.tobytes()
            blk = a + blk[m:]
        splits = typesize if len(blk) == blocksize else 1
        body = b""
        for j in range(splits):
            s = blk[j * len(blk) // splits:(j + 1) * len(blk) // splits]
            c = s if raw_stream else _zstd(s, 3)
            body += struct.pack("<i", len(c)) + c
        blocks.append(body)
    starts, at = [], 16 + 4 * nblocks
    for b in blocks:
        starts.append(at)
        at += len(b)
    flags = (4 << 5) | (1 if shuffle else 0)
    head = bytes([2, 1, flags, typesize]) + struct.pack("<iii", n, blocksize, at)
    return head + struct.pack(f"<{nblocks}i", *starts) + b"".join(blocks)


@pytest.mark.parametrize("typesize,shuffle,raw_stream", [(2, True, False), (4, True, False),
                                                        (4, False, False), (2, True, True),
                                                        (8, True, False)])
def test_blosc_split_streams_leftover_block_and_raw_streams(typesize, shuffle, raw_stream):
    rng = np.random.default_rng(typesize)
    data = (rng.integers(0, 40, 10_000) * 3).astype(f"<u{typesize}").tobytes() + b"xyz"[:0]
    data = data[: len(data) - typesize - 1]  # a leftover block that is no multiple of the type
    container = _blosc_split(data, typesize, 4096, shuffle, raw_stream)
    cs.reset_counters()
    assert cs.blosc_decode(container).tobytes() == data
    assert cs.counters()["blosc_raw_streams" if raw_stream else "frames"] > 0


def test_memcpyed_container_header():
    head = cs.blosc_memcpyed_header(1000, 4, (4 << 5) | 0x10 | 0x01)
    assert head[:4] == bytes([2, 1, 0x80 | 0x10 | 0x02 | 0x01, 4])
    assert struct.unpack("<iii", head[4:]) == (1000, 1000, 1016)
    body = bytes(range(250)) * 4
    assert cs.blosc_decode(head + body).tobytes() == body
    with pytest.raises(cs.ChunkStoreError, match="exceeds maximum size of 2147483631"):
        cs.blosc_memcpyed_header(cs.BLOSC_MAX_BUFFERSIZE + 1, 4, 0)


# ---------------------------------------------------------------------------
# Stores against tensorstore
# ---------------------------------------------------------------------------

SHAPE, CHUNKS = (23, 19, 11), (8, 8, 4)
LAYOUTS = [("zarr", "/"), ("zarr", "."), ("zarr3", "/")]
DTYPES = ["uint8", "uint16", "float32", "float64"]


def _spec(path, driver, dtype, sep="/", shape=SHAPE, chunks=CHUNKS, shuffle=1, cname="zstd",
          fill=None, clevel=3):
    if driver == "zarr":
        md = {"shape": list(shape), "chunks": list(chunks), "dtype": np.dtype(dtype).str,
              "compressor": {"id": "blosc", "cname": cname, "clevel": clevel, "shuffle": shuffle},
              "dimension_separator": sep}
    else:
        name = {0: "noshuffle", 1: "shuffle", 2: "bitshuffle"}[shuffle]
        md = {"shape": list(shape), "data_type": dtype,
              "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": list(chunks)}},
              "codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                         {"name": "blosc", "configuration": {"cname": cname, "clevel": clevel,
                                                             "shuffle": name}}]}
    if fill is not None:
        md["fill_value"] = fill
    return {"driver": driver, "kvstore": {"driver": "file", "path": str(path)}, "create": True,
            "metadata": md}


def _data(dtype, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) * 200).astype(dtype)
    x[: CHUNKS[0], : CHUNKS[1], : CHUNKS[2]] = 0  # one chunk equal to the fill value
    x[CHUNKS[0]:, :4] = np.arange(x[CHUNKS[0]:, :4].size).reshape(x[CHUNKS[0]:, :4].shape) % 7
    return x


def _open_spec(path, driver):
    return {"driver": driver, "kvstore": {"driver": "file", "path": str(path)}}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("driver,sep", LAYOUTS)
def test_reads_blosc_chunks_tensorstore_wrote(tmp_path, driver, sep, dtype):
    x = _data(dtype)
    tensorstore.open(_spec(tmp_path / "a", driver, dtype, sep)).result().write(x).result()
    arr = cs.open(_open_spec(tmp_path / "a", driver)).result()
    want = tensorstore.open(_open_spec(tmp_path / "a", driver)).result()
    assert arr.shape == SHAPE and arr.dtype.name == dtype
    assert tuple(arr.chunk_layout.read_chunk_template.shape) == tuple(
        want.chunk_layout.read_chunk_template.shape)
    np.testing.assert_array_equal(arr.read().result(), want.read().result())
    for sel in [(5,), (slice(3, 20), 4), (Ellipsis, 2), (slice(None), slice(1, 18), slice(3, 11)),
                (-1, Ellipsis, slice(0, 1))]:
        np.testing.assert_array_equal(arr[sel].read().result(), x[sel])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("driver,sep", LAYOUTS)
def test_tensorstore_reads_what_the_engine_wrote(tmp_path, driver, sep, dtype):
    x = _data(dtype, seed=1)
    arr = cs.open(_spec(tmp_path / "a", driver, dtype, sep)).result()
    arr.write(x).result()
    arr[2:9, 3:17, 4].write(np.full((7, 14), 7, dtype)).result()  # a partial chunk: RMW
    x[2:9, 3:17, 4] = 7
    arr[20, ...].write(np.asarray(5, dtype)).result()  # broadcast
    x[20] = 5
    np.testing.assert_array_equal(
        tensorstore.open(_open_spec(tmp_path / "a", driver)).result().read().result(), x)
    np.testing.assert_array_equal(arr.read().result(), x)
    assert not list(tmp_path.rglob("*.tmp"))  # every chunk published by rename
    # What tensorstore read is blosc-zstd (flags 0x91), no chunk past its
    # bytes and a 16-byte header.
    heads = [p.read_bytes()[:16] for p in (tmp_path / "a").rglob("*")
             if p.is_file() and p.name not in (".zarray", "zarr.json")]
    assert any(h[2] == 0x91 for h in heads)
    nbytes = int(np.prod(CHUNKS)) * np.dtype(dtype).itemsize
    assert all(struct.unpack("<i", h[12:])[0] <= nbytes + 16 for h in heads)
    # The fill-valued chunk is stored where tensorstore stores it.
    (tmp_path / "t").mkdir()
    tensorstore.open(_spec(tmp_path / "t/a", driver, dtype, sep)).result().write(x).result()
    ours = sorted(str(p.relative_to(tmp_path / "a")) for p in (tmp_path / "a").rglob("*")
                  if p.is_file())
    theirs = sorted(str(p.relative_to(tmp_path / "t/a")) for p in (tmp_path / "t/a").rglob("*")
                    if p.is_file())
    assert ours == theirs


@pytest.mark.parametrize("version", ["0.4", "0.5"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "uint32", "float32", "float64"])
def test_metadata_json_is_tensorstore_s(tmp_path, version, dtype):
    """The spec ``io/ngff.py`` writes, and variants of it (separators, fill
    values, shuffles, a spec that leaves the bytes codec unconfigured)."""
    specs = [tngff._array_spec(tmp_path / "x", version=version, shape=(2, 1, 5, 6, 7),
                               chunks=(1, 1, 3, 4, 7), dtype=dtype, create=True)]
    driver = "zarr" if version == "0.4" else "zarr3"
    for fill in (None, 0, 3):
        for shuffle in (0, 1, 2):
            specs.append(_spec(tmp_path / "x", driver, dtype, "." if fill == 3 else "/",
                               shuffle=shuffle, fill=fill))
    bare = _spec(tmp_path / "x", "zarr3", dtype)
    bare["metadata"]["codecs"][0] = {"name": "bytes"}
    specs.append(bare)
    for i, spec in enumerate(specs):
        meta = ".zarray" if spec["driver"] == "zarr" else "zarr.json"
        paths = []
        for who, engine in (("ts", tensorstore), ("cs", cs)):
            spec = json.loads(json.dumps(spec))
            spec["kvstore"]["path"] = str(tmp_path / f"{who}{i}")
            engine.open(spec).result()
            paths.append(tmp_path / f"{who}{i}" / meta)
        assert json.loads(paths[0].read_text()) == json.loads(paths[1].read_text()), spec


def test_reads_of_uncompressed_chunks_read_their_byte_runs(tmp_path, monkeypatch):
    """Chunks in blosc's memcpyed form (the engine writes it at clevel 0):
    a box that is one run of a chunk's bytes is read from the file straight
    into the output (no decode), any other box through the decoder; both
    give numpy's values, edge chunks included, and a truncated chunk raises
    naming its key."""
    x = _data("float32", seed=4)
    runs = []
    real = cs._Array.read_run
    monkeypatch.setattr(cs._Array, "read_run",
                        lambda self, idx, box, dst: runs.append(real(self, idx, box, dst))
                        or runs[-1])
    arr = cs.open(_spec(tmp_path / "b", "zarr3", "float32", clevel=0)).result()
    arr.write(x).result()
    rng = np.random.default_rng(5)
    for _ in range(40):
        lo = [int(rng.integers(0, n)) for n in SHAPE]
        hi = [int(rng.integers(a + 1, n + 1)) for a, n in zip(lo, SHAPE)]
        sel = tuple(slice(a, b) for a, b in zip(lo, hi))
        np.testing.assert_array_equal(arr[sel].read().result(), x[sel])
    np.testing.assert_array_equal(arr[20].read().result(), x[20])  # edge chunks' runs
    assert True in runs and False in runs
    chunk = next(p for p in (tmp_path / "b").rglob("*") if p.is_file() and p.name != "zarr.json")
    chunk.write_bytes(chunk.read_bytes()[:-1])
    with pytest.raises(cs.ChunkStoreError, match=f"DATA_LOSS: .*{chunk.name}"):
        cs.open(_open_spec(tmp_path / "b", "zarr3")).result().read().result()


@pytest.mark.parametrize("driver,edit,match", [
    ("zarr", {"compressor": None}, "compressor None"),
    ("zarr", {"order": "F"}, "order 'F'"),
    ("zarr", {"dtype": ">u2"}, "big-endian data type >u2"),
    ("zarr3", {"codecs": [{"name": "transpose"}, {"name": "bytes"}]}, "codecs"),
    ("zarr3", {"codecs": [{"name": "bytes", "configuration": {"endian": "big"}},
                          {"name": "blosc"}]}, "big-endian bytes"),
    ("zarr3", {"chunk_key_encoding": {"name": "v2"}}, "chunk key encoding 'v2'"),
])
def test_formats_the_engine_does_not_read_are_refused_by_name(tmp_path, driver, edit, match):
    spec = _spec(tmp_path / "a", driver, "uint16")
    meta = cs._normalized(driver, spec["metadata"])
    meta.update(edit)
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / (".zarray" if driver == "zarr" else "zarr.json")).write_text(
        json.dumps(meta))
    with pytest.raises(cs.ChunkStoreError, match=f"INVALID_ARGUMENT: .*{re.escape(match)}"):
        cs.open(_open_spec(tmp_path / "a", driver)).result()


def test_concurrent_partial_writes_to_one_chunk(tmp_path):
    arr = cs.open(_spec(tmp_path / "a", "zarr3", "uint16", shape=(4, 64), chunks=(4, 64))).result()
    futs = [arr[i // 16, (i % 16) * 4:(i % 16) * 4 + 4].write(np.full(4, i + 1, np.uint16))
            for i in range(64)]
    for f in futs:
        f.result()
    np.testing.assert_array_equal(arr.read().result(),
                                  (np.arange(256) // 4 + 1).reshape(4, 64))


def test_written_chunk_is_never_seen_half_written(tmp_path):
    """A reader polling a chunk while it is rewritten sees the old or the new
    chunk, whole."""
    arr = cs.open(_spec(tmp_path / "a", "zarr3", "float32", shape=(64, 256, 256),
                        chunks=(64, 256, 256))).result()
    arr.write(np.full((64, 256, 256), 1.0, np.float32)).result()
    stop, seen = threading.Event(), set()

    def poll():
        while not stop.is_set():
            v = arr[::1, 0, 0].read().result()
            seen.add(float(v.min()))
            seen.add(float(v.max()))

    t = threading.Thread(target=poll)
    t.start()
    for value in (2.0, 3.0, 4.0):
        arr.write(np.full((64, 256, 256), value, np.float32)).result()
    stop.set()
    t.join()
    assert seen <= {1.0, 2.0, 3.0, 4.0}


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


def test_missing_array_and_create_over_an_existing_one(tmp_path):
    for driver in ("zarr", "zarr3"):
        with pytest.raises(ValueError, match="NOT_FOUND"):
            cs.open(_open_spec(tmp_path / f"none_{driver}", driver)).result()
        spec = _spec(tmp_path / driver, driver, "uint16")
        cs.open(spec).result().write(_data("uint16")).result()
        with pytest.raises(ValueError, match="ALREADY_EXISTS"):
            cs.open(spec).result()
        n_before = len(list((tmp_path / driver).rglob("*")))
        spec["delete_existing"] = True
        fresh = cs.open(spec).result()
        assert len(list((tmp_path / driver).rglob("*"))) < n_before
        assert not fresh.read().result().any()


@pytest.mark.parametrize("cname,shuffle,match", [("lz4", 1, "lz4 compressor"),
                                                 ("zlib", 1, "zlib compressor"),
                                                 ("blosclz", 0, "blosclz compressor"),
                                                 ("zstd", 2, "bitshuffle")])
def test_unsupported_blosc_chunks_name_what_they_use(tmp_path, cname, shuffle, match):
    x = np.tile(np.arange(64, dtype=np.uint16), (23, 19, 1))[:, :, :11]
    tensorstore.open(_spec(tmp_path / "a", "zarr", "uint16", shuffle=shuffle,
                           cname=cname)).result().write(x).result()
    arr = cs.open(_open_spec(tmp_path / "a", "zarr")).result()
    with pytest.raises(cs.ChunkStoreError, match=match) as e:
        arr.read().result()
    assert re.search(r"chunk '.*a/\d+/\d+/\d+'", str(e.value)), e.value


def test_a_corrupt_chunk_raises_naming_its_key(tmp_path):
    tensorstore.open(_spec(tmp_path / "a", "zarr3", "float32")).result().write(
        _data("float32")).result()
    chunk = tmp_path / "a/c/1/1/1"
    raw = bytearray(chunk.read_bytes())
    raw[len(raw) // 2:] = bytes(len(raw) - len(raw) // 2)
    chunk.write_bytes(bytes(raw))
    with pytest.raises(cs.ChunkStoreError, match=r"DATA_LOSS: .*chunk '.*a/c/1/1/1'"):
        cs.open(_open_spec(tmp_path / "a", "zarr3")).result().read().result()


def test_codec_that_cannot_be_built_raises(monkeypatch):
    monkeypatch.setattr(cs, "_lib", None)
    monkeypatch.setattr(native_build, "load", lambda name: None)
    with pytest.raises(RuntimeError, match="zarrcodec.c could not be built.*native.build"):
        cs.zstd_decompress(_zstd(b"abc", 1), 3)


# ---------------------------------------------------------------------------
# OME-Zarr stores of the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", ["0.4", "0.5"])
@pytest.mark.parametrize("writer,reader", [(jngff, tngff), (tngff, jngff)],
                         ids=["jax_to_port", "port_to_jax"])
def test_plate_pyramid_and_half_written_store_cross_read(tmp_path, version, writer, reader):
    store = writer.create_hcs(tmp_path / "p.zarr", channel_names=["a", "b"], version=version)
    rng = np.random.default_rng(3)
    data = {}
    for key in (("A", "1", "000"), ("B", "2", "001")):
        pos = store.create_position(*key, zyx_scale=(0.5, 0.25, 0.25))
        pos.create_array((3, 2, 5, 12, 10), dtype="uint16", chunks=(1, 1, 4, 8, 8))
        vol = rng.integers(1, 4000, (2, 2, 5, 12, 10)).astype(np.uint16)
        pos.write(slice(0, 2), vol)  # timepoints 0 and 1 of 3
        data["/".join(key)] = vol
    writer.add_pyramid_levels(writer.open_ngff(tmp_path / "p.zarr").position("A/1/000"), 2)
    other = reader.open_ngff(tmp_path / "p.zarr")
    assert sorted(other.positions()) == sorted(data)
    for key, vol in data.items():
        pos = other.position(key)
        np.testing.assert_array_equal(pos.read(slice(0, 2)), vol)
        assert not pos.read(2).any()
        assert pos.written_timepoints() == [0, 1]
        assert pos.zyx_scale == (0.5, 0.25, 0.25)
    pos = other.position("A/1/000")
    assert len(pos.multiscales[0]["datasets"]) == 3
    same = writer.open_ngff(tmp_path / "p.zarr").position("A/1/000")
    for level in ("1", "2"):
        np.testing.assert_array_equal(np.asarray(pos.array(level).read().result()),
                                      np.asarray(same.array(level).read().result()))
    assert pos.array("2").shape == (3, 2, 5, 3, 2)


@pytest.mark.parametrize("name", sorted(json.loads((FIXTURES / "hashes.json").read_text())))
def test_committed_fixtures_decode_to_their_hashes(name):
    """The stores ``tests/data/ts_fixtures/make_fixtures.py`` wrote with
    tensorstore: tensorstore and the port read each array to the SHA-256
    recorded when they were made (``chip_smoke.py`` phase 4u decodes the same
    files on the card)."""
    want = json.loads((FIXTURES / "hashes.json").read_text())[name]
    store, array = name.rsplit("/", 1)
    spec = _open_spec(FIXTURES / store / array, "zarr" if "v2" in store else "zarr3")
    for engine in (tensorstore, cs):
        got = np.ascontiguousarray(engine.open(spec).result().read().result())
        assert list(got.shape) == want["shape"] and got.dtype.name == want["dtype"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file()) < 1 << 20


def test_tiled_container_of_the_fixtures_frames_decodes_on_the_pool(monkeypatch):
    """``chip_smoke.tiled_blosc``, phase 4u's production-size container, at
    32 blocks of 256 KiB: every block's stream through ``zstandard`` and a
    numpy unshuffle gives the bytes it returns, and the engine decodes the
    container to them with its blocks split across the decode pool."""
    import io

    import chip_smoke

    chunks = [p.read_bytes() for p in sorted(FIXTURES.rglob("*"))
              if p.is_file() and p.name[0].isdigit() and p.parent.name != "ts_fixtures"]
    container, plain = chip_smoke.tiled_blosc(chunks, 32)
    buf = container.tobytes()
    info = cs.blosc_info(buf)
    block = chip_smoke.BLOSC_TILE_FRAMES * 4096
    assert (info["units"], info["nbytes"], info["blocksize"], info["compressor"]) \
        == (32, 32 * block, block, "zstd")
    starts = np.frombuffer(buf[16:16 + 4 * 32], "<i4")
    for k, at in enumerate(starts):
        size = int.from_bytes(buf[at:at + 4], "little")
        shuffled = zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(buf[at + 4:at + 4 + size]), read_across_frames=True).read()
        want = np.frombuffer(shuffled, np.uint8).reshape(2, -1).T.reshape(-1)
        np.testing.assert_array_equal(plain[k * block:(k + 1) * block], want)
    jobs, pool = [], cs._pool

    def recording(kind):
        jobs.append(kind)
        return pool(kind)

    monkeypatch.setattr(cs, "_pool", recording)
    np.testing.assert_array_equal(cs.blosc_decode(buf), plain)
    assert jobs.count("codec") > 1


# ---------------------------------------------------------------------------
# The store runtime and the CLI
# ---------------------------------------------------------------------------


def test_output_chunks_keep_a_chunk_within_blosc():
    assert tstream._output_chunks((2, 1, 128, 2888, 1600), "float32") == (1, 1, 64, 2888, 1600)
    assert tstream._output_chunks((2, 1, 128, 2888, 1600), "uint16") == (1, 1, 128, 2888, 1600)
    assert tstream._output_chunks((3, 2, 700, 64, 64), "float32") == (1, 1, 512, 64, 64)
    for shape in ((1, 1, 4000, 1024, 1024), (1, 1, 300, 2048, 2048)):
        c = tstream._output_chunks(shape, "float32")
        assert np.prod(c) * 4 <= cs.BLOSC_MAX_BUFFERSIZE and c[2] * (-(-shape[2] // c[2])) \
            >= shape[2]


def test_resume_redoes_exactly_the_volume_whose_chunk_was_deleted(tmp_path):
    coordinate_encoded_plate(tmp_path / "p.zarr", shape_tczyx=(3, 1, 4, 16, 16))
    from shrimpy_tpu_torch.config import ReconstructSettings
    from shrimpy_tpu_torch.config.schemas import DeconvolveSettings

    settings = ReconstructSettings(deconvolve=DeconvolveSettings(iterations=1))
    first = tstream.reconstruct_store(tmp_path / "p.zarr", tmp_path / "o.zarr", settings,
                                      device="cpu")
    out = tngff.open_ngff(tmp_path / "o.zarr")
    before = {k: p.read() for k, p in out.positions().items()}
    assert first["volumes"] == 3 * len(before)
    again = tstream.reconstruct_store(tmp_path / "p.zarr", tmp_path / "o.zarr", settings,
                                      device="cpu", resume=True)
    assert again["volumes"] == 0
    key = sorted(before)[0]
    chunk = tmp_path / "o.zarr" / key / "0/c/1/0/0/0/0"
    assert chunk.exists()
    chunk.unlink()
    redo = tstream.reconstruct_store(tmp_path / "p.zarr", tmp_path / "o.zarr", settings,
                                     device="cpu", resume=True)
    assert redo["volumes"] == 1 and redo["skipped_resume"] == 3 * len(before) - 1
    after = tngff.open_ngff(tmp_path / "o.zarr")
    for k, vol in before.items():
        np.testing.assert_array_equal(after.position(k).read(), vol)


def test_cli_reconstruct_without_tensorstore_writes_jax_s_store(tmp_path):
    """``reconstruct -c`` the demo config ``--device cpu`` in a process where
    tensorstore cannot be imported writes what the JAX CLI writes
    (tensorstore) for the same store, within the port's budget against JAX
    (1e-4 of the volume's max, ``test_torch_pipeline.py``), and a second run
    with ``--resume`` does nothing. The config names ``matmul``, the backend
    JAX's ``auto`` takes off the TPU (the port's takes ``fused``: the two
    RL-20 then differ by 1.5e-3 of the max on this store)."""
    synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(40, 24, 32))
    demo = (REPO / "configs/reconstruct_demo.yml").read_text()
    assert "  separable_tol: 1.0e-4\n" in demo
    cfg = tmp_path / "demo_matmul.yml"
    cfg.write_text(demo.replace("  separable_tol: 1.0e-4\n",
                                "  separable_tol: 1.0e-4\n  separable_backend: matmul\n"))
    cfg = str(cfg)
    code = textwrap.dedent("""
        import sys
        sys.modules["tensorstore"] = None
        from shrimpy_tpu_torch.cli.main import cli
        try:
            cli(sys.argv[1:])
        finally:
            assert "tensorstore" not in sys.modules or sys.modules["tensorstore"] is None
            assert not [m for m in sys.modules if m == "jax" or m.startswith("shrimpy_tpu.")]
    """)
    args = ["reconstruct", str(tmp_path / "ls.zarr"), "-o", str(tmp_path / "port.zarr"),
            "-c", cfg, "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for extra in ([], ["--resume"]):
        proc = subprocess.run([sys.executable, "-c", code, *args, *extra], capture_output=True,
                              text=True, env=env, cwd=tmp_path, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout[proc.stdout.index("{"):])["volumes"] == 0
    result = CliRunner().invoke(jax_cli, ["reconstruct", str(tmp_path / "ls.zarr"), "-o",
                                          str(tmp_path / "jax.zarr"), "-c", cfg])
    assert result.exit_code == 0, result.output
    got = jngff.open_ngff(tmp_path / "port.zarr").position().read()
    want = tngff.open_ngff(tmp_path / "jax.zarr").position().read()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_port_and_chip_smoke_import_no_tensorstore():
    pattern = re.compile(r"^\s*(import tensorstore\b|from tensorstore\b)|"
                         r"__import__\(\s*['\"]tensorstore|import_module\(\s*['\"]tensorstore",
                         re.M)
    files = sorted((REPO / "shrimpy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                   REPO / "profile_step.py"]
    hits = {str(f.relative_to(REPO)): pattern.findall(f.read_text()) for f in files}
    assert not {f: h for f, h in hits.items() if h}
    from shrimpy_tpu_torch.utils.logging import environment_provenance
    assert "tensorstore" not in environment_provenance()
    for bad in ("import tensorstore as ts", "  from tensorstore import open",
                "__import__('tensorstore')"):
        assert pattern.search(bad), bad
    assert not pattern.search("from shrimpy_tpu_torch.io import chunkstore as ts")

"""PyTorch port: the zstd and blosc encoders of ``native/zarrcodec.c`` and the
chunk engine's compressed writes (``io/chunkstore.py``), against
``zstandard`` and tensorstore (CPU).

Every frame the encoder writes at levels 1-3 decodes bit for bit through
``zstandard`` and through the port's own decoder, over a corpus of edge sizes
and kinds of data and over hypothesis buffers; the decoder's counters show
that the corpus takes the block types, literal types and sequence modes the
encoder writes; a blosc block stored raw leaves the frames of the blocks
after it in the same range right. Stores the engine writes compress as
tensorstore's do (the same blosc header, within 1.15x of its bytes on the
committed fixtures' arrays and a camera-like volume), tensorstore reads
them, no chunk is larger than its bytes and a 16-byte header, ``clevel`` 0
and other compressors write blosc's uncompressed form, and an encoder
failure raises naming the chunk.
"""

import os
import struct
from pathlib import Path

import numpy as np
import pytest
import tensorstore
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from shrimpy_tpu_torch.io import chunkstore as cs
from tests.test_torch_chunkstore import DTYPES, LAYOUTS, _data, _open_spec, _spec, buffers

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests/data/ts_fixtures"
BLOCK = 1 << 17  # zstd's largest block
LEVELS = (1, 2, 3)
SIZE_RATIO = 1.15  # the engine's bytes on disk against tensorstore's, at most


def _camera(shape, seed: int) -> np.ndarray:
    """Camera-like counts: a smooth background of 100-300 with shot noise."""
    rng = np.random.default_rng(seed)
    lead = rng.uniform(100, 300, (shape[0],) + (1,) * (len(shape) - 1))
    mean = lead + 40 * np.sin(np.arange(shape[-1]) / 37.0)
    return rng.poisson(np.broadcast_to(mean, shape)).astype(np.uint16)


def _lits(n: int, seed: int) -> bytes:
    """``n`` bytes over 64 symbols, skewed: Huffman-coded, no 4-byte match
    (the literal sections' size formats at 1 KiB and 16 KiB)."""
    rng = np.random.default_rng(seed)
    return bytes(np.minimum(rng.geometric(0.08, n), 63).astype(np.uint8))


def _corpus() -> dict[str, bytes]:
    rng = np.random.default_rng(22)
    small = rng.integers(0, 4, 3 * BLOCK, dtype=np.uint8).tobytes()
    noise = rng.integers(0, 256, 140_000, dtype=np.uint8).tobytes()
    text = (b"Huffman coding is a lossless data compression algorithm; the idea is to assign "
            b"variable-length codes to input characters, lengths of the assigned codes are "
            b"based on the frequencies of corresponding characters.")
    shuffled = _camera((4, 64, 256), 3).reshape(-1).view(np.uint8).reshape(-1, 2).T.tobytes()
    reps = b"".join(bytes([int(rng.integers(0, 256))]) + b"abcdefgh"[:int(k)]
                    for k in rng.integers(1, 9, 20_000))
    # A first block of noise holding one 8-byte repeat at distance 80 (its
    # match found, the block still stored raw), then an 80-byte pattern
    # repeated: the next block's matches are at that distance, which the
    # decoder's repeat offsets do not hold, since a raw block updates none.
    rng_raw = np.random.default_rng(23)
    first = bytearray(rng_raw.integers(0, 256, BLOCK, dtype=np.uint8).tobytes())
    first[100:108] = first[20:28]
    period = rng_raw.integers(0, 256, 80, dtype=np.uint8).tobytes()
    # Two blocks of bytes 1-255 with 0.83 % and 0.94 % zeros and the same
    # early repeat: the first block's literals take a new Huffman table but
    # its sequence leaves it no smaller, so it is stored raw; the second may
    # not reuse that table, which the decoder never saw.
    rng_huf = np.random.default_rng(5)
    draw, skewed = rng_huf.random(2 * BLOCK), rng_huf.integers(1, 256, 2 * BLOCK, dtype=np.uint8)
    skewed[:BLOCK][draw[:BLOCK] < 0.0083] = 0
    skewed[BLOCK:][draw[BLOCK:] < 0.0094] = 0
    skewed[100:108] = skewed[20:28]
    pattern = rng.integers(2, 256, 100, dtype=np.uint8).tobytes()
    separated = b"".join(b"\x01" * int(k) + pattern for k in rng.integers(1, 3, 3000))
    return {
        "empty": b"",
        "one_byte": b"q",
        "three_bytes": b"abc",
        "one_byte_repeated": b"\x07" * 300_000,
        "noise": noise,
        "block_less_1": small[:BLOCK - 1],
        "block": small[:BLOCK],
        "block_plus_1": small[:BLOCK + 1],
        # 256 KiB whose second block repeats the first's noise: matches reach
        # back across the 128 KiB block edge.
        "across_block_edge": noise[:BLOCK + 4096] + noise[:2 * BLOCK - (BLOCK + 4096)],
        "repeat_offsets": reps,
        "raw_block_after_matches": bytes(first) + period * 2000,
        "raw_block_after_a_new_table": skewed.tobytes(),
        # A pattern behind one or two 0x01 bytes at random: after the first
        # block every literal is 0x01 (RLE literals).
        "one_literal_byte": separated,
        "shuffled_camera": shuffled,
        "text": text * 400,
        "short_text": text,
        "literal_run_over_16k": text * 100 + _lits(20_000, 4) + text * 100,
        "literals_1023": _lits(1023, 5),
        "literals_1024": _lits(1024, 6),
        "literals_16383": _lits(16383, 7),
        "literals_16384": _lits(16384, 8),
        "random_walk": np.cumsum(rng.integers(-2, 3, 200_000)).astype(np.int16).tobytes(),
    }


CORPUS = _corpus()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(CORPUS))
def test_encoder_frames_decode_through_zstandard_and_the_port(name, level):
    data = CORPUS[name]
    frame = cs.zstd_compress(data, level)
    assert frame[:4] == b"\x28\xb5\x2f\xfd" and frame[4] & 0x20  # one segment, no checksum
    assert not frame[4] & 0x04
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == len(data) and not params.has_checksum
    assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(data) or 1) == data
    assert cs.zstd_decompress(frame, len(data)) == data
    assert len(frame) <= len(data) + 3 * (len(data) // BLOCK + 1) + 9


def test_matches_reach_back_across_the_block_edge():
    data = CORPUS["across_block_edge"]
    assert len(data) == 2 * BLOCK
    # The second block is noise repeated from the first: only a match into
    # the earlier block compresses it.
    assert len(cs.zstd_compress(data, 1)) < 0.6 * len(data)


@pytest.mark.parametrize("name", ["raw_block_after_matches", "raw_block_after_a_new_table"])
def test_a_raw_block_leaves_the_decoder_state_as_it_was(name):
    """The two cases still take the path they were built for: a first block
    stored raw after its sequences (and, in the second, a new Huffman table)
    were found, then a compressed block."""
    data = CORPUS[name]
    for level in LEVELS:
        cs.reset_counters()
        assert cs.zstd_decompress(cs.zstd_compress(data, level), len(data)) == data
        seen = cs.counters()
        assert seen["block_raw"] >= 1 and seen["block_compressed"] >= 1, seen


def test_levels_above_3_run_level_3s_search():
    data = CORPUS["random_walk"]
    assert cs.zstd_compress(data, 9) == cs.zstd_compress(data, 3)
    assert len(cs.zstd_compress(data, 3)) < len(cs.zstd_compress(data, 1))


def test_the_corpus_takes_every_block_literal_and_sequence_mode_the_encoder_writes():
    cs.reset_counters()
    for data in CORPUS.values():
        for level in LEVELS:
            cs.zstd_decompress(cs.zstd_compress(data, level), len(data))
    seen = cs.counters()
    want = ("block_raw", "block_rle", "block_compressed", "literals_raw", "literals_rle",
            "literals_huffman_1", "literals_huffman_4", "literals_treeless",
            "huffman_weights_direct", "huffman_weights_fse",
            *(f"{code}_{mode}" for code in ("ll", "of", "ml")
              for mode in ("predefined", "rle", "fse")))
    assert not [k for k in want if seen[k] == 0], seen
    # No table repeat mode and no checksum: the encoder writes neither.
    assert seen["ll_repeat"] == seen["of_repeat"] == seen["ml_repeat"] == seen["checksums"] == 0


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=buffers(), level=st.sampled_from(LEVELS))
def test_encoder_agrees_with_zstandard_on_drawn_buffers(data, level):
    frame = cs.zstd_compress(data, level)
    assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(data)) == data
    assert cs.zstd_decompress(frame, len(data)) == data


# ---------------------------------------------------------------------------
# Blosc containers
# ---------------------------------------------------------------------------


def _container(chunk, typesize, shuffle, clevel) -> bytes:
    return b"".join(bytes(p) for p in cs.blosc_encode(chunk, typesize, shuffle, clevel))


@pytest.mark.parametrize("dtype,shuffle,n", [("uint16", True, 5 * BLOCK // 2 + 6),
                                             ("float32", True, 3 * BLOCK // 4 + 3),
                                             ("float64", True, BLOCK // 8 * 3 + 5),
                                             ("uint8", True, 3 * BLOCK + 77),
                                             ("uint16", False, 5 * BLOCK // 2 + 6)])
def test_blosc_container_leftover_block_and_shuffle(dtype, shuffle, n):
    """Several blocks and a leftover one, compressed; the header is
    tensorstore's for the same data and spec."""
    x = _camera((n,), 11).astype(dtype) // (1 if dtype.startswith("uint") else 3)
    if dtype == "uint8":
        x = (x % 7).astype(dtype)
    buf = _container(x, x.itemsize, shuffle, 3)
    info = cs.blosc_info(buf)
    assert info["flags"] == (0x91 if shuffle else 0x90) and info["units"] > 1
    assert info["nbytes"] % info["blocksize"], "a leftover block"
    assert cs.blosc_decode(buf).tobytes() == x.tobytes()
    ts_chunk = _ts_chunk(x, shuffle)
    assert buf[:12] == ts_chunk[:12]  # version, flags, typesize, nbytes, block size
    assert len(buf) <= SIZE_RATIO * len(ts_chunk)


def _ts_chunk(x: np.ndarray, shuffle: bool, clevel: int = 3) -> bytes:
    """The one chunk tensorstore writes for ``x`` with JAX's codec."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": d}, "create": True,
                "metadata": {"shape": list(x.shape), "chunks": list(x.shape),
                             "dtype": x.dtype.str,
                             "compressor": {"id": "blosc", "cname": "zstd", "clevel": clevel,
                                            "shuffle": int(shuffle)}}}
        tensorstore.open(spec).result().write(x).result()
        return (Path(d) / ".".join("0" * x.ndim)).read_bytes()


@pytest.mark.parametrize("clevel", [1, 2, 3, 4, 5, 6, 9])
def test_blosc_block_size_is_c_blosc_s(clevel):
    x = _camera((2, 256, 1100), clevel)  # past 1 MiB: clevel 9's block
    ts_chunk = _ts_chunk(x, True, clevel)
    buf = _container(x, 2, True, clevel)
    assert cs.blosc_info(buf)["blocksize"] == cs.blosc_info(ts_chunk)["blocksize"]
    assert cs.blosc_decode(buf).tobytes() == x.tobytes()


def test_incompressible_and_tiny_chunks_take_the_memcpyed_form():
    noise = np.random.default_rng(0).integers(0, 256, 300_000, dtype=np.uint8)
    for chunk in (noise, noise[:100]):
        buf = _container(chunk, 1, True, 3)
        info = cs.blosc_info(buf)
        assert info["flags"] & 0x02 and len(buf) == chunk.size + 16
        assert cs.blosc_decode(buf).tobytes() == chunk.tobytes()


def test_large_chunk_encodes_in_ranges_on_the_codec_pool(monkeypatch):
    x = _camera((8, 256, 1600), 9)
    assert x.nbytes > cs._PARALLEL_MIN_BYTES
    jobs, pool = [], cs._pool

    def recording(kind):
        jobs.append(kind)
        return pool(kind)

    monkeypatch.setattr(cs, "_pool", recording)
    pieces = cs.blosc_encode(x, 2, True, 3)
    assert jobs.count("codec") > 1 and len(pieces) == 1 + jobs.count("codec")
    monkeypatch.undo()
    buf = b"".join(bytes(p) for p in pieces)
    assert buf == _container(x, 2, True, 3)  # ranges give the one-call bytes
    assert cs.blosc_decode(buf).tobytes() == x.tobytes()


def _noise_then_structure(name: str) -> np.ndarray:
    """One range of blosc blocks: 128 KiB that do not compress (stored raw,
    after the match finder has filled its tables), then 384 KiB that do.
    In the uint8 case the last noise block of every level holds, at its
    byte 96, the 8 bytes the next block repeats: its table entry, were it
    taken for the next frame's own, matches ahead of the search."""
    rng = np.random.default_rng(31)
    if name == "uint8":
        pattern = np.frombuffer(b"\x10\x32\x54\x76\x98\xba\xdc\xfe", np.uint8)
        noise = rng.integers(0, 256, BLOCK, dtype=np.uint8)
        for at in (96, BLOCK // 2 + 96, 3 * BLOCK // 4 + 96):  # blocks of 128, 64, 32 KiB
            noise[at:at + 8] = pattern
        return np.concatenate([noise, np.tile(pattern, 3 * BLOCK // 8)])
    return np.concatenate([rng.integers(0, 1 << 16, BLOCK // 2, dtype=np.uint16),
                           _camera((3, 256, 256), 32).reshape(-1)])


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", ["uint8", "uint16"])
def test_a_raw_blosc_block_leaves_the_next_blocks_frames_right(tmp_path, name, level):
    x = _noise_then_structure(name)
    ts = x.itemsize
    cs.open(_spec(tmp_path / "a", "zarr", name, shape=x.shape, chunks=x.shape, clevel=level)
            ).result().write(x).result()
    buf = (tmp_path / "a/0").read_bytes()
    info = cs.blosc_info(buf)
    bs, nblocks = info["blocksize"], info["units"]
    assert info["flags"] == 0x91 and nblocks == 4 * BLOCK // bs  # not the memcpyed form
    starts = struct.unpack(f"<{nblocks}i", buf[16:16 + 4 * nblocks])
    for k, at in enumerate(starts):
        size = struct.unpack("<i", buf[at:at + 4])[0]
        shuffled = x.view(np.uint8)[k * bs:(k + 1) * bs].reshape(-1, ts).T.tobytes()
        if (k + 1) * bs <= BLOCK:
            assert size == bs  # c-blosc's raw block
            continue
        assert size < bs
        frame = buf[at + 4:at + 4 + size]
        assert zstandard.ZstdDecompressor().decompress(frame) == shuffled, k
    assert cs.blosc_decode(buf).tobytes() == x.tobytes()
    np.testing.assert_array_equal(
        tensorstore.open(_open_spec(tmp_path / "a", "zarr")).result().read().result(), x)


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------


def _chunk_files(root: Path) -> list[Path]:
    return sorted(p for p in root.rglob("*") if p.is_file()
                  and p.name not in (".zarray", ".zattrs", ".zgroup", "zarr.json"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("driver,sep", LAYOUTS)
def test_engine_chunks_carry_tensorstore_s_header_and_are_never_larger(tmp_path, driver, sep,
                                                                       dtype):
    x = _data(dtype, seed=2)
    cs.open(_spec(tmp_path / "a", driver, dtype, sep)).result().write(x).result()
    tensorstore.open(_spec(tmp_path / "t", driver, dtype, sep)).result().write(x).result()
    nbytes = int(np.prod((8, 8, 4))) * np.dtype(dtype).itemsize
    compressed = 0
    for ours in _chunk_files(tmp_path / "a"):
        theirs = tmp_path / "t" / ours.relative_to(tmp_path / "a")
        a, b = ours.read_bytes(), theirs.read_bytes()
        assert len(a) <= nbytes + 16
        if not a[2] & 0x02 and not b[2] & 0x02:
            assert a[:12] == b[:12], ours
            compressed += 1
    assert compressed
    np.testing.assert_array_equal(
        tensorstore.open(_open_spec(tmp_path / "a", driver)).result().read().result(), x)


@pytest.mark.parametrize("driver,sep", LAYOUTS)
@pytest.mark.parametrize("name", ["0", "f32"])
def test_bytes_on_disk_within_tensorstore_s_on_the_fixtures_arrays(tmp_path, driver, sep, name):
    """The committed fixtures' arrays (tensorstore: 23,899 bytes for 128,520
    uint16; 49,934 for 57,720 float32), rewritten with JAX's spec."""
    x = np.asarray(tensorstore.open(_open_spec(FIXTURES / "fov_v3.zarr" / name, "zarr3"))
                   .result().read().result())
    sizes = {}
    for who, engine in (("ts", tensorstore), ("cs", cs)):
        spec = _spec(tmp_path / who, driver, x.dtype.name, sep, shape=x.shape,
                     chunks=(1, 1, 8, 16, 16))
        engine.open(spec).result().write(x).result()
        sizes[who] = sum(p.stat().st_size for p in _chunk_files(tmp_path / who))
    assert sizes["cs"] <= SIZE_RATIO * sizes["ts"], sizes
    np.testing.assert_array_equal(
        tensorstore.open(_open_spec(tmp_path / "cs", driver)).result().read().result(), x)


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_bytes_on_disk_within_tensorstore_s_on_a_camera_volume(tmp_path, dtype):
    x = _camera((6, 256, 400), 13)
    if dtype == "float32":
        x = (x / 7.3).astype(np.float32)
    chunks = (3, 256, 400)  # 4 or more blosc blocks a chunk
    sizes = {}
    for who, engine in (("ts", tensorstore), ("cs", cs)):
        engine.open(_spec(tmp_path / who, "zarr3", dtype, shape=x.shape, chunks=chunks)
                    ).result().write(x).result()
        sizes[who] = sum(p.stat().st_size for p in _chunk_files(tmp_path / who))
    assert cs.blosc_info((tmp_path / "cs/c/0/0/0").read_bytes())["units"] >= 4
    assert sizes["cs"] <= SIZE_RATIO * sizes["ts"], sizes
    assert sizes["cs"] < x.nbytes
    np.testing.assert_array_equal(
        tensorstore.open(_open_spec(tmp_path / "cs", "zarr3")).result().read().result(), x)


@pytest.mark.parametrize("cname,clevel,shuffle", [("zstd", 0, 1), ("lz4", 5, 1),
                                                  ("blosclz", 3, 0), ("zstd", 3, 2)])
def test_clevel_0_other_compressors_and_bitshuffle_write_the_memcpyed_form(tmp_path, cname,
                                                                            clevel, shuffle):
    x = _data("uint16", seed=3)
    cs.open(_spec(tmp_path / "a", "zarr", "uint16", shuffle=shuffle, cname=cname,
                  clevel=clevel)).result().write(x).result()
    nbytes = 8 * 8 * 4 * 2
    for p in _chunk_files(tmp_path / "a"):
        head = p.read_bytes()[:16]
        assert head[2] & 0x02 and head[2] >> 5 == cs._CNAME_CODE[cname]
        assert p.stat().st_size == nbytes + 16
    np.testing.assert_array_equal(cs.open(_open_spec(tmp_path / "a", "zarr")).result()
                                  .read().result(), x)
    np.testing.assert_array_equal(tensorstore.open(_open_spec(tmp_path / "a", "zarr")).result()
                                  .read().result(), x)


def test_an_encoder_failure_raises_naming_the_chunk_and_writes_nothing(tmp_path, monkeypatch):
    real = cs.codec()

    class Failing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def zc_blosc_encode(*args):
            return -9

    monkeypatch.setattr(cs, "codec", lambda: Failing())
    arr = cs.open(_spec(tmp_path / "a", "zarr3", "float32")).result()
    with pytest.raises(cs.ChunkStoreError, match=r"INTERNAL: blosc encode of chunk '.*a/c/\d/\d/\d'"
                                                 r": out of memory"):
        arr.write(_data("float32")).result()
    assert not _chunk_files(tmp_path / "a")
    assert not list((tmp_path / "a").rglob("*.tmp"))


def test_compressed_chunks_decode_whole_and_partial_writes_read_them_back(tmp_path):
    x = _camera((23, 19, 11), 17)
    arr = cs.open(_spec(tmp_path / "a", "zarr3", "uint16")).result()
    arr.write(x).result()
    arr[3:5, 2:9, 1:3].write(np.full((2, 7, 2), 9, np.uint16)).result()
    x[3:5, 2:9, 1:3] = 9
    cs.reset_counters()
    np.testing.assert_array_equal(arr[1:20, 4, :].read().result(), x[1:20, 4, :])
    seen = cs.counters()
    assert seen["block_compressed"] > 0 and seen["blosc_memcpyed"] == 0
    head = (tmp_path / "a/c/0/0/0").read_bytes()[:16]
    assert head[2] == 0x91 and struct.unpack("<i", head[12:])[0] < 8 * 8 * 4 * 2 + 16
    assert os.path.getsize(tmp_path / "a/c/0/0/0") < 8 * 8 * 4 * 2


def size_table(root: Path) -> list[tuple[str, int, int, int]]:
    """(array, raw bytes, tensorstore's bytes on disk, the engine's) for JAX's
    spec (zarr v3, blosc-zstd clevel 3, byte shuffle) on the fixtures'
    arrays, the camera-like volume of the tests as uint16 and as float32,
    and uniform 12-bit counts."""
    fixture = {name: np.asarray(tensorstore.open(_open_spec(FIXTURES / "fov_v3.zarr" / name,
                                                            "zarr3")).result().read().result())
               for name in ("0", "f32")}
    cam = _camera((16, 256, 1600), 13)
    arrays = {"fixtures uint16": (fixture["0"], (1, 1, 8, 16, 16)),
              "fixtures float32": (fixture["f32"], (1, 1, 8, 16, 16)),
              "camera uint16": (cam, (16, 256, 1600)),
              "camera float32": ((cam / 7.3).astype(np.float32), (16, 256, 1600)),
              "uniform 12-bit": (np.random.default_rng(0).integers(0, 4096, (16, 256, 1600))
                                 .astype(np.uint16), (16, 256, 1600))}
    rows = []
    for name, (x, chunks) in arrays.items():
        sizes = []
        for who, engine in (("ts", tensorstore), ("cs", cs)):
            path = root / f"{who}_{name.replace(' ', '_')}"
            engine.open(_spec(path, "zarr3", x.dtype.name, shape=x.shape, chunks=chunks)
                        ).result().write(x).result()
            sizes.append(sum(p.stat().st_size for p in _chunk_files(path)))
        rows.append((name, x.nbytes, *sizes))
    return rows


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_zstd_encode.py
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for name, raw, ts, ours in size_table(Path(d)):
            print(f"{name}: raw {raw}, tensorstore {ts} ({ts / raw:.4f}), the engine {ours} "
                  f"({ours / raw:.4f}; {ours / ts:.4f} of tensorstore's)")

"""PyTorch port of the native frame-ring core (ROADMAP item 12d) against the
JAX package (CPU).

``shrimpy_tpu_torch/native/ring.c`` is byte for byte
``shrimpy_tpu/native/ring.c``; ``native/build.py``, ``native/__init__.py``
and ``viewer/ring.py`` are copies, pinned statement for statement in
``tests/test_torch_config.py`` (``COPIES``). Here the JAX tests of the ring
core (``tests/test_native_ring.py``: build and load, the numpy path's
parity on one segment, torn slots under a writer without the GIL, the
``SHRIMPY_NATIVE_RING=0`` fallback) run on both packages, and a ring
written by either package is read by the other with the frames bit-equal.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.acq_pkgs import PACKAGES, Pkg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


def _ring(pkg):
    return pkg("viewer.ring").FrameRing


def test_ring_c_is_the_original_byte_for_byte():
    ours = (REPO / "shrimpy_tpu_torch/native/ring.c").read_bytes()
    assert ours == (REPO / "shrimpy_tpu/native/ring.c").read_bytes()


def test_port_builds_under_its_own_cache_name():
    from shrimpy_tpu_torch.native import build

    assert build._cache_dir().parts[-2:] == ("shrimpy_tpu_torch", "native")
    assert build._SRC_DIR == REPO / "shrimpy_tpu_torch" / "native"


def test_native_library_builds_and_loads(pkg):
    lib = pkg("native").load_ring()
    assert lib is not None, "host has cc; the native ring must build"


def test_env_knob_disables_native(pkg, monkeypatch):
    monkeypatch.setenv("SHRIMPY_NATIVE_RING", "0")
    ring = _ring(pkg)(None, n_slots=2, frame_shape=(4, 4))
    try:
        assert ring._lib is None
        ring.write(3, np.full((4, 4), 7.0, np.float32))
        seq, frame = ring.read(3 % 2)
        assert seq == 3
        np.testing.assert_array_equal(frame, 7.0)
    finally:
        ring.close()


def test_native_and_numpy_paths_share_one_layout(pkg, monkeypatch):
    FrameRing = _ring(pkg)
    writer = FrameRing(None, n_slots=4, frame_shape=(8, 16))
    assert writer._lib is not None
    monkeypatch.setenv("SHRIMPY_NATIVE_RING", "0")
    reader = FrameRing(writer.name, n_slots=4, frame_shape=(8, 16), create=False)
    assert reader._lib is None
    try:
        frame = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        writer.write(5, frame)                      # native write
        seq, got = reader.read(5 % 4)               # numpy read
        assert seq == 5
        np.testing.assert_array_equal(got, frame)
        reader.write(9, frame * 2)                  # numpy write
        seq, got = writer.read(9 % 4)               # native read
        assert seq == 9
        np.testing.assert_array_equal(got, frame * 2)
    finally:
        reader.close()
        writer.close()


def test_native_read_rows_matches_numpy(pkg, monkeypatch):
    FrameRing = _ring(pkg)
    native = FrameRing(None, n_slots=4, frame_shape=(8, 16))
    assert native._lib is not None
    monkeypatch.setenv("SHRIMPY_NATIVE_RING", "0")
    plain = FrameRing(native.name, n_slots=4, frame_shape=(8, 16), create=False)
    try:
        rng = np.random.default_rng(0)
        for s in range(4):
            native.write(s, rng.random((8, 16), dtype=np.float32))
        slots = [2, None, 0, 3]
        np.testing.assert_array_equal(native.read_rows(5, slots), plain.read_rows(5, slots))
    finally:
        plain.close()
        native.close()


def test_unwritten_and_torn_slots_report_minus_one(pkg):
    ring = _ring(pkg)(None, n_slots=2, frame_shape=(4, 4))
    try:
        seq, _ = ring.read(1)
        assert seq == -1  # never written
        ring._seq[0] = -1  # mid-write: marker set, data half-written
        seq, _ = ring.read(0)
        assert seq == -1
    finally:
        ring.close()


def test_concurrent_writer_never_yields_mixed_consistent_frame(pkg):
    """A native writer without the GIL spins constant frames (value ==
    seq); a read reporting a consistent sequence must return the matching
    uniform frame."""
    ring = _ring(pkg)(None, n_slots=2, frame_shape=(64, 64))
    assert ring._lib is not None
    stop = threading.Event()
    frames = [np.full((64, 64), float(s), np.float32) for s in range(64)]

    def writer():
        s = 0
        while not stop.is_set():
            ring.write(s % 64, frames[s % 64])
            s += 1

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        consistent = 0
        for _ in range(3000):
            for slot in (0, 1):
                seq, frame = ring.read(slot)
                if seq >= 0:
                    consistent += 1
                    vals = np.unique(frame)
                    assert vals.size == 1 and vals[0] == float(seq), (
                        f"torn frame published as consistent seq={seq}")
        assert consistent > 0
    finally:
        stop.set()
        t.join(timeout=5)
        ring.close()


@pytest.mark.parametrize("writer_pkg,reader_pkg", [PACKAGES, PACKAGES[::-1]])
@pytest.mark.parametrize("native", [True, False])
def test_a_ring_of_one_package_reads_in_the_other(writer_pkg, reader_pkg, native, monkeypatch):
    """One segment, two packages: frames, sequences and row gathers of the
    writer's ring come out of the reader's bit for bit, on the native path
    and on the numpy path."""
    if not native:
        monkeypatch.setenv("SHRIMPY_NATIVE_RING", "0")
    writer = _ring(Pkg(writer_pkg))(None, n_slots=5, frame_shape=(6, 10))
    reader = _ring(Pkg(reader_pkg))(writer.name, n_slots=5, frame_shape=(6, 10), create=False)
    try:
        assert (writer._lib is None, reader._lib is None) == (not native, not native)
        rng = np.random.default_rng(3)
        frames = {seq: rng.standard_normal((6, 10)).astype(np.float32) for seq in range(7)}
        for seq, frame in frames.items():
            writer.write(seq, frame)
        for seq in range(2, 7):
            got_seq, got = reader.read(seq % 5)
            assert got_seq == seq
            np.testing.assert_array_equal(got, frames[seq])
        latest = reader.latest()
        assert latest[0] == 6 and np.array_equal(latest[1], frames[6])
        np.testing.assert_array_equal(reader.read_rows(4, [2, None, 0]),
                                      writer.read_rows(4, [2, None, 0]))
    finally:
        reader.close()
        writer.close()

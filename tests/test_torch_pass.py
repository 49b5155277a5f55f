"""The three-pass route's compiled passes (``csrc/rl_pass.cu``), from
geometry alone: which kernel each pass takes, the axis pass's tiles, the x
pass's shared memory, the build kind, and numpy walks of the two kernels'
loops that must hand every output its taps in ascending order (the order
that gives the plain version's bits). The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""

import numpy as np
import pytest
import torch

from shrimpy_tpu_torch.kernels import build
from shrimpy_tpu_torch.ops import rl_fused as trl

torch.set_num_threads(1)

# BASELINE.md config 2: the G grid of the deskewed production volume with
# the PSF measured from beads, cropped to (31, 41, 37), in 24 terms.
CONFIG2_CARRY, CONFIG2_RADII, CONFIG2_TERMS = (158, 2928, 1636), (15, 20, 18), 24


def test_config2_takes_the_three_pass_route_on_the_compiled_passes():
    assert trl.half_bound_error(CONFIG2_CARRY, CONFIG2_RADII, 1) is not None
    assert trl.half_step_route(CONFIG2_CARRY, CONFIG2_RADII, CONFIG2_TERMS) == "three_pass"
    gz, gy, gx = CONFIG2_CARRY
    lengths = tuple(2 * r + 1 for r in CONFIG2_RADII)
    assert [trl.axis_pass_route(k) for k in lengths[:2]] == ["compiled", "compiled"]
    assert trl.x_pass_route(gx, lengths[2]) == "compiled"
    # The z pass takes whole columns, the y pass tiles of ~600 rows.
    assert trl.axis_tile(1, gz, gy * gx) == gz
    assert trl.axis_tile(gz, gy, gx) == 586
    # A row is one piece of 6,704 bytes, one block of the x pass.
    assert trl.x_piece(gx, 18) == gx
    assert trl.x_pass_smem_bytes(37, gx) == 6704
    assert trl.x_blocks(CONFIG2_CARRY, 18) == gz * gy


@pytest.mark.parametrize("nk", [1, 3, 21, 41, 61, 63, 65, 201, 423, 425, 851])
def test_axis_pass_route_by_tap_count(nk):
    want = "compiled" if nk <= trl.PASS_MAX_TAPS else "runtime"
    assert trl.axis_pass_route(nk) == want


@pytest.mark.parametrize("outer,n,inner", [
    (1, 158, 2928 * 1636), (158, 2928, 1636), (1, 136, 2908 * 1620), (136, 2908, 1620),
    (66000, 4, 8), (4, 2_100_000, 8), (1, 4, 2_100_000 * 8), (2, 5, 3), (1, 9, 1), (3, 300, 1)])
def test_axis_tile(outer, n, inner):
    tile = trl.axis_tile(outer, n, inner)
    assert 1 <= tile <= n
    tiles = -(-n // tile)
    if tile < n:
        # Tiled only to give the launch its threads, never below the floor.
        assert tile >= trl._AXIS_MIN_TILE
        assert (tiles - 1) * outer * inner < trl._AXIS_THREADS
    else:
        assert tiles == 1


@pytest.mark.parametrize("gx,nk", [(1636, 37), (1620, 21), (60000, 21), (58108, 9),
                                   (58080, 63), (58090, 1), (57000, 63), (130, 63), (21, 45),
                                   (16384, 65), (400, 99), (5, 1)])
def test_x_pass_route_and_shared_memory(gx, nk):
    """The compiled x pass stages whole 16-byte chunks from round4(r)
    columns before its piece; it runs where the tap list is short enough
    and that block fits with the accelerated pass's reduction buffer, on
    x_piece's own pieces (so the partial sums are one pair a piece on
    either kernel)."""
    r = nk // 2
    piece = trl.x_piece(gx, r)
    smem = trl.x_pass_smem_bytes(nk, piece)
    assert smem % 16 == 0
    # It holds every column a window reads: the piece and its halos.
    lead = (r + 3) // 4 * 4
    assert smem // 4 >= lead + piece + r
    fits = nk <= trl.PASS_MAX_TAPS and smem + trl._X_STATIC_BYTES <= trl._SMEM_BYTES
    assert trl.x_pass_route(gx, nk) == ("compiled" if fits else "runtime")


def test_fused_bound_takes_at_least_what_it_took():
    """fused_bound_error's bound is the runtime kernels' (the compiled
    passes run inside it): every geometry the rule before the compiled
    passes took is still taken, over a sweep of radii and shapes."""
    def before(shape, radii):
        if (32 + 2 * max(radii[:2])) * 128 * 4 > 232448:
            return False
        gx, rx = shape[2], radii[2]
        if (gx + 2 * rx) * 4 + 64 <= 232448:
            return True
        piece = ((232448 - 64) // 4 - 2 * rx) // 128 * 128
        return piece >= 128

    rng = np.random.default_rng(0)
    cases = [((158, 2928, 1636), (15, 20, 18)), ((136, 2908, 1620), (4, 10, 10)),
             ((6, 440, 40), (1, 215, 1)), ((4, 10, 60000), (1, 1, 28000))]
    cases += [(tuple(int(v) for v in rng.integers(1, 70000, 3)),
               tuple(int(v) for v in rng.integers(0, 30000, 3))) for _ in range(300)]
    for shape, radii in cases:
        if before(shape, radii):
            assert trl.fused_bound_error(shape, radii) is None, (shape, radii)


def test_rl_pass_build_kind_keys_its_tap_count(tmp_path, monkeypatch):
    """Kind ``rl_pass``: one library a tap count, keyed by the source and
    headers, compiled with -DRL_PASS_NK; a second request finds it."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    source, prefix, entries, macros = build.GEOMETRY_KERNELS["rl_pass"]
    assert (source, prefix, macros) == ("rl_pass.cu", "RL_PASS", ("NK",))
    assert set(entries) == {"shrimpy_axis_pass", "shrimpy_x_pass", "shrimpy_x_pass_accel"}
    paths = {nk: build.geometry_library_path("rl_pass", (nk,)) for nk in (31, 37, 41)}
    assert len(set(paths.values())) == 3
    assert all(p.name.startswith("librl_pass_") and p.name.endswith(f"_{nk}.so")
               for nk, p in paths.items())
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    log = tmp_path / "calls"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    got = build.build_geometries([("rl_pass", (37,)), ("rl_pass", (31,))])
    assert got == [paths[37], paths[31]] and all(p.exists() for p in got)
    assert build.build_geometries([("rl_pass", (37,))]) == [paths[37]]
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert sorted(c.split("-DRL_PASS_NK=")[1].split()[0] for c in calls) == ["31", "37"]
    assert all("rl_pass.cu" in c and "arch=compute_90a,code=sm_90a" in c for c in calls)


def _axis_walk(nk, n, tile):
    """The axis pass's loop (``axis_pass_kernel``) in numpy over one
    column: per output, the (tap, input) pairs in the order its ring slot
    takes them."""
    r = nk // 2
    got = {o: [] for o in range(n)}
    for n0 in range(0, n, tile):
        n1 = min(n0 + tile, n)
        slot_of = {}  # ring slot -> output it holds
        m_top, m_end = n1 - 1 + r, n0 - r
        m0 = m_top
        while m0 >= m_end:
            for j in range(nk):
                m = m0 - j
                for s in range(nk):
                    t = (j - s) % nk
                    o = m + t - r  # the output in slot s: o + r - m = t
                    if t == 0:
                        slot_of[s] = o
                    if slot_of.get(s) == o and n0 <= o < n1:
                        got[o].append((t, m))
                e = (j + 1) % nk
                o = m0 - j + r
                if n0 <= o < n1:
                    assert slot_of[e] == o
                slot_of.pop(e, None)
            m0 -= nk
    return got


@pytest.mark.parametrize("nk,n,tile", [(31, 158, 158), (41, 90, 37), (5, 9, 4), (1, 5, 2),
                                       (9, 4, 3), (3, 40, 7), (41, 7, 3)])
def test_axis_ring_gives_each_output_its_taps_in_order(nk, n, tile):
    r = nk // 2
    for o, pairs in _axis_walk(nk, n, tile).items():
        assert pairs == [(t, o + r - t) for t in range(nk)], o


@pytest.mark.parametrize("nk,length", [(37, 1636), (21, 1620), (1, 9), (5, 17), (63, 70),
                                       (45, 21), (3, 128)])
def test_x_window_gives_each_output_its_taps_in_order(nk, length):
    """``x_window``'s chunks walked from the top, a thread's 4 outputs
    at a time: each output takes element s of the staged piece (the
    column s - round4(r)) with tap i + r + round4(r) - s, in ascending
    tap order, from inside the staged floats."""
    r, lead = nk // 2, (nk // 2 + 3) // 4 * 4
    chunks = (3 + lead + r) // 4 + 1
    staged = trl.x_pass_smem_bytes(nk, length) // 4
    for g in range(-(-length // 4)):
        order = {i: [] for i in range(4)}
        for c in range(chunks - 1, -1, -1):
            for e in range(3, -1, -1):
                s = 4 * g + 4 * c + e
                assert s < staged
                for i in range(4):
                    t = i + r + lead - (4 * c + e)
                    if 0 <= t < nk:
                        order[i].append((t, s - lead))
        for i in range(min(4, length - 4 * g)):
            x = 4 * g + i
            assert order[i] == [(t, x + r - t) for t in range(nk)]

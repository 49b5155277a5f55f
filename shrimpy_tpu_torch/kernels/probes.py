"""On-chip probes: what a kernel design for this card may rely on
(counterpart of ``scripts/probe_mosaic.py``; kernels in ``csrc/probes.cu``).

* :func:`probe_dynamic_smem_slice` — a slice of dynamic shared memory at
  a run-time offset (TPU: ``probe_dynamic_lane_slice``, a dynamic
  128-aligned lane slice of an on-chip buffer);
* :func:`probe_smem` — whether a block launches with ``kb`` KB of opt-in
  dynamic shared memory, every word touched and read back (TPU:
  ``probe_vmem``): :func:`smem_touch_cuda` launches the block, which
  leaves its two words on the card, and :func:`smem_touch_check` reads
  them; :func:`largest_smem` queues every size of :data:`SMEM_KB`, reads
  all answers after one synchronisation and confirms the constant
  ``_SMEM_BYTES`` that three kernels' bounds rely on;
* :func:`probe_split_dot` — a (128, 160) @ (160, 512) product on the
  tensor cores through ``wgmma.mma_async``, as bf16x3 hi/lo, one-pass
  TF32, 3xTF32 and one-pass bf16, beside a float32 FMA product on the
  CUDA cores (TPU: ``probe_bf16_dot``), each held against float64. Every
  mode is one launch that loads float32 tiles and splits them in shared
  memory.

Each probe has a plain PyTorch version (what a CPU tensor runs) and a
launch count; :func:`empty_launch` launches an empty kernel of a probe's
launch shape, the floor its time is read against. Run them all on the
card with ``python -m shrimpy_tpu_torch.kernels.probes``: it prints the
results, asserts what must hold (the slice is exact, the largest block
is ``_SMEM_BYTES``, bf16x3 and 3xTF32 are within 1e-5 of float64) and
reports the one-pass errors without gating them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from shrimpy_tpu_torch.ops.rl_fused import _SMEM_BYTES, _check_cuda_operand

SLICE_SHAPE, SLICE_WIDTH = (8, 512), 128
SMEM_KB = (48, 96, 164, 200, 227, 228)
DOT_SHAPES = ((128, 160), (160, 512))
DOT_MODES = {"bf16x3": 0, "tf32": 1, "tf32x3": 2, "bf16": 3, "fma": 4}
SPLIT_RTOL = 1e-5  # bf16x3 and 3xTF32 against float64
DOT_MULTIPLES = (64, 8, 8)  # m, n, k of split_dot_cuda: wgmma's 64 rows, the TF32 depth
SMEM_BYTES_PER_CLOCK = 128  # one SM's shared memory
_PATTERN = 2654435761


def dynamic_smem_slice_plain(x: torch.Tensor, width: int = SLICE_WIDTH) -> torch.Tensor:
    """Block ``i`` of the output is twice the ``width``-column slice
    ``max(i - 1, 0)`` of ``x``."""
    if x.is_cuda:
        dynamic_smem_slice_plain.cuda_calls += 1
    n = x.shape[1] // width
    return torch.cat([2.0 * x[:, max(i - 1, 0) * width:(max(i - 1, 0) + 1) * width]
                      for i in range(n)], dim=1)


dynamic_smem_slice_plain.cuda_calls = 0


def dynamic_smem_slice_cuda(x: torch.Tensor, width: int = SLICE_WIDTH) -> torch.Tensor:
    """The same with the kernel: ``x`` (rows, cols) is staged whole in
    dynamic shared memory and sliced at an offset computed in the block."""
    if x.dim() != 2 or x.shape[1] % width:
        raise ValueError(f"the slice probe takes (rows, n * {width}), got {tuple(x.shape)}")
    _check_cuda_operand("x", x, tuple(x.shape))
    if width != SLICE_WIDTH or x.data_ptr() % 16:
        raise ValueError(f"the slice kernel takes width {SLICE_WIDTH} and a 16-byte aligned x, "
                         f"got width {width} and x {x.data_ptr() % 16} bytes past a boundary")
    if x.numel() * 4 > _SMEM_BYTES:
        raise ValueError(f"{tuple(x.shape)} float32 exceeds a block's shared memory")
    from shrimpy_tpu_torch.kernels.build import check, load_library

    out = torch.empty_like(x)
    check(load_library().shrimpy_probe_smem_slice(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], width,
        torch.cuda.current_stream(x.device).cuda_stream), "shrimpy_probe_smem_slice")
    dynamic_smem_slice_cuda.launches += 1
    return out


dynamic_smem_slice_cuda.launches = 0


def probe_dynamic_smem_slice(device="cuda") -> bool:
    """Run the slice probe on ``arange(8 * 512)`` and compare with the
    same indexing in torch: exact, or False."""
    x = torch.arange(SLICE_SHAPE[0] * SLICE_SHAPE[1], dtype=torch.float32,
                     device=device).reshape(SLICE_SHAPE)
    want = dynamic_smem_slice_plain(x.cpu())
    got = dynamic_smem_slice_cuda(x) if x.is_cuda else dynamic_smem_slice_plain(x)
    return bool(torch.equal(got.cpu(), want))


def smem_touch_plain(kb: int) -> tuple[int, int]:
    """What a block that holds ``kb`` KB reports: the number of 32-bit
    words, and the sum of the pattern ``i * 2654435761`` modulo 2^32."""
    words = kb * 1024 // 4
    i = torch.arange(words, dtype=torch.int64)
    return words, int(((i * _PATTERN) % 2**32).sum() % 2**32)


def _card(device, name: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{name} asks the card: it has no CPU version but smem_touch_plain")
    return dev


def smem_touch_cuda(kb: int, out: torch.Tensor) -> bool:
    """Launch one block that holds ``kb`` KB of opt-in dynamic shared
    memory; it writes the words that read back right and the sum of the
    pattern into ``out`` (2 int32 on the card) and nothing is read back.
    A refused opt-in or launch returns False, not an error: it is what
    the probe asks."""
    _check_cuda_operand("out", out, (2,), torch.int32)
    from shrimpy_tpu_torch.kernels.build import load_library

    code = load_library().shrimpy_probe_smem(out.data_ptr(), kb * 1024,
                                             torch.cuda.current_stream(out.device).cuda_stream)
    if code != 0:
        return False
    smem_touch_cuda.launches += 1
    return True


smem_touch_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _touch_expected(kb: int) -> tuple[int, int]:
    return smem_touch_plain(kb)


def smem_touch_check(out: torch.Tensor, kb: int) -> bool:
    """Whether the two words a block of ``kb`` KB left in ``out`` are
    :func:`smem_touch_plain`'s (worked out once a size)."""
    good, total = (int(v) % 2**32 for v in out.cpu())
    return (good, total) == _touch_expected(kb)


def probe_smem(kb: int, device="cuda") -> bool:
    """Whether one block launches with ``kb`` KB of opt-in dynamic shared
    memory and reads every word back right."""
    out = torch.empty(2, dtype=torch.int32, device=_card(device, "probe_smem"))
    return smem_touch_cuda(kb, out) and smem_touch_check(out, kb)


def largest_smem(device="cuda") -> int:
    """The largest of :data:`SMEM_KB` that launches and reads back right,
    in bytes: every size queued, then one synchronisation and one read."""
    dev = _card(device, "largest_smem")
    out = torch.empty((len(SMEM_KB), 2), dtype=torch.int32, device=dev)
    ran = [smem_touch_cuda(kb, out[i]) for i, kb in enumerate(SMEM_KB)]
    torch.cuda.synchronize(dev)
    words = out.cpu()
    fits = [kb for kb, r, w in zip(SMEM_KB, ran, words) if r and smem_touch_check(w, kb)]
    return max(fits) * 1024 if fits else 0


def smem_bound_ms(bytes_moved: float, sm_clock_mhz: float) -> float:
    """The least time one SM takes to move ``bytes_moved`` through its
    shared memory, :data:`SMEM_BYTES_PER_CLOCK` a clock at
    ``sm_clock_mhz``: the bound of a one-block probe."""
    return bytes_moved / SMEM_BYTES_PER_CLOCK / (sm_clock_mhz * 1e3)


def smem_touch_bytes(kb: int) -> int:
    """Shared-memory bytes the block of ``kb`` KB moves: each word written
    once and read once."""
    return 2 * kb * 1024


def empty_launch(blocks: int, threads: int, smem_bytes: int = 0, device="cuda") -> None:
    """Launch an empty kernel of ``blocks`` blocks of ``threads`` threads
    with ``smem_bytes`` of dynamic shared memory: the floor of a launch
    of that shape."""
    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(load_library().shrimpy_probe_empty(
        blocks, threads, smem_bytes, torch.cuda.current_stream(torch.device(device)).cuda_stream),
        "shrimpy_probe_empty")
    empty_launch.launches += 1


empty_launch.launches = 0


def split_dot_launch(m: int, n: int, mode: str) -> tuple[int, int, int]:
    """The launch of ``mode`` at (m, n): blocks, threads a block and bytes
    of dynamic shared memory (from the kernel library)."""
    import ctypes

    from shrimpy_tpu_torch.kernels.build import check, load_library

    shape = (ctypes.c_int * 3)()
    check(load_library().shrimpy_probe_split_dot_launch(m, n, DOT_MODES[mode], shape),
          "shrimpy_probe_split_dot_launch")
    return tuple(shape)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_dot_plain(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """The split product of ``mode`` with exact accumulation: the
    operands rounded and split as the kernel does, the products taken by
    ``torch.matmul`` in float64."""
    if mode not in DOT_MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(DOT_MODES)}")
    if a.is_cuda:
        split_dot_plain.cuda_calls += 1
    if mode == "fma":
        return a.double() @ b.double()
    if mode.startswith("bf16"):
        def big(v):
            return v.to(torch.bfloat16).float()
    else:
        big = round_tf32
    a_big, b_big = big(a), big(b)
    out = a_big.double() @ b_big.double()
    if mode.endswith("x3"):
        a_small, b_small = big(a - a_big), big(b - b_big)
        out = a_small.double() @ b_big.double() + a_big.double() @ b_small.double() + out
    return out


split_dot_plain.cuda_calls = 0


def split_dot_cuda(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` in float32 with the hand-written product of ``mode``, one
    launch: ``wgmma`` tensor-core tiles of the pieces split in the kernel
    (bf16x3, tf32, tf32x3, bf16) or float32 FMAs (fma). m is a multiple of
    64, n and k of 8 (:data:`DOT_MULTIPLES`)."""
    if mode not in DOT_MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(DOT_MODES)}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"split_dot_cuda takes (m, k) @ (k, n), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if any(v <= 0 or v % q for v, q in zip((m, n, k), DOT_MULTIPLES)):
        raise ValueError(f"split_dot_cuda: ({m}, {k}) @ ({k}, {n}) needs m a multiple of "
                         f"{DOT_MULTIPLES[0]}, n of {DOT_MULTIPLES[1]} and k of {DOT_MULTIPLES[2]}")
    _check_cuda_operand("a", a, (m, k))
    _check_cuda_operand("b", b, (k, n))
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("split_dot_cuda copies a and b in 16-byte pieces: they must be "
                         "16-byte aligned")
    from shrimpy_tpu_torch.kernels.build import check, load_library

    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    check(load_library().shrimpy_probe_split_dot(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, DOT_MODES[mode],
        torch.cuda.current_stream(a.device).cuda_stream), "shrimpy_probe_split_dot")
    split_dot_cuda.launches += 1
    return c


split_dot_cuda.launches = 0


def dot_operands(device="cpu", seed: int = 0, shapes=DOT_SHAPES):
    """Standard-normal operands of ``shapes`` (the probe's (128, 160) and
    (160, 512)), from a numpy seed."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
                 for shape in shapes)


def probe_split_dot(device="cuda", seed: int = 0) -> dict:
    """``max|c - ref| / max|ref|`` against the float64 product for every
    mode (``err``), and of the kernel against its plain version
    (``vs_plain``: what float32 accumulation adds to the split). On a
    CPU device only the plain versions run."""
    a, b = dot_operands(device, seed)
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    res = {}
    for mode in DOT_MODES:
        plain = split_dot_plain(a.cpu(), b.cpu(), mode)
        got = split_dot_cuda(a, b, mode).double().cpu() if a.is_cuda else plain
        res[mode] = {"err": float((got - ref.cpu()).abs().max()) / scale,
                     "vs_plain": float((got - plain).abs().max()) / scale}
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the probes ask the card: torch.cuda.is_available() is False")
    print(f"card: {torch.cuda.get_device_name(0)}")
    ok = probe_dynamic_smem_slice()
    print(f"dynamic_smem_slice: {'OK' if ok else 'WRONG RESULT'}")
    for kb in SMEM_KB:
        print(f"smem {kb} KB: {'OK' if probe_smem(kb) else 'refused'}")
    largest = largest_smem()
    print(f"largest block: {largest} bytes (_SMEM_BYTES = {_SMEM_BYTES})")
    dots = probe_split_dot()
    for mode, r in dots.items():
        print(f"split_dot {mode}: rel err vs float64 {r['err']:.3e} (vs its plain version "
              f"{r['vs_plain']:.3e})")
    assert ok, "the dynamic shared-memory slice is wrong"
    assert largest == _SMEM_BYTES, f"largest block {largest} != {_SMEM_BYTES}"
    for mode in ("bf16x3", "tf32x3"):
        assert dots[mode]["err"] <= SPLIT_RTOL, f"{mode}: {dots[mode]['err']:.3e} > {SPLIT_RTOL}"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

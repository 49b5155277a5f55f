"""Where the time of one production step goes, on one NVIDIA GPU.

Run from the repository root: ``python3 profile_step.py``. For each
path ``chip_smoke.py`` drives (deskew + RL-20 and deskew + Biggs RL-10
on the ``fused``, ``fused_iter``, ``linear_pallas`` and ``zy_pallas``
backends, deskew + RL-20 on ``matmul``, and deskew + register-apply +
RL-20 on ``fused``) it runs one warm step under
``torch.profiler`` and prints:

* ``wall``: host time of the profiled step, launch to synchronise;
* ``busy``: the union of the device events' intervals (kernels, copies,
  memsets) in that step, so overlapping events are counted once;
* ``idle = 1 - busy / wall``;
* ``sum``: the device events' durations added up, and the events by
  name (total ms, count), largest first.

Only device events are read: the CPU-side rows of ``key_averages()``
repeat the time of the kernels they launch.

``python3 profile_step.py --tiles`` instead times, at the production
carry (CUDA events, warm, 5 launches each): the one-launch half-step
kernel ``rl_half`` in mode ``ratio`` on every (ty, tx) tile of
``ops/rl_fused.py::HALF_TILES`` and :data:`MORE_HALF_TILES` that fits a
block (each tile is a compilation of the kernel), then all five modes
on the tile the wrapper picks beside the three-pass route's times, and
mode ``ratio`` with the PSFs of :data:`MORE_PSFS`; and the
whole-iteration kernel ``rl_iter`` on every tile of
``ops/rl_fused_iter.py::TILES`` whose block fits (each a compilation).
Each output is checked against the first tile's.

``--tiles`` also times the z+y march ``csrc/convzy.cu`` on every tile
of ``ops/conv3_cuda.py::CONVZY_TILES`` and :data:`MORE_ZY_TILES` that
fits, both boundaries, each output checked against the first tile's;
then beside the variants of its source in :data:`ZY_VARIANTS` (planes in
flight, the order of a step's passes, the registers that keep older
planes; copies built under ``shrimpy_tpu_torch/build/``), timed in turns
on its first tile and held to the kernel's bits.

``python3 profile_step.py --mesh`` starts four gloo ranks on cuda:0 and
times a tiled ``all_to_all`` of CUDA complex64 over them, given to gloo
as it is (``parallel/mesh.py``'s way) and staged through pageable host
tensors, at
``chip_smoke.py`` phase 4t(d)'s carry and a small shape; then runs phase
4t alone.

``python3 profile_step.py --deskew`` times the deskew kernel
``csrc/deskew.cu`` and the variants of its source in
:data:`DESKEW_VARIANTS` (band slots, rows a thread) on the tiles of
:data:`DESKEW_TILES`, at the production raw and at ``BASELINE.md``
config 1, each output held to the kernel's bits, beside the time of a
copy of the raw and a fill of the output.

``python3 profile_step.py --conv-axis`` times the three-pass route's
compiled passes (``csrc/rl_pass.cu``: the z and y passes and the x pass)
beside ``csrc/rl_fused.cu``'s runtime-length kernels, in turns, at
``BASELINE.md`` config 2's grid and on the headline's launches at the
production carry, then beside builds with registers capped
(:data:`PASS_VARIANTS`) and, for config 2's y pass, other tiles
(:data:`Y_TILES`), each output held to the compiled pass's bits.

``python3 profile_step.py --config2`` measures the PSF of ``chip_smoke.py``
phase 4p's beads and runs one warm deskew + RL-20 step with it (the
three-pass route, K = 24) under ``torch.profiler``, its device events by
kind (:func:`pass_kind`), then times one term's z+y step on the march
(``csrc/convzy.cu``) at tile (8, 32) beside the compiled z and y passes.

``python3 profile_step.py --affine`` times the warp and the refine's kernels of
``csrc/affine.cu`` beside builds of the edits in :data:`AFFINE_VARIANTS`
(the unroll of the x loop the three kernels share, a cap on registers), at the deskewed volume on
``chip_smoke.py``'s four maps and at the refine grid, each output held to
the kernel's bits, with each build's register counts.

``python3 profile_step.py --conv3`` times ``conv3_circular``'s one
launch (``csrc/rl_half.cu`` built with ``RL_HALF_WRAP=1``) at the
production carry beside the zero boundary's build and the variants in
:data:`CONV3_VARIANTS` (where its blocks take their slab), with each
build's registers and spills, and prints a profile build's clocks a
plane step over the blocks in the grid and those on a seam.

``python3 profile_step.py --probes`` times the split products of
``csrc/probes.cu`` (each mode alone, launches back to back) beside the
builds of :data:`PROBE_VARIANTS` (product and fma tiles, the threads that
split, and two builds timed only: no products, no pieces stored), each
held to the kernel's bits, with each build's registers.

``python3 profile_step.py --refine`` runs one warm ``estimate_registration``
at the deskewed shape under ``torch.profiler`` (as a step above), then one
with no refine step.

``python3 profile_step.py --rl-input`` times RL-20 on ``fused`` alone on
the deskewed production volume, on its registered warp and on the
deskewed volume zeroed where the warp has no support.

``python3 profile_step.py --fft`` runs one warm call of each FFT path
of ``chip_smoke.py`` (``bench.py`` config 6: RL-20 ``fft2z`` with the
non-separable ``tilted_gaussian_psf()`` at (128, 2888, 1600); config 8:
hybrid, 16 warm + 6 exact) under ``torch.profiler`` as above, and sums
the device events by kind: transforms (cuFFT), the band
(``csrc/zband.cu``), the separable warm phase's kernels and the
elementwise rest. ``--phase`` does the same for the phase step at
(64, 2048, 2048), the transfer function computed on the host before
the window.

``python3 profile_step.py --track`` runs one warm tracking update of each
method of ``chip_smoke.py`` phase 4m (``preprocessing: [deskew]`` at the
production raw) under ``torch.profiler`` as above, and sums the device
events by kind (:func:`track_kind`): transforms, the deskew kernel, the
blur's convolutions, reductions and scans, copies, the elementwise rest.

``python3 profile_step.py --vs`` runs one warm ``VirtualStainer.predict``
of the default unet25d and of unext2 at ConvNeXt-V2 Tiny widths
(``chip_smoke.py`` phase 4n's nets, seeded weights) on a (64, 2048, 2048)
volume under ``torch.profiler`` as above, and sums the device events by
kind (:func:`vs_kind`): convolutions (cuDNN), dense products (cuBLAS),
normalisation and elementwise, copies.

``python3 profile_step.py --train`` runs one warm training step
(``models/train.py``'s ``train_step``: forward, MSE, backward, AdamW) of
each run of ``chip_smoke.py`` phase 4o (the default unet25d and unext2 at
Tiny widths at batch 4, patch 128; unet25d at batch 16, patch 256) on a
batch already on the card under ``torch.profiler`` as above, and sums the
device events by kind (:func:`train_kind`): forward and backward
convolutions, products, LayerNorm and its backward, AdamW's elementwise
passes, copies and casts, the elementwise rest.

``python3 profile_step.py --zband`` times the band kernel
``csrc/zband.cu`` beside builds of the edits in :data:`ZBAND_VARIANTS`
(a cap on registers for more warps an SM, smaller blocks, the taps read
from memory at every output instead of kept in registers), in turns, at
the production grid (144, 3000, 961) with kz = 15, both modes, each
output held to the kernel's bits, with each build's registers.

``python3 profile_step.py --stages`` builds ``csrc/rl_half.cu`` with
``-DRL_HALF_PROFILE``, ``csrc/rl_iter.cu`` with ``-DRL_ITER_PROFILE``
and ``csrc/convzy.cu`` with ``-DCONVZY_PROFILE`` and prints, for a few
tiles, the clocks that thread 0 of a block spends in each stage of a
plane step (mean over the blocks and plane steps; what it waits at a
barrier is part of the stage before it, unless the barrier is a stage of
its own).

``python3 profile_step.py --child-start`` times a child process's start as
``chip_smoke.py``'s children make it, in turns, twice: ``import torch``
with a CUDA tensor, and the ``reconstruct`` verb's imports with one, each
without a bytecode prefix (as before the smoke kept one) and reading the
prefix a writer process has filled, as the smoke fills it.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch


def device_events(prof):
    """(name, start_us, end_us) of every device event of ``prof``: kernels,
    copies and memsets, not the optimizer's range that the profiler also
    draws on the device timeline (``Optimizer.step#AdamW.step``, spanning
    the optimizer's kernels)."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("Optimizer.")]


def union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def kind(name: str) -> str:
    """The kind of a device event: transforms, the band, the separable
    kernels, or the elementwise rest (copies, pads, products)."""
    low = name.lower()
    if "fft" in low:
        return "transforms"
    if "zband" in low:
        return "band"
    if any(k in low for k in ("rl_half", "conv_axis", "conv_x", "gemm", "sgemm", "dgemm")):
        return "separable"
    return "elementwise"


def track_kind(name: str) -> str:
    """The kind of a device event of a tracking update: transforms, the
    deskew kernel, the blur's convolutions (cuDNN), reductions and scans
    (sums, min/max, argmax, cumsum, bincount), copies, or the elementwise
    rest."""
    low = name.lower()
    if "fft" in low:
        return "transforms"
    if "deskew" in low:
        return "deskew"
    if any(k in low for k in ("cudnn", "xmma", "implicit", "convolve", "conv2d", "conv1d",
                              "fprop", "winograd")):
        return "convolution"
    if any(k in low for k in ("reduce", "scan", "cumsum", "bincount", "histogram", "argmax")):
        return "reductions"
    if any(k in low for k in ("memcpy", "copy", "index", "cat", "gather", "scatter")):
        return "copies"
    return "elementwise"


def vs_kind(name: str) -> str:
    """The kind of a device event of a VS forward: convolutions (cuDNN's
    implicit GEMMs, PyTorch's depthwise kernel), dense products (cuBLAS's
    GEMMs and ``nvjet`` kernels), copies (casts, layout transforms, concat,
    gathers), or normalisation and elementwise."""
    low = name.lower()
    if any(k in low for k in ("fprop", "implicit", "conv", "winograd", "cudnn")):
        return "convolutions"
    if any(k in low for k in ("gemm", "matmul", "nvjet")):
        return "products"
    if any(k in low for k in ("memcpy", "copy", "cat", "index", "gather", "scatter", "nchw",
                              "nhwc", "transpose", "shuffle")):
        return "copies"
    return "normalisation and elementwise"


def train_kind(name: str) -> str:
    """The kind of a device event of a training step: forward or backward
    convolutions (cuDNN's fprop, dgrad and wgrad, PyTorch's depthwise
    kernels), dense products, LayerNorm and its backward, AdamW's
    elementwise passes (``multi_tensor_apply``), copies and casts, or the
    elementwise rest (GELU and its backward, the GRN, the loss)."""
    low = name.lower()
    if "layer_norm" in low or "gammabeta" in low:
        return "LayerNorm and its backward"
    if any(k in low for k in ("dgrad", "wgrad", "bprop")) or (
            "conv" in low and ("backward" in low or "grad" in low)):
        return "convolutions, backward"
    if any(k in low for k in ("fprop", "implicit", "winograd", "conv", "cudnn")):
        return "convolutions, forward"
    if any(k in low for k in ("gemm", "matmul", "nvjet")):
        return "products"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "AdamW's elementwise passes"
    if any(k in low for k in ("memcpy", "copy", "cat", "index", "gather", "scatter", "nchw",
                              "nhwc", "transpose", "shuffle")):
        return "copies and casts"
    return "elementwise rest"


def profile(step, batch, kind_of=kind) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    step(batch)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    busy = union_us([(s, e) for _, s, e in events]) / 1e3
    total = sum(e - s for _, s, e in events) / 1e3
    print(f"  wall {wall:.3f} ms; busy {busy:.3f} ms; idle {1 - busy / wall:.4f}; "
          f"sum {total:.3f} ms over {len(events)} device events", flush=True)
    by_name = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        by_name[name][0] += (e - s) / 1e3
        by_name[name][1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:10.3f} ms  x{n:4d}  {name[:100]}", flush=True)
    kinds = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        kinds[kind_of(name)][0] += ms
        kinds[kind_of(name)][1] += n
    print("  by kind: " + ", ".join(f"{k} {ms:.3f} ms ({n})" for k, (ms, n) in
                                    sorted(kinds.items(), key=lambda kv: -kv[1][0])), flush=True)
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "kinds": {k: v[0] for k, v in kinds.items()}}


# Edits of csrc/zband.cu that --zband builds and times beside it.
ZBAND_VARIANTS = {
    "3 blocks an SM": [("__launch_bounds__(kThreads)\nzband_reg_kernel",
                        "__launch_bounds__(kThreads, 3)\nzband_reg_kernel")],
    "4 blocks an SM": [("__launch_bounds__(kThreads)\nzband_reg_kernel",
                        "__launch_bounds__(kThreads, 4)\nzband_reg_kernel")],
    "128 threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "taps from memory": [
        ("float2 acc = cmul(tap[0], win[r % KZ]);",
         "float2 acc = cmul(tap_of(h, KZ, 0, cols, col, corr), win[r % KZ]);"),
        ("acc = cadd(acc, cmul(tap[t], win[(r + t) % KZ]));",
         "acc = cadd(acc, cmul(tap_of(h, KZ, t, cols, col, corr), win[(r + t) % KZ]));")],
}


def sweep_zband(cs) -> None:
    """The band kernel beside the builds of ZBAND_VARIANTS, in turns."""
    import ctypes
    import subprocess

    from shrimpy_tpu_torch.kernels import build

    source = (build.CSRC_DIR / "zband.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, edits) in enumerate(ZBAND_VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/zband.cu no longer has {old!r} ({label})")
            text = text.replace(old, new)
        src = build.BUILD_DIR / f"zband_variant{i}.cu"
        src.write_text(text)
        lib = build.BUILD_DIR / f"libzband_variant{i}.so"
        cmd = [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))
    libs = {"kernel": build.load_library()}
    for label, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{err}")
        regs = [line.split("Used ")[1].split(",")[0] for line in err.splitlines()
                if "Used" in line and "registers" in line]
        print(f"  {label}: registers by instance {regs}", flush=True)
        libs[label] = ctypes.CDLL(str(lib))
        libs[label].shrimpy_zband.argtypes = build.SIGNATURES["shrimpy_zband"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    (gz, gy, gxr), kz = cs.BAND_CASES[0]
    spec, taps = cs.complex_uniform((gz, gy, gxr), gen), cs.complex_uniform((kz, gy, gxr), gen)
    outs = {which: torch.empty_like(spec) for which in ("kernel", "variant")}
    stream = torch.cuda.current_stream().cuda_stream
    for mode in (0, 1):
        def run(which, out):
            return libs[which].shrimpy_zband(spec.data_ptr(), taps.data_ptr(), out.data_ptr(),
                                             gz, kz, gy * gxr, mode, stream)

        build.check(run("kernel", outs["kernel"]), "shrimpy_zband")
        for label in ZBAND_VARIANTS:
            build.check(run(label, outs["variant"]), f"shrimpy_zband ({label})")
            torch.cuda.synchronize()
            if not torch.equal(outs["variant"], outs["kernel"]):
                raise AssertionError(f"zband {label}: bits differ from the kernel's")
            times = {"kernel": [], label: []}
            for which in ("kernel", label, label, "kernel"):
                out = outs["kernel" if which == "kernel" else "variant"]
                times[which].append(cs.kernel_ms(lambda: run(which, out), 10))
            k, v = sum(times["kernel"]) / 2, sum(times[label]) / 2
            print(f"  zband mode {mode} {label}: {v:.3f} ms {times[label]} beside the kernel "
                  f"{k:.3f} {times['kernel']} ({100 * (v - k) / k:+.2f} %)", flush=True)


def profile_fft(cs) -> None:
    """One warm call of bench.py configs 6 and 8 under the profiler."""
    from shrimpy_tpu_torch.io.synthetic import tilted_gaussian_psf
    from shrimpy_tpu_torch.ops.deconv import richardson_lucy

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    vol, psf = cs.uniform(cs.NONSEP_SHAPE, gen, 0.0, 100.0), tilted_gaussian_psf()
    for label, config in (("RL-20 fft2z (config 6)", "config6"),
                          ("hybrid 16 + 6 (config 8)", "config8")):
        s = cs.nonsep_settings(config)
        print(f"== {label} at {cs.NONSEP_SHAPE}", flush=True)
        profile(lambda v: richardson_lucy(v, psf, s), vol)
        torch.cuda.empty_cache()


def profile_phase(cs) -> None:
    """One warm phase step at (64, 2048, 2048) under the profiler."""
    from shrimpy_tpu_torch.config import phase_settings, reconstruct_settings
    from shrimpy_tpu_torch.ops.phase import compute_transfer_function, tf_tensor
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    settings = phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.25})
    t0 = time.perf_counter()
    tf = tf_tensor(compute_transfer_function(cs.PHASE_SHAPE, settings.transfer_function), "cuda")
    print(f"  host transfer function {time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    stack = cs.uniform((1, *cs.PHASE_SHAPE), gen, 0.9, 1.1)
    step = build_reconstruct_step(reconstruct_settings(phase=settings), device="cuda")
    print(f"== phase step at {cs.PHASE_SHAPE}", flush=True)
    profile(lambda b: step(b, tf), stack)


def profile_track(cs) -> None:
    """One warm tracking update a method under the profiler, at the
    production raw through ``preprocessing: [deskew]`` (chip_smoke.py
    phase 4m's data and settings), events summed by ``track_kind``."""
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    centers, amps = cs.track_blobs(gen)
    raws = cs.track_raws(gen, centers, amps)
    cz, cy, cx = (int(round(c)) for c in centers[0])
    slice_zyx = ((cz - 10, cz + 10), (cy - 24, cy + 24), (cx - 24, cx + 24))
    for method in cs.TRACK_METHODS:
        extra = {"template": {"slice_zyx": slice_zyx}} if method == "template_matching" else {}
        cfg = cs.track_config(method, preprocessing=["deskew"],
                              deskew=vars(cs.headline_settings().deskew), **extra)
        pre, tracker = Preprocessor(cfg), Tracker(cfg)
        for t in range(cs.TRACK_TIMEPOINTS - 1):
            tracker.update(pre.tracking_stack(raws[t]), t)
        print(f"== {method}: one warm update at raw {cs.RAW_SHAPE}", flush=True)
        profile(lambda raw: tracker.update(pre.tracking_stack(raw), cs.TRACK_TIMEPOINTS - 1),
                raws[-1], track_kind)
        del pre, tracker
        torch.cuda.empty_cache()


def profile_vs(cs) -> None:
    """One warm ``predict`` of each net of phase 4n under the profiler, by
    ``vs_kind``."""
    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    vol = cs.uniform(cs.PHASE_SHAPE, gen, -1.0, 1.0)
    for label, kw in (("unet25d (VSModelSettings())", {}),
                      ("unext2 plane head", cs.VS_NETS["unext2 plane head"])):
        stainer = VirtualStainer(vs_settings(**kw))
        print(f"== {label}: one warm predict at {cs.PHASE_SHAPE}", flush=True)
        profile(stainer.predict, vol, vs_kind)
        del stainer
        torch.cuda.empty_cache()


def profile_train(cs) -> None:
    """One warm training step of each run of phase 4o under the profiler,
    by ``train_kind``; the batch is on the card before the window."""
    import numpy as np

    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models import train
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer

    rng = np.random.default_rng(cs.SEED)
    for label, kw, batch, patch, _, lr in cs.TRAIN_RUNS:
        settings = vs_settings(**kw, out_channels=cs.TRAIN_TARGETS)
        model = VirtualStainer(settings).model.to("cuda").train()
        opt = train.adamw(model, lr)
        shapes = ((batch, settings.in_slices, patch, patch),
                  (batch, len(cs.TRAIN_TARGETS), patch, patch))
        x, y = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda() for s in shapes)
        print(f"== {label}, batch {batch}, patch {patch}: one warm step", flush=True)
        profile(lambda b: train.train_step(model, opt, *b), (x, y), train_kind)
        del model, opt, x, y
        torch.cuda.empty_cache()


def iter_operands(cs, gen):
    """Stencils, est, data, packed taps at the production carry, and eps."""
    from shrimpy_tpu_torch.ops.rl_fused import Stencil
    from shrimpy_tpu_torch.ops.rl_fused_iter import pack_taps

    terms, carry = cs.production_terms()
    conv, adj = Stencil(terms, device="cuda"), Stencil(terms, flip=True, device="cuda")
    est, data = cs.uniform(carry, gen, 0.5, 10.5), cs.uniform(carry, gen, 0.0, 5.0)
    return conv, adj, est, data, pack_taps(conv, adj, "cuda"), cs.headline_settings().deconvolve.epsilon


def sweep_tiles(cs) -> None:
    """rl_iter at the production carry, one time per tile that fits (each
    tile a compilation of the kernel, all compiled at once)."""
    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.rl_fused_iter import TILES, iter_layout, rl_iter_cuda

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    conv, adj, est, data, taps, eps = iter_operands(cs, gen)
    n_terms, lengths = len(conv.host), tuple(2 * r + 1 for r in conv.radii)
    layouts = {t: iter_layout(est.shape, conv.radii, n_terms, tile=t) for t in TILES}
    build.build_geometries([("rl_iter", (n_terms, *lengths, *t))
                            for t, lay in layouts.items() if lay is not None])
    out, first = torch.empty_like(est), None
    for tile, layout in layouts.items():
        if layout is None:
            print(f"  rl_iter tile {tile}: does not fit", flush=True)
            continue
        ms = cs.gpu_ms(lambda: rl_iter_cuda(est, data, conv, adj, eps, out, taps=taps,
                                            tile=tile), 5)
        if first is None:
            first = out.clone()
        print(f"  rl_iter tile {tile}: {layout['smem_bytes']} bytes a block, {layout['blocks']} "
              f"blocks, {ms:.3f} ms a launch, equal to the first tile's {torch.equal(out, first)}",
              flush=True)


# Tiles of rl_half beside ops/rl_fused.py::HALF_TILES that --tiles times.
MORE_HALF_TILES = ((40, 32), (48, 32), (64, 32))
# (lengths, sigma) of Gaussian PSFs beside the headline's that --tiles times:
# the streaming runtime's default, a deeper and a wider one.
MORE_PSFS = (((9, 15, 15), (1.5, 2.5, 2.5)), ((15, 21, 21), (2.5, 3.0, 3.0)),
             ((9, 31, 31), (1.5, 4.5, 4.5)))
STAGES = ("request aux", "z", "barrier 1", "y", "wait copies", "barrier 2", "x + epilogue",
          "set-up", "step top + cp.async", "TMA issue")
ITER_STAGES = ("B (adjoint y, z, out)", "A.z + ratio", "wait slab", "A.x", "barrier 1",
               "slab request", "A.y", "B.x", "wait cp.async", "barrier 2")


def half_operands(cs, gen):
    """Stencils, (inp, aux, out, dx, g_prev, alpha) at the production
    carry, and eps."""
    from shrimpy_tpu_torch.ops.rl_fused import Stencil

    terms, carry = cs.production_terms()
    conv, adj = Stencil(terms, device="cuda"), Stencil(terms, flip=True, device="cuda")
    inp, aux = cs.uniform(carry, gen, 0.5, 10.5), cs.uniform(carry, gen, 0.0, 5.0)
    dx = cs.uniform(carry, gen, -1.0, 1.0).to(torch.bfloat16)
    g_prev = cs.uniform(carry, gen, 0.0, 1.0).to(torch.bfloat16)
    alpha = torch.tensor(0.6, device="cuda")
    eps = cs.headline_settings().deconvolve.epsilon
    return conv, adj, (inp, aux, torch.empty_like(inp), dx, g_prev, alpha), eps


def sweep_half_tiles(cs) -> None:
    """rl_half at the production carry: mode ratio on every tile that
    fits, then every mode on both routes."""
    from shrimpy_tpu_torch.config import deconvolve_settings
    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf
    from shrimpy_tpu_torch.ops.rl_fused import (
        HALF_TILES,
        Stencil,
        half_layout,
        half_step_one_launch,
        half_step_three_pass,
    )

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    conv, adj, (inp, aux, out, dx, g_prev, alpha), eps = half_operands(cs, gen)
    lengths = tuple(2 * r + 1 for r in conv.radii)
    tiles = [t for t in HALF_TILES + MORE_HALF_TILES
             if half_layout(inp.shape, conv.radii, 1, tile=t) is not None]
    build.build_geometries([("rl_half", (1, *lengths, *t)) for t in tiles])  # all at once
    first = None
    for tile in HALF_TILES + MORE_HALF_TILES:
        layout = half_layout(inp.shape, conv.radii, 1, tile=tile)
        if layout is None:
            print(f"  rl_half tile {tile}: does not fit", flush=True)
            continue
        ms = cs.gpu_ms(lambda: half_step_one_launch(inp, aux, conv, "ratio", eps, out=out,
                                                    tile=tile), 5)
        if first is None:
            first = out.clone()
        print(f"  rl_half tile {tile}: {layout['smem_bytes']} bytes a block, {layout['blocks']} "
              f"blocks, ratio {ms:.3f} ms a launch, equal to the first tile's "
              f"{torch.equal(out, first)}", flush=True)
    del first
    scratch = [torch.empty_like(inp) for _ in range(2)]
    for route, step, kw in (("one_launch", half_step_one_launch, {}),
                            ("three_pass", half_step_three_pass, {"scratch": scratch})):
        calls = {
            "plain": lambda: step(inp, None, conv, "plain", eps, out=out, **kw),
            "ratio": lambda: step(inp, aux, conv, "ratio", eps, out=out, **kw),
            "mult": lambda: step(inp, aux, adj, "mult", eps, out=aux, **kw),
            "ratio_accel": lambda: step(inp, aux, conv, "ratio_accel", eps, out=out, dx=dx,
                                        alpha=alpha, **kw),
            "mult_accel": lambda: step(inp, aux, adj, "mult_accel", eps, dx=dx, g_prev=g_prev,
                                       alpha=alpha, **kw),
        }
        for mode, call in calls.items():
            print(f"  half-step {mode} on {route}: {cs.gpu_ms(call, 5):.3f} ms", flush=True)
        del calls
    del scratch
    # Other PSFs on the carry of the same extent (their own tile and build).
    settings = deconvolve_settings()
    stencils = []
    for shape, sigma in MORE_PSFS:
        terms = plan_terms(prepare_psf(gaussian_psf(shape, sigma), settings), settings)
        stencils.append(Stencil(terms, device="cuda"))
    layouts = [half_layout(inp.shape, st.radii, len(st.host)) for st in stencils]
    build.build_geometries([("rl_half", (len(st.host), *(2 * r + 1 for r in st.radii),
                                         *lay["tile"]))
                            for st, lay in zip(stencils, layouts) if lay is not None])
    for st, layout in zip(stencils, layouts):
        name = f"PSF {tuple(2 * r + 1 for r in st.radii)} x {len(st.host)} term(s)"
        if layout is None:
            print(f"  rl_half {name}: past the one-launch kernel's block", flush=True)
            continue
        ms = cs.gpu_ms(lambda: half_step_one_launch(inp, aux, st, "ratio", eps, out=out), 5)
        print(f"  rl_half {name}: tile {layout['tile']}, {layout['smem_bytes']} bytes a block, "
              f"ratio {ms:.3f} ms a launch", flush=True)
    torch.cuda.empty_cache()


def half_stages(cs, tiles=((32, 64), (16, 64), (8, 32))) -> None:
    """Clocks a plane step of rl_half spends in each of its stages."""
    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.rl_fused import half_layout

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    conv, _, (inp, aux, out, _, _, alpha), eps = half_operands(cs, gen)
    gz, gy, gx = inp.shape
    rz, ry, rx = conv.radii
    tiles = [t for t in tiles if half_layout(inp.shape, conv.radii, 1, tile=t) is not None]
    geometries = [(1, 2 * rz + 1, 2 * ry + 1, 2 * rx + 1, *t) for t in tiles]
    paths = build.build_geometries([("rl_half", g) for g in geometries],
                                   flags=("-DRL_HALF_PROFILE",))
    for tile, path in zip(tiles, paths):
        layout = half_layout(inp.shape, conv.radii, 1, tile=tile)
        lib = build.open_geometry_library("rl_half", path)
        clocks = torch.zeros((layout["blocks"], len(STAGES)), device="cuda")

        def launch():
            build.check(lib.shrimpy_rl_half(
                inp.data_ptr(), aux.data_ptr(), out.data_ptr(), None, None, alpha.data_ptr(),
                clocks.data_ptr(), conv.packed().data_ptr(), 1, 2 * rz + 1, 2 * ry + 1,
                2 * rx + 1, gz, gy, gx, *tile, 1, 1, float(eps),
                torch.cuda.current_stream().cuda_stream), "shrimpy_rl_half (profile build)")

        ms = cs.gpu_ms(launch, 3)
        per_plane = (clocks.mean(dim=0) / gz).tolist()
        stages = ", ".join(f"{name} {c:.0f}" for name, c in zip(STAGES, per_plane))
        print(f"  rl_half tile {tile}: {ms:.3f} ms a launch (profile build); clocks a plane: "
              f"{stages}; total {sum(per_plane):.0f}", flush=True)


def iter_stages(cs, tiles=((32, 48), (48, 32))) -> None:
    """Clocks a plane step of rl_iter spends in each of its stages."""
    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.rl_fused_iter import iter_layout

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    conv, adj, est, data, taps, eps = iter_operands(cs, gen)
    gz, gy, gx = est.shape
    n_terms, lengths = len(conv.host), tuple(2 * r + 1 for r in conv.radii)
    tiles = [t for t in tiles if iter_layout(est.shape, conv.radii, n_terms, tile=t) is not None]
    paths = build.build_geometries([("rl_iter", (n_terms, *lengths, *t)) for t in tiles],
                                   flags=("-DRL_ITER_PROFILE",))
    out = torch.empty_like(est)
    for tile, path in zip(tiles, paths):
        layout = iter_layout(est.shape, conv.radii, n_terms, tile=tile)
        lib = build.open_geometry_library("rl_iter", path)
        clocks = torch.zeros((layout["blocks"], len(ITER_STAGES)), device="cuda")

        def launch():
            build.check(lib.shrimpy_rl_iter(
                est.data_ptr(), data.data_ptr(), out.data_ptr(), taps.data_ptr(),
                clocks.data_ptr(), n_terms, *lengths, gz, gy, gx, *tile, 1, float(eps),
                torch.cuda.current_stream().cuda_stream), "shrimpy_rl_iter (profile build)")

        ms = cs.gpu_ms(launch, 3)
        per_step = (clocks.mean(dim=0) / (gz + 2 * conv.radii[0] + 2)).tolist()
        stages = ", ".join(f"{name} {c:.0f}" for name, c in zip(ITER_STAGES, per_step))
        print(f"  rl_iter tile {tile}: {ms:.3f} ms a launch (profile build); clocks a plane "
              f"step: {stages}; total {sum(per_step):.0f}", flush=True)


# Tiles of the z+y march beside ops/conv3_cuda.py::CONVZY_TILES that
# --tiles times, and the stages of a plane step that --stages reads.
MORE_ZY_TILES = ((128, 16), (16, 64), (48, 32))
ZY_STAGES = ("set-up", "copy issue", "z", "y", "wait copy", "barrier")


def zy_operands(cs, gen):
    """The headline term's stencil and a carry at the production shape."""
    from shrimpy_tpu_torch.ops.rl_fused import Stencil

    terms, carry = cs.production_terms()
    return Stencil(terms[:1], device="cuda"), cs.uniform(carry, gen, 0.0, 10.0)


def sweep_zy_tiles(cs) -> None:
    """The z+y march at the production carry on every tile that fits, both
    boundaries (each tile and boundary a compilation, all at once)."""
    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.conv3_cuda import CONVZY_TILES, convzy_layout, convzy_march

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    st, v = zy_operands(cs, gen)
    nkz, nky = (2 * r + 1 for r in st.radii[:2])
    tiles = [t for t in CONVZY_TILES + MORE_ZY_TILES
             if convzy_layout(v.shape, st.radii[:2], tile=t) is not None]
    build.build_geometries([("convzy", (nkz, nky, *t, w)) for t in tiles for w in (0, 1)])
    out, first = torch.empty_like(v), {}
    for boundary in ("zero", "circular"):
        for tile in tiles:
            layout = convzy_layout(v.shape, st.radii[:2], tile=tile)
            ms = cs.gpu_ms(lambda: convzy_march(v, st.packed()[0], nkz, nky, boundary=boundary,
                                                out=out, tile=tile), 10)
            first.setdefault(boundary, out.clone())
            print(f"  convzy {boundary} tile {tile}: {layout['smem_bytes']} bytes a block, "
                  f"{layout['blocks']} blocks, {ms:.3f} ms a launch, equal to the first tile's "
                  f"{torch.equal(out, first[boundary])}", flush=True)
    torch.cuda.empty_cache()


# Variants of csrc/convzy.cu that --tiles times beside it, each a change of
# its source: planes in flight (kDepth), the order of a step's passes (half
# the warps take the y pass first), the registers that keep older planes.
ZY_VARIANTS = {
    **{f"{d} plane(s) in flight": [("constexpr int kDepth = 3;", f"constexpr int kDepth = {d};")]
       for d in (1, 2, 4, 5)},
    "every warp z pass first": [("const bool y_first = (warp >> 2) & 1;",
                                 "const bool y_first = false;")],
    "every warp y pass first": [("const bool y_first = (warp >> 2) & 1;",
                                 "const bool y_first = true;")],
    "36 registers of kept planes": [("constexpr int kKeepRegisters = 64;",
                                     "constexpr int kKeepRegisters = 36;")],
}


def sweep_zy_variants(cs, tile=(64, 32)) -> None:
    """The z+y march beside variants of its source (:data:`ZY_VARIANTS`,
    copies built under shrimpy_tpu_torch/build/, all at once) at the
    production carry on ``tile``, both boundaries, timed in turns (each
    four times, forward and back), every variant held to the kernel's
    bits."""
    import subprocess

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_march

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    st, v = zy_operands(cs, gen)
    nkz, nky = (2 * r + 1 for r in st.radii[:2])
    taps = st.packed()[0]
    work = build.BUILD_DIR / "convzy_variants"
    work.mkdir(parents=True, exist_ok=True)
    for header in build.headers():
        (work / header.name).write_text(header.read_text())
    source = (build.CSRC_DIR / "convzy.cu").read_text()
    variants, procs = {}, []
    for i, (name, edits) in enumerate({"the kernel": [], **ZY_VARIANTS}.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/convzy.cu no longer has {old!r}")
            text = text.replace(old, new)
        src = work / f"convzy_variant{i}.cu"
        src.write_text(text)
        for wrap in (0, 1):
            lib = work / f"libconvzy_variant{i}_{wrap}.so"
            procs.append(subprocess.Popen(
                [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
                 *(f"-DCONVZY_{m}={x}" for m, x in zip(build.CONVZY_MACROS,
                                                         (nkz, nky, *tile, wrap))),
                 "-shared", "-o", str(lib), str(src)], stderr=subprocess.DEVNULL))
            variants[(name, wrap)] = lib
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a variant of csrc/convzy.cu did not build")
    want = {w: convzy_march(v, taps, nkz, nky, boundary=("zero", "circular")[w],
                            out=torch.empty_like(v)) for w in (0, 1)}
    out, times, keys = torch.empty_like(v), {k: [] for k in variants}, list(variants)
    for key in keys + keys[::-1] + keys + keys[::-1]:
        lib = build.open_geometry_library("convzy", variants[key])
        times[key].append(cs.gpu_ms(lambda: build.check(lib.shrimpy_convzy(
            v.data_ptr(), out.data_ptr(), taps.data_ptr(), nkz, nky, *v.shape, *tile, key[1], 1,
            None, torch.cuda.current_stream().cuda_stream), "shrimpy_convzy (variant)"), 10))
        if not torch.equal(out, want[key[1]]):
            raise AssertionError(f"variant {key} differs from the kernel")
    for (name, wrap), t in times.items():
        print(f"  convzy {('zero', 'circular')[wrap]} tile {tile}, {name}: "
              f"{sum(t) / len(t):.3f} ms a launch {['%.3f' % x for x in t]}", flush=True)
    torch.cuda.empty_cache()


def zy_stages(cs, tiles=((64, 32), (32, 64))) -> None:
    """Clocks a plane step of the z+y march spends in each of its stages."""
    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_layout

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    st, v = zy_operands(cs, gen)
    gz, gy, gx = v.shape
    nkz, nky = (2 * r + 1 for r in st.radii[:2])
    tiles = [t for t in tiles if convzy_layout(v.shape, st.radii[:2], tile=t) is not None]
    jobs = [("convzy", (nkz, nky, *t, w)) for t in tiles for w in (0, 1)]
    paths = build.build_geometries(jobs, flags=("-DCONVZY_PROFILE",))
    out = torch.empty_like(v)
    for (_, geometry), path in zip(jobs, paths):
        layout = convzy_layout(v.shape, st.radii[:2], tile=geometry[2:4])
        lib = build.open_geometry_library("convzy", path)
        clocks = torch.zeros((layout["blocks"], len(ZY_STAGES)), device="cuda")

        def launch():
            build.check(lib.shrimpy_convzy(
                v.data_ptr(), out.data_ptr(), st.packed()[0].data_ptr(), nkz, nky, gz, gy, gx,
                *geometry[2:], 1, clocks.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "shrimpy_convzy (profile build)")

        ms = cs.gpu_ms(launch, 3)
        per_step = (clocks.mean(dim=0) / (gz + nkz + 1)).tolist()
        stages = ", ".join(f"{name} {c:.0f}" for name, c in zip(ZY_STAGES, per_step))
        print(f"  convzy {'circular' if geometry[4] else 'zero'} tile {geometry[2:4]}: {ms:.3f} ms "
              f"a launch (profile build); clocks a plane step: {stages}; total "
              f"{sum(per_step):.0f}", flush=True)
    torch.cuda.empty_cache()


# Variants of csrc/deskew.cu that --deskew times beside it, each a change of
# its source: band slots (in flight: one fewer), the float4 sums a thread
# keeps (rows of a tile it owns).
DESKEW_VARIANTS = {
    "3 slots": [("constexpr int kSlots = 2;", "constexpr int kSlots = 3;")],
    "4 slots": [("constexpr int kSlots = 2;", "constexpr int kSlots = 4;")],
    "8 rows a thread": [("constexpr int kRowsThread = 16;", "constexpr int kRowsThread = 8;")],
    "8 rows a thread, 3 slots": [("constexpr int kRowsThread = 16;",
                                  "constexpr int kRowsThread = 8;"),
                                 ("constexpr int kSlots = 2;", "constexpr int kSlots = 3;")],
}
# (ty, tx) output tiles of the deskew that --deskew times in each variant.
DESKEW_TILES = ((64, 256), (32, 256), (16, 256), (128, 128), (64, 128), (32, 128), (256, 64),
                (128, 64), (64, 64))


def sweep_deskew(cs) -> None:
    """The deskew kernel and the variants of its source in
    :data:`DESKEW_VARIANTS` (copies built under shrimpy_tpu_torch/build/,
    all at once) on every tile of :data:`DESKEW_TILES` that the variant
    takes, at the production raw and at BASELINE.md config 1, timed in
    turns (forward and back), every output held to the kernel's bits."""
    import ctypes
    import subprocess

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.deskew_cuda import TABLE_KEYS, band_rows, deskew_cuda, device_plan

    work = build.BUILD_DIR / "deskew_variants"
    work.mkdir(parents=True, exist_ok=True)
    for header in build.headers():
        (work / header.name).write_text(header.read_text())
    source = (build.CSRC_DIR / "deskew.cu").read_text()
    libs, procs = {}, []
    for i, (name, edits) in enumerate({"the kernel": [], **DESKEW_VARIANTS}.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/deskew.cu no longer has {old!r}")
            text = text.replace(old, new)
        src, lib = work / f"deskew_variant{i}.cu", work / f"libdeskew_variant{i}.so"
        src.write_text(text)
        procs.append(subprocess.Popen([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
                                       "-shared", "-o", str(lib), str(src)],
                                      stderr=subprocess.DEVNULL))
        libs[name] = lib
    if any(proc.wait() != 0 for proc in procs):
        raise RuntimeError("a variant of csrc/deskew.cu did not build")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape, settings in ((cs.RAW_SHAPE, cs.headline_settings().deskew),
                            (cs.CONFIG1_RAW, cs.config1_settings())):
        raw = cs.uniform(shape, gen, 0.0, 100.0)
        want = deskew_cuda(raw, settings)
        tab = device_plan(raw, settings)
        out = torch.empty_like(want)
        runs = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.shrimpy_deskew.argtypes = build.SIGNATURES["shrimpy_deskew"]
            for tile in DESKEW_TILES:
                args = (raw.data_ptr(), out.data_ptr(),
                        *(tab["dev"][k].data_ptr() for k in TABLE_KEYS), *shape, tab["nz"],
                        tab["ny"], tab["n_groups"], tab["a_avg"], *tile, band_rows(tab, tile[0]),
                        1, torch.cuda.current_stream().cuda_stream)
                if lib.shrimpy_deskew(*args) != 0:
                    continue  # the variant does not take the tile
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"deskew {name} tile {tile} differs from the kernel")
                runs[(name, tile)] = (lib, args)
        times = {key: [] for key in runs}
        order = list(runs)
        for key in order + order[::-1]:
            lib, args = runs[key]
            times[key].append(cs.gpu_ms(lambda: lib.shrimpy_deskew(*args), 10))
        for (name, tile), t in sorted(times.items(), key=lambda kv: sum(kv[1])):
            print(f"  deskew {shape} {name}, tile {tile}: {sum(t) / len(t):.3f} ms "
                  f"{['%.3f' % x for x in t]}", flush=True)
        # What the card's memory gives plain traffic of these sizes.
        copy = cs.gpu_ms(lambda: raw.clone(), 10)
        fill = cs.gpu_ms(lambda: out.fill_(0.0), 10)
        print(f"  deskew {shape}: raw.clone() {copy:.3f} ms, {8 * raw.numel() / copy / 1e9:.3f} "
              f"TB/s; out.fill_ {fill:.3f} ms, {4 * out.numel() / fill / 1e9:.3f} TB/s", flush=True)
        del raw, want, out
        torch.cuda.empty_cache()


# Builds of csrc/rl_pass.cu that --conv-axis times beside it, (edits of the
# source, nvcc flags): the axis pass loading a ring pass's inputs only after
# the pass before (no prefetch), and the axis pass's registers capped for 3
# or 4 blocks of 128 threads an SM (nvcc's -maxrregcount does not reach a
# kernel with __launch_bounds__).
_AXIS_BOUNDS = "__launch_bounds__(kAxisThreads)\n    axis_pass_kernel"
PASS_VARIANTS = {
    "no prefetch": ([("constexpr bool kPrefetch = true;", "constexpr bool kPrefetch = false;")],
                    ()),
    "min blocks 3": ([(_AXIS_BOUNDS, _AXIS_BOUNDS.replace("kAxisThreads)", "kAxisThreads, 3)"))],
                     ()),
    "min blocks 4": ([(_AXIS_BOUNDS, _AXIS_BOUNDS.replace("kAxisThreads)", "kAxisThreads, 4)"))],
                     ()),
}


def build_pass_variants(lengths) -> dict:
    """{variant: {tap count: library}} of :data:`PASS_VARIANTS`, each an
    edited copy of csrc/rl_pass.cu compiled for every tap count of
    ``lengths`` under shrimpy_tpu_torch/build/, all nvcc runs at once;
    prints each build's registers by kernel."""
    import subprocess

    from shrimpy_tpu_torch.kernels import build

    source = (build.CSRC_DIR / "rl_pass.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, (edits, flags)) in enumerate(PASS_VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/rl_pass.cu no longer has {old!r} ({label})")
            text = text.replace(old, new)
        src = build.BUILD_DIR / f"rl_pass_variant{i}.cu"
        src.write_text(text)
        for k in lengths:
            lib = build.BUILD_DIR / f"librl_pass_variant{i}_{k}.so"
            cmd = [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, *flags, "-Xptxas",
                   "-v", f"-DRL_PASS_NK={k}", "-I", str(build.CSRC_DIR), "-shared", "-o",
                   str(lib), str(src)]
            procs[(label, k)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.PIPE, text=True))
    libs = {label: {} for label in PASS_VARIANTS}
    for (label, k), (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}, {k} taps:\n{err}")
        regs = [line.split("Used ")[1].split(",")[0] for line in err.splitlines()
                if "Used" in line and "registers" in line]
        print(f"  {label}, {k} taps: registers by kernel {regs}", flush=True)
        libs[label][k] = build.open_geometry_library("rl_pass", lib)
    return libs
# Tiles of the y pass at config 2's grid that --conv-axis times beside
# ops/rl_fused.py::axis_tile's (586): outputs a thread walks.
Y_TILES = (256, 1024, 2928)


def time_passes(cs) -> None:
    """The three-pass route's compiled passes (``csrc/rl_pass.cu``) beside
    csrc/rl_fused.cu's runtime-length kernels, in turns (runtime, compiled,
    compiled, runtime), then beside the builds of :data:`PASS_VARIANTS`
    and, for the y pass, the tiles of :data:`Y_TILES`; every output held to
    the compiled pass's bits. At ``BASELINE.md`` config 2's grid (one term
    of (31, 41, 37) taps: z, y, and x as a middle term (adding the earlier
    terms' sum) and as the last (ratio epilogue)) and at the headline's
    production carry (the two-pass z+y route's z 9 and y 21, and the x pass
    of linear_pallas: 21 taps, ratio, no earlier term)."""
    import numpy as np

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.rl_fused import MODES, axis_tile, x_piece

    lengths = sorted({*cs.CONFIG2_LENGTHS, 9, 21})
    libs = build_pass_variants(lengths)
    paths = build.build_geometries([("rl_pass", (k,)) for k in lengths])
    libs["compiled"] = {k: build.open_geometry_library("rl_pass", p) for k, p in zip(lengths, paths)}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(cs.SEED + 16)
    for grid_name, carry, cases in (
            ("config 2", cs.config2_carry(),
             (("z", 31, None), ("y", 41, None), ("x mid", 37, "plain"), ("x last", 37, "ratio"))),
            ("headline", cs.production_terms()[1],
             (("z", 9, None), ("y", 21, None), ("x", 21, "ratio")))):
        gz, gy, gx = carry
        v = cs.uniform(carry, gen, 0.5, 10.5)
        prev = cs.uniform(carry, gen, 0.0, 1.0)
        aux = cs.uniform(carry, gen, 0.0, 5.0)
        want, out = torch.empty_like(v), torch.empty_like(v)
        for label, k, mode in cases:
            host = rng.random(k).astype(np.float32) + 0.1
            dev = torch.tensor(host, device="cuda")
            if mode is None:
                view = (1, gz, gy * gx) if label == "z" else (gz, gy, gx)

                def compiled(name, o, tile=None, view=view, host=host, k=k):
                    build.check(libs[name][k].shrimpy_axis_pass(
                        v.data_ptr(), o.data_ptr(), host.ctypes.data, k, *view,
                        tile or axis_tile(*view), None, None, 0, stream), "shrimpy_axis_pass")

                def runtime(o, view=view, dev=dev, k=k):
                    build.check(build.load_library().shrimpy_conv_axis(
                        v.data_ptr(), o.data_ptr(), dev.data_ptr(), k, *view, None, None, 0,
                        stream), "shrimpy_conv_axis")
            else:
                p = prev if label == "x mid" else None
                a = aux if mode == "ratio" else None

                def compiled(name, o, tile=None, host=host, k=k, p=p, a=a, mode=mode):
                    vec = int(gx % 4 == 0)
                    build.check(libs[name][k].shrimpy_x_pass(
                        v.data_ptr(), p.data_ptr() if p is not None else None,
                        a.data_ptr() if a is not None else None, o.data_ptr(), host.ctypes.data,
                        k, gz * gy, gx, x_piece(gx, k // 2), MODES[mode], 1e-6, 0, vec, stream),
                        "shrimpy_x_pass")

                def runtime(o, dev=dev, k=k, p=p, a=a, mode=mode):
                    build.check(build.load_library().shrimpy_conv_x(
                        v.data_ptr(), p.data_ptr() if p is not None else None,
                        a.data_ptr() if a is not None else None, o.data_ptr(), dev.data_ptr(), k,
                        gz * gy, gx, x_piece(gx, k // 2), MODES[mode], 1e-6, 0, stream),
                        "shrimpy_conv_x")
            compiled("compiled", want)
            runtime(out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{grid_name} {label}: the runtime kernel's bits differ")
            times = {"runtime": [], "compiled": []}
            for which in ("runtime", "compiled", "compiled", "runtime"):
                run = (lambda: runtime(out)) if which == "runtime" else \
                    (lambda: compiled("compiled", out))
                times[which].append(cs.gpu_ms(run, 10))
            r, c = sum(times["runtime"]) / 2, sum(times["compiled"]) / 2
            print(f"  {grid_name} {carry} {label} ({k} taps): compiled {c:.3f} ms "
                  f"{['%.3f' % x for x in times['compiled']]}, runtime-length {r:.3f} "
                  f"{['%.3f' % x for x in times['runtime']]}", flush=True)
            variants = [(name, None) for name in PASS_VARIANTS]
            if label == "y" and grid_name == "config 2":
                variants += [("compiled", t) for t in Y_TILES]
            for name, tile in variants:
                out.zero_()
                compiled(name, out, tile)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{grid_name} {label} {name} tile {tile}: bits differ")
                ms = cs.gpu_ms(lambda: compiled(name, out, tile), 10)
                print(f"    {name}{f' tile {tile}' if tile else ''}: {ms:.3f} ms", flush=True)
        del v, prev, aux, want, out
        torch.cuda.empty_cache()


def pass_kind(name: str) -> str:
    """The kind of a device event of config 2's step: the compiled axis
    and x passes, the runtime-length passes, the deskew, the rest."""
    low = name.lower()
    for key, label in (("axis_pass", "axis pass"), ("x_pass", "x pass"),
                       ("conv_axis", "runtime-length pass"), ("conv_x", "runtime-length pass"),
                       ("deskew", "deskew")):
        if key in low:
            return label
    return "elementwise"


def profile_config2(cs) -> None:
    """``BASELINE.md`` config 2: the PSF measured from ``chip_smoke.py``
    phase 4p's bead raw, then one warm deskew + RL-20 step with it at the
    production raw under ``torch.profiler`` (as a step above), its device
    events by kind (:func:`pass_kind`); then one term's z+y step on the
    march (``csrc/convzy.cu``) at its radii (15, 20) and tile (8, 32)
    beside the compiled z and y passes, bit for bit."""
    import numpy as np

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_layout, convzy_march, zy_taps
    from shrimpy_tpu_torch.ops.deconv import plan_terms, prepare_psf
    from shrimpy_tpu_torch.ops.rl_fused import Stencil, conv_axis_cuda, conv_x_cuda
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step
    from shrimpy_tpu_torch.psf import measure_volume_psf

    settings = cs.headline_settings()
    raw, _ = cs.bead_raw()
    scale = (cs.BEAD_PX_UM / settings.deskew.px_to_scan_ratio, cs.BEAD_PX_UM, cs.BEAD_PX_UM)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "profile_config2_psf"
    report = measure_volume_psf(raw, scale, path, geometry="lightsheet", deskew=settings.deskew)
    del raw
    psf = np.load(path.with_suffix(".npy"))
    psf_w = prepare_psf(psf, settings.deconvolve)
    terms = plan_terms(psf_w, settings.deconvolve)
    print(f"== deskew + RL-20, fused, config 2: {report.n_beads} beads, PSF {psf_w.shape}, "
          f"K = {len(terms)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    batch = cs.uniform((1, *cs.RAW_SHAPE), gen, 0.0, 100.0)
    profile(build_reconstruct_step(settings, psf=psf, device="cuda"), batch, kind_of=pass_kind)
    del batch
    torch.cuda.empty_cache()
    carry = tuple(n + k - 1 for n, k in zip(cs.deskewed_shape(), psf_w.shape))
    gz, gy, gx = carry
    st = Stencil(terms[:1], device="cuda")
    (kz, ky, _), (hz, hy, _) = st.dev[0], st.host32[0]
    radii = tuple(k // 2 for k in psf_w.shape[:2])
    layout = convzy_layout(carry, radii, tile=(8, 32))
    if layout is None:
        raise AssertionError(f"the march takes no tile (8, 32) at radii {radii}")
    v = cs.uniform(carry, gen, 0.5, 10.5)
    march, mid, two = torch.empty_like(v), torch.empty_like(v), torch.empty_like(v)
    taps = zy_taps(kz, ky)

    def run_march():
        convzy_march(v, taps, kz.numel(), ky.numel(), boundary="zero", out=march, tile=(8, 32))

    def run_two():
        conv_axis_cuda(v, mid, kz, hz, 1, gz, gy * gx)
        conv_axis_cuda(mid, two, ky, hy, gz, gy, gx)

    run_march()
    run_two()
    torch.cuda.synchronize()
    if not torch.equal(march, two):
        raise AssertionError("the march and the compiled passes differ")
    m_ms, t_ms = cs.gpu_ms(run_march, 5), cs.gpu_ms(run_two, 5)
    print(f"  one term's z+y at {carry}: the march, tile (8, 32), {layout['smem_bytes']} bytes, "
          f"{m_ms:.3f} ms; the compiled z and y passes {t_ms:.3f} ms (the same bits)", flush=True)
    # The x pass of a middle term as the route runs it (the sum of the
    # earlier terms updated in place) and into a carry of its own.
    kx, hx = st.dev[0][2], st.host32[0][2]
    x_in = cs.gpu_ms(lambda: conv_x_cuda(two, mid, None, mid, kx, "plain", 0.0, host=hx), 5)
    x_out = cs.gpu_ms(lambda: conv_x_cuda(two, mid, None, march, kx, "plain", 0.0, host=hx), 5)
    print(f"  the x pass of a middle term: in place {x_in:.3f} ms, into another carry "
          f"{x_out:.3f} ms", flush=True)


# Edits of csrc/affine.cu that --affine builds and times beside it: the x
# loop of walk_row, which the warp and the refine's kernels share, unrolled
# 1, 2 or 8 times (4 in the kernel), and registers capped so that 3 or 4
# blocks of 256 threads fit an SM.
_X_LOOP = "#pragma unroll 4  // the x loop"
_BOUNDS = "constexpr int kMinBlocks = 1;"
AFFINE_VARIANTS = {
    "unroll 1": [(_X_LOOP, "#pragma unroll 1")],
    "unroll 2": [(_X_LOOP, "#pragma unroll 2")],
    "unroll 8": [(_X_LOOP, "#pragma unroll 8")],
    "min blocks 3": [(_BOUNDS, "constexpr int kMinBlocks = 3;")],
    "min blocks 4": [(_BOUNDS, "constexpr int kMinBlocks = 4;")],
}


def sweep_affine(cs) -> None:
    """The warp and the refine's two kernels of ``csrc/affine.cu`` beside
    the builds of :data:`AFFINE_VARIANTS` (under shrimpy_tpu_torch/build/,
    all at once, each with its ptxas register count), timed in turns
    (forward and back) at the deskewed volume (the warp on chip_smoke's
    four maps) and at the refine grid (the sums and the gradient, ncc),
    every warp held to the kernel's bits and every sum within 1e-9 of it;
    beside them a copy of the volume."""
    import ctypes
    import re
    import subprocess

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.affine_cuda import (
        affine_warp_cuda,
        map_params,
        refine_grad_cuda,
        refine_scratch,
        refine_sums_cuda,
    )

    work = build.BUILD_DIR / "affine_variants"
    work.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC_DIR / "affine.cu").read_text()
    libs, procs = {}, []
    for i, (name, edits) in enumerate({"the kernel": [], **AFFINE_VARIANTS}.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/affine.cu no longer has {old!r}")
            text = text.replace(old, new)
        src, lib = work / f"affine_variant{i}.cu", work / f"libaffine_variant{i}.so"
        src.write_text(text)
        procs.append((name, subprocess.Popen(
            [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        libs[name] = lib
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"affine.cu {name} did not build:\n{err}")
        regs = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers", err, re.S)
        print(f"  affine.cu {name}: registers " + ", ".join(
            f"{k.split('affine_')[-1][:40]} {r}" for k, r in regs), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    shape = cs.deskewed_shape()
    vol = cs.uniform(shape, gen, 0.0, 100.0)
    grid = (shape[0], -(-shape[1] // cs.DOWN), -(-shape[2] // cs.DOWN))
    fixed = cs.uniform(grid, gen, 0.0, 100.0)
    partials = refine_scratch(vol, grid)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {f"warp {k}": (m, t, "warp") for k, (m, t) in cs.affine_maps(shape).items()}
    cases["refine sums lower"] = (*cs.refine_map(*cs.LOWER_MAP), "sums")
    cases["refine grad lower"] = (*cs.refine_map(*cs.LOWER_MAP), "grad")
    for case, (m, t, kind) in cases.items():
        params = map_params(torch.from_numpy(m).cuda(), torch.from_numpy(t).cuda())
        stats = refine_sums_cuda(vol, fixed, params, "ncc", partials)[1]
        want = {"warp": lambda: affine_warp_cuda(vol, params, shape),
                "sums": lambda: stats,
                "grad": lambda: refine_grad_cuda(vol, fixed, params, stats, partials)}[kind]()
        runs = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            for fn in ("shrimpy_affine_warp", "shrimpy_affine_refine_blocks",
                       "shrimpy_affine_refine_sums", "shrimpy_affine_refine_grad"):
                getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            out = torch.empty_like(want)
            part = torch.empty((lib.shrimpy_affine_refine_blocks(*shape, *grid[:2]), 12),
                               dtype=torch.float64, device="cuda")
            loss = torch.empty((), device="cuda")
            if kind == "sums":
                args = (vol.data_ptr(), fixed.data_ptr(), params.data_ptr(), part.data_ptr(),
                        part.shape[0], out.data_ptr(), loss.data_ptr(), *shape, *grid, 0, stream)
                fn = lib.shrimpy_affine_refine_sums
            elif kind == "grad":
                args = (vol.data_ptr(), fixed.data_ptr(), params.data_ptr(), stats.data_ptr(),
                        part.data_ptr(), part.shape[0], out.data_ptr(), *shape, *grid, stream)
                fn = lib.shrimpy_affine_refine_grad
            else:
                args = (vol.data_ptr(), out.data_ptr(), params.data_ptr(), *shape, *shape, stream)
                fn = lib.shrimpy_affine_warp
            build.check(fn(*args), name)
            torch.cuda.synchronize()
            # A build whose registers let more blocks fit an SM runs the
            # refine on a larger grid: its float64 sums then add in another
            # order.
            if not (torch.equal(out, want) or kind != "warp" and torch.allclose(
                    out, want, rtol=1e-9, atol=0.0)):
                raise AssertionError(f"affine {case} {name} differs from the kernel")
            runs[name] = (fn, args, out, part)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            fn, args = runs[name][:2]
            times[name].append(cs.gpu_ms(lambda: fn(*args), 10))
        for name, t_ in sorted(times.items(), key=lambda kv: sum(kv[1])):
            print(f"  affine {case}, {name}: {sum(t_) / len(t_):.3f} ms "
                  f"{['%.3f' % x for x in t_]}", flush=True)
        del runs
    copy = cs.gpu_ms(lambda: vol.clone(), 10)
    print(f"  affine: vol.clone() {copy:.3f} ms, {8 * vol.numel() / copy / 1e9:.3f} TB/s",
          flush=True)


# Edits of csrc/rl_half.cu that --conv3 builds beside its circular build:
# every block's slab by one TMA copy (a seam block then reads zeros past the
# grid: timed only, not held to the bits), every block's by 16-byte cp.async.
_CONV3_TMA = """  const bool tma = kVec && (!Geo::wrap || (y0 - ry >= 0 && y0 + ty + ry <= gy &&
                                          x0 - nkx / 2 >= 0 && x0 + tx + nkx / 2 <= gx));"""
CONV3_VARIANTS = {
    "every block by TMA (seams wrong)": [(_CONV3_TMA, "  const bool tma = kVec;")],
    "every block by cp.async": [(_CONV3_TMA, "  const bool tma = false;")],
    "one kept plane fewer": [("constexpr int kKeepRegisters = 54;",
                              "constexpr int kKeepRegisters = 45;")],
}


def time_conv3(cs) -> None:
    """conv3_circular's one launch (rl_half.cu, RL_HALF_WRAP=1, mode plain)
    at the production carry beside the zero boundary's build in mode plain
    and the builds of :data:`CONV3_VARIANTS` (under shrimpy_tpu_torch/build/,
    all at once, each with ptxas's registers and spills), timed in turns;
    then a -DRL_HALF_PROFILE build of the circular kernel: the clocks a
    plane step of thread 0 spends in each stage, over the blocks whose slab
    lies in the grid and over those on a seam."""
    import re
    import subprocess

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.conv3_cuda import conv3_one_launch
    from shrimpy_tpu_torch.ops.rl_fused import Stencil, half_layout

    terms, carry = cs.production_terms()
    st = Stencil(terms, device="cuda")
    lengths = tuple(2 * r + 1 for r in st.radii)
    tile = half_layout(carry, st.radii)["tile"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    v = cs.uniform(carry, gen, 0.0, 10.0)
    work = build.BUILD_DIR / "conv3_variants"
    work.mkdir(parents=True, exist_ok=True)
    for header in build.headers():
        (work / header.name).write_text(header.read_text())
    source = (build.CSRC_DIR / "rl_half.cu").read_text()
    builds = {"zero boundary": (source, 0, ()), "circular": (source, 1, ())}
    for name, edits in CONV3_VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/rl_half.cu no longer has {old!r}")
            text = text.replace(old, new)
        builds[f"circular, {name}"] = (text, 1, ())
    builds["circular, profile"] = (source, 1, ("-DRL_HALF_PROFILE",))
    libs, procs = {}, []
    for i, (name, (text, wrap, flags)) in enumerate(builds.items()):
        src, lib = work / f"rl_half_variant{i}.cu", work / f"librl_half_variant{i}.so"
        src.write_text(text)
        macros = (1, *lengths, *tile, wrap)
        procs.append((name, subprocess.Popen(
            [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
             *(f"-DRL_HALF_{m}={x}" for m, x in zip(build.GEOMETRY_MACROS + ("WRAP",), macros)),
             "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        libs[name] = lib
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"rl_half.cu {name} did not build:\n{err}")
        regs = re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores.*?"
                          r"Used (\d+) registers", err, re.S)
        print(f"  rl_half.cu {name}: " + ", ".join(
            f"{k[-24:]} {r} registers, {sp} bytes spilled" for k, sp, r in regs), flush=True)
    want = conv3_one_launch(v, st)
    out = torch.empty_like(v)
    taps = st.packed()
    gz, gy, gx = carry

    def launcher(name, clocks=None):
        lib = build.open_geometry_library("rl_half", libs[name])
        return lambda: build.check(lib.shrimpy_rl_half(
            v.data_ptr(), None, out.data_ptr(), None, None, None,
            None if clocks is None else clocks.data_ptr(), taps.data_ptr(), 1, *lengths, gz, gy,
            gx, *tile, 0, 1, 0.0, torch.cuda.current_stream().cuda_stream), name)

    timed = [k for k in builds if k != "circular, profile"]
    times = {k: [] for k in timed}
    for name in timed + timed[::-1]:
        run = launcher(name)
        times[name].append(cs.gpu_ms(run, 10))
        if "seams wrong" not in name and name != "zero boundary" and not torch.equal(out, want):
            raise AssertionError(f"rl_half.cu {name} differs from conv3_one_launch")
    for name, t in times.items():
        print(f"  conv3 {carry} mode plain, {name}: {sum(t) / len(t):.3f} ms "
              f"{['%.3f' % x for x in t]}", flush=True)
    layout = half_layout(carry, st.radii)
    clocks = torch.zeros((layout["blocks"], len(STAGES)), device="cuda")
    launcher("circular, profile", clocks)()
    torch.cuda.synchronize()
    ty, tx = tile
    rz, ry, rx = st.radii
    nbx = -(-gx // tx)
    seam = torch.tensor([not (by * ty - ry >= 0 and by * ty + ty + ry <= gy and bx * tx - rx >= 0
                              and bx * tx + tx + rx <= gx)
                         for by in range(-(-gy // ty)) for bx in range(nbx)], device="cuda")
    for label, mask in (("blocks in the grid", ~seam), ("blocks on a seam", seam)):
        per_plane = (clocks[mask].mean(dim=0) / gz).tolist()
        print(f"  conv3 circular, {label} ({int(mask.sum())}): clocks a plane: "
              + ", ".join(f"{n} {c:.0f}" for n, c in zip(STAGES, per_plane))
              + f"; total {sum(per_plane):.0f}", flush=True)
    del v, out, want
    torch.cuda.empty_cache()


def profile_refine(cs) -> None:
    """One warm estimate_registration (pcc+refine, defaults) at the
    deskewed shape on chip_smoke's blob pair under torch.profiler, as
    :func:`profile` reads a step; then the same with no refine step."""
    from shrimpy_tpu_torch.config import registration_settings
    from shrimpy_tpu_torch.ops.register import affine_apply_plain, estimate_registration

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    fixed = cs.blob_volume(cs.deskewed_shape(), gen, 3000)
    m, t = cs.f32_map(*cs.TRUE_MAP)
    moving = affine_apply_plain(fixed, m, t, dtype=torch.float64).float()
    for label, iters in (("estimate, 100 refine steps", 100), ("estimate, no refine step", 0)):
        print(f"== {label}", flush=True)
        settings = registration_settings(refine_iterations=iters)
        profile(lambda _: estimate_registration(fixed, moving, settings), None)


def time_rl_inputs(cs) -> None:
    """RL-20 on ``fused`` alone (``richardson_lucy``, CUDA events, warm) on
    the deskewed production volume, on its warp by chip_smoke's
    LOWER_MAP (the registered step's RL input) and on the deskewed volume
    with the voxels the warp leaves out of support set to 0: whether the
    RL kernels' time depends on the warp's zero border."""
    from shrimpy_tpu_torch.ops.deconv import richardson_lucy
    from shrimpy_tpu_torch.ops.deskew import deskew_volume
    from shrimpy_tpu_torch.ops.register import affine_apply

    steps = cs.Steps(torch.Generator(device="cuda").manual_seed(cs.SEED))
    settings, psf = cs.headline_settings(), steps.psf
    vol = deskew_volume(steps.batch[0], settings.deskew)
    m, t = cs.f32_map(*cs.LOWER_MAP)
    warped = affine_apply(vol, m, t)
    support = affine_apply(torch.ones_like(vol), m, t) > 0.999
    inputs = {"deskewed": vol, "warped": warped, "deskewed, zero outside the warp's support":
              vol * support}
    del steps
    torch.cuda.empty_cache()
    print(f"  the warp leaves {int((~support).sum())} of {support.numel()} voxels out of support",
          flush=True)
    times = {name: [] for name in inputs}
    for name in list(inputs) + list(inputs)[::-1]:
        times[name].append(cs.gpu_ms(
            lambda: richardson_lucy(inputs[name], psf, settings.deconvolve), 2))
    for name, t_ in times.items():
        print(f"  RL-20 on the {name} volume: {sum(t_) / len(t_):.3f} ms "
              f"{['%.3f' % x for x in t_]}", flush=True)


# Edits of csrc/probes.cu that --probes builds and times beside it: the
# product tile and the threads that split, the fma tile, and two builds
# timed only (their outputs are wrong): one that issues no product, one that
# stores no piece.
_DOT_SHAPE = "constexpr int kDotM = 64, kDotN = 32, kDotK = 64, kDotThreads = 384;"
_FMA_SHAPE = "constexpr int kFmaM = 16, kFmaN = 16, kFmaK = 64, kFmaThreads = 64,"
PROBE_VARIANTS = {
    "64 x 64 product tiles": [(_DOT_SHAPE, _DOT_SHAPE.replace("kDotN = 32", "kDotN = 64"))],
    "one warpgroup splits (256 threads)": [
        (_DOT_SHAPE, _DOT_SHAPE.replace("kDotThreads = 384", "kDotThreads = 256"))],
    "four warpgroups split (640 threads)": [
        (_DOT_SHAPE, _DOT_SHAPE.replace("kDotThreads = 384", "kDotThreads = 640"))],
    "fma 64 x 64 tiles, 4 x 4 a thread": [
        (_FMA_SHAPE, "constexpr int kFmaM = 64, kFmaN = 64, kFmaK = 32, kFmaThreads = 256,")],
    "fma 32 x 32 tiles, 2 x 4 a thread": [
        (_FMA_SHAPE, "constexpr int kFmaM = 32, kFmaN = 32, kFmaK = 64, kFmaThreads = 128,")],
    "no products (timed only)": [("      for (int s = 0; s < steps; ++s) {",
                                  "      for (int s = 0; s < 0; ++s) {")],
    "no pieces stored (timed only)": [
        ("      store_pieces<MODE>(a_big,", "      if (false) store_pieces<MODE>(a_big,"),
        ("      store_pieces<MODE>(b_big,", "      if (false) store_pieces<MODE>(b_big,")],
}


def sweep_probes(cs) -> None:
    """The split products of ``csrc/probes.cu`` at the probe's (128, 160) @
    (160, 512), each mode timed alone (``chip_smoke.kernel_ms``) beside the
    builds of :data:`PROBE_VARIANTS` (all at once, each with its ptxas
    registers), in turns forward and back; every build but those timed only
    held to the kernel's bits; beside them ``torch.matmul`` in float32 and
    an empty kernel of the product's launch shape."""
    import ctypes
    import re
    import subprocess

    from shrimpy_tpu_torch.kernels import build, probes

    work = build.BUILD_DIR / "probe_variants"
    work.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC_DIR / "probes.cu").read_text()
    libs, procs = {}, []
    for i, (name, edits) in enumerate({"the kernel": [], **PROBE_VARIANTS}.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/probes.cu no longer has {old!r}")
            text = text.replace(old, new)
        src, lib = work / f"probes_variant{i}.cu", work / f"libprobes_variant{i}.so"
        src.write_text(text)
        procs.append((name, subprocess.Popen(
            [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-Xptxas", "-v",
             f"-I{build.CSRC_DIR}", "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        libs[name] = lib
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probes.cu {name} did not build:\n{err}")
        regs = re.findall(r"Compiling entry function '\S+?(dot_\w+?kernel(?:ILi\d)?)\S*'.*?"
                          r"Used (\d+) registers", err, re.S)
        print(f"  probes.cu {name}: registers " + ", ".join(f"{k} {r}" for k, r in regs),
              flush=True)
    a, b = probes.dot_operands("cuda", cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for mode, code in probes.DOT_MODES.items():
        want = probes.split_dot_cuda(a, b, mode)
        runs = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.shrimpy_probe_split_dot.argtypes = build.SIGNATURES["shrimpy_probe_split_dot"]
            out = torch.empty_like(want)
            args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), *want.shape, a.shape[1], code,
                    stream)
            build.check(lib.shrimpy_probe_split_dot(*args), name)
            torch.cuda.synchronize()
            if "timed only" not in name and not torch.equal(out, want):
                raise AssertionError(f"probes {mode} {name} differs from the kernel")
            runs[name] = (lib.shrimpy_probe_split_dot, args)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            fn, args = runs[name]
            times[name].append(cs.kernel_ms(lambda: fn(*args)))
        for name, t_ in sorted(times.items(), key=lambda kv: sum(kv[1])):
            print(f"  probes {mode}, {name}: {sum(t_) / len(t_):.5f} ms "
                  f"{['%.5f' % x for x in t_]}", flush=True)
        blocks, threads, smem = probes.split_dot_launch(*want.shape, mode)
        print(f"  probes {mode}: an empty kernel of {blocks} x {threads} threads, {smem} bytes: "
              f"{cs.kernel_ms(lambda: probes.empty_launch(blocks, threads, smem)):.5f} ms",
              flush=True)
    print(f"  torch.matmul float32: {cs.kernel_ms(lambda: torch.matmul(a, b)):.5f} ms", flush=True)


MESH_PROBE_SHAPES = ((144, 2920, 416), (8, 16, 64))  # chip_smoke 4t(d)'s carry, and a small one


def gloo_probe(*, mesh) -> list:
    """A rank of ``--mesh``: a tiled ``all_to_all_single`` over the mesh's
    row of CUDA complex64 tensors, given to gloo as they are (what
    ``parallel/mesh.py::all_to_all`` does) and staged through pageable
    host tensors (``.cpu()``, the host exchange, a copy back); seconds of
    each (three runs), or the error gloo raised."""
    import torch.distributed as dist

    group = mesh.group("space")

    def staged(src):
        host = src.cpu()
        got = torch.empty_like(host)
        dist.all_to_all_single(got, host, group=group)
        return got.to(src.device)

    def timed(fn) -> list:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    out = []
    for shape in MESH_PROBE_SHAPES:
        src = torch.view_as_real(torch.randn(shape, dtype=torch.complex64, device=mesh.device))
        rec = {"shape": shape, "gib": src.numel() * 4 / 2**30}
        try:
            dst = torch.empty_like(src)
            dist.all_to_all_single(dst, src, group=group)
            torch.cuda.synchronize()
            rec["direct_equal_staged"] = bool(torch.equal(dst, staged(src)))
            rec["direct_s"] = timed(lambda: dist.all_to_all_single(dst, src, group=group))
        except Exception as exc:  # noqa: BLE001 — the finding is what gloo says
            rec["direct_error"] = f"{type(exc).__name__}: {exc}"[:300]
        rec["staged_s"] = timed(lambda: staged(src))
        out.append(rec)
    every = [None] * mesh.devices.size
    dist.all_gather_object(every, out)
    return every


def time_child_start() -> None:
    """See the module docstring (``--child-start``)."""
    import os
    import subprocess
    import tempfile
    from pathlib import Path

    repo = Path(__file__).resolve().parent
    torch_dir = Path(torch.__file__).parent
    print(f"PYTHONDONTWRITEBYTECODE={os.environ.get('PYTHONDONTWRITEBYTECODE')!r}; torch's "
          f"__pycache__ beside its sources: {(torch_dir / '__pycache__').is_dir()}", flush=True)
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPYCACHEPREFIX"}
    base["PYTHONPATH"] = str(repo)
    children = {"import torch, a CUDA tensor": "import torch; torch.zeros(1, device='cuda')",
                "the `reconstruct` verb's imports, a CUDA tensor": (
                    "import shrimpy_tpu_torch.cli.main, shrimpy_tpu_torch.parallel.launch, "
                    "shrimpy_tpu_torch.parallel.mesh, shrimpy_tpu_torch.runtime.stream, torch; "
                    "torch.zeros(1, device='cuda')")}
    with tempfile.TemporaryDirectory() as prefix:
        writer = {k: v for k, v in base.items() if k != "PYTHONDONTWRITEBYTECODE"}
        subprocess.run([sys.executable, "-c", children["the `reconstruct` verb's imports, a "
                                                        "CUDA tensor"].replace("cuda", "cpu")],
                       env={**writer, "PYTHONPYCACHEPREFIX": prefix}, check=True)
        for turn in range(2):
            for label, code in children.items():
                for how, env in (("no prefix", base),
                                 ("the filled prefix", {**base, "PYTHONPYCACHEPREFIX": prefix})):
                    t0 = time.monotonic()
                    subprocess.run([sys.executable, "-c", code], env=env, check=True)
                    print(f"turn {turn}, {label}, {how}: {time.monotonic() - t0:.2f} s",
                          flush=True)


def probe_mesh(cs) -> None:
    """``--mesh``: four gloo ranks on cuda:0, the transpose of
    :func:`gloo_probe` on each, then ``chip_smoke.py``'s phase 4t alone."""
    from shrimpy_tpu_torch.parallel import launch

    t0 = time.monotonic()
    every = launch.spawn(gloo_probe, 4, space=4, backend="gloo", devices=["cuda:0"] * 4)
    print(f"  gloo all_to_all of CUDA complex64 over 4 ranks on one card "
          f"({time.monotonic() - t0:.1f} s with the ranks' start):", flush=True)
    for rank, recs in enumerate(every):
        for rec in recs:
            print(f"    rank {rank} {rec}", flush=True)
    cs.phase_mesh(torch.Generator(device="cuda").manual_seed(cs.SEED + 20))["closing"].join()
    for _ in range(6):
        time.sleep(5)
        print(f"  5 s later: {cs.host_line()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from shrimpy_tpu_torch.kernels import build

    print(cs.card_line(), flush=True)
    if "--child-start" in sys.argv[1:]:
        time_child_start()
        return 0
    build.load_library()
    if "--mesh" in sys.argv[1:]:
        probe_mesh(cs)
        return 0
    if "--conv-axis" in sys.argv[1:]:
        time_passes(cs)
        return 0
    if "--config2" in sys.argv[1:]:
        profile_config2(cs)
        return 0
    if "--deskew" in sys.argv[1:]:
        sweep_deskew(cs)
        return 0
    if "--affine" in sys.argv[1:]:
        sweep_affine(cs)
        return 0
    if "--rl-input" in sys.argv[1:]:
        time_rl_inputs(cs)
        return 0
    if "--conv3" in sys.argv[1:]:
        time_conv3(cs)
        return 0
    if "--refine" in sys.argv[1:]:
        profile_refine(cs)
        return 0
    if "--probes" in sys.argv[1:]:
        sweep_probes(cs)
        return 0
    if "--zband" in sys.argv[1:]:
        sweep_zband(cs)
        return 0
    if "--fft" in sys.argv[1:]:
        profile_fft(cs)
        return 0
    if "--phase" in sys.argv[1:]:
        profile_phase(cs)
        return 0
    if "--track" in sys.argv[1:]:
        profile_track(cs)
        return 0
    if "--vs" in sys.argv[1:]:
        profile_vs(cs)
        return 0
    if "--train" in sys.argv[1:]:
        profile_train(cs)
        return 0
    if "--tiles" in sys.argv[1:]:
        sweep_zy_tiles(cs)
        sweep_zy_variants(cs)
        sweep_half_tiles(cs)
        sweep_tiles(cs)
        return 0
    if "--stages" in sys.argv[1:]:
        zy_stages(cs)
        half_stages(cs)
        iter_stages(cs)
        return 0
    steps = cs.Steps(torch.Generator(device="cuda").manual_seed(cs.SEED))
    biggs = {"acceleration": "biggs", "iterations": cs.BIGGS_ITERATIONS}
    transform = cs.transform_json(*cs.LOWER_MAP)
    for label, kw in (("deskew + RL-20, fused", {}),
                      ("deskew + register + RL-20, fused", {"transform": transform}),
                      ("deskew + Biggs RL-10, fused", biggs),
                      ("deskew + RL-20, fused_iter", {"separable_backend": "fused_iter"}),
                      ("deskew + Biggs RL-10, fused_iter",
                       {"separable_backend": "fused_iter", **biggs}),
                      ("deskew + RL-20, linear_pallas", {"separable_backend": "linear_pallas"}),
                      ("deskew + Biggs RL-10, linear_pallas",
                       {"separable_backend": "linear_pallas", **biggs}),
                      ("deskew + RL-20, zy_pallas", {"separable_backend": "zy_pallas"}),
                      ("deskew + Biggs RL-10, zy_pallas",
                       {"separable_backend": "zy_pallas", **biggs}),
                      ("deskew + RL-20, matmul", {"separable_backend": "matmul"})):
        print(f"== {label}", flush=True)
        profile(steps.build(**kw), steps.batch)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

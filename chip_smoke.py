"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc``, ``cc`` and the repository's ``shrimpy_tpu_torch``
package, imports no jax and no tensorstore (phase 4u runs the port's CLI,
which needs click, pydantic and yaml, and its own chunk engine), and exits
non-zero without printing a result when any of these is missing
or any check fails. ``--parent-iter DIR`` names a directory holding the
``rl_iter.cu`` and ``stencil.cuh`` of the whole-iteration kernel before
its redesign (kept out of the package): phase 3 then builds it too,
checks that it gives the new kernel's bits and times the two in turns.
``--parent-convzy DIR`` does the same for the z+y kernel before the
march (``convzy.cu`` of the commit before it), on both boundaries, and
``--parent-deskew DIR`` for the deskew kernel before its redesign
(``deskew.cu``), at the production raw and at ``BASELINE.md`` config 1,
``--parent-affine DIR`` for the affine kernels before the two-launch
refine step (``affine.cu``): its gradient kernel, and a refine step
built on it, each timed beside the new one; and ``--parent-probes DIR``
for the probe kernels before their redesign (``probes.cu``): each held
to the new one (the slice bit for bit, every product mode within 1e-5)
and timed beside it in turns.
Phases:

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build every kernel from ``shrimpy_tpu_torch/csrc`` with nvcc (seconds),
   the one-launch half-step and the whole iteration once for each PSF
   geometry run below, all compilers at once;
3. each kernel against its plain PyTorch version on the card, on the
   same inputs: the deskew at the production raw (1201, 256, 1600),
   timed beside its bound from the raw rows this run's tables read,
   ``F.affine_grid`` + ``F.grid_sample`` (the same resample from
   normalized coordinates; it has no z-averaging) and, with
   ``--parent-deskew``, the kernel before its redesign, bit for bit; the
   same at ``BASELINE.md`` config 1, raw (300, 2048, 2048) with
   ``keep_overhang`` and ``average_n_slices=3``; at (300, 512, 512) with
   those settings; at (410000, 4, 8), whose (2, 1062171, 8) output has
   more rows than one launch's grid of the kernel before;
   the one-launch RL half-step (``csrc/rl_half.cu``) in ``ratio``,
   ``mult`` and ``plain`` modes and the Biggs half-step in
   ``ratio_accel`` and ``mult_accel`` modes (alpha 0.6, random bf16
   dx/g_prev; mult_accel in place), each on the production carry
   (136, 2908, 1620), on a (40, 300, 400) carry with a 2-term asymmetric
   PSF and on a (5, 37, 45) grid smaller than a tile on every axis with
   z < 2 rz + 1: bit-equal to the plain version (the kernel sums every
   output's taps in the same order), the two Biggs sums within 1e-5; the
   same kernel timed at the production carry with the streaming
   runtime's default PSF (9, 15, 15) and with two terms of (9, 21, 21);
   the three-pass route (for geometries past the one-launch kernel's
   block; its passes on ``csrc/rl_pass.cu`` compiled for their tap count)
   in all five modes on the (40, 300, 400) carry bit-equal to the plain
   version, at the production carry timed and bit-equal to the one-launch
   kernel, then driven once through ``richardson_lucy`` with a (121, 9, 9)
   PSF that only it takes; its passes at ``BASELINE.md`` config 2's grid
   (158, 2928, 1636) with one term of (31, 41, 37) taps: the z and y
   passes (``axis_pass_kernel``) and the x pass (``x_pass_kernel``, a
   middle term adding the earlier terms' sum and the last with the ratio
   epilogue), each bit for bit against its plain version and against
   ``csrc/rl_fused.cu``'s runtime-length kernel, timed beside its bound,
   that kernel, the plain version and ``F.conv3d`` with the single-axis
   kernel; the
   z+y step ``convzy_linear`` and ``convzy_circular`` on both of its
   routes (the march of ``csrc/convzy.cu`` and two ``conv_axis``
   passes), both tap orders, bit-equal to the plain version, on the
   production carry, the 2-term (40, 300, 400) one, a carry 4 bytes into
   its storage with an x extent of 33, a (17, 61, 3) PSF past the
   kernel before the march, and (circular) a (3, 9, 40) grid smaller
   than the radii (4, 10, 10); each route timed at the production carry
   beside the bound and ``F.conv3d`` (and beside the kernel before the
   march with ``--parent-convzy``); ``conv3_circular`` (both tap
   orders) on those carries, on a (20, 150, 256) one with blocks in the
   grid and on its seams, and past the one-launch block with a (9, 201, 3)
   PSF, its one launch (``csrc/rl_half.cu`` built with
   ``RL_HALF_WRAP=1``) bit-equal to the two-launch route (the circular z+y
   step, then the circular x pass) and both against the plain version,
   the two timed in turns at the production carry beside
   ``torch.nn.Conv3d(padding_mode="circular")`` with the dense kernel;
   the circular x pass in ``ratio``,
   ``mult`` and ``plain`` modes against the dense circulant product
   (also with a row that wraps twice); ``conv3_circular``, which no
   backend reaches, is then driven once at the production carry with
   the counts reset (one launch); the two-pass route through ``richardson_lucy`` with
   a (9, 201, 3) PSF past the march's block on ``linear_pallas`` and
   ``zy_pallas`` (RL-2 and Biggs RL-2), and the carries repaired with
   it: a (66000, 2, 6) image on ``linear_pallas`` (the y pass over more
   than 65535 planes) and a (4, 6, 60000) one on ``zy_pallas`` (x rows
   in pieces), each against its float64 plain path; a y radius of 215
   (PSF (3, 431, 3)), past the two-pass route's column, where
   ``conv_axis`` takes its taps in chunks: the z+y step bit for bit on
   both boundaries, then ``zy_pallas`` RL-2 through ``richardson_lucy``
   with the counts reset; the whole-iteration
   kernel ``rl_iter`` (``csrc/rl_iter.cu``) on the production carry, on
   the (40, 300, 400) carry with the 2-term asymmetric PSF and on a
   (5, 37, 45) grid that no tile divides and whose z extent is smaller
   than 2 rz + 1, both tap orders, bit-equal to the plain version (the
   same order of sums), timed at the production carry beside its bound
   by bytes and the bound of its own FMAs with the halo it recomputes
   (and beside the kernel before the redesign with ``--parent-iter``);
   then ``fused_iter`` RL-2 through ``richardson_lucy`` with a
   (17, 61, 61) PSF past the one-launch block, counts reset: the
   half-step route, no ``rl_iter`` launch, within 1e-3 of float64 and
   1e-4 of ``fused``; the three on-chip probes (shared-memory slice, largest
   block, split products on the tensor cores through ``wgmma``, one
   launch a mode, at the probe's shapes and three more) against their
   plain versions (1e-5; bf16x3 and 3xTF32 also against float64), each
   timed alone (back-to-back launches queued behind a spin kernel, so
   neither the host nor the read back is in the window) beside an empty
   kernel of its launch shape, and as a call of its entry, read back
   included; the largest block beside its bound at one SM's
   shared-memory rate; then driven through their entry points with the
   counts reset; the affine warp (``csrc/affine.cu``) at the deskewed volume
   (128, 2888, 1600) on four maps (a fractional translation, the refine's
   lower-triangular form, 2- and 30-degree rotations), each to the same
   shape, the 30-degree one also to (136, 2800, 1700), against the plain
   version in float64
   (1e-4) and float32 (1e-3: the plain float32 version rounds M u + t as
   the JAX gather does), timed beside its bound from the voxels the map
   reads and ``F.affine_grid`` + ``F.grid_sample``; the refine step's two
   launches at the refine grid (128, 722, 400) on a blob pair, ncc and
   mse, twice (the same bits), the loss and the 12 sums against the plain
   objective in float64 (within 1e-5), each launch timed beside its bound
   by voxels and by 32-byte sectors (and, with ``--parent-affine``, beside
   the gradient kernel before); the band of the ``fft2z`` RL
   (``csrc/zband.cu``) in ``conv`` and ``corr`` modes against its plain
   version within 1e-6 on the production grid (144, 3000, 961) with
   kz = 15 and on (9, 33, 17) with kz = 9 = gz, (20, 37, 45) with kz = 7
   and one plane (kz = 1), timed at the production grid beside its bound,
   the plain version and the einsum over a window view of the spectrum;
   the FFT RL's loop between its bands (``csrc/rl_fft.cu``) at a chunk of
   ``ls-fft.rl20``'s grid, (8, 2916, 1920): the cuFFT plans on the loop's
   buffers against ``torch.fft.rfft2`` / ``irfft2`` within 1e-6, the
   update's two kernels (``rl_ratio_kernel``, ``rl_scale_kernel``) bit for
   bit against their plain versions with eps hits, zeros and a NaN, each
   timed beside its bound, its plain version and the out-of-place torch
   calls.
   Tolerance: max|a-b| / max|b| <= 1e-4 (float32 sums taken in
   another order); the bf16 Biggs state within one bf16 ulp, the
   step-length sums within 1e-5 relative. Beside each kernel's time the
   phase works out its bound from the shapes (bytes it must move over
   3.35 TB/s, operations over the peak for their type, the larger) and
   times the one PyTorch call that computes the same function, where
   there is one (``F.conv3d``, ``torch.matmul``);
4. the main path through ``build_reconstruct_step`` — deskew, then
   RL-20 with the (9, 21, 21) PSF — on a (1, 1201, 256, 1600) batch from
   a fixed seed, with the kernels' launch counters reset just before and
   read just after (40 half-steps, each one kernel launch, none on the
   three-pass route); the result against the same step on the plain
   versions in float64 on the card, within the BASELINE budget
   max|a-b| / max|b| <= 1e-3;
4b. the same step with ``acceleration: biggs`` and 10 iterations (the
   RL-20-equivalent), against its float64 plain path (bf16 state) by
   the two-tier gate of ``tests/test_rl_fused.py:244-245``: 99.99 % of
   voxels within 5e-4 of the scale, every voxel within 2e-2;
4c. the same two steps on ``separable_backend: linear_pallas`` (a march
   launch a z+y step): RL-20 within 1e-4 of phase 4's output, Biggs
   RL-10 within the two-tier gate of phase 4b's;
4d. the same two steps on ``separable_backend: zy_pallas`` (circular
   boundaries on the same G grid), each against its float64 plain path:
   RL-20 within 1e-3, timed; Biggs RL-10 by the two-tier gate;
4e. deskew + RL-20 on ``separable_backend: matmul`` (circulant products
   on the block-rounded (136, 2944, 1664) grid, no kernel of the
   repository) against the same backend in float64 on the card, within
   1e-3; warm time and peak memory;
4f. deskew + RL-20 on ``separable_backend: fused_iter`` (one ``rl_iter``
   launch per iteration, no half-step launch: the production geometry
   takes the one-launch route) against the float64 plain path within 1e-3
   (phase 4's output: the plain paths of ``fused`` and ``fused_iter`` are
   the same RL, within 5e-13 of each other) and against phase 4's
   ``fused`` output within 1e-4, timed; Biggs RL-10 (generic loop) by
   the two-tier gate against phase 4b's float64 output; the peak of Biggs RL-10 through
   ``richardson_lucy`` with and without ``donate_input``, the two
   results bit-equal;
4g. ``estimate_registration`` (``pcc+refine``, defaults) on a blob pair
   of the deskewed shape, the moving volume the float64 plain warp of a
   known lower-triangular map: first and warm seconds, the recovered map
   against the truth (offset within 0.3 px, diagonal within 0.02), the
   counts (102 sums launches, 100 gradient launches, no warp), a refine
   step's ms in the estimate and alone (beside the step before with
   ``--parent-affine``); at ``bench.py``'s (64, 256, 256) the
   kernel path's estimate against the plain path's;
4h. deskew + register-apply (a transform JSON) + RL-20 on ``fused``: one
   warp launch, against its float64 plain step within 1e-3, timed, peak
   memory;
4i. ``bench.py`` config 6: RL-20 ``algorithm: fft`` with
   ``tilted_gaussian_psf()`` (15, 31, 31), non-separable, on a
   (128, 2888, 1600) volume uniform in [0, 100) through ``richardson_lucy``
   (``fft_backend: auto`` -> ``fft2z``, grid (144, 3000, 1920)): two band
   launches an iteration and, a z chunk, two transforms each way and one
   launch of each update kernel, against the same call on the plain versions in
   float64 on the card within 1e-3; ms, GVox/s and peak; ``fft3`` timed
   and held within 2e-4 of ``fft2z``;
4j-4k. ``bench.py`` configs 8 (``hybrid``, 16 warm + 6 exact) and 9 (16 +
   3, Biggs on both phases) on that volume and PSF: K and the warm
   residual of the nonnegative CP terms, the separable backend of the
   warm phase and its ms, the tail's ms, the total and the peak; at a
   depth of HYBRID_CHECK (config 8: 1 warm + 1 exact iteration; config 9:
   1 + 3, its Biggs tail extrapolating), config 8 against its float64
   plain path within 1e-3, config 9 by the two-tier gate;
4l. phase: a brightfield stack (64, 2048, 2048) with the schema's
   defaults (z_padding 5), yx 0.116 um, z 0.25 um: the host transfer
   function (computed in a thread beside phases 4-4k) and the card's
   inverse timed apart, the inverse against its
   float64 version within 1e-3, then through the reconstruct step; at
   (64, 1024, 1024) where the host has too little memory for the
   transfer function; a simulated weak phase object recovered at
   (16, 32, 32) (correlation > 0.8);
4m. tracking (DynaTrack): (a) three production raws (1201, 256, 1600) of
   seeded blobs on a camera offset with noise, drifting 2 scan steps and
   3 x pixels a timepoint, through the ``Preprocessor`` (``preprocessing: [deskew]``,
   ``csrc/deskew.cu``, four launches a method) and the ``Tracker``, each of
   the six methods: its shifts against the same tracker in float64 on the
   plain deskew (integer shifts equal, centres of mass within 1e-3 px; the
   multi-Otsu methods against float64 at the float32 run's bin pair, which
   must tie the float64 objective's maximum within 1e-5),
   ``pcc`` and ``template_matching`` within 1 px of the injected drift; the
   first update, the warm update from the card and from a host numpy
   stack, the reference's moves and the peak; the blur, multi-Otsu, NCC
   and PCC alone at the deskewed shape; (b) ``pcc`` with ``preprocessing:
   [phase]`` on two brightfield stacks of phase 4l's shape shifted in yx,
   the transfer function a hit of phase 4l's host cache, against float64;
   the focus metric's index against float64;
4q. DynaTrack's closed loop (run after 4m, whose blobs and tracker settings
   it takes): one position over six timepoints of production raws whose
   sample drifts 2 scan steps and 3 x pixels a timepoint, the stage seam
   rolling each raw by minus the stored offset (the JAX engine's
   ``_stage_offset_px`` and ``ReplaySource.volume``), through
   ``tracking/position.py::PositionUpdateManager`` (record the acquisition,
   submit the stack, drain) whose worker thread runs the engine's updater
   (``Preprocessor([deskew])`` on the deskew kernel, ``Tracker`` ``pcc``,
   the stage shift through ``loop_matrix``): every correction applied, no
   "updater failed" or "no baseline" record, one deskew launch a timepoint
   and no other kernel, every drain within 120 s, and from t = 2 on the
   sample within 1 raw px of where it started on every axis after the
   correction; the first and warm update ms, the drains, the residuals and
   the peak;
4r. the acquisition engine (run after 4q, with 4m's blobs and 4q's matrix):
   ``engine/engine.py::AcquisitionEngine(source, device="cuda").acquire`` of
   a plan namespace (``config.acquisition_plan``: an HCS plate of two
   positions, the tracking channel (two channels before phase 4u), three
   timepoints,
   ``interval_s`` 0, DynaTrack ``pcc`` after ``[deskew]`` with
   ``loop_matrix``) over production raws whose samples (a blob seed a
   position) drift 2 scan steps and 3 x px a timepoint, through two
   in-memory stand-ins for the host file IO (``MemorySource``, ``ReplaySource.volume``'s one-volume cache, depth
   modulo and stage roll; ``MemoryStore`` in the place of ``io/ngff.py``,
   a digest of each written volume): every (t, p) update applied, no
   "updater failed" or "no baseline" record, one deskew launch an update and
   no other kernel, every drain within 120 s, from t = 2 on each sample
   within 1 raw px of where it started after the correction, every written
   volume the one served at its (t, c, p) and offset, the summary (12
   volumes, none skipped, no error) and the journal (6 rows); the update ms,
   the host seconds a volume, the drains and the peak;
4n. virtual staining, every net with weights from its seed: (a) the default
   unet25d (base 64, depth 3, batch 8) through the ``Preprocessor``
   (``preprocessing: [phase, vs]``) and the ``Tracker`` (``pcc`` on
   ``vs_nuclei``) over phase 4m(b)'s two stacks, the first and warm VS and
   update ms, the peak, the shift equal to the injected one, the bf16
   ``vs_nuclei`` of the second stack within 1e-1 of the float32 run's (the
   same weights computing in float32, no TF32; before phase 4u the float32 run
   also tracked both stacks, to the same shift); (b) unext2 at ConvNeXt-V2 Tiny widths (blocks
   (3, 3, 9, 3), dims (96, 192, 384, 768)), the plane head (``in_slices``
   5) and the voxel-stack head (15 in, 5 out, step 1), on the phase
   volume: ms, peak, error against the float32 run on 8 planes; (c)
   ``[deskew, phase, vs]`` on a raw (427, 64, 256) (a YX the net pads): one
   deskew launch with the counts reset, against the float32 run; beside
   each net's ms its bound, its FLOPs over the dense bf16 peak;
4o. virtual-staining training (``models/train.py``), weights from their
   seeds, on four in-memory (16, 1024, 1024) volumes whose two targets are
   fixed smooth functions of the input: the default unet25d and unext2 at
   Tiny widths (plane head), 20 steps each at the CLI's batch 4 and patch
   128 (learning rates 1e-3 and 1e-4: at 1e-3 the Tiny unext2 diverges),
   validation every 5
   steps on one held-out volume: 3 steps of the module's AdamW step in bf16
   against the same steps in float32 (no TF32) from the same weights and
   batches (losses within 5e-2), the first and warm step's ms beside the
   step's bound (3 forward FLOPs over the bf16 peak), the run with every
   kernel count at 0 (no kernel of the repository: cuDNN and cuBLAS), its
   peak, the validation loss falling, the best-weights rule (the last
   evaluation reported worse than every earlier one: the returned weights
   must be the copy taken at the best, not the live ones, and their
   validation loss the best's), their checkpoint reloaded into a fresh
   stainer whose ``predict`` is the trained one's within 1e-6;
4p. ``BASELINE.md`` config 2: ``synthetic_ls_stack``'s beads (50 at raw
   (400, 256, 1600), 30 degrees, ratio 0.386) rendered on the card, the PSF
   measured through ``psf.py::measure_volume_psf`` (the deskew kernel, one
   launch, then the host code; patch (31, 41, 41)) and on the CPU plain path
   (equal bead count, the PSF within 1e-5 of its max); the FWHM beside the
   rendered bead's; K, the cropped radii and the ``rl_half`` tile; deskew +
   RL-20 on ``fused`` with that PSF at the production raw with the counts
   reset (one deskew, 40 ``rl_half`` half-steps, each one launch or, past
   the one-launch block, three a term, counted on the compiled passes):
   ms, GVox/s, peak, one term's z, y and x passes timed with the measured
   taps; on the deskewed volume RL-2 against float64 within 1.5e-6 (the
   reference's passes as banded float64 products on cuBLAS, held on the
   crop to the plain float64 path within 1e-10) and RL-5 on a
   (32, 512, 512) crop within 1e-3;
4t. (run right after phase 3, with a seed of its own) the mesh on one
   card (item 11): four ranks share cuda:0 over gloo
   (``parallel/launch.py::Ranks``; NCCL refuses two ranks on one card), each
   check against the single-device step run in this process on the same
   inputs: (a) ``__graft_entry__.py``'s pass 1 on a (2, 2) mesh, raw
   (2, 16, 12, 256), within 1e-5; (b) the main path at full width: four
   production raws (on the card, mapped by the ranks through CUDA IPC)
   over (2, 2), the deskew
   kernel on X slabs of 800, the reshard to one whole volume a rank, RL-20
   on ``fused``, every rank's counts set to 0 just before its step and read
   just after (2 deskew, 40 ``rl_half`` launches a rank, no plain version
   on a CUDA tensor), each rank's volume against the single-device output
   (bit for bit, or within 1e-5), its peak, and the reshard's
   ``all_to_all`` timed alone; (c) pass 3, ``shard_volumes`` phase +
   ``dft2z`` RL-2 over (1, 4), within 1e-5, and within 1e-3 of the float64
   plain path; (d) pass 4(b) run for real: ``tilted_gaussian_psf()``,
   ``shard_volumes``, ``dft2z`` RL-1 (the dryrun's RL-2 cut to one
   iteration: 8 slab transposes) at the production carry over (1, 4),
   each rank's carry (1, 144, 2920, 416), its peak beside the 5.21 GiB
   estimate, its X slab within 1e-5, one slab transpose timed alone; (e)
   one rank on NCCL, the card's default backend, on (a)'s inputs, beside
   the rest; the phase's seconds. The ranks start beside phase 3 (their
   allocators with expandable segments: five processes share the card)
   and exit beside phase 4. Four ranks on one card measure correctness
   and the gloo transfers, not multi-GPU speed;
4u. (after 4p) the store path and the CLI as users run them
   (:func:`phase_store`): (a) the stores tensorstore wrote in
   ``tests/data/ts_fixtures`` decoded by the port's chunk engine to their
   SHA-256, its counters, and its rate on a 1 GiB blosc-zstd container of
   4096 blocks built from their frames, block-parallel and on one thread;
   the encoder on a production raw of camera counts (4m's blobs and
   noise, uint16), block-parallel and on one thread, its ratio, and the
   container decoded back bit for bit with its block and literal modes;
   (b) an OME-Zarr store of two production raws from the seed, ``python3 -m
   shrimpy_tpu_torch.cli.main reconstruct -c configs/reconstruct_demo.yml``
   on it in a subprocess on the card, each volume read back and held to the
   step run here (bit for bit), the stages, the bytes on disk of the input
   and the output (blosc-zstd: below their raw bytes), the decoder's
   counters, the peak;
   (c) through the CLI in this process, each run's counts set to 0 just
   before and read just after: ``--resume`` does nothing and launches
   nothing, and redoes exactly a volume whose chunk was deleted, with 1
   deskew and 40 ``rl_half`` launches; (d) the ``deskew`` (1 launch) and
   ``deconvolve`` (40) verbs in turn within 1e-3 of (b);
4v. (after 4u) every other verb through the CLI in this process
   (:func:`phase_verbs`), ``--device`` at its default, each run's counts set
   to 0 just before and held just after, on stores the port wrote from the
   data of the phases before (written beside 4n-4p): (a) ``measure-psf`` of
   4p's bead raw, bit for bit 4p's PSF (1 deskew); (b) ``register`` across
   two single-arm stores of 4g's blob pair, bit for bit 4g's map and within
   its gates of the truth (4g's refine launches); (c) ``reconstruct`` with
   (a)'s PSF (``BASELINE.md`` config 2) of 4p's raw, bit for bit 4p's
   deskew + RL-20 (its three-pass launches); (d) with (b)'s transform
   (config 4) and (e) with ``--devices 1``, of 4u's one-timepoint raw, bit
   for bit the step run here and 4u(b)'s volume; (g) ``phase`` of 4l's
   stack, its transfer function a hit of 4l's host cache, bit for bit 4l's
   step; (i) ``track`` of 4m's raws as camera counts, without and with a
   deskew (1 launch a timepoint): the baked drift, 4m's pcc run here; (h)
   ``plan validate`` and ``replay`` with the demo plan (DynaTrack, -I,
   autofocus): each frame the source's rolled by minus the stage offset it
   was acquired under, the journal against (i)'s; (j) ``replay-dual`` with
   a label-free arm beside: both arms' frames so, the final stage the
   journal's; (k) ``train-vs`` of 4o's volumes: the checkpoint reloads bit
   for bit; (f) ``monitor --once`` (no matplotlib on the card's machine:
   the status all the same, no PNG), ``info`` of every store 4v wrote,
   ``microscopes``, ``plan show``. A line a run: its wall seconds, launches,
   peak and checks;
5. timings (kernel path, warm, twice), launch counts (a path's plain
   versions must have run on no
   CUDA tensor), peak memory, then the kernel JSON line (eighteen
   entries: the sixteen kernels, the three-pass half-step and the z+y
   step's two-pass route),
   the card line and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

# Run as a script from a checkout, this process writes the bytecode of what
# it imports (torch's too, which its installation may hold none of) into the
# checkout's build directory, and the processes it starts (4t's ranks, 4s's
# monitor, 4u's `reconstruct`) load it there instead of compiling torch's
# sources again.
if __name__ == "__main__" and (Path(__file__).resolve().parent / "shrimpy_tpu_torch").is_dir():
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = str(
        Path(__file__).resolve().parent / "shrimpy_tpu_torch" / "build" / "pycache")
    sys.dont_write_bytecode = False

import torch  # noqa: E402

SEED = 0
RAW_SHAPE = (1201, 256, 1600)  # bench.py::_run_headline
PSF_SHAPE, PSF_SIGMA = (9, 21, 21), (1.5, 3.0, 3.0)
ITERATIONS = 20
BIGGS_ITERATIONS = 10  # bench.py config 7, rl10_biggs_accelerated
KERNEL_RTOL = 1e-4
SLOW_CALL_MS = 1000.0  # gpu_ms times a call slower than this once
SUM_RTOL = 1e-5  # the Biggs step-length sums
STEP_RTOL = 1e-3  # BASELINE.md parity budget
LINEAR_RTOL = 1e-4  # linear_pallas vs fused (tests/test_rl_fused.py:186)
BULK_TOL, BULK_SHARE, MAX_TOL = 5e-4, 0.9999, 2e-2  # two-tier Biggs gate
FUSED_RTOL = 1e-4  # fused_iter vs fused: the same sums in another order, 20 iterations
# Published peaks of one H100 SXM: device memory, float32 outside the
# tensor cores, and dense TF32 and bf16 in them.
HBM_BYTES_S, FP32_FLOPS, TF32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 495e12, 989e12


def bound(bytes_moved: float, ops: float, peak: float = FP32_FLOPS) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations
    at their peak rate, whichever is larger."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def n_taps(terms) -> int:
    """Taps of every term and axis: FMAs of one separable conv3 per voxel."""
    return sum(len(w) for term in terms for w in term)


def dense_kernel(terms, axes=(0, 1, 2)) -> torch.Tensor:
    """The dense ``F.conv3d`` weight of the separable ``terms`` over
    ``axes`` (flipped: conv3d correlates), float32 on the card."""
    import numpy as np

    psf = 0.0
    for term in terms:
        w = [np.asarray(term[a], np.float64)[::-1] if a in axes else np.ones(1) for a in range(3)]
        psf = psf + np.einsum("z,y,x->zyx", *w)
    return torch.tensor(np.ascontiguousarray(psf), dtype=torch.float32, device="cuda")[None, None]


def library_conv3d(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One ``F.conv3d`` call, zero boundary: the yardstick the port never
    calls."""
    pad = tuple(k // 2 for k in weight.shape[2:])
    return torch.nn.functional.conv3d(v[None, None], weight, padding=pad)[0, 0]


def headline_settings(**deconvolve):
    """bench.py::_run_headline's ReconstructSettings, as a namespace;
    ``deconvolve`` overrides its deconvolve fields."""
    from shrimpy_tpu_torch.config import (
        deconvolve_settings,
        deskew_settings,
        reconstruct_settings,
    )

    return reconstruct_settings(
        deskew=deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386),
        deconvolve=deconvolve_settings(**{"iterations": ITERATIONS, **deconvolve}),
    )


def deskewed_shape() -> tuple[int, int, int]:
    """The deskewed volume of the production raw, (128, 2888, 1600)."""
    from shrimpy_tpu_torch.parallel.pipeline import output_shape

    return tuple(output_shape(RAW_SHAPE, headline_settings()))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def max_abs(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max|a-b|, max|b|) in float64, 2^27 elements at a time (a deskewed
    volume of BASELINE.md config 1 in float64 would take 14 GB)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    diff = top = 0.0
    for i in range(0, fa.numel(), 1 << 27):
        a64, b64 = fa[i:i + (1 << 27)].double(), fb[i:i + (1 << 27)].double()
        diff = max(diff, float((a64 - b64).abs().max()))
        top = max(top, float(b64.abs().max()))
    return diff, top


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    diff, top = max_abs(a, b)
    return diff / max(top, 1e-30)


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events), warm. A
    call over SLOW_CALL_MS is timed once, as its first run: more runs would
    cost more than they tell (the dense ``F.conv3d`` library calls, ~8 s)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(end)
    if first > SLOW_CALL_MS:
        return first
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """Check max|a-b| / max|b| <= tol; returns max|a-b|."""
    err = rel_err(a, b)
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max|a-b|/max|b| = {err:.3e} (tol {tol:g}) {status}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: relative error {err:.3e} > {tol:g}")
    return max_abs(a, b)[0]


def same_bits(name: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """Check that ``a`` has ``b``'s bits (a kernel that sums in its plain
    version's order, an output against the run it repeats); returns
    max|a-b| (0.0)."""
    equal = bool(torch.equal(a, b))
    gap = "" if equal else (f"max|a-b|/max|b| = {rel_err(a, b):.3e}" if a.shape == b.shape
                            else f"shape {tuple(a.shape)} against {tuple(b.shape)}")
    print(f"  {name}: {'bit-equal' if equal else gap + ' FAIL'}", flush=True)
    if not equal:
        raise AssertionError(f"{name}: not bit-equal ({gap})")
    return 0.0


def two_tier(name: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """The Biggs gate: a share >= BULK_SHARE of voxels within BULK_TOL
    of max|b|, every voxel within MAX_TOL; returns max|a-b| / max|b|."""
    scale = float(b.double().abs().max())
    diff = (a.double() - b.double()).abs()
    share = float((diff <= BULK_TOL * scale).double().mean())
    worst = float(diff.max()) / scale
    ok = share >= BULK_SHARE and worst <= MAX_TOL
    print(f"  {name}: max|a-b|/max|b| = {worst:.3e} (tol {MAX_TOL:g}), share within "
          f"{BULK_TOL:g} = {share:.6f} (tol {BULK_SHARE}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: two-tier gate failed ({worst:.3e}, {share:.6f})")
    return worst


def bf16_within_ulp(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal, or within one bf16 ulp of ``b`` (ulp <= |b| * 2**-7)."""
    a32, b32 = a.float(), b.float()
    ulps = float(((a32 - b32).abs() / (b32.abs() * 2.0**-7).clamp_min(1e-30)).max())
    exact = bool(torch.equal(a, b))
    print(f"  {name}: {'bit-equal' if exact else f'max {ulps:.3f} bf16 ulp'}", flush=True)
    if not ulps <= 1.0:
        raise AssertionError(f"{name}: {ulps:.3f} bf16 ulp apart")


def sum_close(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    err = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    print(f"  {name}: {float(a):.9g} vs {float(b):.9g}, rel {err:.3e} (tol {SUM_RTOL:g})",
          flush=True)
    if not err <= SUM_RTOL:
        raise AssertionError(f"{name}: relative error {err:.3e} > {SUM_RTOL:g}")


def uniform(shape, gen, lo=0.0, hi=1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


def counters() -> dict:
    from shrimpy_tpu_torch.ops.conv3_cuda import (
        conv3_circular_cuda,
        conv3_circular_plain,
        conv3_one_launch,
        convzy_circular_cuda,
        convzy_circular_plain,
        convzy_linear_cuda,
        convzy_linear_plain,
        convzy_march,
        convzy_two_pass,
    )
    from shrimpy_tpu_torch.kernels import probes
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda
    from shrimpy_tpu_torch.ops.rl_fused import (
        axis_pass_cuda,
        half_step_cuda,
        half_step_one_launch,
        half_step_plain,
        half_step_three_pass,
        x_pass_accel_cuda,
        x_pass_cuda,
    )
    from shrimpy_tpu_torch.ops.affine_cuda import affine_warp_cuda, refine_grad_cuda, refine_sums_cuda
    from shrimpy_tpu_torch.ops.register import affine_apply_plain
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_cuda, rl_iter_half_steps, rl_iter_plain
    from shrimpy_tpu_torch.ops import fft_cuda
    from shrimpy_tpu_torch.ops.zband_cuda import zband_cuda, zband_plain

    return {
        "zband": (zband_cuda, "launches"),
        "plain_zband_on_cuda": (zband_plain, "cuda_calls"),
        "fft_r2c": (fft_cuda.r2c_cuda, "launches"),
        "fft_c2r": (fft_cuda.c2r_cuda, "launches"),
        "rl_ratio": (fft_cuda.ratio_cuda, "launches"),
        "rl_scale": (fft_cuda.scale_cuda, "launches"),
        "plain_r2c_on_cuda": (fft_cuda.r2c_plain, "cuda_calls"),
        "plain_c2r_on_cuda": (fft_cuda.c2r_plain, "cuda_calls"),
        "plain_ratio_on_cuda": (fft_cuda.ratio_plain, "cuda_calls"),
        "plain_scale_on_cuda": (fft_cuda.scale_plain, "cuda_calls"),
        "affine_warp": (affine_warp_cuda, "launches"),
        "refine_sums": (refine_sums_cuda, "launches"),
        "refine_grad": (refine_grad_cuda, "launches"),
        "plain_affine_on_cuda": (affine_apply_plain, "cuda_calls"),
        "rl_iter": (rl_iter_cuda, "launches"),
        "rl_iter_half_steps": (rl_iter_half_steps, "launches"),
        "probe_smem_slice": (probes.dynamic_smem_slice_cuda, "launches"),
        "probe_smem": (probes.smem_touch_cuda, "launches"),
        "probe_split_dot": (probes.split_dot_cuda, "launches"),
        "plain_rl_iter_on_cuda": (rl_iter_plain, "cuda_calls"),
        "plain_probe_slice_on_cuda": (probes.dynamic_smem_slice_plain, "cuda_calls"),
        "plain_split_dot_on_cuda": (probes.split_dot_plain, "cuda_calls"),
        "deskew": (deskew_cuda, "launches"),
        "rl_half_step": (half_step_cuda, "launches"),
        "rl_half_step_accel": (half_step_cuda, "accel_launches"),
        "rl_half_one_launch": (half_step_one_launch, "launches"),
        "rl_half_three_pass": (half_step_three_pass, "launches"),
        "convzy_linear": (convzy_linear_cuda, "launches"),
        "convzy_circular": (convzy_circular_cuda, "launches"),
        "convzy_march": (convzy_march, "launches"),
        "convzy_two_pass": (convzy_two_pass, "launches"),
        "axis_pass": (axis_pass_cuda, "launches"),
        "x_pass": (x_pass_cuda, "launches"),
        "x_pass_accel": (x_pass_accel_cuda, "launches"),
        "conv3_circular": (conv3_circular_cuda, "launches"),
        "conv3_one_launch": (conv3_one_launch, "launches"),
        "plain_half_step_on_cuda": (half_step_plain, "cuda_calls"),
        "plain_convzy_on_cuda": (convzy_linear_plain, "cuda_calls"),
        "plain_convzy_circular_on_cuda": (convzy_circular_plain, "cuda_calls"),
        "plain_conv3_circular_on_cuda": (conv3_circular_plain, "cuda_calls"),
    }


# The compiled passes' launches (csrc/rl_pass.cu): kernels inside the routes
# counted above (the three-pass half-step, the two-pass z+y step, the x pass
# of linear_pallas and zy_pallas), checked where a drive names them.
PASS_COUNTS = ("axis_pass", "x_pass", "x_pass_accel")


def zero_counts() -> dict:
    """Set every count to 0; returns the table of :func:`counters`."""
    table = counters()
    for obj, attr in table.values():
        setattr(obj, attr, 0)
    return table


def check_counts(counts: dict, want: dict | None) -> None:
    """Fail unless ``counts`` are ``want`` (the others 0; the PASS_COUNTS
    only where ``want`` names them), or, ``want`` None, unless no plain
    version saw a CUDA tensor."""
    bad = {k: v for k, v in counts.items()
           if (want is None and "plain" in k and v)
           or (want is not None and (k not in PASS_COUNTS or k in want) and v != want.get(k, 0))}
    if bad:
        raise AssertionError(f"launch counts {bad}, want {want} (others 0)")


def drive(step, batch, want: dict | None) -> tuple[torch.Tensor, dict, float]:
    """Run ``step`` once with every count set to 0 just before and read
    just after; fail unless each named kernel ran and no plain version
    saw a CUDA tensor (``want`` None: only read the counts, which the
    caller checks; the PASS_COUNTS only where ``want`` names them). Returns (output, counts, peak GiB); the peak
    counts what was allocated before (the batch, kept references), and
    the line printed also gives the step's own rise above that."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    table = zero_counts()
    out = step(batch)
    torch.cuda.synchronize()
    counts = {name: getattr(obj, attr) for name, (obj, attr) in table.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches: {counts}; peak allocated {peak_gib:.2f} GiB "
          f"({peak_gib - before / 2**30:.2f} above the {before / 2**30:.2f} GiB held before)",
          flush=True)
    check_counts(counts, want)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    return out, counts, peak_gib


def kernel_times(step, steps, label: str) -> dict:
    """Warm host-clock time of the kernel path, twice. The plain float32
    path of a step is held to float64 just before and not timed (3-8 s a
    phase): phase 3 times every kernel beside its plain version."""
    ms = [warm_ms(step, steps) for _ in range(2)]
    k = sum(ms) / 2
    print(f"  {label} kernel path: {k:.1f} ms/volume, {steps.vox / k / 1e6:.4f} GVox/s  "
          f"{[round(m, 1) for m in ms]} ms", flush=True)
    return {"gvox_s": steps.vox / k / 1e6, "ms": k}


CONFIG1_RAW = (300, 2048, 2048)  # BASELINE.md config 1: deskew ~2048 x 2048 x 300


def config1_settings():
    """BASELINE.md config 1's deskew: the headline's angle and ratio, the
    full parallelogram kept, z averaged over 3 slices."""
    from shrimpy_tpu_torch.config import deskew_settings

    return deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386, keep_overhang=True,
                           average_n_slices=3)


@functools.lru_cache(maxsize=1)
def parent_deskew(parent_dir):
    """The deskew kernel before the redesign (a block of 128 threads
    walking 16 output rows, four 4-byte gathers an output), built from
    ``parent_dir`` (its ``deskew.cu``, kept out of the package) into a
    library of its own: a function that runs it on (raw, settings) with
    the same tables."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.deskew_cuda import TABLE_KEYS, device_plan

    lib_path = build.BUILD_DIR / "libdeskew_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "deskew.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.shrimpy_deskew.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.shrimpy_deskew.restype = ctypes.c_int

    def launch(raw, settings):
        tab = device_plan(raw, settings)
        out = torch.empty((tab["n_groups"], tab["ny"], raw.shape[2]), device=raw.device)
        build.check(lib.shrimpy_deskew(
            raw.data_ptr(), out.data_ptr(), *(tab["dev"][k].data_ptr() for k in TABLE_KEYS),
            *raw.shape, tab["nz"], tab["ny"], tab["n_groups"], tab["a_avg"],
            torch.cuda.current_stream().cuda_stream), "shrimpy_deskew (parent)")
        return out
    return launch


def deskew_bound(raw: torch.Tensor, settings) -> dict:
    """The least time of the deskew on these inputs: each raw row that an
    output reads with a nonzero weight read once, the output written once;
    9 operations a raw-rate output voxel (two 2-row lerps and the tilt
    lerp) at the float32 rate."""
    import numpy as np

    from shrimpy_tpu_torch.ops.deskew_cuda import device_plan

    tab = device_plan(raw, settings)
    ns, nt, nx = raw.shape
    need = np.zeros((ns, nt), bool)
    for wt, t in (("wt0", "t0"), ("wt1", "t1")):
        for w, row in (("w00", "s0"), ("w01", "s1")):
            z, y = np.nonzero((tab[w] != 0) & (tab[wt] != 0)[:, None])
            need[tab[row][z, y], tab[t][z]] = True
    rows = int(need.sum())
    print(f"  deskew {tuple(raw.shape)}: {rows} of {ns * nt} raw rows read with a nonzero weight",
          flush=True)
    return bound(4 * nx * (rows + tab["n_groups"] * tab["ny"]), 9 * tab["nz"] * tab["ny"] * nx)


def library_deskew(raw: torch.Tensor, settings) -> torch.Tensor:
    """The same order-1 resample as one ``F.affine_grid`` and one
    ``F.grid_sample`` (5-D, trilinear, zero padding, ``align_corners``),
    from float32 normalized coordinates: the yardstick the port never
    calls. It has no z-averaging (``average_n_slices`` 1 only)."""
    from shrimpy_tpu_torch.ops.deskew import _geometry

    if settings.average_n_slices != 1:
        raise ValueError("F.grid_sample has no z-averaging")
    ns, nt, nx = raw.shape
    g = _geometry(tuple(raw.shape), settings)
    nz, ny, r, tan_t = g["nz_full"], g["ny"], g["r"], math.tan(g["theta"])
    # Output (zo, yo, xo) at normalized (zn, yn, xn) in [-1, 1]; raw t =
    # zo / sin, s = r (yo + y_offset - zo / tan), both to [-1, 1].
    a_t = (nz - 1) / ((nt - 1) * g["sin_t"]) if nt > 1 else 0.0
    c = 2 * r / max(ns - 1, 1)
    theta = torch.tensor([[[1.0, 0.0, 0.0, 0.0],
                           [0.0, 0.0, a_t, a_t - 1.0],
                           [0.0, c * (ny - 1) / 2, -c * (nz - 1) / (2 * tan_t),
                            c * ((ny - 1) / 2 + g["y_offset"] - (nz - 1) / (2 * tan_t)) - 1.0]]],
                         dtype=torch.float32, device=raw.device)
    grid = torch.nn.functional.affine_grid(theta, [1, 1, nz, ny, nx], align_corners=True)
    return torch.nn.functional.grid_sample(raw[None, None], grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=True)[0, 0]


def time_deskew(raw, settings, old=None) -> dict:
    """The deskew kernel on ``raw`` (beside the kernel before the redesign,
    held to its bits and timed in turns, when ``old`` runs that one)."""
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda

    label = f"deskew {tuple(raw.shape)}"
    new = lambda: deskew_cuda(raw, settings)  # noqa: E731
    if old is None:
        res = {"ms": gpu_ms(new, 10)}
        print(f"  {label}: {res['ms']:.3f} ms (no --parent-deskew: the kernel before it not timed)",
              flush=True)
        return res
    same_bits(f"{label} vs the kernel before the redesign", old(raw, settings), new())
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        times[which].append(gpu_ms((lambda: old(raw, settings)) if which == "old" else new, 10))
    res = {"ms": sum(times["new"]) / 2, "ms_parent": sum(times["old"]) / 2}
    print(f"  {label}: {res['ms']:.3f} ms {times['new']}; the kernel before it "
          f"{res['ms_parent']:.3f} {times['old']}", flush=True)
    return res


def phase_deskew(gen, parent_dir=None) -> dict:
    """The deskew kernel against its plain version at the production raw and
    at BASELINE.md config 1, each timed beside its bound (and beside the
    kernel before the redesign with ``--parent-deskew``), the production
    one also beside ``F.affine_grid`` + ``F.grid_sample``; then a raw whose
    output has more rows than one launch's grid of the kernel before."""
    from shrimpy_tpu_torch.config import deskew_settings
    from shrimpy_tpu_torch.ops.deskew import deskew_plain
    from shrimpy_tpu_torch.ops.deskew_cuda import _device_tables, deskew_cuda

    old = parent_deskew(parent_dir) if parent_dir else None
    prod = headline_settings().deskew
    raw = uniform(RAW_SHAPE, gen, 0.0, 100.0)
    want = deskew_plain(raw, prod)
    err = compare(f"deskew {RAW_SHAPE}", deskew_cuda(raw, prod), want, KERNEL_RTOL)
    res = {"max_abs_err": err, **time_deskew(raw, prod, old), **deskew_bound(raw, prod)}
    res["plain_ms"] = gpu_ms(lambda: deskew_plain(raw, prod), 3)
    lib_err = rel_err(library_deskew(raw, prod), want)
    del want
    res["library_ms"] = gpu_ms(lambda: library_deskew(raw, prod), 3)
    res["library_rel_err"] = lib_err
    print(f"  deskew {RAW_SHAPE}: bound {res['bound_ms']:.3f} ms by {res['bound_by']}, plain "
          f"{res['plain_ms']:.3f} ms, F.affine_grid + F.grid_sample {res['library_ms']:.3f} ms "
          f"(max|a-b|/max|b| {lib_err:.3e} against the plain version)", flush=True)
    del raw
    torch.cuda.empty_cache()
    over = config1_settings()
    raw = uniform(CONFIG1_RAW, gen, 0.0, 100.0)
    out = deskew_cuda(raw, over)
    want = deskew_plain(raw, over)
    err = compare(f"deskew {CONFIG1_RAW} keep_overhang avg3", out, want, KERNEL_RTOL)
    res["max_abs_err"] = max(res["max_abs_err"], err)
    del out, want
    torch.cuda.empty_cache()
    c1 = {**time_deskew(raw, over, old), **deskew_bound(raw, over),
          "plain_ms": gpu_ms(lambda: deskew_plain(raw, over), 1), "library_ms": None}
    print(f"  deskew {CONFIG1_RAW} keep_overhang avg3: bound {c1['bound_ms']:.3f} ms by "
          f"{c1['bound_by']}, plain {c1['plain_ms']:.3f} ms; F.grid_sample has no z-averaging",
          flush=True)
    res.update({f"config1_{k}": v for k, v in c1.items()})
    del raw
    torch.cuda.empty_cache()
    raw2 = uniform((300, 512, 512), gen, 0.0, 100.0)
    compare("deskew (300, 512, 512) keep_overhang avg3", deskew_cuda(raw2, over),
            deskew_plain(raw2, over), KERNEL_RTOL)
    tall = deskew_settings(px_to_scan_ratio=0.386)
    raw3 = uniform((410000, 4, 8), gen, 0.0, 100.0)
    out = deskew_cuda(raw3, tall)
    if not out.shape[1] > 65535 * 16:
        raise AssertionError(f"deskew (410000, 4, 8): output {tuple(out.shape)} is not past the grid")
    compare(f"deskew (410000, 4, 8) -> {tuple(out.shape)}", out, deskew_plain(raw3, tall),
            KERNEL_RTOL)
    # The plans of these shapes (76 MB of tables at config 1 and (410000,
    # 4, 8)) would stay cached and count in every later path's peak.
    _device_tables.cache_clear()
    return res


RAGGED = (5, 37, 45)  # smaller than a tile on every axis, z < 2 rz + 1
SMALL = (40, 300, 400)


def phase_rl(gen) -> tuple[dict, dict]:
    """The half-step in ratio, mult and plain modes: the one-launch
    kernel on three grids, the three-pass route on one. Returns the two
    routes' entries."""
    from shrimpy_tpu_torch.ops.rl_fused import (
        Stencil,
        half_layout,
        half_step_cuda,
        half_step_one_launch,
        half_step_plain,
        half_step_three_pass,
    )

    terms, carry = production_terms()
    print(f"  PSF {PSF_SHAPE}: {len(terms)} separable term(s), carry {carry}")
    eps = headline_settings().deconvolve.epsilon

    def modes(shape, terms, label, step):
        """All three modes, kernel against plain; the ratio error back."""
        route = "one_launch" if step is half_step_one_launch else "three_pass"
        conv = Stencil(terms, device="cuda")
        adj = Stencil(terms, flip=True, device="cuda")
        inp = uniform(shape, gen, 0.5, 10.5)
        aux = uniform(shape, gen, 0.0, 5.0)
        if route == "one_launch":
            print(f"  rl_half {label}: {half_layout(shape, conv.radii, len(terms))}", flush=True)
        errs = {}
        for mode, st in (("ratio", conv), ("mult", adj), ("plain", conv)):
            got = step(inp, aux, st, mode, eps)
            want = half_step_plain(inp, aux, st, mode, eps)
            errs[mode] = same_bits(f"rl half-step {mode} {label} ({route})", got, want)
        return errs["ratio"], conv, adj, inp, aux

    err, conv, adj, inp, aux = modes(carry, terms, f"{carry}", half_step_one_launch)
    out = torch.empty_like(inp)
    ms = gpu_ms(lambda: half_step_cuda(inp, aux, conv, "ratio", eps, out=out), 10)
    est = aux.clone()  # in place, as the RL loop runs it
    mult_ms = gpu_ms(lambda: half_step_cuda(inp, est, adj, "mult", eps, out=est), 10)
    del est
    # The three-pass route on the same operands: the same bits (the
    # one-launch result above is the plain version's), and its time.
    scratch = [torch.empty_like(inp) for _ in range(2)]
    out3 = torch.empty_like(inp)
    three_ms = gpu_ms(lambda: half_step_three_pass(inp, aux, conv, "ratio", eps, out=out3,
                                                   scratch=scratch), 10)
    err3 = same_bits(f"rl half-step ratio {carry} (three_pass) vs one launch", out3, out)
    del out3
    print(f"  rl half-step ratio {carry}: one launch {ms:.3f} ms (mult in place {mult_ms:.3f}), "
          f"three passes {three_ms:.3f} ms", flush=True)
    other = phase_other_psf(inp, aux, eps)
    plain_ms = gpu_ms(lambda: half_step_plain(inp, aux, conv, "ratio", eps), 2)
    # inp and aux read, out written; an FMA a tap and the division.
    roof = bound(3 * 4 * inp.numel(), (2 * n_taps(terms) + 1) * inp.numel())
    del aux, out, scratch
    # The library's one call for the convolution inside the half-step:
    # F.conv3d with the dense PSF (float32, TF32 off).
    weight = dense_kernel(terms)
    compare(f"F.conv3d dense {tuple(weight.shape[2:])} vs plain conv3", library_conv3d(inp, weight),
            half_step_plain(inp, None, conv, "plain", eps), 1e-3)
    library_ms = gpu_ms(lambda: library_conv3d(inp, weight), 1)
    del inp
    modes(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_one_launch)
    modes(RAGGED, terms, f"{RAGGED} ragged, gz < 2rz+1", half_step_one_launch)
    modes(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_three_pass)
    shared = {"plain_ms": plain_ms, **roof, "library_ms": library_ms}
    return ({"max_abs_err": err, "ms": ms, "ms_mult": mult_ms, "ms_three_pass": three_ms,
             **other, **shared},
            {"max_abs_err": err3, "ms": three_ms, **shared})


OTHER_PSF = ((9, 15, 15), (1.5, 2.5, 2.5))  # runtime/stream.py's PSF when no file is given
OTHER_TERMS = 2


def other_terms() -> dict:
    """Terms of the geometries phase_other_psf runs, by name."""
    import numpy as np

    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf

    deconv = headline_settings().deconvolve
    rng = np.random.default_rng(SEED + 2)
    return {
        "other_psf": plan_terms(prepare_psf(gaussian_psf(*OTHER_PSF), deconv), deconv),
        "two_terms": [tuple(rng.random(k).astype(np.float32) / k for k in PSF_SHAPE)
                      for _ in range(OTHER_TERMS)],
    }


def phase_other_psf(inp, aux, eps) -> dict:
    """The one-launch kernel at the production carry on geometries other
    than the headline's: the streaming runtime's default PSF (9, 15, 15)
    and a PSF of OTHER_TERMS asymmetric terms of the headline's lengths,
    mode ratio, timed, each held to the three-pass route's bits (that
    route is held to the plain version on the small carry)."""
    from shrimpy_tpu_torch.ops.rl_fused import (
        Stencil,
        half_layout,
        half_step_one_launch,
        half_step_three_pass,
    )

    cases = other_terms()
    carry = tuple(inp.shape)
    out, out3 = torch.empty_like(inp), torch.empty_like(inp)
    res = {}
    for name, terms in cases.items():
        conv = Stencil(terms, device="cuda")
        lengths = tuple(2 * r + 1 for r in conv.radii)
        layout = half_layout(carry, conv.radii, len(terms))
        ms = gpu_ms(lambda: half_step_one_launch(inp, aux, conv, "ratio", eps, out=out), 10)
        half_step_three_pass(inp, aux, conv, "ratio", eps, out=out3)
        label = f"PSF {lengths} x {len(terms)} term(s) {carry}"
        same_bits(f"rl half-step ratio {label} vs three_pass", out, out3)
        roof = bound(3 * 4 * inp.numel(), (2 * n_taps(terms) + 1) * inp.numel())
        print(f"  rl half-step ratio {label}: {layout}, one launch {ms:.3f} ms "
              f"(bound {roof['bound_ms']:.3f} by {roof['bound_by']})", flush=True)
        res[f"ms_{name}"] = ms
        res[f"bound_ms_{name}"] = roof["bound_ms"]
    return res


def production_terms():
    """The headline PSF's separable terms and the production carry."""
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf

    deconv = headline_settings().deconvolve
    psf_np = prepare_psf(gaussian_psf(PSF_SHAPE, PSF_SIGMA), deconv)
    radii = tuple(k // 2 for k in psf_np.shape)
    carry = tuple(n + 2 * r for n, r in zip((128, 2888, 1600), radii))
    return plan_terms(psf_np, deconv), carry


def two_term_psf():
    """A 2-term PSF with asymmetric taps of unequal radii per axis."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [tuple(rng.random(k).astype(np.float32) for k in (7, 11, 13)) for _ in range(2)]


def phase_accel(gen) -> dict:
    """ratio_accel and mult_accel against their plain versions: the
    one-launch kernel on three grids, the three-pass route on one."""
    from shrimpy_tpu_torch.ops.rl_fused import (
        Stencil,
        half_step_cuda,
        half_step_one_launch,
        half_step_plain,
        half_step_three_pass,
        partial_rows,
    )

    eps = headline_settings().deconvolve.epsilon
    alpha = torch.tensor(0.6, device="cuda")

    def check(shape, terms, label, step):
        route = "one_launch" if step is half_step_one_launch else "three_pass"
        conv = Stencil(terms, device="cuda")
        adj = Stencil(terms, flip=True, device="cuda")
        x = uniform(shape, gen, 0.0, 10.5)
        data = uniform(shape, gen, 0.0, 5.0)
        ratio = uniform(shape, gen, 0.5, 10.5)
        dx = uniform(shape, gen, -1.0, 1.0).to(torch.bfloat16)
        gp = uniform(shape, gen, 0.0, 1.0).to(torch.bfloat16)
        label = f"{label} ({route})"
        exact = route == "one_launch"
        got = step(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha)
        want = half_step_plain(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha)
        err = (same_bits(f"ratio_accel {label}", got, want) if exact
               else compare(f"ratio_accel {label}", got, want, KERNEL_RTOL))
        want = half_step_plain(ratio, x, adj, "mult_accel", eps, dx=dx, g_prev=gp, alpha=alpha)
        got = step(ratio, x, adj, "mult_accel", eps, dx=dx, g_prev=gp, alpha=alpha)
        if got[0] is not x or got[1] is not dx or got[2] is not gp:
            raise AssertionError("mult_accel did not update x, dx and g_prev in place")
        if exact:
            same_bits(f"mult_accel x_new {label}", x, want[0])
        else:
            err = max(err, compare(f"mult_accel x_new {label}", x, want[0], KERNEL_RTOL))
        bf16_within_ulp(f"mult_accel dx {label}", dx, want[1])
        bf16_within_ulp(f"mult_accel g {label}", gp, want[2])
        sum_close(f"mult_accel <g, g_prev> {label}", got[3], want[3])
        sum_close(f"mult_accel <g, g> {label}", got[4], want[4])
        return err, conv, adj, x, data, ratio, dx, gp

    terms, carry = production_terms()
    err, conv, adj, x, data, ratio, dx, gp = check(carry, terms, f"{carry}", half_step_one_launch)
    out = torch.empty_like(x)
    parts = torch.empty((2, partial_rows(carry, conv.radii, len(terms))), device="cuda")
    r_ms = gpu_ms(lambda: half_step_cuda(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha,
                                         out=out), 10)
    r_plain = gpu_ms(lambda: half_step_plain(x, data, conv, "ratio_accel", eps, dx=dx,
                                             alpha=alpha), 2)
    # mult_accel in place: x grows by ~conv(ratio) ~ 5.5 a call, far
    # from overflow in the 33 calls of the three timings.
    m_ms = gpu_ms(lambda: half_step_cuda(ratio, x, adj, "mult_accel", eps, dx=dx, g_prev=gp,
                                         alpha=alpha, partials=parts), 10)
    m_plain = gpu_ms(lambda: half_step_plain(ratio, x, adj, "mult_accel", eps, dx=dx,
                                             g_prev=gp, alpha=alpha), 2)
    # The three-pass route on the same operands: ratio_accel to the same
    # bits as the one-launch kernel's (held to the plain version above).
    scratch = [torch.empty_like(x) for _ in range(2)]
    out3 = torch.empty_like(x)
    r3_ms = gpu_ms(lambda: half_step_three_pass(x, data, conv, "ratio_accel", eps, dx=dx,
                                                alpha=alpha, out=out3, scratch=scratch), 10)
    half_step_one_launch(x, data, conv, "ratio_accel", eps, dx=dx, alpha=alpha, out=out)
    same_bits(f"ratio_accel {carry} (three_pass) vs one launch", out3, out)
    del out3
    m3_ms = gpu_ms(lambda: half_step_three_pass(ratio, x, adj, "mult_accel", eps, dx=dx,
                                                g_prev=gp, alpha=alpha, scratch=scratch), 10)
    print(f"  {carry}: ratio_accel one launch {r_ms:.3f} ms, three passes {r3_ms:.3f} ms; "
          f"mult_accel one launch {m_ms:.3f} ms, three passes {m3_ms:.3f} ms", flush=True)
    # ratio_accel reads x, data and the bf16 dx and writes the ratio (14
    # bytes a voxel); mult_accel reads the ratio, x, dx and g and writes
    # x, dx and g (20). The entry is their mean, as its times are.
    n = x.numel()
    ops = (2 * n_taps(terms) + 8) * n
    roofs = [bound(14 * n, ops), bound(20 * n, ops)]
    roof = {"bound_ms": (roofs[0]["bound_ms"] + roofs[1]["bound_ms"]) / 2,
            "bound_by": roofs[1]["bound_by"], "library_ms": None}
    del x, data, ratio, dx, gp, out, scratch, parts
    check(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_one_launch)
    check(RAGGED, terms, f"{RAGGED} ragged, gz < 2rz+1", half_step_one_launch)
    check(SMALL, two_term_psf(), f"{SMALL} 2 terms", half_step_three_pass)
    return {"max_abs_err": err, "ms": (r_ms + m_ms) / 2, "plain_ms": (r_plain + m_plain) / 2,
            **roof,
            "ms_ratio_accel": r_ms, "plain_ms_ratio_accel": r_plain,
            "ms_mult_accel": m_ms, "plain_ms_mult_accel": m_plain,
            "ms_ratio_accel_three_pass": r3_ms, "ms_mult_accel_three_pass": m3_ms}


def phase_three_pass() -> dict:
    """The three-pass route through its entry point: ``richardson_lucy``
    with a (121, 9, 9) PSF, whose ring of 2 rz + 2 planes no block of the
    one-launch kernel holds, plain RL-2 and Biggs RL-2 on a (40, 64, 64)
    image, each against its float64 plain path. Returns the counts."""
    from shrimpy_tpu_torch.config import deconvolve_settings
    from shrimpy_tpu_torch.ops.deconv import (
        gaussian_psf,
        plan_terms,
        prepare_psf,
        richardson_lucy,
    )
    from shrimpy_tpu_torch.ops.rl_fused import half_step_route

    psf = gaussian_psf((121, 9, 9), (20.0, 1.5, 1.5))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    img = uniform((40, 64, 64), gen, 0.0, 100.0)
    total = {}
    for kw, name in (({}, "rl_half_step"), ({"acceleration": "biggs"}, "rl_half_step_accel")):
        s = deconvolve_settings(iterations=2, psf_crop_tol=0.0, **kw)
        psf_w = prepare_psf(psf, s)
        radii = tuple(k // 2 for k in psf_w.shape)
        n_terms = len(plan_terms(psf_w, s))
        grid = tuple(n + 2 * r for n, r in zip(img.shape, radii))
        if half_step_route(grid, radii, n_terms) != "three_pass":
            raise AssertionError(f"PSF {psf_w.shape} on {grid} does not take the three-pass route")
        out, counts, _ = drive(lambda v: richardson_lucy(v, psf, s), img,
                               {name: 4, "rl_half_three_pass": 4 * 3 * n_terms})
        ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
        if kw:
            two_tier("three-pass Biggs RL-2 vs float64 plain", out, ref)
        else:
            compare("three-pass RL-2 vs float64 plain", out, ref, STEP_RTOL)
        total[name] = counts["rl_half_three_pass"]
    return total


# BASELINE.md config 2's G grid: the deskewed production volume padded by
# the radii (15, 20, 18) of the PSF phase 4p measures from beads, (31, 41,
# 37) after its crop, in 24 terms (ops/rl_fused.py::half_step_three_pass).
CONFIG2_LENGTHS = (31, 41, 37)
CONFIG2_TERMS = 24


def config2_carry() -> tuple[int, int, int]:
    return tuple(n + k - 1 for n, k in zip(deskewed_shape(), CONFIG2_LENGTHS))


def library_conv_axis(v: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """``F.conv3d`` with a single-axis kernel (flipped: conv3d
    correlates), zero padding: one pass of the three-pass route as one
    library call (float32, TF32 off); never called by the port."""
    import numpy as np

    import torch.nn.functional as F

    shape = [1, 1, 1]
    shape[axis] = len(taps)
    w = torch.tensor(np.ascontiguousarray(np.asarray(taps, np.float32)[::-1]),
                     device=v.device).reshape(1, 1, *shape)
    pad = [0, 0, 0]
    pad[axis] = len(taps) // 2
    return F.conv3d(v[None, None], w, padding=tuple(pad))[0, 0]


def runtime_pass(v, out, taps, view=None, prev=None, aux=None, mode="plain", eps=0.0):
    """The pass on csrc/rl_fused.cu's runtime-length kernel (the kernel
    before the compiled passes, which still runs tap lists past 63): the
    axis pass over ``view``, else the x pass."""
    from shrimpy_tpu_torch.kernels.build import check, load_library
    from shrimpy_tpu_torch.ops.rl_fused import MODES, x_piece

    lib, stream = load_library(), torch.cuda.current_stream().cuda_stream
    if view is not None:
        check(lib.shrimpy_conv_axis(v.data_ptr(), out.data_ptr(), taps.data_ptr(), taps.numel(),
                                    *view, None, None, 0, stream), "shrimpy_conv_axis")
        return
    gz, gy, gx = v.shape
    check(lib.shrimpy_conv_x(v.data_ptr(), prev.data_ptr() if prev is not None else None,
                             aux.data_ptr() if aux is not None else None, out.data_ptr(),
                             taps.data_ptr(), taps.numel(), gz * gy, gx,
                             x_piece(gx, taps.numel() // 2), MODES[mode] if aux is not None else 0,
                             eps, 0, stream), "shrimpy_conv_x")


def phase_passes(gen) -> tuple[dict, dict]:
    """The three-pass route's passes at BASELINE.md config 2's full grid,
    one term of (31, 41, 37) taps: the z and y passes
    (``csrc/rl_pass.cu::axis_pass_kernel``) and the x pass
    (``x_pass_kernel``: a middle term, adding the earlier terms' sum, and
    the last, with the ratio epilogue), each bit-equal to its plain
    version, timed beside its bound from the shapes, the plain version,
    one ``F.conv3d`` with the single-axis kernel and csrc/rl_fused.cu's
    runtime-length kernel on the same operands (held to the same bits).
    Returns the axis and x passes' entries."""
    import numpy as np

    from shrimpy_tpu_torch.ops.rl_fused import (
        _conv_axis_plain,
        _epilogue,
        axis_pass_cuda,
        conv_axis_cuda,
        conv_x_cuda,
        x_pass_cuda,
    )

    carry = config2_carry()
    gz, gy, gx = carry
    vox = gz * gy * gx
    rng = np.random.default_rng(SEED + 16)
    host = [rng.random(k).astype(np.float32) + 0.1 for k in CONFIG2_LENGTHS]
    dev = [torch.tensor(h, device="cuda") for h in host]
    eps = headline_settings().deconvolve.epsilon
    v = uniform(carry, gen, 0.5, 10.5)
    out = torch.empty_like(v)
    res = {}
    for axis, view, name in ((0, (1, gz, gy * gx), "z"), (1, (gz, gy, gx), "y")):
        before = axis_pass_cuda.launches
        conv_axis_cuda(v, out, dev[axis], host[axis], *view)
        torch.cuda.synchronize()
        if axis_pass_cuda.launches != before + 1:
            raise AssertionError(f"the {name} pass did not run the compiled axis pass")
        want = _conv_axis_plain(v, host[axis].astype(np.float64), axis)
        err = same_bits(f"{name} pass, {len(host[axis])} taps, config 2 grid {carry}", out, want)
        runtime_pass(v, want, dev[axis], view)
        same_bits(f"{name} pass: the runtime-length kernel", want, out)
        del want
        lib = library_conv_axis(v, host[axis], axis)
        lib_err = rel_err(lib, out)
        del lib
        res[name] = {
            "max_abs_err": err,
            "ms": gpu_ms(lambda: conv_axis_cuda(v, out, dev[axis], host[axis], *view), 10),
            "runtime_ms": gpu_ms(lambda: runtime_pass(v, out, dev[axis], view), 3),
            "plain_ms": gpu_ms(lambda: _conv_axis_plain(v, host[axis], axis), 1),
            "library_ms": gpu_ms(lambda: library_conv_axis(v, host[axis], axis), 2),
            # A carry read, one written; an FMA a tap a voxel.
            **bound(2 * 4 * vox, 2 * len(host[axis]) * vox)}
        print(f"  {name} pass at {carry}: {res[name]['ms']:.3f} ms (the runtime-length kernel "
              f"{res[name]['runtime_ms']:.3f}, plain {res[name]['plain_ms']:.3f}, F.conv3d "
              f"{res[name]['library_ms']:.3f} at {lib_err:.1e} of it; bound "
              f"{res[name]['bound_ms']:.3f} by {res[name]['bound_by']})", flush=True)
    prev = uniform(carry, gen, 0.0, 1.0)
    aux = uniform(carry, gen, 0.0, 5.0)
    x = _conv_axis_plain(v, host[2].astype(np.float64), 2)
    for label, a, mode in (("mid", None, "plain"), ("last", aux, "ratio")):
        before = x_pass_cuda.launches
        conv_x_cuda(v, prev, a, out, dev[2], mode, eps, host=host[2])
        torch.cuda.synchronize()
        if x_pass_cuda.launches != before + 1:
            raise AssertionError("the x pass did not run the compiled x pass")
        want = _epilogue(x + prev, a, mode, eps)
        err = same_bits(f"x pass ({label} term, {mode}), 37 taps, config 2 grid", out, want)
        runtime_pass(v, want, dev[2], prev=prev, aux=a, mode=mode, eps=eps)
        same_bits(f"x pass ({label} term): the runtime-length kernel", want, out)
        del want
        carries = 3 if a is None else 4  # in, prev (and aux) read, out written
        res[f"x_{label}"] = {
            "max_abs_err": err,
            "ms": gpu_ms(lambda: conv_x_cuda(v, prev, a, out, dev[2], mode, eps, host=host[2]),
                         10),
            "runtime_ms": gpu_ms(lambda: runtime_pass(v, out, dev[2], prev=prev, aux=a,
                                                      mode=mode, eps=eps), 3),
            "plain_ms": gpu_ms(lambda: _epilogue(_conv_axis_plain(v, host[2], 2) + prev, a,
                                                 mode, eps), 1),
            **bound(carries * 4 * vox, (2 * len(host[2]) + 1) * vox)}
    del x, prev, aux
    res["x_mid"]["library_ms"] = gpu_ms(lambda: library_conv_axis(v, host[2], 2), 2)
    for label in ("mid", "last"):
        r = res[f"x_{label}"]
        print(f"  x pass at {carry}, {label} term: {r['ms']:.3f} ms (the runtime-length kernel "
              f"{r['runtime_ms']:.3f}, plain {r['plain_ms']:.3f}; bound {r['bound_ms']:.3f} by "
              f"{r['bound_by']})", flush=True)
    print(f"  F.conv3d (1, 1, 37) at {carry}: {res['x_mid']['library_ms']:.3f} ms", flush=True)
    del v, out
    z, y, xm, xl = res["z"], res["y"], res["x_mid"], res["x_last"]
    axis = {**y, "z_ms": z["ms"], "z_runtime_ms": z["runtime_ms"], "z_plain_ms": z["plain_ms"],
            "z_library_ms": z["library_ms"], "z_bound_ms": z["bound_ms"]}
    xp = {**xm, "last_ms": xl["ms"], "last_runtime_ms": xl["runtime_ms"],
          "last_plain_ms": xl["plain_ms"], "last_bound_ms": xl["bound_ms"]}
    return axis, xp


@functools.lru_cache(maxsize=1)
def parent_convzy(parent_dir):
    """The z+y kernel of the commit before the march (``convzy_kernel<kTy,
    kWrap>``), built from ``parent_dir`` (its ``convzy.cu``, kept out of
    the package) into a library of its own: a function that launches it
    on (v, out, kz, ky, boundary)."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    lib_path = build.BUILD_DIR / "libconvzy_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "convzy.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("shrimpy_convzy_linear", "shrimpy_convzy_circular"):
        getattr(lib, name).argtypes = [p, p, p, i32, p, i32, i64, i64, i64, p]
        getattr(lib, name).restype = i32

    def launch(v, out, kz, ky, boundary):
        name = "shrimpy_convzy_linear" if boundary == "zero" else "shrimpy_convzy_circular"
        build.check(getattr(lib, name)(v.data_ptr(), out.data_ptr(), kz.data_ptr(), kz.numel(),
                                       ky.data_ptr(), ky.numel(), *v.shape,
                                       torch.cuda.current_stream().cuda_stream), f"{name} (parent)")
    return launch


def time_convzy(v, st, boundary, old=None) -> dict:
    """The z+y step at the production carry on the march (beside the
    kernel before it, in turns, when ``old`` launches that one) and on the
    two-pass route, each held to the march's bits; returns their times."""
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_circular_cuda, convzy_linear_cuda, convzy_two_pass

    step = convzy_linear_cuda if boundary == "zero" else convzy_circular_cuda
    kz, ky, _ = st.dev[0]
    taps = st.packed()[0]
    out, other, tmp = torch.empty_like(v), torch.empty_like(v), torch.empty_like(v)
    new = lambda: step(v, kz, ky, out=out, taps=taps)  # noqa: E731
    new()
    res = {}
    if old is not None:
        run_old = lambda: old(v, other, kz, ky, boundary)  # noqa: E731
        run_old()
        same_bits(f"convzy {boundary} {tuple(v.shape)} vs the kernel before the march", other, out)
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(gpu_ms(run_old if which == "old" else new, 10))
        res["ms"], res["ms_parent"] = sum(times["new"]) / 2, sum(times["old"]) / 2
        print(f"  convzy {boundary} {tuple(v.shape)}: march {res['ms']:.3f} ms {times['new']}; the "
              f"kernel before it {res['ms_parent']:.3f} {times['old']}", flush=True)
    else:
        res["ms"] = gpu_ms(new, 10)
        print(f"  convzy {boundary} {tuple(v.shape)}: march {res['ms']:.3f} ms (no --parent-convzy: "
              "the kernel before it not timed)", flush=True)
    two = lambda: convzy_two_pass(v, kz, ky, boundary=boundary, out=other, tmp=tmp,  # noqa: E731
                                  host=st.host32[0][:2])
    two()
    same_bits(f"convzy {boundary} {tuple(v.shape)} two_pass vs march", other, out)
    res["ms_two_pass"] = gpu_ms(two, 5)
    print(f"  convzy {boundary} {tuple(v.shape)}: two passes {res['ms_two_pass']:.3f} ms",
          flush=True)
    return res


def convzy_cases(terms, carry):
    """(shape, terms, label, offset in floats) of the z+y checks: the
    production carry, a 2-term PSF, a carry that is not 16-byte aligned
    with an x extent no multiple of 4, and radii past the kernel before
    the march."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    wide = [tuple(rng.random(k).astype(np.float32) for k in (17, 61, 3))]
    return ((carry, terms, f"{carry}", 0), (SMALL, two_term_psf(), f"{SMALL} 2 terms", 0),
            ((13, 200, 33), terms, "(13, 200, 33) 4 bytes in", 1),
            ((20, 90, 40), wide, "(20, 90, 40) PSF (17, 61, 3)", 0))


def offset_carry(shape, gen, off: int) -> torch.Tensor:
    """A random carry whose first element lies ``off`` floats into its storage."""
    n = math.prod(shape)
    return uniform((n + off,), gen, 0.0, 10.0)[off:].view(shape)


def phase_convzy(gen, parent_dir=None) -> dict:
    """convzy_linear against its plain version, both tap orders and both
    routes, bit for bit; timed at the production carry (beside the kernel
    before the march with ``--parent-convzy``)."""
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_linear_cuda, convzy_linear_plain, convzy_two_pass
    from shrimpy_tpu_torch.ops.rl_fused import Stencil

    terms, carry = production_terms()
    res = {"max_abs_err": 0.0}
    for shape, tt, label, off in convzy_cases(terms, carry):
        v = offset_carry(shape, gen, off)
        for flip in (False, True):
            for t, (kz, ky, _) in enumerate(Stencil(tt, flip=flip, device="cuda").dev):
                want = convzy_linear_plain(v, kz.cpu().numpy(), ky.cpu().numpy())
                same_bits(f"convzy_linear {label} term {t} flip={flip}",
                          convzy_linear_cuda(v, kz, ky), want)
                same_bits(f"convzy_linear {label} term {t} flip={flip} (two_pass)",
                          convzy_two_pass(v, kz, ky, boundary="zero", out=torch.empty_like(v)),
                          want)
                del want
        if shape == carry:
            st = Stencil(tt, device="cuda")
            kz, ky, _ = st.host[0]
            res.update(time_convzy(v, st, "zero", parent_convzy(parent_dir) if parent_dir else None))
            res["plain_ms"] = gpu_ms(lambda: convzy_linear_plain(v, kz, ky), 2)
            res.update(bound(2 * 4 * v.numel(), 2 * (len(kz) + len(ky)) * v.numel()))
            weight = dense_kernel(tt[:1], axes=(0, 1))
            compare(f"F.conv3d {tuple(weight.shape[2:])} vs convzy_linear", library_conv3d(v, weight),
                    convzy_linear_cuda(v, kz, ky), 1e-3)
            res["library_ms"] = gpu_ms(lambda: library_conv3d(v, weight), 2)
            print(f"  convzy_linear {carry}: bound {res['bound_ms']:.3f} ms by {res['bound_by']}, "
                  f"F.conv3d {res['library_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms", flush=True)
        del v
    return res


def library_conv3d_circular(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One ``torch.nn.Conv3d(..., padding_mode="circular", bias=False)``
    call with ``weight``: the circular yardstick the port never calls."""
    conv = torch.nn.Conv3d(1, 1, tuple(weight.shape[2:]), padding=tuple(k // 2 for k in
                           weight.shape[2:]), padding_mode="circular", bias=False).cuda()
    conv.weight.data.copy_(weight)
    with torch.no_grad():
        return conv(v[None, None])[0, 0]


def time_conv3(v, st) -> dict:
    """conv3_circular at the production carry on its one launch
    (``rl_half.cu``'s circular build) and on the two-launch route it
    replaces, in turns (two, one, one, two), the first held to the
    second's bits."""
    from shrimpy_tpu_torch.ops.conv3_cuda import conv3_half_step_cuda, conv3_one_launch

    out, other, scratch = torch.empty_like(v), torch.empty_like(v), [torch.empty_like(v)]
    one = lambda: conv3_one_launch(v, st, out=out)  # noqa: E731
    two = lambda: conv3_half_step_cuda(v, None, st, "plain", boundary="circular",  # noqa: E731
                                       out=other, scratch=scratch)
    one()
    two()
    same_bits(f"conv3_circular {tuple(v.shape)} one launch vs z+y then x", out, other)
    times = {"one": [], "two": []}
    for which in ("two", "one", "one", "two"):
        times[which].append(gpu_ms(one if which == "one" else two, 10))
    res = {"ms": sum(times["one"]) / 2, "ms_zy_then_x": sum(times["two"]) / 2}
    print(f"  conv3_circular {tuple(v.shape)}: one launch {res['ms']:.3f} ms {times['one']}; "
          f"z+y then x {res['ms_zy_then_x']:.3f} {times['two']}", flush=True)
    return res


def phase_circular(gen, parent_dir=None) -> tuple[dict, dict, dict]:
    """convzy_circular (both routes, bit for bit; timed beside the kernel
    before the march with ``--parent-convzy``), conv3_circular (both
    routes, bit for bit, and against the plain version) and the circular x
    pass against their plain versions; conv3_circular past the one-launch
    block; then conv3_circular driven once with the counts reset (no
    backend reaches it). Returns the three kernels' entries: max|a-b| over
    every check, times at the production carry beside torch.nn.Conv3d
    with a circular padding (the dense (9, 21, 1) kernel of the z+y step,
    the dense sum of the terms for conv3)."""
    import numpy as np

    from shrimpy_tpu_torch.ops.conv3_cuda import (
        conv3_circular,
        conv3_circular_cuda,
        conv3_circular_plain,
        conv3_circular_route,
        conv3_half_step_cuda,
        convzy_circular_cuda,
        convzy_circular_plain,
        convzy_two_pass,
        x_circulant_plain,
    )
    from shrimpy_tpu_torch.ops.rl_fused import Stencil, _epilogue, conv_x_cuda

    eps = headline_settings().deconvolve.epsilon
    terms, carry = production_terms()
    zy, c3, xp = ({"max_abs_err": 0.0} for _ in range(3))
    for shape, tt, label, off in conv3_cases(terms, carry):
        v = offset_carry(shape, gen, off)
        for flip in (False, True):
            st = Stencil(tt, flip=flip, device="cuda")
            for t, (kz, ky, _) in enumerate(st.dev):
                want = convzy_circular_plain(v, kz.cpu().numpy(), ky.cpu().numpy())
                same_bits(f"convzy_circular {label} term {t} flip={flip}",
                          convzy_circular_cuda(v, kz, ky), want)
                same_bits(f"convzy_circular {label} term {t} flip={flip} (two_pass)",
                          convzy_two_pass(v, kz, ky, boundary="circular",
                                          out=torch.empty_like(v)), want)
                del want
            route = conv3_circular_route(shape, st.radii, len(tt))
            got = conv3_circular_cuda(v, st)
            if route == "one_launch":
                same_bits(f"conv3_circular {label} flip={flip} one launch vs z+y then x", got,
                          conv3_half_step_cuda(v, None, st, "plain", boundary="circular"))
            err = compare(f"conv3_circular {label} flip={flip} ({route})", got,
                          conv3_circular_plain(v, st), KERNEL_RTOL)
            c3["max_abs_err"] = max(c3["max_abs_err"], err)
            del got
        if shape == carry:
            st = Stencil(tt, device="cuda")
            kz, ky, _ = st.host[0]
            zy.update(time_convzy(v, st, "circular",
                                  parent_convzy(parent_dir) if parent_dir else None))
            zy["plain_ms"] = gpu_ms(lambda: convzy_circular_plain(v, kz, ky), 2)
            c3.update(time_conv3(v, st))
            c3["plain_ms"] = gpu_ms(lambda: conv3_circular_plain(v, st), 2)
            # v read, out written.
            zy.update(bound(2 * 4 * v.numel(), 2 * (len(kz) + len(ky)) * v.numel()))
            c3.update(bound(2 * 4 * v.numel(), 2 * n_taps(tt) * v.numel()))
            for entry, weight, want, name in (
                    (zy, dense_kernel(tt[:1], axes=(0, 1)),
                     convzy_circular_cuda(v, st.dev[0][0], st.dev[0][1]), "convzy_circular"),
                    (c3, dense_kernel(tt), conv3_circular_cuda(v, st), "conv3_circular")):
                compare(f"Conv3d circular {tuple(weight.shape[2:])} vs {name}",
                        library_conv3d_circular(v, weight), want, 1e-3)
                del want
                entry["library_ms"] = gpu_ms(lambda: library_conv3d_circular(v, weight),
                                             1 if name == "conv3_circular" else 2)
                print(f"  {name} {carry}: bound {entry['bound_ms']:.3f} ms by "
                      f"{entry['bound_by']}, Conv3d circular {entry['library_ms']:.3f} ms, plain "
                      f"{entry['plain_ms']:.3f} ms", flush=True)
        del v
    # Past the one-launch block: the z+y step, then the x pass.
    wide = [tuple(np.random.default_rng(SEED + 5).random(k).astype(np.float32)
                  for k in TWO_PASS_PSF[0])]
    v = uniform((6, 210, 20), gen, 0.0, 10.0)
    st = Stencil(wide, device="cuda")
    if conv3_circular_route(tuple(v.shape), st.radii) != "zy_then_x":
        raise AssertionError("conv3_circular: a (9, 201, 3) PSF should be past the block")
    err = compare("conv3_circular (6, 210, 20) PSF (9, 201, 3) (zy_then_x)",
                  conv3_circular_cuda(v, st), conv3_circular_plain(v, st), KERNEL_RTOL)
    c3["max_abs_err"] = max(c3["max_abs_err"], err)
    # The x pass alone: the production row, and a row of 21 under 45 taps.
    rng = np.random.default_rng(SEED)
    for shape, kx, label in ((carry, Stencil(terms).host[0][2], f"{carry}"),
                             ((5, 9, 21), rng.random(45).astype(np.float32), "(5, 9, 21) 45 taps")):
        h = uniform(shape, gen, 0.5, 10.5)
        aux = uniform(shape, gen, 0.0, 5.0)
        kxh = np.array(kx, np.float32)
        kxd = torch.tensor(kxh, device="cuda")
        out = torch.empty_like(h)
        for mode in ("ratio", "mult", "plain"):
            a = None if mode == "plain" else aux
            conv_x_cuda(h, None, a, out, kxd, mode, eps, wrap=True, host=kxh)
            err = compare(f"circular x pass {mode} {label}", out,
                          _epilogue(x_circulant_plain(h, kx), a, mode, eps), KERNEL_RTOL)
            xp["max_abs_err"] = max(xp["max_abs_err"], err)
        if shape == carry:
            xp["ms"] = gpu_ms(lambda: conv_x_cuda(h, None, aux, out, kxd, "ratio", eps,
                                                  wrap=True, host=kxh), 10)
            # Mode ratio, as timed: h and aux read, out written; an FMA a
            # tap and the division.
            xp.update(bound(3 * 4 * h.numel(), (2 * len(kx) + 1) * h.numel()))
            xp["plain_ms"] = gpu_ms(lambda: _epilogue(x_circulant_plain(h, kx), aux, "ratio",
                                                      eps), 2)
        del h, aux, out
    print("  conv3_circular through its entry point at the production carry:", flush=True)
    v = uniform(carry, gen, 0.0, 10.0)
    _, counts, _ = drive(lambda vol: conv3_circular(vol, terms), v,
                         {"conv3_circular": 1, "conv3_one_launch": 1})
    c3["launches"] = counts["conv3_one_launch"]
    del v
    return zy, c3, xp


def conv3_cases(terms, carry):
    """convzy_cases, and a grid smaller than the radii (wraps twice) and an
    aligned carry with interior and seam blocks of every kind."""
    return convzy_cases(terms, carry) + (((3, 9, 40), terms, "(3, 9, 40) multi-wrap", 0),
                                         ((20, 150, 256), terms, "(20, 150, 256) seams", 0))


TWO_PASS_PSF = ((9, 201, 3), (1.5, 30.0, 0.8))  # y radius 100: no tile of the march fits


def rl_drive(backend: str, image_shape, psf_spec, iterations: int, want: dict, seed: int,
             **kw) -> dict:
    """RL through ``richardson_lucy`` on ``backend`` with the counts reset,
    against its float64 plain path; returns the counts."""
    from shrimpy_tpu_torch.config import deconvolve_settings
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, richardson_lucy

    psf = gaussian_psf(*psf_spec)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = uniform(image_shape, gen, 0.0, 100.0)
    s = deconvolve_settings(iterations=iterations, psf_crop_tol=0.0, separable_backend=backend, **kw)
    t0 = time.monotonic()
    out, counts, _ = drive(lambda v: richardson_lucy(v, psf, s), img, want)
    t1 = time.monotonic()
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    torch.cuda.synchronize()
    label = f"{backend} RL-{iterations} {image_shape} PSF {psf_spec[0]}"
    print(f"  {label}: the kernel path {t1 - t0:.1f} s, its float64 plain path "
          f"{time.monotonic() - t1:.1f} s", flush=True)
    if kw.get("acceleration") == "biggs":
        two_tier(f"{label} Biggs vs float64 plain", out, ref)
    else:
        compare(f"{label} vs float64 plain", out, ref, STEP_RTOL)
    return counts


def phase_routes() -> dict:
    """The z+y step's two-pass route through ``richardson_lucy``: a PSF
    past the march kernel's block on ``linear_pallas`` and ``zy_pallas``
    (RL-2 each, Biggs too); then the carries repaired in this slice,
    driven once: a z extent past a launch's grid in the two-pass y pass,
    and an x row longer than a block's shared memory in the x pass.
    Returns the two-pass route's launches."""
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_route

    t0 = time.monotonic()
    radii = tuple(k // 2 for k in TWO_PASS_PSF[0])
    image = (16, 120, 64)
    grid = tuple(n + 2 * r for n, r in zip(image, radii))
    launches = 0
    for backend, boundary, name in (("linear_pallas", "zero", "convzy_linear"),
                                    ("zy_pallas", "circular", "convzy_circular")):
        if convzy_route(grid, radii[:2], boundary) != "two_pass":
            raise AssertionError(f"PSF {TWO_PASS_PSF[0]} on {grid} does not take the two-pass route")
        for kw in ({}, {"acceleration": "biggs"}):
            counts = rl_drive(backend, image, TWO_PASS_PSF, 2, {name: 4, "convzy_two_pass": 8},
                              SEED + 5, **kw)
            launches += counts["convzy_two_pass"]
    print(f"  repaired carries: z past a launch's grid (two-pass y pass), an x row in pieces "
          f"(the two-pass route's RL took {time.monotonic() - t0:.1f} s):", flush=True)
    rl_drive("linear_pallas", (66000, 2, 6), TWO_PASS_PSF, 1,
             {"convzy_linear": 2, "convzy_two_pass": 4}, SEED + 6)
    rl_drive("zy_pallas", (4, 6, 60000), ((3, 5, 21), (0.8, 1.0, 3.0)), 1,
             {"convzy_circular": 2, "convzy_march": 2}, SEED + 7)
    print(f"  (the repaired carries: {time.monotonic() - t0:.1f} s so far)", flush=True)
    launches += phase_wide_radius()
    return {"launches": launches}


WIDE_PSF = ((3, 431, 3), (0.8, 60.0, 0.8))  # y radius 215: past the two-pass route's column


def phase_wide_radius() -> int:
    """A y radius past 211, where the two-pass route's column of 32 + 2 r
    rows outgrows a block and conv_axis takes the taps in chunks: the z+y
    step bit for bit on both boundaries on the (6, 440, 40) grid of a
    (4, 10, 38) image, then zy_pallas RL-2 through richardson_lucy with
    the counts reset. Returns the two-pass route's launches there."""
    import numpy as np

    from shrimpy_tpu_torch.ops.conv3_cuda import (
        convzy_circular_cuda,
        convzy_circular_plain,
        convzy_linear_cuda,
        convzy_linear_plain,
    )

    print(f"  PSF {WIDE_PSF[0]}: z+y radii past the two-pass route's column", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    v = uniform((6, 440, 40), gen, 0.0, 10.0)
    wz, wy = (np.random.default_rng(k).random(k).astype(np.float32) for k in WIDE_PSF[0][:2])
    for name, step, plain in (("convzy_linear", convzy_linear_cuda, convzy_linear_plain),
                              ("convzy_circular", convzy_circular_cuda, convzy_circular_plain)):
        same_bits(f"{name} (6, 440, 40) taps {WIDE_PSF[0][:2]}", step(v, wz, wy), plain(v, wz, wy))
    counts = rl_drive("zy_pallas", (4, 10, 38), WIDE_PSF, 2,
                      {"convzy_circular": 4, "convzy_two_pass": 8}, SEED + 8)
    return counts["convzy_two_pass"]


def iter_fmas(shape, radii, tile, n_terms: int = 1) -> float:
    """FMAs of one ``csrc/rl_iter.cu`` launch on a (gz, gy, gx) carry,
    the halo it recomputes included and its windows unpadded: per block
    and plane the x pass of the est slab, the y and z passes over the
    footprint, the adjoint x pass over it and the adjoint y and z passes
    over the tile, each term."""
    (gz, gy, gx), (rz, ry, rx), (ty, tx) = shape, radii, tile
    kz, ky, kx = 2 * rz + 1, 2 * ry + 1, 2 * rx + 1
    sr, mr, mc = ty + 4 * ry, ty + 2 * ry, tx + 2 * rx
    per_plane = n_terms * (sr * mc * kx + mr * mc * (ky + kz) + mr * tx * kx + ty * tx * (ky + kz))
    return per_plane * gz * -(-gy // ty) * -(-gx // tx)


def parent_iter(parent_dir):
    """The whole-iteration kernel of the commit before the redesign, built
    from ``parent_dir`` (its ``rl_iter.cu`` and ``stencil.cuh``, kept out
    of the package) into a library of its own: a function that launches it
    on (est, data, out, taps, eps) with the tile and threads it took at the
    production carry."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    src = Path(parent_dir) / "rl_iter.cu"
    lib_path = build.BUILD_DIR / "librl_iter_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.shrimpy_rl_iter.argtypes = [p] * 4 + [i32] * 4 + [i64] * 3 + [i32] * 3 + [ctypes.c_float, p]
    lib.shrimpy_rl_iter.restype = i32

    def launch(est, data, out, taps, radii, eps, tile=(32, 48), threads=1024):
        build.check(lib.shrimpy_rl_iter(
            est.data_ptr(), data.data_ptr(), out.data_ptr(), taps.data_ptr(), taps.shape[1],
            *(2 * r + 1 for r in radii), *est.shape, *tile, threads, float(eps),
            torch.cuda.current_stream().cuda_stream), "shrimpy_rl_iter (parent)")
    return launch


ROUTE_PSF = ((17, 61, 61), (3.0, 9.0, 9.0))  # past the one-launch block: the half-step route


def phase_iter(gen, parent_dir=None) -> dict:
    """rl_iter (one launch per RL iteration) against its plain version on
    three grids, both tap orders, bit for bit; timed at the production
    carry, beside the kernel of the commit before the redesign when
    ``parent_dir`` holds its source; then the route past the block,
    driven through ``richardson_lucy`` with the counts reset."""
    from shrimpy_tpu_torch.ops.rl_fused import Stencil
    from shrimpy_tpu_torch.ops.rl_fused_iter import (
        iter_layout,
        pack_taps,
        rl_iter_cuda,
        rl_iter_plain,
    )

    eps = headline_settings().deconvolve.epsilon
    terms, carry = production_terms()
    res = {}
    for shape, tt, label in ((carry, terms, f"{carry}"),
                             (SMALL, two_term_psf(), f"{SMALL} 2 terms"),
                             (RAGGED, terms, f"{RAGGED} ragged, gz < 2rz+1")):
        conv = Stencil(tt, device="cuda")
        adj = Stencil(tt, flip=True, device="cuda")
        est = uniform(shape, gen, 0.5, 10.5)
        data = uniform(shape, gen, 0.0, 5.0)
        layout = iter_layout(shape, conv.radii, len(tt))
        print(f"  rl_iter {label}: {layout}", flush=True)
        # Both tap orders: the adjoint's taps as the convolution's and back.
        for a, b, order in ((conv, adj, "conv, adj"), (adj, conv, "adj, conv")):
            same_bits(f"rl_iter {label} ({order})", rl_iter_cuda(est, data, a, b, eps),
                      rl_iter_plain(est, data, a, b, eps))
        if shape == carry:
            res["max_abs_err"] = 0.0
            out = torch.empty_like(est)
            taps = pack_taps(conv, adj, "cuda")
            new = lambda: rl_iter_cuda(est, data, conv, adj, eps, out, taps=taps)  # noqa: E731
            if parent_dir is not None:
                old = parent_iter(parent_dir)
                old_out = torch.empty_like(est)
                run_old = lambda: old(est, data, old_out, taps, conv.radii, eps)  # noqa: E731
                new()
                run_old()
                same_bits("rl_iter vs the kernel before the redesign", out, old_out)
                times = {"old": [], "new": []}
                for which in ("old", "new", "new", "old"):
                    times[which].append(gpu_ms(run_old if which == "old" else new, 5))
                res["ms"] = sum(times["new"]) / 2
                res["ms_parent"] = sum(times["old"]) / 2
                print(f"  rl_iter {label}: {res['ms']:.3f} ms a launch {times['new']}; the kernel "
                      f"before the redesign {res['ms_parent']:.3f} {times['old']}", flush=True)
                del old_out
            else:
                res["ms"] = gpu_ms(new, 5)
                print(f"  rl_iter {label}: {res['ms']:.3f} ms a launch (no --parent-iter: the "
                      "kernel before the redesign not timed)", flush=True)
            res["plain_ms"] = gpu_ms(lambda: rl_iter_plain(est, data, conv, adj, eps), 2)
            # est and data read, out written; both conv3s' FMAs, the
            # division and the product. A whole RL iteration is no single
            # PyTorch call. Beside it the bound of the FMAs the kernel does,
            # the halo it recomputes included.
            res.update(bound(3 * 4 * est.numel(), (4 * n_taps(tt) + 2) * est.numel()),
                       library_ms=None)
            kernel_ops = 2 * iter_fmas(shape, conv.radii, layout["tile"], len(tt))
            res["bound_ms_kernel_fmas"] = bound(0, kernel_ops)["bound_ms"]
            print(f"  rl_iter {label}: bound {res['bound_ms']:.3f} ms by {res['bound_by']}; "
                  f"of its own FMAs with halo ({kernel_ops / 2 / est.numel():.1f} a voxel) "
                  f"{res['bound_ms_kernel_fmas']:.3f} ms", flush=True)
            del out
        del est, data
    res["route_launches"] = phase_iter_route()
    return res


def phase_iter_route() -> int:
    """fused_iter past the one-launch kernel's block: RL-2 through
    ``richardson_lucy`` with a (17, 61, 61) PSF takes the half-step route
    (no rl_iter launch, no plain version), against the float64 plain path
    and the ``fused`` backend's output. Returns the route's count."""
    from shrimpy_tpu_torch.config import deconvolve_settings
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms, prepare_psf, richardson_lucy
    from shrimpy_tpu_torch.ops.rl_fused import half_step_route
    from shrimpy_tpu_torch.ops.rl_fused_iter import rl_iter_route

    psf = gaussian_psf(*ROUTE_PSF)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    img = uniform((24, 200, 240), gen, 0.0, 100.0)
    s = deconvolve_settings(iterations=2, psf_crop_tol=0.0, separable_backend="fused_iter")
    psf_w = prepare_psf(psf, s)
    radii = tuple(k // 2 for k in psf_w.shape)
    n_terms = len(plan_terms(psf_w, s))
    grid = tuple(n + 2 * r for n, r in zip(img.shape, radii))
    route, half = rl_iter_route(grid, radii, n_terms), half_step_route(grid, radii, n_terms)
    print(f"  fused_iter RL-2, PSF {psf_w.shape} x {n_terms} term(s), carry {grid}: route {route}, "
          f"half-steps {half}", flush=True)
    if route != "half_steps":
        raise AssertionError(f"PSF {psf_w.shape} on {grid} does not take the half-step route")
    per_step = 1 if half == "one_launch" else 3 * n_terms
    out, counts, _ = drive(lambda v: richardson_lucy(v, psf, s), img,
                           {"rl_iter_half_steps": 2, "rl_half_step": 4,
                            f"rl_half_{half}": 4 * per_step})
    ref = richardson_lucy(img, psf, s, plain=True, dtype=torch.float64)
    compare("fused_iter RL-2 on the half-step route vs float64 plain", out, ref, STEP_RTOL)
    s.separable_backend = "fused"
    compare("fused_iter RL-2 on the half-step route vs fused", out, richardson_lucy(img, psf, s),
            FUSED_RTOL)
    return counts["rl_iter_half_steps"]


def kernel_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn``'s launches back to back, the host kept
    out of the window: a spin kernel holds the stream while the host
    queues the ``reps`` calls (longer until the window opens after the
    last of them is queued), so no launch waits for the host."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the host did not queue the launches ahead of the card")


def in_turns(new, old=None) -> dict:
    """``kernel_ms`` of ``new``; with ``old``, of both in turns (old, new,
    new, old), each the mean of its two."""
    if old is None:
        return {"ms": kernel_ms(new)}
    p1, n1, n2, p2 = kernel_ms(old), kernel_ms(new), kernel_ms(new), kernel_ms(old)
    return {"ms": (n1 + n2) / 2, "ms_parent": (p1 + p2) / 2}


def sm_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi``), the rate of the
    one-SM shared-memory bound."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


@functools.lru_cache(maxsize=1)
def parent_probes(parent_dir):
    """The probe kernels of the commit before their redesign (the
    ``nvcuda::wmma`` products, three launches a bf16 mode), built from
    ``parent_dir`` (its ``probes.cu``, kept out of the package) into a
    library of their own: (slice, touch, dot), functions that launch the
    slice into ``out``, the block of ``kb`` KB into a zeroed ``out`` and
    the product of mode ``mode`` into a new tensor."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    lib_path = build.BUILD_DIR / "libprobes_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "probes.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shrimpy_probe_smem_slice.argtypes = [p, p] + [i32] * 3 + [p]
    lib.shrimpy_probe_smem.argtypes = [p, i32, p]
    lib.shrimpy_probe_split_dot.argtypes = [p] * 7 + [i32] * 4 + [p]
    for fn in (lib.shrimpy_probe_smem_slice, lib.shrimpy_probe_smem, lib.shrimpy_probe_split_dot):
        fn.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def slice_(x, out):
        build.check(lib.shrimpy_probe_smem_slice(x.data_ptr(), out.data_ptr(), *x.shape, 128,
                                                 stream()), "shrimpy_probe_smem_slice (parent)")

    def touch(kb, out):
        build.check(lib.shrimpy_probe_smem(out.data_ptr(), kb * 1024, stream()),
                    "shrimpy_probe_smem (parent)")

    def dot(a, b, mode):
        from shrimpy_tpu_torch.kernels.probes import DOT_MODES

        (m, k), n = a.shape, b.shape[1]
        pieces = [torch.empty(shape, dtype=torch.bfloat16, device=a.device)
                  for shape in ((m, k), (m, k), (k, n), (k, n))]
        c = torch.empty((m, n), device=a.device)
        build.check(lib.shrimpy_probe_split_dot(a.data_ptr(), b.data_ptr(),
                                                *(q.data_ptr() for q in pieces), c.data_ptr(),
                                                m, n, k, DOT_MODES[mode], stream()),
                    "shrimpy_probe_split_dot (parent)")
        return c
    return slice_, touch, dot


# The split products' shapes past the probe's, (m, k, n): the smallest
# tile, ragged k and n, a deep k.
DOT_EXTRA_SHAPES = ((64, 16, 8), (192, 168, 264), (64, 1024, 256))


def phase_probes(parent_dir=None) -> tuple[dict, dict, dict]:
    """The three on-chip probes against their plain versions, each timed
    alone (``kernel_ms``: back-to-back launches, the opt-in and the read
    back outside the window) beside an empty kernel of its launch shape
    (``floor_ms``) and, under ``ms_host``, with the host (a call of the
    entry, its read back included); with ``parent_dir`` also the kernels
    before the redesign, in turns, each product mode held to theirs; then
    the probes driven through their entry points with the counts reset."""
    from shrimpy_tpu_torch.kernels import probes
    from shrimpy_tpu_torch.ops.rl_fused import _SMEM_BYTES

    t0 = time.monotonic()
    old = parent_probes(parent_dir) if parent_dir else None
    x = torch.arange(8 * 512, dtype=torch.float32, device="cuda").reshape(8, 512)
    got = probes.dynamic_smem_slice_cuda(x)
    want = probes.dynamic_smem_slice_plain(x)
    if not torch.equal(got, want):
        raise AssertionError("probe_dynamic_smem_slice differs from the same indexing in torch")
    print("  probe_dynamic_smem_slice: exact", flush=True)
    out_old = torch.empty_like(x)
    if old:
        old[0](x, out_old)
        same_bits("probe_dynamic_smem_slice vs the kernel before", got, out_old)
    sl = {"max_abs_err": 0.0,
          **in_turns(lambda: probes.dynamic_smem_slice_cuda(x),
                     old and (lambda: old[0](x, out_old))),
          "floor_ms": kernel_ms(lambda: probes.empty_launch(4, 128, 4 * x.numel())),
          "ms_host": gpu_ms(lambda: probes.dynamic_smem_slice_cuda(x), 20),
          "plain_ms": gpu_ms(lambda: probes.dynamic_smem_slice_plain(x), 20),
          **bound(2 * 4 * x.numel(), x.numel()), "library_ms": None}

    fits = {kb: probes.probe_smem(kb) for kb in probes.SMEM_KB}
    largest = probes.largest_smem()
    print(f"  probe_smem: {fits}; largest block {largest} bytes (_SMEM_BYTES {_SMEM_BYTES})",
          flush=True)
    if list(fits.values()) != [True] * 5 + [False] or largest != _SMEM_BYTES:
        raise AssertionError(f"probe_smem {fits}, largest block {largest} != {_SMEM_BYTES}")
    kb = _SMEM_BYTES // 1024
    words = _SMEM_BYTES // 4
    out = torch.empty(2, dtype=torch.int32, device="cuda")
    out_old = torch.zeros(2, dtype=torch.int32, device="cuda")
    mhz = sm_clock_mhz()
    # The block writes and reads each word once in shared memory (8 bytes
    # leave it; 2 integer operations a word at the float32 rate: bound());
    # bound_ms_smem: those bytes at one SM's 128 bytes a clock.
    sm = {"max_abs_err": 0.0,
          **in_turns(lambda: probes.smem_touch_cuda(kb, out),
                     old and (lambda: old[1](kb, out_old))),
          "floor_ms": kernel_ms(lambda: probes.empty_launch(1, 1024, _SMEM_BYTES)),
          "ms_host": gpu_ms(lambda: probes.probe_smem(kb), 5),
          "plain_ms": gpu_ms(lambda: probes.smem_touch_plain(kb), 5),
          **bound(8, 2 * words), "library_ms": None,
          "bound_ms_smem": probes.smem_bound_ms(probes.smem_touch_bytes(kb), mhz),
          "sm_clock_mhz": mhz}

    a, b = probes.dot_operands("cuda", SEED)
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    (m, k), n = a.shape, b.shape[1]
    passes = {"bf16x3": (3, BF16_FLOPS), "tf32": (1, TF32_FLOPS), "tf32x3": (3, TF32_FLOPS),
              "bf16": (1, BF16_FLOPS), "fma": (1, FP32_FLOPS)}
    dot = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "floor_ms": 0.0,
           "ms_host": 0.0, "errors": {}}
    if old:
        dot["ms_parent"] = 0.0
    for mode, (n_pass, peak) in passes.items():
        c = probes.split_dot_cuda(a, b, mode).double()
        plain = probes.split_dot_plain(a, b, mode)
        err, vs_plain = (float((c - r).abs().max()) / scale for r in (ref, plain))
        gated = mode in ("bf16x3", "tf32x3")
        print(f"  probe_split_dot {mode}: rel err vs float64 {err:.3e}"
              f"{f' (tol {probes.SPLIT_RTOL:g})' if gated else ' (reported)'}; vs its plain "
              f"version {vs_plain:.3e} (tol {probes.SPLIT_RTOL:g})", flush=True)
        if (gated and not err <= probes.SPLIT_RTOL) or not vs_plain <= probes.SPLIT_RTOL:
            raise AssertionError(f"probe_split_dot {mode}: {err:.3e} vs float64, {vs_plain:.3e} "
                                 "vs plain")
        for sm_, sk, sn in DOT_EXTRA_SHAPES:
            xa, xb = probes.dot_operands("cuda", SEED + 1, ((sm_, sk), (sk, sn)))
            got = probes.split_dot_cuda(xa, xb, mode).double()
            at = f"at ({sm_}, {sk}) @ ({sk}, {sn})"
            compare(f"probe_split_dot {mode} {at} vs plain", got,
                    probes.split_dot_plain(xa, xb, mode), probes.SPLIT_RTOL)
            if gated:
                compare(f"probe_split_dot {mode} {at} vs float64", got,
                        xa.double() @ xb.double(), probes.SPLIT_RTOL)
        if old:
            compare(f"probe_split_dot {mode} vs the kernel before", c, old[2](a, b, mode).double(),
                    probes.SPLIT_RTOL)
        dot["errors"][mode] = err
        dot["max_abs_err"] = max(dot["max_abs_err"], vs_plain * scale)
        times = in_turns(lambda: probes.split_dot_cuda(a, b, mode),
                         old and (lambda: old[2](a, b, mode)))
        blocks, threads, smem = probes.split_dot_launch(m, n, mode)
        times["floor_ms"] = kernel_ms(lambda: probes.empty_launch(blocks, threads, smem))
        times["ms_host"] = gpu_ms(lambda: probes.split_dot_cuda(a, b, mode), 20)
        for key, value in times.items():
            dot[f"{mode}_{key}"] = value
            dot[key] += value
        dot["plain_ms"] += gpu_ms(lambda: probes.split_dot_plain(a, b, mode), 5)
        dot["bound_ms"] += bound(4 * (m * k + k * n + m * n), 2 * m * n * k * n_pass,
                                 peak)["bound_ms"]
    dot["bound_by"] = bound(4 * (m * k + k * n + m * n), 2 * m * n * k, FP32_FLOPS)["bound_by"]
    # No one PyTorch call computes the five products that the entry sums.
    # torch.matmul in float32 (TF32 off) is the same function as the fma
    # mode alone, and stands beside that mode's time (timed alone, and
    # with the host).
    dot["library_ms"] = None
    dot["fma_library_ms"] = kernel_ms(lambda: torch.matmul(a, b))
    dot["fma_library_ms_host"] = gpu_ms(lambda: torch.matmul(a, b), 20)
    for name, e in (("probe_smem_slice", sl), ("probe_smem", sm), ("probe_split_dot", dot)):
        print(f"  {name}: {e['ms']:.4f} ms alone (floor {e['floor_ms']:.4f}, before "
              f"{e.get('ms_parent', 'not timed')}), {e['ms_host']:.4f} ms with the host, bound "
              f"{e['bound_ms']:.6f}" + (f", one SM's shared memory {e['bound_ms_smem']:.6f}"
                                        if "bound_ms_smem" in e else ""), flush=True)
    print("  probe_split_dot by mode: " + ", ".join(
        f"{mode} {dot[mode + '_ms']:.4f} (floor {dot[mode + '_floor_ms']:.4f}, before "
        f"{dot.get(mode + '_ms_parent', 'not timed')})" for mode in passes)
        + f"; torch.matmul {dot['fma_library_ms']:.4f}", flush=True)

    print("  the probes through their entry points:", flush=True)

    def entry(_):
        if not probes.probe_dynamic_smem_slice():
            raise AssertionError("probe_dynamic_smem_slice")
        if probes.largest_smem() != _SMEM_BYTES:
            raise AssertionError("largest_smem")
        errs = probes.probe_split_dot(seed=SEED)
        return torch.tensor([r["err"] for r in errs.values()])

    fit_count = sum(fits.values())
    _, counts, _ = drive(entry, None, {"probe_smem_slice": 1, "probe_smem": fit_count,
                                       "probe_split_dot": len(passes)})
    for entry_dict, name in ((sl, "probe_smem_slice"), (sm, "probe_smem"),
                             (dot, "probe_split_dot")):
        entry_dict["launches"] = counts[name]
    print(f"  the probes took {time.monotonic() - t0:.1f} s", flush=True)
    return sl, sm, dot


# Registration (csrc/affine.cu): the warp on four maps, its gradient at the
# refine grid, the production estimate and the registered step.
AFFINE_OTHER_SHAPE = (136, 2800, 1700)  # deeper and wider, shorter in y
AFFINE_OTHER_MAPS = ("rot30",)  # the maps also run to it (all four before phase 4u)
REGISTER_SMALL = (64, 256, 256)  # bench.py::_config_register
DOWN = 4  # RegistrationSettings.downsample_yx: the refine's y/x stride
# The refine's default form: scale, shear and a fractional offset.
LOWER_MAP = ([[1.003, 0.0, 0.0], [0.012, 0.997, 0.0], [-0.018, 0.015, 1.002]], [0.4, -3.2, 2.6])
# The register phase's truth: a residual misalignment (the far edge moves
# by up to 0.43 px beside the translation) well inside what the default
# refine reaches in its 100 steps: an Adam step moves an entry of its dm by
# ~lr = 0.05, and a y scale of 1e-4 is 1.16 units of dm on the stride-4 grid
# of the deskewed volume (4 x 2888 x 1e-4). Scales of 4e-4 (4.6 units) left
# the offset 0.39 px from the truth after 100 steps.
TRUE_MAP = ([[1.0, 0.0, 0.0], [0.0002, 1.0001, 0.0], [-0.0001, 0.00015, 0.9999]],
            [0.4, -3.2, 2.6])


def f32_map(m, t):
    import numpy as np

    return np.asarray(m, np.float32), np.asarray(t, np.float32)


def affine_maps(shape) -> dict:
    """The maps phase affine runs: a fractional translation, the refine's
    lower-triangular form, and 2- and 30-degree rotations in the yx plane
    about the volume's center (the last, JAX's gather tier)."""
    import numpy as np

    maps = {"translate": f32_map(np.eye(3), LOWER_MAP[1]), "lower": f32_map(*LOWER_MAP)}
    center = (np.asarray(shape, np.float64) - 1) / 2
    for deg in (2, 30):
        c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
        m = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
        maps[f"rot{deg}"] = f32_map(m, center - m @ center)
    return maps


def warp_footprint(vol_shape, m, t, out_shape, step: int = 1 << 24) -> tuple[int, int]:
    """(input voxels the warp reads with a nonzero weight, 32-byte sectors
    of the input that hold them), in float64 coordinates, output z-slabs
    of ``step`` voxels at a time."""
    touched = torch.zeros(math.prod(vol_shape), dtype=torch.bool, device="cuda")
    nz, ny, nx = vol_shape
    m64 = torch.tensor(m, dtype=torch.float64, device="cuda")
    t64 = torch.tensor(t, dtype=torch.float64, device="cuda")
    oz, oy, ox = out_shape
    yy = torch.arange(oy, dtype=torch.float64, device="cuda")[:, None]
    xx = torch.arange(ox, dtype=torch.float64, device="cuda")[None, :]
    slabs = max(1, step // (oy * ox))
    for z0 in range(0, oz, slabs):
        zz = torch.arange(z0, min(z0 + slabs, oz), dtype=torch.float64, device="cuda")[:, None, None]
        c = [(m64[a, 0] * zz + m64[a, 1] * yy + m64[a, 2] * xx + t64[a]).reshape(-1)
             for a in range(3)]
        base = [torch.floor(v) for v in c]
        frac = [v - b for v, b in zip(c, base)]
        base = [b.to(torch.int64) for b in base]
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    idx = [base[0] + dz, base[1] + dy, base[2] + dx]
                    keep = torch.ones_like(idx[0], dtype=torch.bool)
                    for a, (i, n, d) in enumerate(zip(idx, vol_shape, (dz, dy, dx))):
                        keep &= (i >= 0) & (i < n) & ((frac[a] > 0) if d else True)
                    touched[((idx[0] * ny + idx[1]) * nx + idx[2])[keep]] = True
    pad = (-touched.numel()) % 8
    sectors = torch.nn.functional.pad(touched, (0, pad)).view(-1, 8).any(dim=1)
    return int(touched.sum()), int(sectors.sum())


def library_affine(vol: torch.Tensor, m, t, out_shape) -> torch.Tensor:
    """The same warp as one ``F.affine_grid`` and one ``F.grid_sample``
    (5-D, trilinear, zero padding, ``align_corners``), from float32
    normalized coordinates: the yardstick the port never calls."""
    import numpy as np

    n_in = np.asarray(vol.shape, np.float64)
    n_out = np.asarray(out_shape, np.float64)
    m, t = np.asarray(m, np.float64), np.asarray(t, np.float64)
    # in_a = sum_b M_ab u_b + t_a with u_b = (g_b + 1)(O_b - 1) / 2 and
    # g_in_a = 2 in_a / (N_a - 1) - 1; theta is in (x, y, z) order.
    lin = m * (n_out[None, :] - 1) / (n_in[:, None] - 1)
    const = (m @ (n_out - 1) + 2 * t) / (n_in - 1) - 1
    theta = np.zeros((3, 4))
    theta[:, :3] = lin[::-1, ::-1]
    theta[:, 3] = const[::-1]
    grid = torch.nn.functional.affine_grid(
        torch.tensor(theta[None], dtype=torch.float32, device=vol.device),
        [1, 1, *out_shape], align_corners=True)
    return torch.nn.functional.grid_sample(vol[None, None], grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=True)[0, 0]


def phase_affine(gen) -> dict:
    """The warp kernel on four maps, each at the deskewed volume's shape (and
    those of AFFINE_OTHER_MAPS at AFFINE_OTHER_SHAPE, not the main path's),
    against the plain version in float64 (within
    KERNEL_RTOL: the kernel forms coordinates in fixed point from float64)
    and in float32 (within STEP_RTOL: the plain float32 version rounds
    M u + t by up to ~2.4e-4 px, as the JAX gather does); timed beside its
    bound from the voxels the map reads, the float32 plain version and
    F.affine_grid + F.grid_sample."""
    from shrimpy_tpu_torch.ops.affine_cuda import affine_warp_cuda, map_params
    from shrimpy_tpu_torch.ops.register import affine_apply_plain

    shape = deskewed_shape()
    vol = uniform(shape, gen, 0.0, 100.0)
    res = {"max_abs_err": 0.0, "maps": {}}
    for name, (m, t) in affine_maps(shape).items():
        params = map_params(torch.from_numpy(m).cuda(), torch.from_numpy(t).cuda())
        for out_shape in (shape, AFFINE_OTHER_SHAPE)[:2 if name in AFFINE_OTHER_MAPS else 1]:
            label = f"affine_warp {name} -> {out_shape}"
            out = affine_warp_cuda(vol, params, out_shape)
            ref = affine_apply_plain(vol, m, t, out_shape, dtype=torch.float64)
            err = compare(f"{label} vs float64 plain", out, ref, KERNEL_RTOL)
            ref32 = affine_apply_plain(vol, m, t, out_shape)
            compare(f"{label} vs float32 plain", out, ref32, STEP_RTOL)
            print(f"  {label}: float32 plain vs float64 plain {rel_err(ref32, ref):.3e}",
                  flush=True)
            del ref32
            lib = library_affine(vol, m, t, out_shape)
            lib_err = rel_err(lib, ref)
            del out, ref, lib
            entry = {"max_abs_err": err, "ms": gpu_ms(lambda: affine_warp_cuda(
                vol, params, out_shape), 10),
                "library_ms": gpu_ms(lambda: library_affine(vol, m, t, out_shape), 3),
                "library_rel_err": lib_err,
                **bound(4 * (warp_footprint(shape, m, t, out_shape)[0] + math.prod(out_shape)),
                        30 * math.prod(out_shape))}
            if out_shape == shape:
                entry["plain_ms"] = gpu_ms(lambda: affine_apply_plain(vol, m, t, out_shape), 1)
            torch.cuda.empty_cache()
            print(f"  {label}: {entry['ms']:.3f} ms, bound {entry['bound_ms']:.3f} by "
                  f"{entry['bound_by']}, plain {entry.get('plain_ms', float('nan')):.3f}, "
                  f"F.affine_grid + F.grid_sample {entry['library_ms']:.3f} "
                  f"(max|a-b|/max|b| {lib_err:.3e} against float64)", flush=True)
            res["maps"][f"{name} {out_shape}"] = entry
            res["max_abs_err"] = max(res["max_abs_err"], err)
    # The row: the refine's lower-triangular form at the volume's shape.
    main = res["maps"][f"lower {shape}"]
    res.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return res


def refine_map(m, t):
    """``(m, t)`` as the refine sees it on its y/x-strided grid."""
    import numpy as np

    return f32_map(np.asarray(m, np.float64) @ np.diag([1.0, DOWN, DOWN]), t)


@functools.lru_cache(maxsize=1)
def parent_affine(parent_dir):
    """The affine kernels of the commit before the two-launch refine step
    (``affine_warp_grad_kernel``, which reads a materialised grad_out),
    built from ``parent_dir`` (its ``affine.cu``, kept out of the package)
    into a library of its own: (warp, grad), functions that launch the
    warp with its support and the gradient."""
    import ctypes
    from pathlib import Path

    from shrimpy_tpu_torch.kernels import build

    lib_path = build.BUILD_DIR / "libaffine_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(Path(parent_dir) / "affine.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.shrimpy_affine_warp.argtypes = [p] * 4 + [i64] * 6 + [p]
    lib.shrimpy_affine_grad_blocks.argtypes = [i64] * 5
    lib.shrimpy_affine_warp_grad.argtypes = [p] * 5 + [i64] * 6 + [p]
    for fn in (lib.shrimpy_affine_warp, lib.shrimpy_affine_grad_blocks,
               lib.shrimpy_affine_warp_grad):
        fn.restype = ctypes.c_int

    def warp(vol, params, shape):
        out, sup = (torch.empty(shape, device="cuda") for _ in range(2))
        build.check(lib.shrimpy_affine_warp(vol.data_ptr(), out.data_ptr(), sup.data_ptr(),
                                            params.data_ptr(), *vol.shape, *shape,
                                            torch.cuda.current_stream().cuda_stream),
                    "shrimpy_affine_warp (parent)")
        return out, sup

    def grad(vol, grad_out, params):
        part = torch.empty((lib.shrimpy_affine_grad_blocks(*vol.shape, *grad_out.shape[:2]), 12),
                           dtype=torch.float64, device="cuda")
        out = torch.empty(12, dtype=torch.float64, device="cuda")
        build.check(lib.shrimpy_affine_warp_grad(
            vol.data_ptr(), grad_out.data_ptr(), params.data_ptr(), part.data_ptr(),
            out.data_ptr(), *vol.shape, *grad_out.shape, torch.cuda.current_stream().cuda_stream),
            "shrimpy_affine_warp_grad (parent)")
        return out
    return warp, grad


class ParentWarp(torch.autograd.Function):
    """The commit before's warp with its support, and its gradient kernel
    of a materialised grad_out: ``apply(matrix, offset, warp, grad)`` with
    ``warp(params) -> (out, support)`` and ``grad(grad_out, params) -> 12
    float64`` of :func:`parent_affine` (at module level: a class made in a
    function makes a reference cycle that would keep the moving volume
    until the collector runs)."""

    @staticmethod
    def forward(ctx, matrix, offset, warp, grad):
        from shrimpy_tpu_torch.ops.affine_cuda import map_params

        params = map_params(matrix, offset)
        out, sup = warp(params)
        ctx.save_for_backward(params)
        ctx.grad_of = grad
        ctx.mark_non_differentiable(sup)
        return out, sup

    @staticmethod
    def backward(ctx, g_out, _):
        (params,) = ctx.saved_tensors
        g = ctx.grad_of(g_out.contiguous(), params)
        return g[:9].reshape(3, 3).float(), g[9:].float(), None, None


def refine_step_ms(pair_of, dm0, off0, reps: int = 20) -> float:
    """Device ms of one refine step, warm: the objective, its backward and
    Adam, as ``register.py::_refine`` takes it (``pair_of(dm, offset)``
    gives the loss with its graph)."""
    dm = dm0.clone().requires_grad_()
    off = off0.clone().requires_grad_()
    opt = torch.optim.Adam([dm, off], lr=0.05, betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        pair_of(dm, off).backward()
        opt.step()

    return gpu_ms(step, reps)


def refine_steps(moving, fixed_s, parent_dir=None) -> dict:
    """The refine's objective as ``_refine`` forms it from ``dm`` and the
    offset, on ``moving`` and the strided ``fixed_s``: ``{"new": ...}``, and
    with ``parent_dir`` ``"before"``: the step of the commit before (the
    warp with its support, torch's NCC and its autograd, the gradient
    kernel of a materialised grad_out)."""
    from shrimpy_tpu_torch.ops.affine_cuda import refine_objective_cuda, refine_scratch
    from shrimpy_tpu_torch.ops.register import RefineObjective, ncc_loss

    grid = tuple(fixed_s.shape)
    scale = torch.diag(torch.tensor([1.0, float(DOWN), float(DOWN)], device="cuda"))
    coord = float(max(moving.shape))
    partials = refine_scratch(moving, grid)

    def new_pair(dm, off):
        return RefineObjective.apply(scale + torch.tril(dm) / coord, off, lambda a, b:
                                     refine_objective_cuda(moving, fixed_s, a, b, "ncc",
                                                           partials))

    runs = {"new": new_pair}
    if parent_dir:
        old_warp, old_grad = parent_affine(parent_dir)

        def old_pair(dm, off):
            warped, sup = ParentWarp.apply(scale + torch.tril(dm) / coord, off,
                                           lambda p: old_warp(moving, p, grid),
                                           lambda g, p: old_grad(moving, g, p))
            return ncc_loss(warped, fixed_s, (sup > 0.999).float())

        runs["before"] = old_pair
    return runs


def phase_refine(gen, parent_dir=None) -> tuple[dict, dict]:
    """The refine step's two launches at the production refine grid (the
    deskewed volume sampled every DOWN rows and columns) on a blob pair:
    twice (the same bits), the loss and the 12 sums against the plain
    objective in float64 (within SUM_RTOL) for ncc and mse; each launch
    timed beside its bound by the voxels it reads and by the 32-byte
    sectors that hold them and the float32 plain objective, and with
    ``--parent-affine`` in turns with the gradient kernel before (which
    reads a materialised grad_out). Returns the entries of the two
    kernels."""
    from shrimpy_tpu_torch.ops.affine_cuda import (
        map_params,
        refine_grad_cuda,
        refine_objective_cuda,
        refine_scratch,
        refine_sums_cuda,
    )
    from shrimpy_tpu_torch.ops.register import affine_apply, refine_objective_plain

    shape = deskewed_shape()
    grid = (shape[0], -(-shape[1] // DOWN), -(-shape[2] // DOWN))
    moving = blob_volume(shape, gen, 3000)
    m, t = refine_map(*LOWER_MAP)
    # fixed: the warp by a map near (m, t), so that the loss is small, not 0.
    fixed = affine_apply(moving, m, t + 0.3, grid)
    mt, tt = torch.from_numpy(m).cuda(), torch.from_numpy(t).cuda()
    params = map_params(mt, tt)
    partials = refine_scratch(moving, grid)
    sums, grads = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    for loss in ("ncc", "mse"):
        got = refine_objective_cuda(moving, fixed, mt, tt, loss, partials)
        again = refine_objective_cuda(moving, fixed, mt, tt, loss, partials)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"refine {loss}: two runs differ")
        want = refine_objective_plain(moving, fixed, mt.double(), tt.double(), loss,
                                      dtype=torch.float64)
        err_v = compare(f"refine {loss} loss at {grid} from {shape} vs float64 plain (run twice: "
                        "the same bits)", got[0].reshape(1), want[0].reshape(1), SUM_RTOL)
        g = torch.cat([got[1].reshape(9), got[2]]).double()
        err_g = compare(f"refine {loss} 12 sums vs float64 plain", g,
                        torch.cat([want[1].reshape(9), want[2]]), SUM_RTOL)
        print(f"  refine {loss}: loss {float(got[0]):.9g} (float64 {float(want[0]):.9g}), sums "
              f"{g.tolist()}", flush=True)
        sums["max_abs_err"] = max(sums["max_abs_err"], err_v)
        grads["max_abs_err"] = max(grads["max_abs_err"], err_g)
        del want
    voxels, sectors = warp_footprint(shape, m, t, grid)
    stats = refine_sums_cuda(moving, fixed, params, "ncc", partials)[1]
    run = {"sums": lambda: refine_sums_cuda(moving, fixed, params, "ncc", partials),
           "grad": lambda: refine_grad_cuda(moving, fixed, params, stats, partials)}
    if parent_dir:
        g_out = uniform(grid, gen, -1.0, 1.0)
        run["old"] = lambda: parent_affine(parent_dir)[1](moving, g_out, params)
    times = {k: [] for k in run}
    for k in list(run) + list(run)[::-1]:
        times[k].append(gpu_ms(run[k], 10))
    for entry, k, ops in ((sums, "sums", 40), (grads, "grad", 70)):
        entry["ms"] = sum(times[k]) / 2
        # The input voxels the map reads and fixed, once; or the sectors
        # that hold them (DRAM moves whole sectors). Operations: about ops
        # float32 a voxel, far below either.
        entry.update(bound(4 * (voxels + math.prod(grid)), ops * math.prod(grid)))
        entry["bound_ms_sectors"] = (32 * sectors + 4 * math.prod(grid)) / HBM_BYTES_S * 1e3
        entry["library_ms"] = None
    if parent_dir:
        grads["ms_parent"] = sum(times["old"]) / 2
    sums["plain_ms"] = gpu_ms(lambda: refine_objective_plain(moving, fixed, mt, tt, "ncc",
                                                             grad=False), 1)
    grads["plain_ms"] = gpu_ms(lambda: refine_objective_plain(moving, fixed, mt, tt, "ncc"), 1)
    for entry, name in ((sums, "sums"), (grads, "gradient")):
        print(f"  refine {name} launch at {grid}: {entry['ms']:.3f} ms, bound "
              f"{entry['bound_ms']:.3f} by {entry['bound_by']} ({voxels} input voxels), "
              f"{entry['bound_ms_sectors']:.3f} by {sectors} sectors; plain "
              f"{entry['plain_ms']:.3f} ms", flush=True)
    print("  refine kernels in turns: " + ", ".join(f"{k} {times[k]}" for k in times)
          + ("" if parent_dir else " (no --parent-affine: the gradient kernel before not timed)"),
          flush=True)
    del moving, fixed
    return sums, grads


def blob_volume(shape, gen, n_blobs: int, sigma=(3.0, 6.0, 6.0)) -> torch.Tensor:
    """A sum of ``n_blobs`` Gaussian blobs (amplitude 100, each added in its
    +-4 sigma box) at seeded positions, plus N(0, 0.5) noise, float32."""
    vol = torch.randn(shape, generator=gen, device="cuda") * 0.5
    pos = torch.rand((n_blobs, 3), generator=gen, device="cuda").cpu().numpy()
    half = [int(4 * s) for s in sigma]
    axes = [torch.arange(-h, h + 1, dtype=torch.float32, device="cuda") for h in half]
    for p in pos:
        center = [int(p[a] * (shape[a] - 1)) for a in range(3)]
        box, prof = [], []
        for a in range(3):
            lo, hi = max(0, center[a] - half[a]), min(shape[a], center[a] + half[a] + 1)
            box.append(slice(lo, hi))
            d = axes[a][lo - center[a] + half[a]:hi - center[a] + half[a]]
            prof.append(torch.exp(-0.5 * (d / sigma[a]) ** 2))
        vol[tuple(box)] += 100.0 * prof[0][:, None, None] * prof[1][None, :, None] * prof[2]
    return vol


def phase_register(gen, parent_dir=None) -> dict:
    """estimate_registration (pcc+refine, defaults) on a blob pair of the
    deskewed shape, moving = the float64 plain warp of fixed by TRUE_MAP:
    first and warm seconds, the recovered map against the truth's inverse
    (offset within 0.3 px, diagonal within 0.02), the counts (a sums
    launch a refine step and two more, a gradient launch a step, no warp
    and no plain warp), a refine step's ms (the warm estimate less one with
    no step, and a step timed alone beside the step before with
    ``--parent-affine``); then at
    bench.py's (64, 256, 256) the kernel path's estimate against the plain
    path's (matrix within 1e-4, offset within 1e-3)."""
    import numpy as np

    from shrimpy_tpu_torch.config import registration_settings
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation
    from shrimpy_tpu_torch.ops.register import affine_apply_plain, estimate_registration

    settings = registration_settings()
    m, t = f32_map(*TRUE_MAP)
    inv = np.linalg.inv(m.astype(np.float64))
    truth_m, truth_t = inv, -inv @ t.astype(np.float64)
    shape = deskewed_shape()
    fixed = blob_volume(shape, gen, 3000)
    moving = affine_apply_plain(fixed, m, t, dtype=torch.float64).float()
    result = {}

    def estimate(_):
        t0 = time.perf_counter()
        result["res"] = estimate_registration(fixed, moving, settings)
        torch.cuda.synchronize()
        result.setdefault("seconds", []).append(time.perf_counter() - t0)
        return torch.from_numpy(np.concatenate([result["res"].matrix.ravel(),
                                                result["res"].offset]))

    iters = settings.refine_iterations
    _, counts, peak = drive(estimate, None, {"refine_sums": iters + 2, "refine_grad": iters})
    estimate(None)
    # The refine's steps alone: the same estimate with no step, warm.
    none = registration_settings(refine_iterations=0)
    estimate_registration(fixed, moving, none)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    estimate_registration(fixed, moving, none)
    torch.cuda.synchronize()
    step_ms = (result["seconds"][1] - (time.perf_counter() - t0)) / iters * 1e3
    # A step timed alone (CUDA events over 20), beside the step before with
    # --parent-affine, in turns, from the PCC seed.
    runs = refine_steps(moving, fixed[:, ::DOWN, ::DOWN].contiguous(), parent_dir)
    dm0 = torch.zeros((3, 3), device="cuda")
    off0 = torch.tensor(np.asarray(result["res"].translation_seed, np.float32), device="cuda")
    alone = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        alone[k].append(refine_step_ms(runs[k], dm0, off0))
    print("  refine step alone (objective, backward, Adam), in turns: "
          + ", ".join(f"{k} {alone[k]}" for k in alone), flush=True)
    pcc = []
    for _ in range(2):
        t0 = time.perf_counter()
        phase_cross_correlation(fixed, moving, upsample="parabolic")
        pcc.append(time.perf_counter() - t0)
    res = result["res"]
    off_err = float(np.abs(res.offset - truth_t).max())
    diag_err = float(np.abs(np.diag(res.matrix) - np.diag(truth_m)).max())
    mat_err = float(np.abs(res.matrix - truth_m).max())
    corners = np.array([[z, y, x] for z in (0, shape[0] - 1) for y in (0, shape[1] - 1)
                        for x in (0, shape[2] - 1)], np.float64)
    disp = float(np.abs(corners @ (res.matrix - truth_m).T + (res.offset - truth_t)).max())
    first, warm = result["seconds"]
    print(f"  estimate_registration {shape}: first call {first:.3f} s, warm {warm:.3f} s; "
          f"seed {res.translation_seed.tolist()}, offset error {off_err:.4f} px (tol 0.3), "
          f"diagonal error {diag_err:.2e} (tol 0.02), matrix error {mat_err:.2e}, largest "
          f"displacement error at a corner "
          f"{disp:.4f} px, final loss {res.final_loss:.5f}; its PCC seed alone after it "
          f"{pcc[0]:.3f} s, then {pcc[1]:.3f} s; a refine step {step_ms:.3f} ms (the warm "
          f"estimate less one with no step, over {iters})", flush=True)
    if not (off_err <= REG_OFFSET_TOL and diag_err <= REG_DIAG_TOL):
        raise AssertionError(f"estimate_registration: offset {off_err:.4f} px, diagonal "
                             f"{diag_err:.2e} from the truth")
    out = {"first_s": first, "warm_s": warm, "pcc_s": pcc[1], "step_ms": step_ms,
           "step_ms_alone": sum(alone["new"]) / 2,
           **({"step_ms_parent": sum(alone["before"]) / 2} if "before" in alone else {}),
           "offset_err_px": off_err,
           "diag_err": diag_err, "matrix_err": mat_err,
           "corner_err_px": disp, "launches": counts, "peak_gib": peak,
           # Phase 4v's register verb: these volumes, this map.
           "verb": {"lf": fixed.cpu().numpy(), "ls": moving.cpu().numpy(),
                    "map": {"matrix": res.matrix, "offset": res.offset}}}
    del fixed, moving, runs
    torch.cuda.empty_cache()
    small = blob_volume(REGISTER_SMALL, gen, 12)
    moved = affine_apply_plain(small, m, t, dtype=torch.float64).float()
    got = estimate_registration(small, moved, settings)
    ref = estimate_registration(small, moved, settings, plain=True)
    dm, dt = float(np.abs(got.matrix - ref.matrix).max()), float(np.abs(got.offset - ref.offset).max())
    print(f"  estimate_registration {REGISTER_SMALL}: kernel path vs plain path: matrix "
          f"{dm:.2e} (tol 1e-4), offset {dt:.2e} px (tol 1e-3)", flush=True)
    if not (dm <= 1e-4 and dt <= 1e-3):
        raise AssertionError(f"estimate_registration {REGISTER_SMALL}: the kernel path differs "
                             f"from the plain path ({dm:.2e}, {dt:.2e})")
    out.update({"small_matrix_diff": dm, "small_offset_diff": dt})
    return out


def warm_ms(step, steps) -> float:
    """Host-clock ms of one warm run of ``step`` on the batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(steps.batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


class Steps:
    """The production batch and the reconstruct steps of phases 4-4c."""

    def __init__(self, gen):
        from shrimpy_tpu_torch.ops.deconv import gaussian_psf
        from shrimpy_tpu_torch.parallel.pipeline import output_shape

        self.psf = gaussian_psf(PSF_SHAPE, PSF_SIGMA)
        self.batch = uniform((1, *RAW_SHAPE), gen, 0.0, 100.0)
        # Phase 4's and 4b's float64 plain outputs, on the host, for 4f: the
        # float64 plain paths of fused and fused_iter are the same RL on the
        # same grid and boundary (within 5e-13 of each other).
        self.ref64: dict[str, torch.Tensor] = {}
        self.out_zyx = output_shape(RAW_SHAPE, headline_settings())
        self.vox = math.prod(self.out_zyx)

    def build(self, plain=False, dtype=torch.float32, transform=None, **deconvolve):
        """The step on the headline settings; ``transform`` (a JSON path)
        adds the registration stage."""
        from shrimpy_tpu_torch.config import registration_settings
        from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

        settings = headline_settings(**deconvolve)
        if transform is not None:
            settings.registration = registration_settings(transform_path=str(transform))
        return build_reconstruct_step(settings, psf=self.psf, device="cuda", plain=plain,
                                      dtype=dtype)

    def check_shape(self, out):
        if tuple(out.shape) != (1, *self.out_zyx):
            raise AssertionError(f"bad output shape {tuple(out.shape)}, want (1, {self.out_zyx})")


def phase_step(steps: Steps) -> dict:
    """Phase 4: deskew + RL-20 on the fused backend."""
    step = steps.build()
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "rl_half_step": 2 * ITERATIONS,
                                                  "rl_half_one_launch": 2 * ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64)(steps.batch)
    compare("whole step (deskew + RL-20) vs float64 plain", out, ref, STEP_RTOL)
    steps.ref64["RL-20"] = ref.cpu()
    del ref
    times = kernel_times(step, steps, "RL-20")
    return {"out": out, "launches": counts, "peak_gib": peak, **times}


def phase_biggs(steps: Steps) -> dict:
    """Phase 4b: deskew + Biggs RL-10 in the half-step kernels."""
    kw = {"acceleration": "biggs", "iterations": BIGGS_ITERATIONS}
    step = steps.build(**kw)
    out, counts, peak = drive(step, steps.batch,
                              {"deskew": 1, "rl_half_step_accel": 2 * BIGGS_ITERATIONS,
                               "rl_half_one_launch": 2 * BIGGS_ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, **kw)(steps.batch)
    err = two_tier("Biggs RL-10 step vs float64 plain (bf16 state)", out, ref)
    steps.ref64["Biggs RL-10"] = ref.cpu()
    del ref
    times = kernel_times(step, steps, "Biggs RL-10 (RL-20-equivalent)")
    return {"out": out, "launches": counts, "peak_gib": peak, "rel_err": err, **times}


def phase_linear(steps: Steps, rl20: torch.Tensor, biggs: torch.Tensor) -> dict:
    """Phase 4c: the same steps on separable_backend linear_pallas."""
    res = {}
    for label, kw, ref, n in (
        ("RL-20", {}, rl20, 2 * ITERATIONS),
        ("Biggs RL-10", {"acceleration": "biggs", "iterations": BIGGS_ITERATIONS}, biggs,
         2 * BIGGS_ITERATIONS),
    ):
        step = steps.build(separable_backend="linear_pallas", **kw)
        out, counts, peak = drive(step, steps.batch, {"deskew": 1, "convzy_linear": n,
                                                      "convzy_march": n, "x_pass": n})
        steps.check_shape(out)
        if ref is rl20:
            err = rel_err(out, ref)
            compare("linear_pallas RL-20 vs fused kernel RL-20", out, ref, LINEAR_RTOL)
        else:
            err = two_tier("linear_pallas Biggs RL-10 vs fused kernel Biggs RL-10", out, ref)
        del out
        ms = warm_ms(step, steps)
        print(f"  linear_pallas {label}: {ms:.1f} ms/volume, "
              f"{steps.vox / ms / 1e6:.4f} GVox/s (warm)", flush=True)
        res[label] = {"launches": counts, "peak_gib": peak, "rel_err": err, "ms": ms}
    return res


def phase_zy(steps: Steps) -> dict:
    """Phase 4d: RL-20 and Biggs RL-10 on separable_backend zy_pallas,
    each against its own float64 plain path."""
    zy = {"separable_backend": "zy_pallas"}
    step = steps.build(**zy)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "convzy_circular": 2 * ITERATIONS,
                                                  "convzy_march": 2 * ITERATIONS,
                                                  "x_pass": 2 * ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, **zy)(steps.batch)
    compare("zy_pallas RL-20 step vs float64 plain", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    times = kernel_times(step, steps, "zy_pallas RL-20")
    kw = {**zy, "acceleration": "biggs", "iterations": BIGGS_ITERATIONS}
    bstep = steps.build(**kw)
    bout, bcounts, bpeak = drive(bstep, steps.batch,
                                 {"deskew": 1, "convzy_circular": 2 * BIGGS_ITERATIONS,
                                  "convzy_march": 2 * BIGGS_ITERATIONS})
    steps.check_shape(bout)
    ref = steps.build(plain=True, dtype=torch.float64, **kw)(steps.batch)
    berr = two_tier("zy_pallas Biggs RL-10 step vs float64 plain (bf16 state)", bout, ref)
    del bout, ref
    bms = warm_ms(bstep, steps)
    print(f"  zy_pallas Biggs RL-10: {bms:.1f} ms/volume, {steps.vox / bms / 1e6:.4f} "
          "RL-20-equivalent GVox/s (warm)", flush=True)
    return {"launches": counts, "peak_gib": peak, "rel_err": err, **times,
            "biggs": {"launches": bcounts, "peak_gib": bpeak, "rel_err": berr, "ms": bms}}


def phase_matmul(steps: Steps) -> dict:
    """Phase 4e: RL-20 on separable_backend matmul against the same
    backend in float64 on the card."""
    mm = {"separable_backend": "matmul"}
    step = steps.build(**mm)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, **mm)(steps.batch)
    compare("matmul RL-20 step vs float64", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    ms = warm_ms(step, steps)
    print(f"  matmul RL-20: {ms:.1f} ms/volume, {steps.vox / ms / 1e6:.4f} GVox/s (warm)",
          flush=True)
    return {"launches": counts, "peak_gib": peak, "rel_err": err, "ms": ms,
            "gvox_s": steps.vox / ms / 1e6}


def phase_fused_iter(steps: Steps, rl20: torch.Tensor) -> dict:
    """Phase 4f: RL-20 and Biggs RL-10 on separable_backend fused_iter, each
    against phase 4's or 4b's float64 plain output (``Steps.ref64``)."""
    from shrimpy_tpu_torch.ops.deconv import richardson_lucy
    from shrimpy_tpu_torch.ops.deskew import deskew_volume

    fi = {"separable_backend": "fused_iter"}
    step = steps.build(**fi)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "rl_iter": ITERATIONS})
    steps.check_shape(out)
    compare("fused_iter RL-20 vs fused kernel RL-20", out, rl20, FUSED_RTOL)
    ref = steps.ref64.pop("RL-20").cuda()
    compare("fused_iter RL-20 step vs float64 plain (phase 4's)", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    times = kernel_times(step, steps, "fused_iter RL-20")
    kw = {**fi, "acceleration": "biggs", "iterations": BIGGS_ITERATIONS}
    bstep = steps.build(**kw)
    bout, bcounts, bpeak = drive(bstep, steps.batch, {"deskew": 1, "rl_iter": BIGGS_ITERATIONS})
    steps.check_shape(bout)
    ref = steps.ref64.pop("Biggs RL-10").cuda()
    berr = two_tier("fused_iter Biggs RL-10 step vs float64 plain (phase 4b's; bf16 state)",
                    bout, ref)
    del ref
    bms = warm_ms(bstep, steps)
    print(f"  fused_iter Biggs RL-10: {bms:.1f} ms/volume, {steps.vox / bms / 1e6:.4f} "
          "RL-20-equivalent GVox/s (warm)", flush=True)
    # donate_input through richardson_lucy (the step does not read it):
    # the caller's deskewed volume is consumed once the carries exist.
    settings = headline_settings(**kw)
    peaks = {}
    for donate in (False, True):
        settings.deconvolve.donate_input = donate
        vol = deskew_volume(steps.batch[0], settings.deskew)
        got, _, peaks[donate] = drive(
            lambda v: richardson_lucy(v, steps.psf, settings.deconvolve), vol,
            {"rl_iter": BIGGS_ITERATIONS})
        if (vol.numel() == 0) != donate:
            raise AssertionError(f"donate_input={donate}: the volume has {vol.numel()} voxels")
        if not torch.equal(got, bout[0]):
            raise AssertionError(f"donate_input={donate}: differs from the step's output")
        del vol, got
    print(f"  fused_iter Biggs RL-10 through richardson_lucy: peak {peaks[False]:.2f} GiB, with "
          f"donate_input {peaks[True]:.2f} GiB", flush=True)
    return {"launches": counts, "peak_gib": peak, "rel_err": err, **times,
            "biggs": {"launches": bcounts, "peak_gib": bpeak, "rel_err": berr, "ms": bms,
                      "peak_rl_gib": peaks[False], "peak_rl_donated_gib": peaks[True]}}


def transform_json(m, t) -> str:
    """The map as the register verb writes it, in the (git-ignored) build
    directory; its path."""
    import numpy as np

    from shrimpy_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "chip_smoke_transform.json"
    path.write_text(json.dumps({"matrix_zyx": np.asarray(m, np.float32).tolist(),
                                "offset_zyx": np.asarray(t, np.float32).tolist()}))
    return str(path)


def phase_step_reg(steps: Steps) -> dict:
    """Phase 4h: deskew + register-apply (LOWER_MAP from a transform JSON)
    + RL-20 on the fused backend: one warp launch a volume, against the
    float64 plain step."""
    path = transform_json(*LOWER_MAP)
    step = steps.build(transform=path)
    out, counts, peak = drive(step, steps.batch, {"deskew": 1, "affine_warp": 1,
                                                  "rl_half_step": 2 * ITERATIONS,
                                                  "rl_half_one_launch": 2 * ITERATIONS})
    steps.check_shape(out)
    ref = steps.build(plain=True, dtype=torch.float64, transform=path)(steps.batch)
    compare("registered step (deskew + affine + RL-20) vs float64 plain", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del out, ref
    times = kernel_times(step, steps, "deskew + register + RL-20")
    return {"launches": counts, "peak_gib": peak, "rel_err": err, **times}


# --- The FFT paths: the band kernel (row 9), bench.py configs 6, 8, 9, and phase.

NONSEP_SHAPE = (128, 2888, 1600)  # bench.py::_config_nonsep's default volume
BAND_RTOL = 1e-6  # the band against its plain version: kz float32 products a voxel
FFT3_RTOL = 2e-4  # fft2z vs fft3 after 20 iterations (tests/test_deconv.py:94)
# Ragged grids of the band: gz = kz = 9 (the smallest gz the padded grid can
# give), a (20, 37, 45) grid with kz 7, and one plane (kz 1).
BAND_CASES = (((144, 3000, 961), 15), ((9, 33, 17), 9), ((20, 37, 45), 7), ((6, 24, 17), 1))
# The depth (warm, exact iterations) of the hybrids' float64 checks: one of
# each for config 8 (its plain warm phase takes ~3.3 s a half-step in
# float64), three exact for config 9 so its Biggs tail extrapolates.
HYBRID_CHECK = {"config8": (1, 1), "config9": (1, 3)}
PHASE_SHAPE, PHASE_SMALL_SHAPE = (64, 2048, 2048), (64, 1024, 1024)
# What the host transfer function holds at its peak, about eight complex128
# arrays of (64 + 2 * 5, 2048, 2048).
PHASE_HOST_GIB = 40


def nonsep_settings(config: str):
    """The deconvolve settings of bench.py's ``_config_nonsep`` (config6,
    RL-20 ``algorithm: fft``), ``_config_nonsep_hybrid`` (config8, 16 warm
    + 6 exact) and ``_config_nonsep_hybrid_accel`` (config9, 16 + 3 with
    Biggs), as namespaces."""
    from shrimpy_tpu_torch.config import deconvolve_settings

    return deconvolve_settings(**{
        "config6": {"iterations": ITERATIONS, "algorithm": "fft"},
        "config8": {"iterations": 6, "algorithm": "hybrid", "hybrid_separable_iters": 16},
        "config9": {"iterations": 3, "algorithm": "hybrid", "hybrid_separable_iters": 16,
                    "acceleration": "biggs"},
    }[config])


def complex_uniform(shape, gen) -> torch.Tensor:
    return torch.complex(uniform(shape, gen, -1.0, 1.0), uniform(shape, gen, -1.0, 1.0))


def library_band(spec: torch.Tensor, taps: torch.Tensor, mode: str) -> torch.Tensor:
    """The band as one PyTorch call, einsum over a window view of the
    spectrum with its rz wrap planes: the yardstick the port never calls."""
    kz = taps.shape[0]
    rz = kz // 2
    h = taps.flip(0) if mode == "conv" else taps.conj()
    wrapped = torch.cat([spec[spec.shape[0] - rz:], spec, spec[:rz]]) if rz else spec
    return torch.einsum("tyx,zyxt->zyx", h, wrapped.unfold(0, kz, 1))


def phase_band(gen) -> dict:
    """The band kernel (csrc/zband.cu) in both modes against its plain
    version on the production grid and three ragged ones, within BAND_RTOL;
    timed at the production grid beside its bound, the plain version and
    the einsum."""
    from shrimpy_tpu_torch.ops.zband_cuda import zband_cuda, zband_plain

    res = {"max_abs_err": 0.0}
    for (gz, gy, gxr), kz in BAND_CASES:
        spec, taps = complex_uniform((gz, gy, gxr), gen), complex_uniform((kz, gy, gxr), gen)
        for mode in ("conv", "corr"):
            out = zband_cuda(spec, taps, mode)
            ref = zband_plain(spec, taps, mode)
            err = compare(f"zband {mode} ({gz}, {gy}, {gxr}) kz {kz} vs plain",
                          torch.view_as_real(out), torch.view_as_real(ref), BAND_RTOL)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if gz == BAND_CASES[0][0][0] and mode == "conv":
                del ref
                res["ms"] = kernel_ms(lambda: zband_cuda(spec, taps, mode, out=out), 20)
                res["ms_corr"] = kernel_ms(lambda: zband_cuda(spec, taps, "corr", out=out), 20)
                res["plain_ms"] = gpu_ms(lambda: zband_plain(spec, taps, mode), 3)
                cols = gy * gxr
                res.update(bound(8 * cols * (2 * gz + kz), 8 * kz * gz * cols))
                del out
                torch.cuda.empty_cache()
                # The einsum reads a (gz, gy, gxr, kz) copy of the window view.
                need = 8 * gz * cols * (kz + 3)
                free = torch.cuda.mem_get_info()[0]
                if free > need:
                    lib = library_band(spec, taps, mode)
                    compare("zband conv: the einsum vs the kernel", torch.view_as_real(lib),
                            torch.view_as_real(zband_cuda(spec, taps, mode)), BAND_RTOL)
                    del lib
                    torch.cuda.empty_cache()
                    res["library_ms"] = gpu_ms(lambda: library_band(spec, taps, mode), 2)
                else:
                    res["library_ms"] = None
                    print(f"  zband einsum: not timed, it needs {need / 2**30:.1f} GiB, "
                          f"{free / 2**30:.1f} free", flush=True)
                print(f"  zband ({gz}, {gy}, {gxr}) kz {kz}: conv {res['ms']:.3f} ms, corr "
                      f"{res['ms_corr']:.3f} ms, bound {res['bound_ms']:.3f} by "
                      f"{res['bound_by']}, plain {res['plain_ms']:.3f}, einsum "
                      f"{res['library_ms']}", flush=True)
        del spec, taps
        torch.cuda.empty_cache()
    return res


# A z chunk of ls-fft.rl20's grid (144, 2916, 1920) at the default
# fft_z_chunk, and the transforms' tolerance against torch.fft (the same
# library, another plan).
FFT_CHUNK = (8, 2916, 1920)
FFT_RTOL = 1e-6


def fft2z_counts(shape, psf, settings, iterations: int) -> dict:
    """The launches of an ``fft2z`` RL of ``iterations`` on a volume of
    ``shape``: two bands an iteration and, a z chunk, two transforms each
    way and one launch of each update kernel."""
    from shrimpy_tpu_torch.ops.deconv import _fft2z_chunk, _padded_grid_shape, prepare_psf

    gz = _padded_grid_shape(tuple(shape), prepare_psf(psf, settings).shape)[0][0]
    chunks = -(-gz // _fft2z_chunk(gz, settings.fft_z_chunk))
    return {"zband": 2 * iterations, "fft_r2c": 2 * chunks * iterations,
            "fft_c2r": 2 * chunks * iterations, "rl_ratio": chunks * iterations,
            "rl_scale": chunks * iterations}


def phase_fft_chunk(gen) -> tuple[dict, dict]:
    """``csrc/rl_fft.cu`` at FFT_CHUNK: the R2C and C2R plans against
    ``torch.fft`` (FFT_RTOL), ``rl_ratio_kernel`` and ``rl_scale_kernel``
    bit for bit against their plain versions (eps hits, zeros, a NaN);
    each timed beside its bound by bytes and its plain version, the
    kernels also beside the out-of-place torch calls. Returns the two
    kernels' entries; the plans' numbers are printed."""
    from shrimpy_tpu_torch.ops import fft_cuda

    n, gy, gx = FFT_CHUNK
    eps = float(nonsep_settings("config6").epsilon)
    x = uniform(FFT_CHUNK, gen, 0.0, 2.0)
    spec = torch.empty((n, gy, gx // 2 + 1), dtype=torch.complex64, device="cuda")
    real_b, spec_b = 4 * x.numel(), 8 * spec.numel()
    fft_cuda.r2c_cuda(x, spec)
    compare("r2c plan vs torch.fft.rfft2", torch.view_as_real(spec),
            torch.view_as_real(torch.fft.rfft2(x)), FFT_RTOL)
    back = torch.empty_like(x)
    want = torch.fft.irfft2(spec, s=(gy, gx), norm="forward")
    fft_cuda.c2r_cuda(spec.clone(), back)
    compare("c2r plan vs torch.fft.irfft2", back, want, FFT_RTOL)
    del want
    for kind, name, cuda_fn, plain_fn, args in (
            (fft_cuda.R2C, "r2c", fft_cuda.r2c_cuda, fft_cuda.r2c_plain, (x, spec)),
            (fft_cuda.C2R, "c2r", fft_cuda.c2r_cuda, fft_cuda.c2r_plain, (spec, back))):
        ms = kernel_ms(lambda: cuda_fn(*args), 20)
        plain_ms = kernel_ms(lambda: plain_fn(*args), 20)
        print(f"  cuFFT {name} plan {FFT_CHUNK}: {ms:.4f} ms, torch.fft {plain_ms:.4f} ms, bound "
              f"{bound(real_b + spec_b, 0.0)['bound_ms']:.4f} by bytes, work area "
              f"{fft_cuda.plan(kind, x)[1] / 2**20:.1f} MiB", flush=True)
    del spec, back
    data = uniform(FFT_CHUNK, gen, 0.0, 100.0)
    # eps hits (below, at and just above it), zeros of either sign, a NaN;
    # zeros in data.
    edge = torch.tensor([float("nan"), 0.0, -0.0, -1.0, eps, eps / 2, eps * (1 + 1e-6), 1e-30],
                        device="cuda")
    x.view(-1)[:edge.numel()] = edge
    data.view(-1)[edge.numel():2 * edge.numel()] = 0.0
    out = {}
    for name, cuda_fn, plain_fn, lib_fn, arg in (
            ("rl_ratio", lambda a, b: fft_cuda.ratio_cuda(a, b, eps),
             lambda a, b: fft_cuda.ratio_plain(a, b, eps),
             lambda a, b: torch.div(b, torch.clamp_min(a, eps)), data),
            ("rl_scale", fft_cuda.scale_cuda, fft_cuda.scale_plain, torch.mul,
             uniform(FFT_CHUNK, gen, 0.99, 1.01))):
        got, ref = cuda_fn(x.clone(), arg), plain_fn(x.clone(), arg)
        same_bits(f"{name} vs its plain version {FFT_CHUNK}", got.view(torch.int32),
                  ref.view(torch.int32))
        del got, ref
        t = x.clone()
        out[name] = {"max_abs_err": 0.0, "ms": kernel_ms(lambda: cuda_fn(t, arg)),
                     "plain_ms": kernel_ms(lambda: plain_fn(t, arg)),
                     "library_ms": kernel_ms(lambda: lib_fn(t, arg)),
                     **bound(3 * real_b, float(x.numel()))}
        del t
        print(f"  {name} {FFT_CHUNK}: {out[name]['ms']:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} by {out[name]['bound_by']}, plain "
              f"{out[name]['plain_ms']:.4f}, torch {out[name]['library_ms']:.4f}", flush=True)
    fft_cuda.r2c_plain.cuda_calls = fft_cuda.c2r_plain.cuda_calls = 0
    fft_cuda.ratio_plain.cuda_calls = fft_cuda.scale_plain.cuda_calls = 0
    return out["rl_ratio"], out["rl_scale"]


def wall_s(fn, *args) -> tuple[torch.Tensor, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_nonsep(vol, psf) -> dict:
    """bench.py config 6: RL-20 ``algorithm: fft`` (``auto`` -> ``fft2z``)
    through ``richardson_lucy`` at the production volume, counts reset:
    the launches of ``fft2z_counts``. Against the same call on the plain
    versions in float64 on the card (STEP_RTOL); then ``fft3`` timed and
    held within FFT3_RTOL of ``fft2z``."""
    from shrimpy_tpu_torch.ops.deconv import resolve_fft_backend, richardson_lucy

    s = nonsep_settings("config6")
    backend = resolve_fft_backend(s, vol.dim())
    if backend != "fft2z":
        raise AssertionError(f"fft_backend auto resolved to {backend}, want fft2z")
    out, counts, peak = drive(lambda v: richardson_lucy(v, psf, s), vol,
                              fft2z_counts(vol.shape, psf, s, ITERATIONS))
    _, first = wall_s(richardson_lucy, vol, psf, s)
    _, ms = wall_s(richardson_lucy, vol, psf, s)
    ms = min(first, ms) * 1e3
    t0 = time.monotonic()
    ref = richardson_lucy(vol, psf, s, plain=True, dtype=torch.float64)
    check_s = time.monotonic() - t0
    compare(f"RL-20 fft2z vs float64 plain (the float64 run {check_s:.1f} s)", out, ref,
            STEP_RTOL)
    err = rel_err(out, ref)
    del ref
    torch.cuda.empty_cache()
    s3 = nonsep_settings("config6")
    s3.fft_backend = "fft3"
    torch.cuda.reset_peak_memory_stats()
    out3, _ = wall_s(richardson_lucy, vol, psf, s3)
    peak3 = torch.cuda.max_memory_allocated() / 2**30
    _, ms3 = wall_s(richardson_lucy, vol, psf, s3)
    compare("RL-20 fft3 vs fft2z", out3, out, FFT3_RTOL)
    del out3, out
    torch.cuda.empty_cache()
    vox = math.prod(vol.shape)
    print(f"  RL-20 fft2z: {ms:.1f} ms, {vox / ms / 1e6:.4f} GVox/s, peak {peak:.2f} GiB; "
          f"fft3 {ms3 * 1e3:.1f} ms, peak {peak3:.2f} GiB", flush=True)
    return {"launches": counts, "peak_gib": peak, "ms": ms, "gvox_s": vox / ms / 1e6,
            "rel_err": err, "fft3_ms": ms3 * 1e3, "fft3_peak_gib": peak3}


def phase_hybrid(vol, psf, config: str) -> dict:
    """bench.py config 8 (hybrid, 16 warm + 6 exact) or 9 (16 + 3, Biggs on
    both phases) through ``richardson_lucy``: K and the warm residual, the
    separable backend the warm phase resolves to, the warm phase's and the
    tail's ms, the total and the peak. Counts: the warm phase alone with
    the counts reset, then the whole call, which must count exactly those
    plus the ``fft2z_counts`` of the tail, each timed as counted. The
    float64 check runs at the depth of HYBRID_CHECK (the plain warm phase
    with K terms takes seconds a half-step in float64): config 8 within
    STEP_RTOL, config 9 by the two-tier Biggs gate."""
    from shrimpy_tpu_torch.ops.deconv import (
        plan_hybrid_terms,
        prepare_psf,
        resolve_separable_backend,
        richardson_lucy,
        rl_separable,
    )
    from shrimpy_tpu_torch.ops.rl_fft import rl_fft

    s = nonsep_settings(config)
    psf_w = prepare_psf(psf, s)
    t0 = time.perf_counter()
    terms, residual = plan_hybrid_terms(psf_w, s)
    plan_s = time.perf_counter() - t0
    backend = resolve_separable_backend(s.separable_backend, tuple(vol.shape), psf_w.shape)
    # The counted runs are timed: build_all compiled the warm phase's kernel.
    t0 = time.perf_counter()
    warm, warm_counts, _ = drive(
        lambda v: rl_separable(v, psf_w, terms, s, s.hybrid_separable_iters), vol, None)
    warm_s = time.perf_counter() - t0
    warm_counts = {k: v for k, v in warm_counts.items() if v}
    _, tail_s = wall_s(lambda: rl_fft(vol, psf_w, s, s.iterations, init=warm))
    del warm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, counts, peak = drive(lambda v: richardson_lucy(v, psf, s), vol,
                              {**warm_counts,
                               **fft2z_counts(vol.shape, psf, s, s.iterations)})
    total_s = time.perf_counter() - t0
    del out
    torch.cuda.empty_cache()
    check = nonsep_settings(config)
    check.hybrid_separable_iters, check.iterations = HYBRID_CHECK[config]
    out = richardson_lucy(vol, psf, check)
    t0 = time.monotonic()
    ref = richardson_lucy(vol, psf, check, plain=True, dtype=torch.float64)
    label = (f"hybrid {config} at {check.hybrid_separable_iters} warm + {check.iterations} "
             f"exact (the float64 "
             f"run {time.monotonic() - t0:.1f} s)")
    if s.acceleration == "biggs":
        err = two_tier(f"{label} (Biggs) vs float64 plain (bf16 state)", out, ref)
    else:
        compare(f"{label} vs float64 plain", out, ref, STEP_RTOL)
        err = rel_err(out, ref)
    del out, ref
    torch.cuda.empty_cache()
    vox = math.prod(vol.shape)
    res = {"k": len(terms), "warm_residual": residual, "warm_backend": backend,
           "plan_s": plan_s, "warm_ms": warm_s * 1e3, "tail_ms": tail_s * 1e3,
           "ms": total_s * 1e3, "gvox_s": vox / total_s / 1e9, "peak_gib": peak,
           "launches": counts, "rel_err": err}
    print(f"  hybrid {config}: K {res['k']} (residual {residual:.4f}, planned in "
          f"{plan_s:.2f} s), warm phase on {backend} {res['warm_ms']:.1f} ms, tail "
          f"{res['tail_ms']:.1f} ms, total {res['ms']:.1f} ms ({res['gvox_s']:.4f} "
          f"RL-20-equivalent GVox/s), peak {peak:.2f} GiB", flush=True)
    return res


def host_line() -> str:
    """The host's available and shared memory and this process's resident
    size, GiB (``/proc``)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) / 2**20
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) / 2**20 for line in f if line.startswith("VmRSS:"))
    return (f"host available {info['MemAvailable']:.1f} GiB, shared {info['Shmem']:.1f}, "
            f"this process {rss:.1f}")


def host_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise AssertionError("no MemAvailable in /proc/meminfo")


def phase_tf() -> dict:
    """The host half of phase 4l, run in a thread beside phases 4-4k
    (the card's work there does not wait on the host): the shape the host
    memory allows and the transfer function of the schema's defaults with
    yx 0.116 um, z 0.25 um (float64 numpy on the host, cached per shape),
    timed in its thread."""
    from shrimpy_tpu_torch.config import phase_settings
    from shrimpy_tpu_torch.ops.phase import compute_transfer_function

    # 4t's ranks give their pinned host buffers back some seconds after they
    # exit (this thread starts right after them): wait for them.
    t0 = time.monotonic()
    while host_available_gib() < 1.5 * PHASE_HOST_GIB and time.monotonic() - t0 < 60.0:
        time.sleep(1.0)
    free = subprocess.run(["free", "-g"], capture_output=True, text=True).stdout.rstrip()
    avail = host_available_gib()
    shape = PHASE_SHAPE if avail >= 1.5 * PHASE_HOST_GIB else PHASE_SMALL_SHAPE
    settings = phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.25})
    t0 = time.perf_counter()
    tf = compute_transfer_function(shape, settings.transfer_function)
    return {"free": free, "avail": avail, "shape": shape, "settings": settings, "tf": tf,
            "tf_s": time.perf_counter() - t0}


def phase_phase(gen, host: dict) -> dict:
    """Phase reconstruction of a brightfield stack (64, 2048, 2048) with
    the schema's defaults (z_padding 5, 0.450 um, NA 1.35 / 0.52), yx
    0.116 um, z 0.25 um: the host transfer function (float64 numpy,
    :func:`phase_tf`'s ``host``) and the card's inverse timed apart, the
    inverse against its float64 path on the card (STEP_RTOL), then
    through the reconstruct step with the transfer function handed over.
    (64, 1024, 1024) where the host cannot hold the transfer function's
    arrays. Then a weak phase object recovered at (16, 32, 32), as
    tests/test_phase.py:65 does."""
    import numpy as np

    from shrimpy_tpu_torch.config import phase_settings, reconstruct_settings
    from shrimpy_tpu_torch.ops.phase import (
        apply_inverse_transfer_function,
        compute_transfer_function,
        simulate_defocus_stack,
        tf_tensor,
    )
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    print(host["free"], flush=True)
    shape, settings, tf, tf_s = host["shape"], host["settings"], host["tf"], host["tf_s"]
    print(f"  host memory available {host['avail']:.1f} GiB: phase at {shape}; the host TF took "
          f"{tf_s:.2f} s in its thread beside phases 4-4k", flush=True)
    tfs, inv = settings.transfer_function, settings.apply_inverse
    t0 = time.perf_counter()
    tf_dev = tf_tensor(tf, "cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    stack = uniform(shape, gen, 0.9, 1.1)
    out = apply_inverse_transfer_function(stack, tf_dev, inv, z_padding=tfs.z_padding)
    ref = apply_inverse_transfer_function(stack, tf_dev, inv, z_padding=tfs.z_padding,
                                          dtype=torch.float64)
    compare(f"phase inverse {shape} vs float64", out, ref, STEP_RTOL)
    err = rel_err(out, ref)
    del ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = gpu_ms(lambda: apply_inverse_transfer_function(stack, tf_dev, inv,
                                                        z_padding=tfs.z_padding), 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step = build_reconstruct_step(reconstruct_settings(phase=settings), device="cuda")
    got = step(stack[None], tf_dev)
    if not torch.equal(got[0], out):
        raise AssertionError("the step's phase stage differs from the inverse")
    _, step_s = wall_s(step, stack[None], tf_dev)
    verb = {"bf": stack.cpu().numpy(), "phase_out": got[0].cpu().numpy()}  # phase 4v's
    del got, out, stack
    torch.cuda.empty_cache()
    # Recovery of a simulated weak phase object (tests/test_phase.py:65).
    small = (16, 32, 32)
    zz, yy, xx = np.meshgrid(*(np.arange(n) - n / 2.0 for n in small), indexing="ij")
    phi = 0.1 * np.exp(-0.5 * ((zz / 2.0) ** 2 + (yy / 4.0) ** 2 + (xx / 4.0) ** 2))
    phi -= phi.mean()
    small_tfs = phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.2,
                                "z_padding": 0}).transfer_function
    small_tf = compute_transfer_function(small, small_tfs)
    sim = simulate_defocus_stack(phi, small_tf, background=1.0)
    recon = apply_inverse_transfer_function(
        sim, small_tf, phase_settings(apply_inverse={"regularization_strength": 1e-4})
        .apply_inverse).cpu().numpy()
    corr = float(np.corrcoef(recon.ravel(), phi.ravel())[0, 1])
    print(f"  weak phase object {small}: correlation {corr:.4f} (want > 0.8)", flush=True)
    if not corr > 0.8:
        raise AssertionError(f"phase recovery correlation {corr:.4f}")
    vox = math.prod(shape)
    print(f"  phase {shape}: host TF {tf_s:.2f} s, to the card {h2d_s:.3f} s, inverse "
          f"{ms:.3f} ms ({vox / ms / 1e6:.4f} GVox/s), peak {peak:.2f} GiB, the step "
          f"{step_s * 1e3:.1f} ms", flush=True)
    return {"shape": shape, "tf_s": tf_s, "h2d_s": h2d_s, "ms": ms, "peak_gib": peak,
            "step_ms": step_s * 1e3, "rel_err": err, "recovery_corr": corr, "verb": verb}


# --- Tracking (DynaTrack): the tracker and its preprocessor at the production
# raw (deskew on csrc/deskew.cu), and on a brightfield stack through phase.
TRACK_TIMEPOINTS = 3
TRACK_DRIFT = (2, 3)  # raw scan steps and x pixels a timepoint
TRACK_BLOBS = 48
TRACK_SIGMA = (3.0, 6.0, 6.0)  # deskewed px
TRACK_BACKGROUND, TRACK_NOISE = 100.0, 10.0  # camera offset, shot noise of ~100 counts
TRACK_COM_ATOL = 1e-3  # px, centres of mass against float64
# Multi-Otsu's pair is the argmax of an objective whose best pairs lie within
# ~1e-6 of each other (4.6e-7 between the first and third at (500, 96, 320),
# CPU): float32 sums cannot order them. The float32 run's pair must be within
# this of the float64 objective's maximum.
OTSU_TIE_RTOL = 1e-5
TRACK_METHODS = {
    "pcc": {},
    "intensity_center_of_mass": {"roi_center": {"background_percentile": 99.0}},
    "roi_center_pcc": {"roi_center": {"blob_sigma": 10.0}},
    "multiotsu_center_of_mass": {"segmentation": {"otsu_sigma": 5.0}},
    "multiotsu_pcc": {"segmentation": {"otsu_sigma": 5.0}},
    "template_matching": {},  # slice_zyx around the first blob, from track_blobs
}
LF_SHIFT = (0, 7, -5)  # the label-free arm's yx drift, px
LF_FOCUS = 40  # its in-focus slice


def track_blobs(gen):
    """Seeded blob centres and amplitudes in the deskewed frame: centres
    inside the production volume with a margin of 4 sigma past the drift,
    amplitudes in [500, 1500) but the first blob's 4000 (one object
    dominates, so roi_center_pcc has one peak) and its companion's 2000,
    (3, 10, 8) px from it: the template window holds the pair, a pattern
    no other window has (NCC ignores amplitude, and one blob alike the
    others would match them as well as its own moved copy)."""
    nz, ny, nx = deskewed_shape()
    r = torch.rand((TRACK_BLOBS, 4), generator=gen, device="cuda").double().cpu().numpy()
    margin = [4 * s + 2 for s in TRACK_SIGMA]
    span_y = ny - 2 * margin[1] - TRACK_TIMEPOINTS * TRACK_DRIFT[0] / 0.386
    centers = [(margin[0] + p[0] * (nz - 2 * margin[0]), margin[1] + p[1] * span_y,
                margin[2] + p[2] * (nx - 2 * margin[2] - TRACK_TIMEPOINTS * TRACK_DRIFT[1]))
               for p in r]
    amps = [4000.0, 2000.0] + [500.0 + 1000.0 * p[3] for p in r[2:]]
    centers[1] = tuple(c + d for c, d in zip(centers[0], (3.0, 10.0, 8.0)))
    return centers, amps


def track_raw(centers, amps) -> torch.Tensor:
    """The production raw (scan, tilt, x) of the blobs on the camera
    offset, each rendered at the raw voxels whose deskewed coordinates lie
    within 4 sigma of it: raw (s, t, x) sits at deskewed z = t sin(theta),
    y = s / r + t cos(theta) - y_offset, x (``ops/deskew.py::_geometry``).
    No noise: each timepoint adds its own (:func:`track_raws`)."""
    from shrimpy_tpu_torch.ops.deskew import _geometry

    g = _geometry(RAW_SHAPE, headline_settings().deskew)
    ns, nt, nxr = RAW_SHAPE
    raw = torch.full(RAW_SHAPE, TRACK_BACKGROUND, device="cuda")
    sz, sy, sx = TRACK_SIGMA
    for (cz, cy, cx), amp in zip(centers, amps):
        t0 = max(0, math.floor((cz - 4 * sz) / g["sin_t"]))
        t1 = min(nt, math.ceil((cz + 4 * sz) / g["sin_t"]) + 1)
        s0 = max(0, math.floor(g["r"] * (cy - 4 * sy + g["y_offset"] - t1 * g["cos_t"])))
        s1 = min(ns, math.ceil(g["r"] * (cy + 4 * sy + g["y_offset"] - t0 * g["cos_t"])) + 1)
        x0, x1 = max(0, math.floor(cx - 4 * sx)), min(nxr, math.ceil(cx + 4 * sx) + 1)
        s = torch.arange(s0, s1, device="cuda", dtype=torch.float64)[:, None, None]
        t = torch.arange(t0, t1, device="cuda", dtype=torch.float64)[None, :, None]
        x = torch.arange(x0, x1, device="cuda", dtype=torch.float64)[None, None, :]
        zd = t * g["sin_t"]
        yd = s / g["r"] + t * g["cos_t"] - g["y_offset"]
        arg = ((zd - cz) / sz) ** 2 + ((yd - cy) / sy) ** 2 + ((x - cx) / sx) ** 2
        raw[s0:s1, t0:t1, x0:x1] += (amp * torch.exp(-0.5 * arg)).float()
    return raw


def track_raws(gen, centers, amps) -> list:
    """TRACK_TIMEPOINTS raws: the blobs rolled by TRACK_DRIFT (scan steps,
    x px) a timepoint, each with its own N(0, TRACK_NOISE) noise. Noise
    matters: on a flat background the float32 integral images of the NCC
    leave windows of no variance with a small positive one, whose NCC
    blows up (what a camera never gives)."""
    raw0 = track_raw(centers, amps)
    raws = []
    for t in range(TRACK_TIMEPOINTS):
        raw = torch.roll(raw0, (t * TRACK_DRIFT[0], t * TRACK_DRIFT[1]), dims=(0, 2))
        raws.append(raw.add_(torch.randn(RAW_SHAPE, generator=gen, device="cuda"),
                             alpha=TRACK_NOISE))
    return raws


def track_config(method: str, **extra):
    from shrimpy_tpu_torch.config import dynatrack_settings

    return dynatrack_settings(input_channel="LS", tracking_channel="LS",
                              tracking_method=method, **{**TRACK_METHODS[method], **extra})


def track_otsu_reference(method: str, cfg, raws) -> tuple[list, list]:
    """The multi-Otsu methods in float64 at the float32 run's bin pair:
    per timepoint the float32 pair (recomputed as the tracker computes it)
    and the float64 objective's own pair, the float32 pair held within
    OTSU_TIE_RTOL of the float64 maximum, then the mask, centre of mass or
    PCC of the masked blur in float64 at the float32 pair. Returns the
    shifts and (pair32, pair64, gap) a timepoint."""
    import numpy as np

    from shrimpy_tpu_torch.ops.features import center_of_mass, gaussian_blur, otsu_objective
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    seg, f64, bins = cfg.segmentation, torch.float64, 256
    pre32, pre64 = Preprocessor(cfg), Preprocessor(cfg, dtype=f64)
    shifts, pairs, anchor = [], [], None
    for raw in raws:
        _, _, v32 = otsu_objective(gaussian_blur(pre32.tracking_stack(raw), seg.otsu_sigma))
        k32 = divmod(int(torch.argmax(v32)), bins)
        del v32
        blurred = gaussian_blur(pre64.tracking_stack(raw), seg.otsu_sigma, dtype=f64)
        lo, span, v64 = otsu_objective(blurred, dtype=f64)
        top = float(v64.max())
        gap = (top - float(v64[k32])) / top
        pairs.append((k32, divmod(int(torch.argmax(v64)), bins), gap))
        if not gap <= OTSU_TIE_RTOL:
            raise AssertionError(f"{method}: the float32 Otsu pair {k32} is {gap:.2e} below the "
                                 f"float64 objective's maximum")
        thr = lo + torch.tensor(k32, dtype=f64, device="cuda") / bins * span
        mask = (blurred > thr[seg.otsu_component]).to(f64)
        if method == "multiotsu_center_of_mass":
            center = (np.asarray(blurred.shape, dtype=np.float64) - 1.0) / 2.0
            shifts.append(center_of_mass(mask, dtype=f64).cpu().numpy() - center)
        elif anchor is None:
            anchor = mask * blurred
            shifts.append(np.zeros(3))
        else:
            shifts.append(phase_cross_correlation(anchor, mask * blurred, dtype=f64)
                          .astype(np.float64))
        del blurred, mask, v64
    return shifts, pairs


def timed_update(tracker, pre, stack, t: int):
    """One update from ``stack`` (raw, on the card or the host): the result
    and its host-clock ms, launch to the shifts on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = tracker.update(pre.tracking_stack(stack), t)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def track_method(method: str, raws, host_raw, slice_zyx, expected) -> dict:
    """One method over the timepoints: the float32 tracker (t = 0 the first
    call, t = 1, t = 2 warm from the card and again from a host numpy
    stack) with the counts reset, against the float64 tracker (the plain
    deskew, the same ops in float64)."""
    import numpy as np

    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    extra = {"template": {"slice_zyx": slice_zyx}} if method == "template_matching" else {}
    cfg = track_config(method, preprocessing=["deskew"],
                       deskew=vars(headline_settings().deskew), **extra)
    table = zero_counts()
    pre, tracker = Preprocessor(cfg), Tracker(cfg)
    got = []
    r, first_ms = timed_update(tracker, pre, raws[0], 0)
    got.append(r.shift_px_zyx)
    r, _ = timed_update(tracker, pre, raws[1], 1)
    got.append(r.shift_px_zyx)
    torch.cuda.reset_peak_memory_stats()
    r, warm_ms = timed_update(tracker, pre, raws[2], 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    got.append(r.shift_px_zyx)
    r, host_ms = timed_update(tracker, pre, host_raw, 2)
    if not np.array_equal(r.shift_px_zyx, got[2]):
        raise AssertionError(f"{method}: the host stack gave {r.shift_px_zyx}, the card's {got[2]}")
    counts = {k: getattr(obj, attr) for k, (obj, attr) in table.items()}
    bad = {k: v for k, v in counts.items() if v != (4 if k == "deskew" else 0)}
    if bad:
        raise AssertionError(f"{method}: launch counts {bad}, want 4 deskew launches, no other")
    stages = tracker.timer.as_dict()
    moves = [rec.seconds for rec in tracker.timer.records if rec.name == "reference_to_device"]
    del pre, tracker
    torch.cuda.empty_cache()
    pre64, tracker64 = Preprocessor(cfg, dtype=torch.float64), Tracker(cfg, dtype=torch.float64)
    want = [tracker64.update(pre64.tracking_stack(raw), t).shift_px_zyx
            for t, raw in enumerate(raws)]
    del pre64, tracker64
    torch.cuda.empty_cache()
    com = method.endswith("center_of_mass")
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    otsu = None
    if method.startswith("multiotsu"):
        # Held to float64 at the float32 run's pair, which must tie the
        # float64 maximum; where the float64 run picked the same pair, its
        # own shifts are that reference's.
        ref, otsu = track_otsu_reference(method, cfg, raws)
        torch.cuda.empty_cache()
        for t, (k32, k64, _) in enumerate(otsu):
            if k32 == k64 and not np.abs(ref[t] - want[t]).max() <= (
                    TRACK_COM_ATOL / 10 if com else 0.0):
                raise AssertionError(f"{method}: t={t} the reference at the tracker's pair "
                                     f"{ref[t]} differs from the float64 tracker's {want[t]}")
        err_ref = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    else:
        err_ref = err
    if (com and not err_ref <= TRACK_COM_ATOL) or (not com and err_ref != 0.0):
        raise AssertionError(f"{method}: shifts {got} against float64 {want}"
                             + (f" (at the float32 pairs: {ref}; pairs {otsu})" if otsu else ""))
    if method in ("pcc", "template_matching"):
        for t in (1, 2):
            if not np.abs(got[t] - expected[t]).max() <= 1.0:
                raise AssertionError(f"{method}: t={t} shift {got[t]}, injected {expected[t]}")
    res = {"first_ms": first_ms, "warm_ms": warm_ms, "host_ms": host_ms, "peak_gib": peak,
           "to_host_ms": stages.get("reference_to_host", 0.0) * 1e3,
           "to_device_ms": float(np.mean(moves)) * 1e3 if moves else None,
           "shifts": [s.tolist() for s in got], "max_err_f64": err, "max_err_ref": err_ref,
           "otsu_pairs": otsu}
    to_dev = (f"{res['to_device_ms']:.3f} ms" if moves else
              "none (only the template window moves)" if method == "template_matching" else
              "none (referenceless)")
    pairs = ("" if otsu is None else "; Otsu pairs float32 / float64 (gap): " + ", ".join(
        f"{k32} / {k64} ({gap:.1e})" for k32, k64, gap in otsu)
        + f", max diff at the float32 pairs {err_ref:.2e}")
    print(f"  {method}: shifts {res['shifts']} (float64: max diff {err:.2e}{' px' if com else ''}"
          f"{pairs}); "
          f"first {first_ms:.1f} ms, warm {warm_ms:.1f} ms from the card, {host_ms:.1f} ms from "
          f"a host numpy stack; reference to the host {res['to_host_ms']:.1f} ms, to the card "
          f"{to_dev}; peak {peak:.2f} GiB", flush=True)
    return res


def track_ops(stack, slice_zyx) -> dict:
    """The tracking ops alone at the deskewed shape, CUDA events, warm."""
    from shrimpy_tpu_torch.ops.features import gaussian_blur, multi_otsu
    from shrimpy_tpu_torch.ops.match import match_template
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation

    blurred = gaussian_blur(stack, 5.0)
    tmpl = stack[tuple(slice(a, b) for a, b in slice_zyx)]
    moved = torch.roll(stack, (0, 5, 3), dims=(0, 1, 2))
    res = {"blur_ms": gpu_ms(lambda: gaussian_blur(stack, 5.0), 3),
           "multi_otsu_ms": gpu_ms(lambda: multi_otsu(blurred), 3),
           "ncc_ms": gpu_ms(lambda: match_template(moved, tmpl), 3),
           "pcc_ms": gpu_ms(lambda: phase_cross_correlation(stack, moved), 3)}
    print(f"  ops alone at {tuple(stack.shape)}: blur (sigma 5) {res['blur_ms']:.3f} ms, "
          f"multi-Otsu {res['multi_otsu_ms']:.3f} ms, NCC surface {res['ncc_ms']:.3f} ms, "
          f"PCC {res['pcc_ms']:.3f} ms", flush=True)
    return res


def focus_stack(shape, gen) -> torch.Tensor:
    """A brightfield defocus stack: one sharp random texture, slice z blurred
    by a Gaussian of sigma |z - LF_FOCUS| * 0.8 + 0.01 px (by its transfer
    function), scaled to 1 +- 0.05."""
    nz, ny, nx = shape
    spec = torch.fft.rfft2(torch.rand((ny, nx), generator=gen, device="cuda"))
    fy = torch.fft.fftfreq(ny, device="cuda")[:, None]
    fx = torch.fft.rfftfreq(nx, device="cuda")[None, :]
    f2 = fy**2 + fx**2
    out = torch.empty(shape, device="cuda")
    for z in range(nz):
        sigma = abs(z - LF_FOCUS) * 0.8 + 0.01
        out[z] = torch.fft.irfft2(spec * torch.exp(-2 * math.pi**2 * sigma**2 * f2), s=(ny, nx))
    return 1.0 + 0.1 * (out - 0.5)


def phase_track(gen, phase_shape) -> dict:
    """(a) The tracker with ``preprocessing: [deskew]`` (``headline_settings``'s
    deskew) over TRACK_TIMEPOINTS production raws of seeded blobs drifting
    TRACK_DRIFT (scan steps, x px) a timepoint, every method against its
    float64 run; pcc and template_matching recover the drift within 1 px;
    the ops alone. (b) pcc with ``preprocessing: [phase]`` on two
    brightfield stacks of ``phase_shape`` (phase 4l's) shifted LF_SHIFT,
    the transfer function from phase 4l's host cache; the focus metric."""
    import numpy as np

    from shrimpy_tpu_torch.engine.autofocus import focus_from_transverse_band
    from shrimpy_tpu_torch.ops.phase import _compute_tf_cached
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    t_start = time.monotonic()
    centers, amps = track_blobs(gen)
    raws = track_raws(gen, centers, amps)
    host_raw = raws[-1].cpu().numpy()
    r = headline_settings().deskew.px_to_scan_ratio
    expected = [np.array([0.0, t * TRACK_DRIFT[0] / r, t * TRACK_DRIFT[1]])
                for t in range(TRACK_TIMEPOINTS)]
    cz, cy, cx = (int(round(c)) for c in centers[0])
    slice_zyx = ((cz - 10, cz + 10), (cy - 24, cy + 24), (cx - 24, cx + 24))
    print(f"  {TRACK_BLOBS} blobs, sigma {TRACK_SIGMA} px, on {TRACK_BACKGROUND:g} with noise of "
          f"{TRACK_NOISE:g}; injected "
          f"deskewed drift {expected[1].tolist()} px a timepoint; template {slice_zyx}",
          flush=True)
    methods = {m: track_method(m, raws, host_raw, slice_zyx, expected) for m in TRACK_METHODS}
    from shrimpy_tpu_torch.ops.deskew import deskew_volume

    ops = track_ops(deskew_volume(raws[1], headline_settings().deskew), slice_zyx)
    session = [camera_counts(raw) for raw in raws]  # phase 4v's session store
    del raws, host_raw
    torch.cuda.empty_cache()
    ls_s = time.monotonic() - t_start

    # (b) label-free: phase, then pcc; the TF from phase 4l's host cache.
    t_lf = time.monotonic()
    stack0 = focus_stack(phase_shape, gen)
    stack1 = torch.roll(stack0, LF_SHIFT[1:], dims=(1, 2))
    phase = {"transfer_function": {"yx_pixel_size": 0.116, "z_pixel_size": 0.25}}
    cfg = track_config("pcc", preprocessing=["phase"], phase=phase)
    pre, tracker = Preprocessor(cfg), Tracker(cfg)
    before = _compute_tf_cached.cache_info()
    r0, first_ms = timed_update(tracker, pre, stack0, 0)
    after = _compute_tf_cached.cache_info()
    if not (after.hits == before.hits + 1 and after.misses == before.misses):
        raise AssertionError(f"the tracker's TF missed phase 4l's cache: {before} -> {after}")
    r1, _ = timed_update(tracker, pre, stack1, 1)
    torch.cuda.reset_peak_memory_stats()
    r1w, warm_ms = timed_update(tracker, pre, stack1, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = pre.timer.as_dict()
    del pre, tracker
    torch.cuda.empty_cache()
    pre64, tracker64 = Preprocessor(cfg, dtype=torch.float64), Tracker(cfg, dtype=torch.float64)
    want = [tracker64.update(pre64.tracking_stack(s), t).shift_px_zyx
            for t, s in enumerate((stack0, stack1))]
    del pre64, tracker64
    torch.cuda.empty_cache()
    if not (np.array_equal(r0.shift_px_zyx, want[0]) and np.array_equal(r1.shift_px_zyx, want[1])
            and np.array_equal(r1w.shift_px_zyx, r1.shift_px_zyx)):
        raise AssertionError(f"label-free pcc {r1.shift_px_zyx} against float64 {want[1]}")
    if not np.abs(r1.shift_px_zyx - np.array(LF_SHIFT)).max() <= 1.0:
        raise AssertionError(f"label-free pcc {r1.shift_px_zyx}, injected {LF_SHIFT}")
    focus = focus_from_transverse_band(stack0, pixel_size_um=0.116)
    focus64 = focus_from_transverse_band(stack0, pixel_size_um=0.116, dtype=torch.float64)
    focus_ms = gpu_ms(lambda: focus_from_transverse_band(stack0, pixel_size_um=0.116), 3)
    if focus != focus64 or focus != LF_FOCUS:
        raise AssertionError(f"focus index {focus}, float64 {focus64}, in focus {LF_FOCUS}")
    del stack0, stack1
    torch.cuda.empty_cache()
    lf = {"shape": phase_shape, "shift": r1.shift_px_zyx.tolist(), "first_ms": first_ms,
          "warm_ms": warm_ms, "peak_gib": peak, "tf_to_card_ms": stages["phase_tf"] * 1e3,
          "phase_ms": stages["phase"] * 1e3 / 3, "tf_cache": str(after),
          "focus": focus, "focus_ms": focus_ms, "seconds": time.monotonic() - t_lf}
    print(f"  label-free pcc at {phase_shape}: shift {lf['shift']} (float64 the same; injected "
          f"{list(LF_SHIFT)}); first {first_ms:.1f} ms (the TF from phase 4l's host cache, "
          f"{after.hits - before.hits} hit, to the card once: {lf['tf_to_card_ms']:.1f} ms), warm "
          f"{warm_ms:.1f} ms, the inverse {lf['phase_ms']:.1f} ms an update; peak {peak:.2f} GiB; "
          f"focus index {focus} (float64 {focus64}) in {focus_ms:.3f} ms", flush=True)
    return {"methods": methods, "ops": ops, "lf": lf, "ls_seconds": ls_s,
            "verb": {"session": session}, "seconds": time.monotonic() - t_start}


# --- DynaTrack's closed loop (tracking/position.py): the manager's worker runs
# the engine's updater (the Preprocessor's deskew, the Tracker's pcc, the stage
# shift) on each stack, and the stage seam rolls the next raw by the corrected
# position, as the JAX engine's replay does (engine.py::_stage_offset_px,
# engine/replay.py::ReplaySource.volume).
LOOP_TIMEPOINTS = 6
LOOP_KEY = "0/0/000"
LOOP_PIXEL_UM = 0.116  # raw y and x pixel; the scan step is LOOP_PIXEL_UM / ratio
LOOP_DRAIN_S = 120.0  # the manager's drain timeout (BASELINE.md:18's budget)


def loop_raw_scale(deskew) -> tuple[float, float, float]:
    """The raw's (scan step, y, x) scale in um for the deskew's ratio."""
    return (LOOP_PIXEL_UM / deskew.px_to_scan_ratio, LOOP_PIXEL_UM, LOOP_PIXEL_UM)


def loop_matrix(deskew, raw_scale_zyx) -> list:
    """The image-to-stage matrix (XYZ) that undoes a deskewed shift on the raw
    stage seam. A raw roll of (a scan steps, b tilt px, c x px) moves the
    deskewed volume by (b sin(theta), a / r + b cos(theta), c) px
    (``ops/deskew.py::_geometry``); the correction ``baseline - M @ shift``
    must move the stage by (c sx, b sy, a sz) um. The signs are those of -I
    (the seam rolls the raw by minus the stage offset); the axes are the
    raw's: the deskewed y drift is a scan drift, which -I would send to the
    tilt axis instead."""
    theta = math.radians(deskew.ls_angle_deg)
    r = deskew.px_to_scan_ratio
    sz, sy, sx = raw_scale_zyx
    px = sy  # the deskewed y and x pixel
    return [[-sx / px, 0.0, 0.0],
            [0.0, 0.0, -sy / (px * math.sin(theta))],
            [0.0, -r * sz / px, r * sz / (px * math.tan(theta))]]


def stage_offset_px(store, key: str, raw_scale_zyx) -> tuple[int, int, int]:
    """The stored position as whole raw pixels (ZYX), as the JAX engine's
    ``_stage_offset_px`` maps it: z by the raw's z scale, y and x by its y
    and x."""
    pos = store.get(key)
    sz, sy, sx = raw_scale_zyx
    return (int(round(pos.z / sz)), int(round(pos.y / sy)), int(round(pos.x / sx)))


def closed_loop(manager, sample, n_timepoints: int, raw_scale_zyx, key: str = LOOP_KEY,
                drain_timeout_s: float = LOOP_DRAIN_S) -> list:
    """DynaTrack's loop for one position: at each timepoint the stage offset
    from the store, ``sample(t, offset)`` (the stack the camera takes there),
    then ``record_acquisition``, ``on_stack_complete`` and ``drain_pending``
    in turn. ``manager`` is a ``PositionUpdateManager`` of either package.
    Returns a record a timepoint: the offset the stack was taken at, the one
    the correction left, the future's result and the drain's seconds."""
    manager.store.set(key, 0.0, 0.0, 0.0)
    records = []
    for t in range(n_timepoints):
        manager.record_acquisition(t, key)
        before = stage_offset_px(manager.store, key, raw_scale_zyx)
        stack = sample(t, before)
        future = manager.on_stack_complete(stack, t, key)
        del stack
        t0 = time.perf_counter()
        drained = manager.drain_pending(drain_timeout_s)
        drain_s = time.perf_counter() - t0
        pos = manager.store.get(key)
        records.append({"t": t, "offset_px": before,
                        "offset_after_px": stage_offset_px(manager.store, key, raw_scale_zyx),
                        "position_um": [pos.x, pos.y, pos.z],
                        "applied": future.result(timeout=0) if future.done() else None,
                        "drained": drained, "drain_s": drain_s})
    return records


def loop_residuals(records, drift_zyx) -> tuple[list, list]:
    """Per timepoint, the sample's offset from where it started in raw px
    (ZYX) in the stack the camera took (the drift less the offset it was
    taken at) and after the loop's correction (less the offset it left)."""
    taken, after = [], []
    for rec in records:
        moved = [rec["t"] * d for d in drift_zyx]
        taken.append([m - o for m, o in zip(moved, rec["offset_px"])])
        after.append([m - o for m, o in zip(moved, rec["offset_after_px"])])
    return taken, after


class LoopLog:
    """A handler on the manager's logger keeping the records that say a
    correction was not applied: an updater that raised, or a stack with no
    baseline."""

    def __init__(self):
        import logging

        self.bad = []
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.logger = logging.getLogger("shrimpy_tpu_torch.tracking.position")
        self.level = self.logger.level

    def _emit(self, record) -> None:
        import traceback

        msg = record.getMessage()
        if "updater failed" in msg or "no baseline" in msg:
            if record.exc_info:
                msg += "\n" + "".join(traceback.format_exception(*record.exc_info))
            self.bad.append(msg)

    def __enter__(self):
        import logging

        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def phase_loop(gen) -> dict:
    """DynaTrack's closed loop at the production raw: one position whose
    sample drifts TRACK_DRIFT (scan steps, x px) a timepoint, phase 4m's
    blobs, LOOP_TIMEPOINTS timepoints. ``PositionUpdateManager``'s worker
    runs the engine's updater (``Preprocessor([deskew])`` on the deskew
    kernel, ``Tracker`` ``pcc``, the stage shift through
    :func:`loop_matrix`); the seam rolls each raw by minus the stored
    offset. Every correction applied, no "updater failed" or "no baseline"
    record, one deskew launch a timepoint and no other kernel, every drain
    within LOOP_DRAIN_S, and from t = 2 on the sample within 1 px of where
    it started on every axis once the loop has corrected."""
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.position import PositionStore, PositionUpdateManager
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    t_start = time.monotonic()
    deskew = headline_settings().deskew
    raw_scale = loop_raw_scale(deskew)
    matrix = loop_matrix(deskew, raw_scale)
    cfg = track_config("pcc", preprocessing=["deskew"], deskew=vars(deskew),
                       image_to_stage_matrix_xyz=matrix)
    centers, amps = track_blobs(gen)
    raw0 = track_raw(centers, amps)
    drift = (TRACK_DRIFT[0], 0, TRACK_DRIFT[1])  # raw px (scan, tilt, x) a timepoint

    def sample(t, offset):
        """The camera's stack at t: the sample moved t * drift, the field of
        view following the stage (rolled by minus its offset), new noise."""
        shift = tuple(t * d - o for d, o in zip(drift, offset))
        raw = torch.roll(raw0, shift, dims=(0, 1, 2))
        return raw.add_(torch.randn(RAW_SHAPE, generator=gen, device="cuda"), alpha=TRACK_NOISE)

    pre = Preprocessor(cfg)
    tracker = Tracker(cfg, scale_zyx_um=pre.tracking_scale_zyx(RAW_SHAPE, raw_scale))
    update_ms = []

    def updater(stack, t, p):
        # The engine's closure (JAX engine.py:202-207), timed on the worker.
        t0 = time.perf_counter()
        stack = pre.tracking_stack(stack)
        result = tracker.update(stack, t, p)
        torch.cuda.current_stream().synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        return result.stage_shift_xyz

    manager = PositionUpdateManager(PositionStore(), updater, drain_timeout_s=LOOP_DRAIN_S)
    table = zero_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        with LoopLog() as log:
            records = closed_loop(manager, sample, LOOP_TIMEPOINTS, raw_scale)
    finally:
        manager.shutdown()
    counts = {k: getattr(obj, attr) for k, (obj, attr) in table.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del raw0, pre, tracker
    torch.cuda.empty_cache()
    taken, after = loop_residuals(records, drift)
    drains = [rec["drain_s"] for rec in records]
    res = {"update_ms": update_ms, "first_ms": update_ms[0] if update_ms else None,
           "warm_ms": update_ms[-1] if update_ms else None, "drain_s": drains,
           "residual_taken_px": taken, "residual_px": after, "peak_gib": peak,
           "positions_um": [rec["position_um"] for rec in records],
           "launches": counts["deskew"], "seconds": time.monotonic() - t_start}
    print(f"  matrix {[[round(v, 6) for v in row] for row in matrix]}; raw scale "
          f"{tuple(round(v, 6) for v in raw_scale)} um", flush=True)
    for rec, a, b in zip(records, taken, after):
        print(f"  t={rec['t']}: taken at offset {list(rec['offset_px'])} px, the sample there at "
              f"{a} px; corrected to {list(rec['offset_after_px'])} px "
              f"({[round(v, 4) for v in rec['position_um']]} um xyz), residual {b} px; "
              f"applied {rec['applied']}, drain {rec['drain_s']:.3f} s", flush=True)
    print(f"  update {res['first_ms']} ms first, {res['warm_ms']} ms warm "
          f"(all {[round(v, 1) for v in update_ms]}); drains max {max(drains):.3f} s; peak "
          f"{peak:.2f} GiB; {counts['deskew']} deskew launches; {card_line()}", flush=True)
    if log.bad:
        raise AssertionError(f"the loop logged corrections not applied: {log.bad}")
    if not all(rec["applied"] is True for rec in records):
        raise AssertionError(f"corrections not applied: {[rec['applied'] for rec in records]}")
    if not all(rec["drained"] for rec in records) or not max(drains) < LOOP_DRAIN_S:
        raise AssertionError(f"drains {drains} against {LOOP_DRAIN_S} s")
    bad = {k: v for k, v in counts.items() if v != (LOOP_TIMEPOINTS if k == "deskew" else 0)}
    if bad:
        raise AssertionError(f"loop launch counts {bad}, want {LOOP_TIMEPOINTS} deskew launches, "
                             "no other")
    far = [(t, r) for t, r in enumerate(after) if t >= 2 and max(abs(v) for v in r) > 1]
    if far:
        raise AssertionError(f"the loop left the sample off where it started: {far}")
    return res


# --- The acquisition engine on the card (engine/engine.py): its own event loop
# (t -> p -> c, the tracking updates in the position manager's worker, the
# drains at timepoint boundaries, the summary and the journal) over a plan
# namespace (config.acquisition_plan) and two in-memory stand-ins for the host
# file IO: a replay source and an output store. Neither touches the tracking's
# device work. The stores run on the card in 4u; through them, 4r's six raws
# (5.9 GB) would add ~7 s of fsynced writes at 4u's rate (4.73 GB in 5.37 s,
# PERF.md) and as long again to read them back for their digests, and
# tests/test_torch_replay.py holds the engine on these stand-ins to its run
# through io/ngff.py.
ENGINE_TIMEPOINTS = 3  # the residual check starts at t = 2: not fewer
ENGINE_POSITIONS = ("0/0/000", "0/1/001")  # one HCS plate
ENGINE_CHANNELS = ("LS", "GFP")  # the tracking channel first (4s's two channels)
# 4r's channels: the tracking channel alone (4r ran both, 12
# volumes at ~2.4 host s each, until phase 4u's time was paid for).
ENGINE_RUN_CHANNELS = ENGINE_CHANNELS[:1]
ENGINE_GAIN = 0.5  # the second channel: the sample at half the brightness


def volume_digest(vol: torch.Tensor) -> tuple:
    """A float32 volume's digest, computed where it lies: its shape, and the
    sum and the first moments along z, y and x of its bit patterns read as
    integers (int64 arithmetic, exact in any order of summation). A volume
    of another (t, c, position), or rolled by another offset, gives another
    digest."""
    if vol.dtype != torch.float32 or vol.dim() != 3:
        raise ValueError(f"a float32 ZYX volume, not {vol.dtype} {tuple(vol.shape)}")
    bits = vol.contiguous().view(torch.int32)
    sums = [bits.sum(dim=d, dtype=torch.int64) for d in ((1, 2), (0, 2), (0, 1))]
    moments = [int((s * torch.arange(1, s.numel() + 1, device=s.device)).sum()) for s in sums]
    return (tuple(vol.shape), int(sums[0].sum()), *moments)


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for None (the CPU)."""
    import contextlib

    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class MemorySource:
    """``engine/replay.py::ReplaySource`` over volumes made in memory:
    ``render(position, t, c)`` gives the recorded ZYX volume of that
    position, timepoint and channel as a float32 tensor (on the card, or on
    the CPU). ``volume`` is ``ReplaySource.volume``: one volume cached, ``t``
    taken modulo the source's depth, the volume rolled by minus the stage
    offset, a host array returned (read-only at zero offset). The attributes
    the engine reads are there (``shape_tczyx``, ``zyx_scale``,
    ``channel_names``, ``channel_index``, ``position_keys``,
    ``store.is_plate``: the source is an HCS plate). ``served`` keeps, for each (position, t, c) asked,
    the offsets and the digest (:func:`volume_digest`) of what was served;
    ``seconds`` the time of each call, ``ends`` the clock at its return.
    Tensor work runs on ``stream``, apart from the default stream a tracking
    worker uses; a volume on the card comes back through pinned memory (the
    caching host allocator's, reused call after call)."""

    def __init__(self, render, shape_tczyx, zyx_scale, channel_names, position_keys, *,
                 stream=None):
        from types import SimpleNamespace

        self.render = render
        self.shape_tczyx = tuple(shape_tczyx)
        self.zyx_scale = tuple(zyx_scale)
        self.channel_names = list(channel_names)
        self._keys = list(position_keys)
        self.store = SimpleNamespace(is_plate=True)
        self.stream = stream
        self._cache_key = None
        self._cache_vol = None
        self.cache_misses = 0
        self.served: dict = {}
        self.seconds: list = []
        self.ends: list = []

    @property
    def position_keys(self) -> list:
        return list(self._keys)

    @property
    def n_timepoints(self) -> int:
        return self.shape_tczyx[0]

    def channel_index(self, name: str) -> int:
        return self.channel_names.index(name)

    def volume(self, position, t, c, *, offset_px_zyx=(0, 0, 0)):
        t0 = time.perf_counter()
        shift = tuple(-int(round(o)) for o in offset_px_zyx)
        with on_stream(self.stream):
            key = (position, t % self.n_timepoints, c)
            if key != self._cache_key:
                self._cache_vol = None  # one volume resident
                self._cache_vol = self.render(*key)
                self._cache_key = key
                self.cache_misses += 1
            vol = self._cache_vol
            if any(shift):
                vol = torch.roll(vol, shift, dims=(0, 1, 2))
            digest = volume_digest(vol)
            host = torch.empty(vol.shape, dtype=vol.dtype, pin_memory=vol.is_cuda)
            out = host.copy_(vol).numpy()
        if not any(shift):
            out.flags.writeable = False
        self.served.setdefault((position, t, c), []).append(
            (tuple(-s for s in shift), digest))
        self.ends.append(time.perf_counter())
        self.seconds.append(self.ends[-1] - t0)
        return out


class MemoryStore:
    """The writer of ``io/ngff.py`` as the engine calls it for a plate
    (``create_hcs`` -> ``create_position`` -> ``create_array``, ``write``),
    keeping of each volume written its digest (:func:`volume_digest`,
    computed on ``device``), not its data. Creating a store makes its
    directory, empty, so the engine's name auto-increment sees it as it sees
    a store. ``positions`` maps (store path, position key) to the
    position; ``seconds`` holds each write's time, ``starts`` the clock at
    its call."""

    def __init__(self, device="cuda", stream=None):
        self.device = device
        self.stream = stream
        self.positions: dict = {}
        self.seconds: list = []
        self.starts: list = []

    def create_hcs(self, path, channel_names=None, **_):
        from pathlib import Path

        Path(path).mkdir(parents=True)
        return MemoryPlate(self, str(path), channel_names)


class MemoryPlate:
    def __init__(self, owner: MemoryStore, path: str, channel_names):
        self.owner, self.path, self.channel_names = owner, path, channel_names

    def create_position(self, row, col, fov, channel_names=None, zyx_scale=(1.0, 1.0, 1.0),
                        **_):
        pos = MemoryWritten(self.owner, channel_names or self.channel_names, zyx_scale)
        self.owner.positions[(self.path, f"{row}/{col}/{fov}")] = pos
        return pos


class MemoryWritten:
    """One position of a :class:`MemoryStore`: ``written`` maps (t, c) to the
    digest of the volume written there."""

    def __init__(self, owner: MemoryStore, channel_names, zyx_scale):
        self.owner = owner
        self.channel_names = list(channel_names or [])
        self.zyx_scale = tuple(zyx_scale)
        self.shape = None
        self.written: dict = {}

    def create_array(self, shape, dtype="float32", **_):
        if dtype != "float32":
            raise ValueError(f"the engine writes float32, not {dtype}")
        self.shape = tuple(shape)

    def write(self, selection, data) -> None:
        import numpy as np

        t0 = time.perf_counter()
        self.owner.starts.append(t0)
        t, c = selection
        if tuple(data.shape) != self.shape[2:] or data.dtype != np.float32:
            raise ValueError(f"volume {data.dtype} {data.shape} for an array of {self.shape}")
        with on_stream(self.owner.stream):
            vol = torch.from_numpy(np.ascontiguousarray(data)).to(self.owner.device)
            self.written[(t, c)] = volume_digest(vol)
        self.owner.seconds.append(time.perf_counter() - t0)


def memory_ngff(store: MemoryStore):
    """Puts ``store`` in the place of ``shrimpy_tpu_torch.io.ngff`` while the
    context lasts: in ``sys.modules``, and as the package's attribute where
    the real module was imported."""
    import contextlib
    from unittest import mock

    import shrimpy_tpu_torch.io as io_pkg

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.dict(sys.modules, {"shrimpy_tpu_torch.io.ngff": store}))
    stack.enter_context(mock.patch.object(io_pkg, "ngff", store, create=True))
    return stack


def recording_manager(records: dict):
    """``tracking/position.py::PositionUpdateManager`` as the engine builds
    it, keeping what it does: each updater call's seconds (the worker's
    tracking update, from the host stack to the stage shift), each future
    ``on_stack_complete`` returns, each drain's seconds and result."""
    from shrimpy_tpu_torch.tracking.position import PositionUpdateManager

    class RecordingManager(PositionUpdateManager):
        def __init__(self, store, updater, **kw):
            def timed(stack, t, p):
                t0 = time.perf_counter()
                out = updater(stack, t, p)
                records["update_ms"].append((t, p, (time.perf_counter() - t0) * 1e3))
                return out

            super().__init__(store, timed, **kw)

        def on_stack_complete(self, stack, t, p):
            future = super().on_stack_complete(stack, t, p)
            records["futures"].append((t, p, future))
            return future

        def drain_pending(self, timeout_s=None):
            t0 = time.perf_counter()
            ok = super().drain_pending(timeout_s)
            records["drains"].append((time.perf_counter() - t0, ok))
            return ok

    return RecordingManager


def engine_plan(deskew, matrix, n_timepoints: int, channels):
    """Phase 4r's plan, as the namespace the card's host can build: one
    tracking channel first, ``interval_s`` 0, DynaTrack ``pcc`` after
    ``[deskew]`` with ``matrix`` as the image-to-stage matrix."""
    from shrimpy_tpu_torch.config import acquisition_plan

    return acquisition_plan(
        time={"n_timepoints": n_timepoints, "interval_s": 0.0},
        channels=[{"name": c} for c in channels],
        metadata={"dynatrack": {
            "input_channel": channels[0], "tracking_channel": channels[0],
            "tracking_method": "pcc", "preprocessing": ["deskew"],
            "deskew": {"ls_angle_deg": deskew.ls_angle_deg,
                       "px_to_scan_ratio": deskew.px_to_scan_ratio},
            "image_to_stage_matrix_xyz": matrix}})


def run_engine(source, store, plan, device, out_dir, name: str = "smoke", **engine_kw) -> tuple:
    """``AcquisitionEngine(source, device=device, **engine_kw).acquire(out_dir,
    name, plan)`` with ``store`` in the place of the store module and the position
    manager recording (:func:`recording_manager`), under a shared
    ``PositionStore`` read after the run. The package logger's handlers,
    level and propagation are restored after, a failed run's log file
    released. Returns (output path, records, stage store, LoopLog)."""
    import logging
    from unittest import mock

    import shrimpy_tpu_torch.engine.engine as engine_mod
    from shrimpy_tpu_torch.tracking.position import PositionStore

    records = {"update_ms": [], "futures": [], "drains": []}
    stage = PositionStore()
    pkg_logger = logging.getLogger("shrimpy_tpu_torch")
    saved = (list(pkg_logger.handlers), pkg_logger.level, pkg_logger.propagate)
    try:
        with LoopLog() as log, memory_ngff(store), mock.patch.object(
                engine_mod, "PositionUpdateManager", recording_manager(records)):
            out = engine_mod.AcquisitionEngine(source, position_store=stage, device=device,
                                               **engine_kw).acquire(out_dir, name, plan)
    finally:
        for h in list(pkg_logger.handlers):
            if h not in saved[0]:
                pkg_logger.removeHandler(h)
                h.close()
        for h in saved[0]:
            if h not in pkg_logger.handlers:
                pkg_logger.addHandler(h)
        pkg_logger.setLevel(saved[1])
        pkg_logger.propagate = saved[2]
    return out, records, stage, log


def engine_residuals(source, stage, raw_scale, positions, n_timepoints, drift) -> dict:
    """Per position and timepoint, the sample's offset from where it started
    (raw px, ZYX) once the loop corrected it: the drift less the offset the
    next timepoint was taken at, or for the last one the offset the final
    stage position gives."""
    out = {}
    for p in positions:
        res = []
        for t in range(n_timepoints):
            if t + 1 < n_timepoints:
                after = source.served[(p, t + 1, 0)][0][0]
            else:
                after = stage_offset_px(stage, p, raw_scale)
            res.append([t * d - o for d, o in zip(drift, after)])
        out[p] = res
    return out


def phase_engine() -> dict:
    """The acquisition engine's own loop at the production raw:
    ``AcquisitionEngine(source, device="cuda").acquire(tmp, "smoke", plan)``
    over an HCS plate of ENGINE_POSITIONS, ENGINE_RUN_CHANNELS (the tracking
    channel first) and ENGINE_TIMEPOINTS, ``interval_s`` 0, DynaTrack ``pcc``
    after ``[deskew]`` with :func:`loop_matrix`. Each position's sample (phase
    4m's blobs, a seed a position) drifts TRACK_DRIFT (scan steps, x px) a
    timepoint; the in-memory source rolls it by minus the stage offset, the
    in-memory store keeps digests. Every (t, p) gets an update whose future is
    True, no "updater failed" or "no baseline" record, one deskew launch an
    update and no other kernel, every drain within LOOP_DRAIN_S, from t = 2 on
    each position's sample within 1 raw px of where it started once
    corrected, every written volume the one served at its (t, c, p) and
    offset, and a summary of every volume, no skipped visit and no error,
    with a journal row an update."""
    import csv
    import tempfile
    from pathlib import Path

    t_start = time.monotonic()
    deskew = headline_settings().deskew
    raw_scale = loop_raw_scale(deskew)
    matrix = loop_matrix(deskew, raw_scale)
    bases = []
    for i in range(len(ENGINE_POSITIONS)):
        centers, amps = track_blobs(torch.Generator(device="cuda").manual_seed(SEED + 40 + i))
        bases.append(track_raw(centers, amps))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    drift = (TRACK_DRIFT[0], 0, TRACK_DRIFT[1])  # raw px (scan, tilt, x) a timepoint

    def render(p, t, c):
        """The recording at (p, t, c): the position's sample moved t * drift,
        the second channel at ENGINE_GAIN, noise of its own seed."""
        i = ENGINE_POSITIONS.index(p)
        raw = torch.roll(bases[i], tuple(t * d for d in drift), dims=(0, 1, 2))
        if c:
            raw.mul_(ENGINE_GAIN)
        g = torch.Generator(device="cuda").manual_seed(SEED + 100 * i + 10 * t + c + 1)
        return raw.add_(torch.randn(RAW_SHAPE, generator=g, device="cuda"), alpha=TRACK_NOISE)

    n_t, n_p, n_c = ENGINE_TIMEPOINTS, len(ENGINE_POSITIONS), len(ENGINE_RUN_CHANNELS)
    source = MemorySource(render, (n_t, n_c, *RAW_SHAPE), raw_scale, ENGINE_RUN_CHANNELS,
                          ENGINE_POSITIONS, stream=stream)
    store = MemoryStore("cuda", stream)
    plan = engine_plan(deskew, matrix, n_t, ENGINE_RUN_CHANNELS)
    table = zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        out, records, stage, log = run_engine(source, store, plan, "cuda", tmp)
        acquire_s = time.monotonic() - t0
        counts = {k: getattr(obj, attr) for k, (obj, attr) in table.items()}
        summary = json.loads((Path(tmp) / "smoke_summary_metadata.json").read_text())
        with open(Path(tmp) / "smoke_dynatrack_log.csv") as f:
            journal = list(csv.DictReader(f))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del bases, source._cache_vol
    torch.cuda.empty_cache()
    residuals = engine_residuals(source, stage, raw_scale, ENGINE_POSITIONS, n_t, drift)
    update_ms = [ms for _, _, ms in records["update_ms"]]
    drains = [s for s, _ in records["drains"]]
    n_volumes = n_t * n_p * n_c
    res = {"update_ms": update_ms, "first_ms": update_ms[0] if update_ms else None,
           "warm_ms": update_ms[-1] if update_ms else None, "drain_s": drains,
           "host_s_per_volume": acquire_s / n_volumes, "acquire_s": acquire_s,
           "serve_s": sum(source.seconds) / len(source.seconds),
           "write_s": sum(store.seconds) / len(store.seconds),
           "engine_copy_s": sum(w - e for w, e in zip(store.starts, source.ends)) / n_volumes,
           "residual_px": residuals,
           "peak_gib": peak, "launches": counts["deskew"], "volumes": summary["volumes_acquired"],
           "positions_um": {p: [float(v) for v in stage.get(p).as_array()]
                            for p in ENGINE_POSITIONS},
           "seconds": time.monotonic() - t_start}
    print(f"  {out.name}: {summary['volumes_acquired']} volumes of {RAW_SHAPE} in "
          f"{acquire_s:.3f} s, {res['host_s_per_volume']:.3f} host s a volume (the source "
          f"{res['serve_s']:.3f} s a volume, the engine's [z_idx] and .astype copies "
          f"{res['engine_copy_s']:.3f}, the store {res['write_s']:.3f}); journal "
          f"{len(journal)} rows", flush=True)
    for p in ENGINE_POSITIONS:
        print(f"  {p}: residual after each correction {residuals[p]} px; stage "
              f"{[round(v, 4) for v in res['positions_um'][p]]} um xyz", flush=True)
    print(f"  update {res['first_ms']} ms first, {res['warm_ms']} ms warm (all "
          f"{[round(v, 1) for v in update_ms]}); drains {[round(v, 3) for v in drains]} s; peak "
          f"{peak:.2f} GiB; {counts['deskew']} deskew launches; {card_line()}", flush=True)
    if log.bad:
        raise AssertionError(f"the engine logged corrections not applied: {log.bad}")
    applied = {(t, p): f.result(timeout=0) if f.done() else None
               for t, p, f in records["futures"]}
    want = {(t, p) for t in range(n_t) for p in ENGINE_POSITIONS}
    if set(applied) != want or not all(v is True for v in applied.values()):
        raise AssertionError(f"tracking updates {applied}, want True at each of {sorted(want)}")
    if not all(ok for _, ok in records["drains"]) or not max(drains) < LOOP_DRAIN_S:
        raise AssertionError(f"drains {records['drains']} against {LOOP_DRAIN_S} s")
    bad = {k: v for k, v in counts.items() if v != (n_t * n_p if k == "deskew" else 0)}
    if bad:
        raise AssertionError(f"engine launch counts {bad}, want {n_t * n_p} deskew launches, "
                             "no other")
    far = [(p, t, r) for p in ENGINE_POSITIONS for t, r in enumerate(residuals[p])
           if t >= 2 and max(abs(v) for v in r) > 1]
    if far:
        raise AssertionError(f"the engine left a sample off where it started: {far}")
    written = {(p, t, c): d for (_, p), pos in store.positions.items()
               for (t, c), d in pos.written.items()}
    served = {k: v[-1][1] for k, v in source.served.items()}
    if written != served or len(written) != n_volumes or any(
            len(v) != 1 for v in source.served.values()):
        raise AssertionError(f"written volumes differ from those served: written "
                             f"{sorted(written)}, served {sorted(source.served)}")
    if (summary["volumes_acquired"], summary["skipped_autofocus"], summary["error"],
            len(journal)) != (n_volumes, [], None, n_t * n_p):
        raise AssertionError(f"summary {summary['volumes_acquired']} volumes, skipped "
                             f"{summary['skipped_autofocus']}, error {summary['error']}; "
                             f"journal {len(journal)} rows")
    return res


# --- The live viewer beside the acquisition engine (viewer/, ROADMAP item
# 12d): the feeder as `replay --viewer` builds it, publishing each volume the
# engine acquires to its shared-memory ring (native/ring.c) and its spawned
# monitor, and a monitor attached in this process as `monitor --live` attaches.
# The viewer is host code; its one kernel is the deskew its preview stands in
# for, held against the preview on the card.
VIEWER_TIMEPOINTS = 1  # two until phase 4u's time was paid for
VIEWER_CACHE_MB = 512.0  # replay --viewer's default budget
VIEWER_TILT_ROW = 128  # lab z = 128 sin(30 deg) = 64, a whole deskewed plane
PREVIEW_CORR = 0.95  # tests/test_viewer.py's bound on the preview against the deskew
CONTRAST_Q = (1.0, 99.7)  # viewer/live.py's auto-contrast percentiles


def shm_bytes() -> tuple[int, int]:
    """(size, free) of /dev/shm, where the feeder's ring lives."""
    import os

    st = os.statvfs("/dev/shm")
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


def viewer_raw(free: int) -> tuple[int, int, int]:
    """RAW_SHAPE, or its scan depth cut to the largest whose ring (the
    feeder's floor of n_z + 1 frames and their sequence words) fits in
    nine tenths of ``free`` bytes of /dev/shm: a ring past it would take a
    SIGBUS at its first write to a page the segment cannot back."""
    frame = RAW_SHAPE[1] * RAW_SHAPE[2] * 4 + 8
    return (min(RAW_SHAPE[0], int(0.9 * free) // frame - 1), *RAW_SHAPE[1:])


class LiveLog:
    """A handler on the port's monitor logger keeping every record at
    WARNING or above."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = self.records.append
        self.logger = logging.getLogger("shrimpy_tpu_torch.viewer.live")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self.handler)


def phase_viewer(engine_host_s: float) -> dict:
    """The live viewer beside ``AcquisitionEngine(source, device="cuda",
    viewer_hooks=[feeder.on_volume])`` over one position of 4r's plate,
    both channels, VIEWER_TIMEPOINTS timepoints of the production raw (its
    depth cut where /dev/shm cannot hold the ring: :func:`viewer_raw`),
    DynaTrack off. The feeder is ``replay --viewer``'s (``cache_mb`` 512,
    ``n_z`` the raw's depth, its monitor spawned); each hook call is timed,
    and at the last volume a monitor attached in this process
    (``live.attach``, a ``LiveMonitor`` with the headline geometry as a
    ``config.deskew_settings`` namespace, ``view.json`` asking for the
    per-render auto-contrast) takes the index as ``monitor --live`` does
    (poll, refresh, render). Checks: (a) the native ring is loaded and both
    rings use it; (b) ``volumes.jsonl`` has a row a volume, ``ring.json``
    the feeder's floor of n_z + 1 slots (the 512 MB budget holds fewer
    production frames), nothing dropped, and every volume but the last
    lapped by the next (its gather None, its layer not drawn) where the
    ring holds fewer than two; (c) the last volume, as the render gathers
    it from the ring (``LiveMonitor._gather``), has the digest of the
    volume served there, and so has the volume the hook was given;
    (d) the row-gather preview of the resident volume at VIEWER_TILT_ROW is
    bit-equal to ``deskew_preview_plane`` of the served volume's row and
    correlates above PREVIEW_CORR with that lab plane of ``deskew_cuda``'s
    output (``keep_overhang``, y offset t cos(theta)), one deskew launch and
    no other kernel in the phase; (e) ``state.json`` selects each channel's
    last timepoint and holds as its contrast ``np.percentile`` of the
    served volume of each channel drawn, a PNG for each where matplotlib
    imports (else its
    ``ImportError`` is the only record the monitor logs, and ``displayed``
    is empty). The monitor subprocess's exit after ``stop()`` is reported,
    not checked."""
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import numpy as np

    from shrimpy_tpu_torch import config, native
    from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda
    from shrimpy_tpu_torch.viewer import FrameRing, ViewerFeeder
    from shrimpy_tpu_torch.viewer.deskew_preview import deskew_preview_plane, preview_from_ring
    from shrimpy_tpu_torch.viewer.live import LiveMonitor, attach

    t_start = time.monotonic()
    shm_size, shm_free = shm_bytes()
    raw_shape = viewer_raw(shm_free)
    n_z, frame = raw_shape[0], raw_shape[1:]
    try:
        import matplotlib  # noqa: F401

        has_mpl = True
    except ImportError:
        has_mpl = False
    print(f"  /dev/shm {shm_size} bytes, {shm_free} free; raw {raw_shape}"
          + ("" if raw_shape == RAW_SHAPE else f", cut from {RAW_SHAPE} to fit the ring")
          + f"; matplotlib {'present' if has_mpl else 'absent: no PNG is drawn'}", flush=True)
    if n_z < 2:
        raise AssertionError(f"/dev/shm holds {n_z + 1} frames of {frame}: too few for a ring")
    deskew = headline_settings().deskew
    raw_scale = loop_raw_scale(deskew)
    position = ENGINE_POSITIONS[0]
    centers, amps = track_blobs(torch.Generator(device="cuda").manual_seed(SEED + 40))
    base = track_raw(centers, amps)[:n_z].contiguous()

    def render(p, t, c):
        """4r's recording at (p, t, c), cut to the raw's depth."""
        raw = torch.roll(base, (t * TRACK_DRIFT[0], 0, t * TRACK_DRIFT[1]), dims=(0, 1, 2))
        if c:
            raw.mul_(ENGINE_GAIN)
        g = torch.Generator(device="cuda").manual_seed(SEED + 10 * t + c + 1)
        return raw.add_(torch.randn(raw_shape, generator=g, device="cuda"), alpha=TRACK_NOISE)

    n_t, n_c = VIEWER_TIMEPOINTS, len(ENGINE_CHANNELS)
    n_volumes = n_t * n_c
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    source = MemorySource(render, (n_t, n_c, *raw_shape), raw_scale, ENGINE_CHANNELS,
                          [position], stream=stream)
    store = MemoryStore("cuda", stream)
    plan = config.acquisition_plan(time={"n_timepoints": n_t, "interval_s": 0.0},
                                   channels=[{"name": c} for c in ENGINE_CHANNELS])
    if native.load_ring() is None:
        raise AssertionError("(a) the native ring (native/ring.c) did not build or load")
    table = zero_counts()
    rec = {"feeder_s": [], "watch_s": [], "gather_s": [], "hook_digest": {}, "gathered": {},
           "errors": []}
    pool = ThreadPoolExecutor(n_c)  # the reference percentiles, beside the run
    percentiles = {}
    attached = {}
    with tempfile.TemporaryDirectory() as tmp, LiveLog() as log:
        preview = Path(tmp) / "preview"
        feeder = ViewerFeeder(frame_shape=frame, cache_mb=VIEWER_CACHE_MB, preview_dir=preview,
                              n_z=n_z)

        def gather(msg):
            """``LiveMonitor._gather`` as the render calls it, keeping the
            seconds and the digest of each volume gathered whole."""
            t0 = time.perf_counter()
            vol = attached["gather"](msg)
            if vol is not None:
                rec["gather_s"].append(time.perf_counter() - t0)
                key = (msg["p"], msg["t"], ENGINE_CHANNELS.index(msg["channel"]))
                rec["gathered"][key] = volume_digest(torch.from_numpy(vol).cuda())
            return vol

        def watch(vol, t, p, channel):
            """``_monitor_live``'s loop body, the gathers of its render
            recorded; the digest of the volume the hook was given."""
            c = ENGINE_CHANNELS.index(channel)
            if not attached:
                # The browser's auto-contrast box (web.py): each render
                # re-stretches, so a channel's limits are its newest volume's.
                (Path(tmp) / "attached").mkdir()
                (Path(tmp) / "attached" / "view.json").write_text('{"contrast_mode": "auto"}')
                ring, tail = attach(preview)
                attached.update(ring=ring, tail=tail, monitor=LiveMonitor(
                    ring, Path(tmp) / "attached",
                    deskew=config.deskew_settings(ls_angle_deg=deskew.ls_angle_deg,
                                                  px_to_scan_ratio=deskew.px_to_scan_ratio)),
                    msgs=[])
                attached["gather"] = attached["monitor"]._gather
                attached["monitor"]._gather = gather
            monitor = attached["monitor"]
            for msg in attached["tail"].poll():
                monitor.on_volume(msg)
                attached["msgs"].append(msg)
            msg = attached["msgs"][-1]
            if (msg["p"], msg["t"], msg["channel"]) != (str(p), t, channel):
                raise AssertionError(f"the index's last row {msg} is not ({p}, {t}, {channel})")
            rec["hook_digest"][(p, t, c)] = volume_digest(torch.from_numpy(vol).cuda())
            percentiles[(p, t, c)] = pool.submit(np.percentile, vol, CONTRAST_Q)
            monitor.refresh_controls()
            monitor.render_dirty()
            if (p, t, c) not in rec["gathered"]:
                raise AssertionError(f"({p}, {t}, {channel}) was not gathered whole by the render")

        def hook(vol, t, p, channel):
            t0 = time.perf_counter()
            feeder.on_volume(vol, t, p, channel)
            rec["feeder_s"].append(time.perf_counter() - t0)
            if (t, channel) == (n_t - 1, ENGINE_CHANNELS[-1]):
                t0 = time.perf_counter()
                try:
                    watch(vol, t, p, channel)
                except Exception as exc:  # raised after the run: the engine ignores hooks'
                    rec["errors"].append(exc)
                rec["watch_s"].append(time.perf_counter() - t0)

        torch.cuda.synchronize()
        feeder.start()
        proc = feeder._proc
        try:
            t0 = time.monotonic()
            out, _, _, _ = run_engine(source, store, plan, "cuda", tmp, "viewer",
                                      viewer_hooks=[hook])
            acquire_s = time.monotonic() - t0
            engine_counts = {k: getattr(obj, attr) for k, (obj, attr) in table.items()}
            rows = [json.loads(line) for line in
                    (preview / "volumes.jsonl").read_text().splitlines()]
            desc = json.loads((preview / "ring.json").read_text())
            if rec["errors"]:
                raise rec["errors"][0]
            ring, monitor, msgs = attached["ring"], attached["monitor"], attached["msgs"]
            state = json.loads((Path(tmp) / "attached" / "state.json").read_text())
            selected = {c: monitor._select_t((str(position), c)) for c in ENGINE_CHANNELS}
            evicted = sum(attached["gather"](m) is None for m in msgs[:-1])
            resident = msgs[-1]
            p, t, c = resident["p"], resident["t"], ENGINE_CHANNELS.index(resident["channel"])
            served = render(p, t, c)
            served_host = served.cpu().numpy()
            from_ring = preview_from_ring(ring, resident["slots"], VIEWER_TILT_ROW, monitor.deskew)
            plain_plane = deskew_preview_plane(served_host[:, VIEWER_TILT_ROW, :], monitor.deskew)
            full = deskew_cuda(served, config.deskew_settings(
                ls_angle_deg=deskew.ls_angle_deg, px_to_scan_ratio=deskew.px_to_scan_ratio,
                keep_overhang=True))
            counts = {k: getattr(obj, attr) for k, (obj, attr) in table.items()}
            z_lab = round(VIEWER_TILT_ROW * math.sin(math.radians(deskew.ls_angle_deg)))
            y_off = VIEWER_TILT_ROW * math.cos(math.radians(deskew.ls_angle_deg))
            n = min(from_ring.shape[0], full.shape[1] - math.ceil(y_off) - 1)
            lab = full[z_lab, round(y_off):round(y_off) + n].cpu().numpy()
            corr = float(np.corrcoef(from_ring[:n].ravel(), lab.ravel())[0, 1])
            want_contrast = {ENGINE_CHANNELS[c]: [float(v) for v in f.result()]
                             for (_, _, c), f in percentiles.items()}
            ring_libs = (feeder.ring._lib is not None, ring._lib is not None)
            pngs = sorted(f.name for f in (Path(tmp) / "attached").glob("*.png"))
            ring.close()
            del served, full
        finally:
            pool.shutdown()
            dropped = feeder.dropped
            feeder.stop()
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    torch.cuda.empty_cache()
    exit_code = proc.exitcode
    hook_s = sum(rec["watch_s"])
    res = {"raw": raw_shape, "shm_bytes": shm_size, "shm_free": shm_free, "matplotlib": has_mpl,
           "feeder_s": rec["feeder_s"], "feeder_s_per_volume": sum(rec["feeder_s"]) / n_volumes,
           "watch_s": rec["watch_s"], "gather_ms": [s * 1e3 for s in rec["gather_s"]],
           "acquire_s": acquire_s,
           "host_s_per_volume": (acquire_s - hook_s) / n_volumes,
           "engine_4r_host_s_per_volume": engine_host_s, "evicted": evicted,
           "n_slots": desc["n_slots"], "corr": corr, "launches": counts["deskew"],
           "monitor_exit": exit_code, "seconds": time.monotonic() - t_start}
    print(f"  {out.name}: {n_volumes} volumes of {raw_shape} in {acquire_s:.3f} s; the feeder "
          f"{res['feeder_s_per_volume']:.3f} s a volume on the acquisition thread (each "
          f"{[round(s, 3) for s in rec['feeder_s']]}); the attached monitor's work at the last "
          f"volume {[round(s, 3) for s in rec['watch_s']]} s, gathers "
          f"{[round(v, 1) for v in res['gather_ms']]} ms a volume; the engine "
          f"{res['host_s_per_volume']:.3f} host s a volume without that work (4r "
          f"{engine_host_s:.3f}); ring {desc['n_slots']} slots ({FrameRing.slots_for_budget(VIEWER_CACHE_MB, frame)} "
          f"in {VIEWER_CACHE_MB:.0f} MB), {evicted} older volumes evicted by design", flush=True)
    print(f"  preview at tilt row {VIEWER_TILT_ROW}: {from_ring.shape}, correlation {corr:.6f} with "
          f"lab plane z={z_lab} of deskew_cuda (y offset {y_off:.3f}); {counts['deskew']} deskew "
          f"launches; contrast {state['contrast']}; displayed {state['displayed']}; the monitor "
          + ("subprocess exited with code " + str(exit_code) if exit_code is not None
             and exit_code >= 0 else f"subprocess was terminated by stop() after its 5 s join "
             f"(exit code {exit_code}, -{int(signal.SIGTERM)} is SIGTERM)")
          + f"; {card_line()}", flush=True)
    if not all(ring_libs):
        raise AssertionError(f"(a) a ring ran on the numpy path: native (feeder, attached) "
                             f"{ring_libs}")
    slots = max(FrameRing.slots_for_budget(VIEWER_CACHE_MB, frame), n_z + 1)
    lapped = n_volumes - 1 if slots < 2 * n_z else 0
    if (len(rows), desc["n_slots"], dropped, evicted) != (n_volumes, slots, 0, lapped):
        raise AssertionError(f"(b) volumes.jsonl {len(rows)} rows, ring {desc['n_slots']} slots, "
                             f"dropped {dropped}, {evicted} evicted; want {n_volumes}, {slots}, "
                             f"0, {lapped}")
    served_digest = {k: v[-1][1] for k, v in source.served.items()}
    for key, digest in rec["gathered"].items():
        if digest != served_digest[key]:
            raise AssertionError(f"(c) the volume gathered at {key} is not the one served")
    for key, digest in rec["hook_digest"].items():
        if digest != served_digest[key] or key not in rec["gathered"]:
            raise AssertionError(f"(c) the hook's volume at {key} is not the one served, or the "
                                 "render did not gather it")
    if sorted(rec["hook_digest"]) != [(position, n_t - 1, n_c - 1)]:
        raise AssertionError(f"(c) watched {sorted(rec['hook_digest'])}, want the last volume")
    if volume_digest(torch.from_numpy(served_host).cuda()) != served_digest[(p, t, c)]:
        raise AssertionError("(d) the re-rendered volume is not the one served")
    if not np.array_equal(from_ring, plain_plane) or not corr > PREVIEW_CORR:
        raise AssertionError(f"(d) preview from the ring bit-equal "
                             f"{np.array_equal(from_ring, plain_plane)}, correlation {corr} "
                             f"against {PREVIEW_CORR}")
    bad = {k: v for k, v in counts.items() if v != (1 if k == "deskew" else 0)}
    if bad or any(engine_counts.values()):
        raise AssertionError(f"(d) launch counts {bad} (the run alone: {engine_counts}); want one "
                             "deskew launch and no other kernel")
    if selected != {ch: n_t - 1 for ch in ENGINE_CHANNELS} or state["contrast"] != want_contrast \
            or monitor.contrast_mode != "auto":
        raise AssertionError(f"(e) selected {selected}, contrast {state['contrast']} "
                             f"({monitor.contrast_mode}); want t = {n_t - 1}, {want_contrast} (auto)")
    drawn = [ch for ch in ENGINE_CHANNELS if ch in want_contrast]
    if has_mpl:
        want_pngs = sorted(f"live_p{position.replace('/', '_')}_{ch}.png" for ch in drawn)
        if state["displayed"] != {f"{position}|{ch}": n_t - 1 for ch in drawn} \
                or pngs != want_pngs or log.records:
            raise AssertionError(f"(e) displayed {state['displayed']}, PNGs {pngs}, records "
                                 f"{[r.getMessage() for r in log.records]}")
    elif state["displayed"] != {} or pngs or not log.records or not all(
            r.exc_info and issubclass(r.exc_info[0], ImportError)
            and "matplotlib" in str(r.exc_info[1]) for r in log.records):
        raise AssertionError(f"(e) displayed {state['displayed']}, records "
                             f"{[(r.getMessage(), r.exc_info) for r in log.records]}")
    return res


# --- Virtual staining (ROADMAP queue 1 item 10): the default unet25d through
# the tracker, unext2 at the widths of ConvNeXt-V2 Tiny (Woo et al. 2023) with
# the plane and the voxel-stack heads, and the [deskew, phase, vs] chain; every
# net with weights from its seed, against the float32 run of the same weights.
# bf16 against the float32 run of the same weights, max|a-b| / max|b|: the
# rounding of a net ~14 layers deep (2e-2 to 6e-2 at base width 8 on the CPU,
# tests/test_torch_vs.py, where the port's error is held to twice JAX's).
VS_BF16_RTOL = 1e-1
VS_F32_BATCH = 4  # the float32 runs' batch: their activations are twice bf16's
VS_PHASE = {"transfer_function": {"yx_pixel_size": 0.116, "z_pixel_size": 0.25}}
UNEXT2_TINY = {"encoder_blocks": [3, 3, 9, 3], "dims": [96, 192, 384, 768], "stem_kernel_z": 5}
VS_NETS = {
    "unext2 plane head": {"architecture": "unext2", "in_slices": 5, "arch_config": UNEXT2_TINY},
    "unext2 voxel-stack head": {"architecture": "unext2", "in_slices": 15, "window_step": 1,
                                "arch_config": {**UNEXT2_TINY, "out_stack_depth": 5}},
}
# The chain's raw: deskewed (32, 1050, 256) with the headline deskew, y no
# multiple of 8 (reflect-padded for the net) and its host transfer function
# (42 planes with z_padding 5) seconds.
VS_CHAIN_RAW = (427, 64, 256)
VS_SLAB = slice(28, 36)  # the unext2 nets' planes held against float32
BF16_PEAK = 989e12  # dense bf16 on the tensor cores, FLOP/s


def vs_track_config(channel: str, steps, **extra):
    from shrimpy_tpu_torch.config import dynatrack_settings

    return dynatrack_settings(input_channel="LS", tracking_channel=channel,
                              tracking_method="pcc", preprocessing=list(steps),
                              phase=VS_PHASE, **extra)


def vs_float32(stainer):
    """``stainer`` made its float32 reference run (the same weights), at
    batch VS_F32_BATCH."""
    stainer.model.compute_dtype = torch.float32
    stainer.settings.batch_slices = VS_F32_BATCH
    return stainer


def vs_stage_ms(pre) -> float:
    """The last ``vs`` stage of ``pre``'s timer, ms."""
    return [r.seconds for r in pre.timer.records if r.name == "vs"][-1] * 1e3


def forward_flops(settings, batch: int, yx) -> float:
    """The convolutions' and products' FLOPs of one forward of a (batch,
    in_slices, *yx) batch (``FlopCounterMode`` on the ``meta`` device)."""
    from torch.utils.flop_counter import FlopCounterMode

    from shrimpy_tpu_torch.models.vsunet import build_model

    net, _ = build_model(settings)
    with FlopCounterMode(display=False) as fc:
        net(torch.empty(batch, settings.in_slices, *yx, device="meta"))
    return float(fc.get_total_flops())


def vs_volume_flops(stainer, shape) -> float:
    """The FLOPs of one ``predict`` of a ``shape`` volume: one window's
    forward times the windows."""
    settings = stainer.settings
    flops = forward_flops(settings, 1, shape[1:])
    d = stainer.model.out_stack_depth
    if d == 1:
        return flops * shape[0]
    return flops * (-(-(shape[0] - d) // settings.window_step) + 1)


def stamp(t_start: float, header: str) -> None:
    """A phase's header line with the script's seconds so far."""
    print(f"{header} ({time.monotonic() - t_start:.1f} s in)", flush=True)


def vs_ms(fn, *args) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_vs(gen, phase_shape) -> dict:
    """(a) The default unet25d (``VSModelSettings()``) through the
    ``Preprocessor`` (``[phase, vs]``) and the ``Tracker`` (``pcc`` on
    ``vs_nuclei``) over two brightfield stacks of ``phase_shape`` (phase
    4l's, the TF from its host cache) shifted LF_SHIFT: the first and the
    warm (second) VS and update ms and the peak; the first update anchors
    (shift 0), the second's shift is the injected LF_SHIFT, and its bf16
    ``vs_nuclei`` is within VS_BF16_RTOL of its float32 run.
    (b) unext2 at Tiny widths, plane and voxel-stack heads, on the phase
    volume: first and warm ms, peak, the error against the float32 run on
    the planes VS_SLAB. (c) ``[deskew, phase, vs]`` on VS_CHAIN_RAW: one
    deskew launch, the VS product against the float32 run."""
    import numpy as np

    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    t_start = time.monotonic()
    stack0 = focus_stack(phase_shape, gen)
    stack1 = torch.roll(stack0, LF_SHIFT[1:], dims=(1, 2))
    cfg = vs_track_config("vs_nuclei", ("phase", "vs"))
    pre, tracker = Preprocessor(cfg), Tracker(cfg)
    r0, first_ms = timed_update(tracker, pre, stack0, 0)
    first_vs = vs_stage_ms(pre)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pre.tracking_stack(stack1)
    r1 = tracker.update(got, 1)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm_vs = vs_stage_ms(pre)
    phase_vol = pre(stack0, run_vs=False)["phase"]
    flops = vs_volume_flops(pre.stainer, tuple(phase_vol.shape))
    batch = pre.stainer.settings.batch_slices
    del pre, tracker
    torch.cuda.empty_cache()
    t32 = time.monotonic()
    pre32 = Preprocessor(cfg)
    vs_float32(pre32.stainer)
    ref = pre32.tracking_stack(stack1)
    f32_s = time.monotonic() - t32
    del pre32
    compare("unet25d vs_nuclei bf16 vs its float32 run", got, ref, VS_BF16_RTOL)
    err = rel_err(got, ref)
    del got, ref, stack0, stack1
    torch.cuda.empty_cache()
    if not (r0.reanchored and not r0.shift_px_zyx.any()
            and np.array_equal(r1.shift_px_zyx, LF_SHIFT)):
        raise AssertionError(f"VS pcc {r0.shift_px_zyx} (reanchored {r0.reanchored}), "
                             f"{r1.shift_px_zyx} against 0 then the injected {LF_SHIFT}")
    unet = {"shape": phase_shape, "batch": batch, "shift": r1.shift_px_zyx.tolist(),
            "first_vs_ms": first_vs, "vs_ms": warm_vs, "first_update_ms": first_ms,
            "update_ms": warm_ms, "peak_gib": peak, "rel_err": err, "tflop": flops / 1e12,
            "bound_ms": flops / BF16_PEAK * 1e3, "float32_s": f32_s,
            "seconds": time.monotonic() - t_start}
    print(f"  unet25d (base 64, depth 3, batch {batch}) at {phase_shape}: VS {warm_vs:.1f} ms "
          f"warm, "
          f"{first_vs:.1f} first ({flops / 1e12:.1f} TFLOP, bound {unet['bound_ms']:.1f} ms at "
          f"the bf16 peak); update {warm_ms:.1f} ms warm, {first_ms:.1f} first; peak "
          f"{peak:.2f} GiB; shift {unet['shift']} (injected {list(LF_SHIFT)}); vs_nuclei rel "
          f"err {err:.3e} against float32 (its run {f32_s:.1f} s); (a) took "
          f"{unet['seconds']:.1f} s", flush=True)

    nets = {}
    for label, kw in VS_NETS.items():
        t_net = time.monotonic()
        stainer = VirtualStainer(vs_settings(**kw))
        t0 = time.perf_counter()
        _, counts, net_peak = drive(lambda v: stainer.predict(v)["vs_nuclei"], phase_vol, {})
        first = (time.perf_counter() - t0) * 1e3
        _, ms = vs_ms(stainer.predict, phase_vol)
        slab = phase_vol[VS_SLAB]
        out = stainer.predict(slab)["vs_nuclei"]
        ref = vs_float32(stainer).predict(slab)["vs_nuclei"]
        compare(f"{label} vs_nuclei bf16 vs its float32 run, planes {VS_SLAB.start}-"
                f"{VS_SLAB.stop - 1}", out, ref, VS_BF16_RTOL)
        flops = vs_volume_flops(stainer, tuple(phase_vol.shape))
        nets[label] = {"ms": ms, "first_ms": first, "peak_gib": net_peak,
                       "rel_err": rel_err(out, ref), "tflop": flops / 1e12,
                       "bound_ms": flops / BF16_PEAK * 1e3,
                       "seconds": time.monotonic() - t_net}
        print(f"  {label} (blocks {UNEXT2_TINY['encoder_blocks']}, dims "
              f"{UNEXT2_TINY['dims']}, in_slices {kw['in_slices']}): {ms:.1f} ms warm, "
              f"{first:.1f} first ({flops / 1e12:.1f} TFLOP, bound "
              f"{nets[label]['bound_ms']:.1f} ms), peak {net_peak:.2f} GiB, rel err "
              f"{nets[label]['rel_err']:.3e} against float32; took "
              f"{nets[label]['seconds']:.1f} s", flush=True)
        del stainer, out, ref
        torch.cuda.empty_cache()
    del phase_vol
    torch.cuda.empty_cache()

    t_chain = time.monotonic()
    raw = uniform(VS_CHAIN_RAW, gen, 90.0, 110.0)
    chain = vs_track_config("vs_nuclei", ("deskew", "phase", "vs"),
                            deskew=vars(headline_settings().deskew))
    pre = Preprocessor(chain)
    t0 = time.perf_counter()
    out, counts, _ = drive(lambda r: pre(r)["vs_nuclei"], raw, {"deskew": 1})
    chain_s = time.perf_counter() - t0
    _, chain_ms = vs_ms(lambda r: pre(r)["vs_nuclei"], raw)
    shape = tuple(pre(raw, run_vs=False)["phase"].shape)
    pre32 = Preprocessor(chain)
    vs_float32(pre32.stainer)
    ref = pre32(raw)["vs_nuclei"]
    compare("[deskew, phase, vs] vs_nuclei bf16 vs its float32 run", out, ref, VS_BF16_RTOL)
    res_c = {"raw": VS_CHAIN_RAW, "shape": shape, "deskew_launches": counts["deskew"],
             "first_s": chain_s, "ms": chain_ms, "rel_err": rel_err(out, ref),
             "seconds": time.monotonic() - t_chain}
    print(f"  [deskew, phase, vs] at raw {VS_CHAIN_RAW} (phase {shape}): "
          f"{counts['deskew']} deskew launch, first {chain_s:.2f} s (host TF included), warm "
          f"{chain_ms:.1f} ms, rel err {res_c['rel_err']:.3e} against float32; took "
          f"{res_c['seconds']:.1f} s", flush=True)
    del pre, pre32, raw, out, ref
    torch.cuda.empty_cache()
    return {"unet25d": unet, "unext2": nets, "chain": res_c,
            "seconds": time.monotonic() - t_start}


# --- Virtual-staining training (ROADMAP queue 1 item 10): the default
# unet25d and unext2 at ConvNeXt-V2 Tiny widths (phase 4n's plane head), from
# their seeds, on four in-memory volumes whose targets are fixed smooth
# functions of the input, at the CLI's batch 4 and patch 128 (unet25d at
# batch 16, patch 256, ran here until phase 4u's time was paid for:
# 30.13 ms a step, PERF.md). unet25d takes the CLI's learning rate 1e-3; at
# 1e-3 the Tiny unext2 diverged on the card (its loss 2.1 -> 7.8e4 in 13
# steps, in bf16 and in float32 alike: Adam's first steps move every weight
# by the rate, 3072 of them into each output of a block's second pointwise
# layer), so it takes 1e-4.
TRAIN_SHAPE, TRAIN_VOLUMES = (16, 1024, 1024), 4
TRAIN_TARGETS = ["vs_nuclei", "vs_membrane"]  # VSModelSettings()'s out_channels
TRAIN_RUNS = (  # (net, settings, batch, patch, steps, learning rate)
    ("unet25d", {}, 4, 128, 20, 1e-3),
    ("unext2 plane head", VS_NETS["unext2 plane head"], 4, 128, 20, 1e-4),
)
# 4o's runs: unet25d's ran here too until phase 4v's time was paid for
# (6.5-8.3 s); 4v(k) trains it through `train-vs` at the same batch and patch.
TRAIN_PHASE_RUNS = TRAIN_RUNS[1:]
TRAIN_VAL = {"val_fraction": 0.25, "val_every": 5}
TRAIN_CHECK_STEPS = 3  # the bf16 steps held to the float32 run's
TRAIN_F32_RTOL = 5e-2  # their losses, relative
SNAPSHOT_RTOL = 1e-5  # the returned weights' validation loss against the best
CKPT_RTOL = 1e-6  # a reloaded checkpoint's predict against the trained stainer's


class MemoryPosition:
    """One timepoint held in memory with a store position's interface
    (``channel_names``, ``shape`` (T, C, Z, Y, X), ``volume(t, c)``), so
    that training reads no store. The targets are ``tanh(2 x)`` and
    ``sin(3 x)`` of the input ``x``."""

    channel_names = ["phase", *TRAIN_TARGETS]

    def __init__(self, phase):
        import numpy as np

        self._channels = (phase, np.tanh(2 * phase), np.sin(3 * phase))
        self.shape = (1, len(self._channels), *phase.shape)

    def volume(self, t: int, c: int):
        return self._channels[c]


class ScriptedLast:
    """``models/train.py::evaluate`` for ``train_positions``: each
    evaluation's weights copied and its loss kept; the last of ``count``
    evaluations is reported worse than any before it, so the best weights
    are an earlier evaluation's, and the returned ones must be that copy
    and not the live tensors."""

    def __init__(self, evaluate, count: int):
        self.evaluate, self.count = evaluate, count
        self.losses, self.states = [], []

    def __call__(self, model, x, y) -> float:
        self.losses.append(self.evaluate(model, x, y))
        self.states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        if len(self.losses) == self.count:
            return 2 * max(self.losses)
        return self.losses[-1]


def train_steps(stainer, batches, lr: float) -> tuple[list, list]:
    """``models/train.py``'s AdamW and step on ``batches`` from the
    stainer's weights: (losses, ms a step)."""
    from shrimpy_tpu_torch.models.train import adamw, train_step

    model = stainer.model.to("cuda").train()
    opt = adamw(model, lr)
    losses, ms = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(model, opt, x, y)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def phase_train() -> dict:
    """Phase 4o: each run of TRAIN_PHASE_RUNS. First TRAIN_CHECK_STEPS steps of
    the module's step on sampled batches, from the seeded weights, in bf16
    (the first and warm step's ms) and in float32 (no TF32): the losses
    within TRAIN_F32_RTOL. Then ``train_positions`` (validation every 5
    steps on a held-out volume of four) with every kernel count set to 0
    (the nets run cuDNN and cuBLAS, no kernel of the repository) and its
    evaluations through ScriptedLast: the validation loss falls, the
    returned weights are bit for bit the copy taken at the best evaluation
    and differ from the last's, their validation loss is the best's, their
    checkpoint reloads into a fresh stainer whose ``predict`` equals the
    trained one's."""
    import numpy as np

    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.models import train
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer

    t_start = time.monotonic()
    rng = np.random.default_rng(SEED + 7)
    positions = [MemoryPosition(rng.standard_normal(TRAIN_SHAPE, dtype=np.float32))
                 for _ in range(TRAIN_VOLUMES)]
    entries, _, ny0 = train.position_entries(positions, "phase", TRAIN_TARGETS)
    bank = train._VolumeBank(entries)
    runs = []
    for i, (label, kw, batch, patch, steps, lr) in enumerate(TRAIN_PHASE_RUNS):
        t_run = time.monotonic()
        settings = vs_settings(**kw, out_channels=TRAIN_TARGETS)
        brng = np.random.default_rng(SEED)
        batches = [tuple(train.to_nchw(a, "cuda") for a in train._sample_batch(
            brng, bank, in_slices=settings.in_slices, patch=patch, batch=batch, augment=True))
            for _ in range(TRAIN_CHECK_STEPS)]
        bf16, ms = train_steps(VirtualStainer(settings), batches, lr)
        stainer32 = VirtualStainer(settings)
        stainer32.model.compute_dtype = torch.float32
        f32, _ = train_steps(stainer32, batches, lr)
        del stainer32, batches
        torch.cuda.empty_cache()
        f32_err = max(abs(a - b) / abs(b) for a, b in zip(bf16, f32))
        print(f"  {label} (batch {batch}, patch {patch}): {TRAIN_CHECK_STEPS} steps, bf16 "
              f"losses {[round(v, 5) for v in bf16]}, float32 {[round(v, 5) for v in f32]}: "
              f"max rel {f32_err:.3e} (tol {TRAIN_F32_RTOL:g}) "
              f"{'ok' if f32_err <= TRAIN_F32_RTOL else 'FAIL'}", flush=True)
        if not f32_err <= TRAIN_F32_RTOL:
            raise AssertionError(f"{label}: bf16 losses {bf16} against float32 {f32}")

        ckpt = build.BUILD_DIR / f"chip_smoke_vs_train_{i}"
        table = zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        evaluate = train.evaluate
        scripted = train.evaluate = ScriptedLast(evaluate, steps // TRAIN_VAL["val_every"])
        try:
            t0 = time.perf_counter()
            stainer, report = train.train_positions(
                positions, input_channel="phase", target_channels=TRAIN_TARGETS,
                settings=settings, steps=steps, batch=batch, patch=patch, learning_rate=lr,
                ckpt_path=ckpt, seed=SEED, device="cuda", **TRAIN_VAL)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            train.evaluate = evaluate
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = {k: getattr(obj, attr) for k, (obj, attr) in table.items()
                    if getattr(obj, attr)}
        if launched or report.steps != steps or report.stopped_early:
            raise AssertionError(f"{label}: {report.steps} steps, stopped early "
                                 f"{report.stopped_early}, launches {launched}")
        losses, val = report.losses, scripted.losses
        # The validation loss, on fixed crops (a training loss is one batch's).
        if not val[-1] < val[0]:
            raise AssertionError(f"{label}: the loss did not fall ({losses}, validation {val})")
        best = report.val_losses.index(report.best_val_loss)
        state = stainer.model.state_dict()
        if not (report.val_losses[:-1] == val[:-1] and best < len(val) - 1
                and all(torch.equal(state[k], v) for k, v in scripted.states[best].items())
                and any(not torch.equal(state[k], v) for k, v in scripted.states[-1].items())):
            raise AssertionError(f"{label}: the returned weights are not the copy taken at the "
                                 f"best evaluation {best} (reported {report.val_losses})")

        _, val_e = train.split_entries(entries, ny0, np.random.default_rng(SEED),
                                       val_fraction=TRAIN_VAL["val_fraction"], patch=patch)
        vx, vy = train.validation_crops(train._VolumeBank(val_e), settings, patch=patch,
                                        batch=batch, seed=SEED)
        again = train.evaluate(stainer.model, train.to_nchw(vx, "cuda"),
                               train.to_nchw(vy, "cuda"))
        snap_err = abs(again - report.best_val_loss) / report.best_val_loss
        if not snap_err <= SNAPSHOT_RTOL:
            raise AssertionError(f"{label}: the returned weights' validation loss {again} is not "
                                 f"the best {report.best_val_loss} ({val})")
        loaded = VirtualStainer(vs_settings(ckpt_path=str(ckpt)))
        vol = torch.from_numpy(positions[0].volume(0, 0)[:, :256, :256]).cuda()
        want = stainer.predict(vol)
        ckpt_err = max(rel_err(loaded.predict(vol)[c], want[c]) for c in TRAIN_TARGETS)
        if not ckpt_err <= CKPT_RTOL:
            raise AssertionError(f"{label}: the reloaded checkpoint's predict is {ckpt_err:.3e} "
                                 "off the trained stainer's")
        flops = forward_flops(settings, batch, (patch, patch))
        run = {"net": label, "batch": batch, "patch": patch, "steps": steps, "lr": lr,
               "first_step_ms": ms[0], "step_ms": sum(ms[1:]) / len(ms[1:]),
               "bound_ms": 3 * flops / BF16_PEAK * 1e3, "forward_gflop": flops / 1e9,
               "run_s": run_s, "peak_gib": peak, "first_loss": losses[0],
               "last_loss": losses[-1], "val_losses": val, "best_val_loss": report.best_val_loss,
               "f32_rel_err": f32_err, "snapshot_rel_err": snap_err, "ckpt_rel_err": ckpt_err,
               "seconds": time.monotonic() - t_run}
        runs.append(run)
        print(f"  {label} (batch {batch}, patch {patch}, {steps} steps at {lr:g}): step "
              f"{run['step_ms']:.2f} ms warm, {ms[0]:.1f} first (bound {run['bound_ms']:.3f} ms: "
              f"3 x {flops / 1e9:.1f} GFLOP forward at the bf16 peak); run {run_s:.2f} s, peak "
              f"{peak:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}, validation "
              f"{[round(v, 4) for v in val]} (the last reported as {report.val_losses[-1]:.4f}); "
              f"returned weights evaluation {best}'s copy, their validation loss within "
              f"{snap_err:.1e} of it; checkpoint reload {ckpt_err:.1e}; took "
              f"{run['seconds']:.1f} s", flush=True)
        del stainer, loaded, vol, want, scripted, state
        torch.cuda.empty_cache()
    return {"runs": runs, "verb": {"pairs": [p.volume(0, 0) for p in positions]},
            "seconds": time.monotonic() - t_start}


# --- BASELINE.md config 2: RL-20 of the deskewed production volume with a
# PSF measured from a bead stack: io/synthetic.py::synthetic_ls_stack's
# beads at the headline's angle and ratio, rendered on the card.
BEAD_RAW, BEAD_COUNT = (400, 256, 1600), 50
BEAD_SIGMA_PX, BEAD_AMPLITUDE = 1.5, 1000.0  # render_beads_skewed's defaults
BEAD_PX_UM = 0.116  # synthetic_ls_stack's pixel size
PSF_RTOL = 1e-5  # the card's PSF against the CPU plain path's, of its max
RL2_RTOL = 1.5e-6  # the first 2 iterations against float64 (ROADMAP queue 3)
PSF_CROP = (32, 512, 512)
# RL on the crop against float64: 5 iterations (20 before phase 4t's time
# was paid for, 10 before phase 4u's; the full-size RL-2 check is unchanged).
PSF_CROP_ITERATIONS = 5


def bead_raw(shape=BEAD_RAW, n_beads: int = BEAD_COUNT, *, device="cuda", seed: int = SEED + 5):
    """``synthetic_ls_stack(raw_shape_szx=shape, n_beads=n_beads,
    seed=seed)``'s raw, rendered with torch on ``device`` (in float64, as
    numpy's float32 grid minus a float64 centre computes, summed in
    float32): (raw float32 tensor, beads (n, 3) lab zyx)."""
    import numpy as np

    theta, r = math.radians(30.0), 0.386
    rng = np.random.default_rng(seed)
    ns, nt, nx = shape
    z_max = (nt - 1) * math.sin(theta)
    z = rng.uniform(0.2 * z_max, 0.8 * z_max, n_beads)
    u = rng.uniform(0.1, 0.9, n_beads)
    y = z / math.tan(theta) + u * (ns - 1) / r
    beads = np.stack([z, y, rng.uniform(0.2 * nx, 0.8 * nx, n_beads)], axis=1)
    axes = [torch.arange(n, dtype=torch.float32, device=device).double() for n in shape]
    s_idx, t_idx, x_idx = axes[0][:, None, None], axes[1][None, :, None], axes[2][None, None, :]
    raw = torch.zeros(shape, dtype=torch.float32, device=device)
    for zb, yb, xb in beads:
        t_c = zb / math.sin(theta)
        s_c = r * (yb - zb / math.tan(theta))
        raw += (BEAD_AMPLITUDE * torch.exp(-0.5 * (
            ((s_idx - s_c) * (1.0 / r) / BEAD_SIGMA_PX) ** 2
            + ((t_idx - t_c) / BEAD_SIGMA_PX) ** 2
            + ((x_idx - xb) / BEAD_SIGMA_PX) ** 2))).float()
    return raw, beads


def bead_fwhm_um() -> tuple[float, float, float]:
    """The rendered bead's FWHM through its centre along deskewed z, y, x:
    the raw Gaussian is sigma in (s / r, t, x), so along z (t = z / sin,
    s / r = y - z cot) sigma / sqrt(cot^2 + csc^2), along y and x sigma."""
    theta = math.radians(30.0)
    width = 2 * math.sqrt(2 * math.log(2)) * BEAD_SIGMA_PX * BEAD_PX_UM
    return (width / math.sqrt(1 / math.tan(theta) ** 2 + 1 / math.sin(theta) ** 2), width, width)


def phase_psf(gen, verb_stores=None) -> dict:
    """Phase 4p: the bead raw deskewed on the card (row 1) and measured on
    the host (``psf.py::measure_volume_psf``, ``deskewed`` patch (31, 41,
    41)), against the CPU plain path (the plain deskew, the same host code,
    run beside the card's RL): n_beads equal, the PSF within PSF_RTOL.
    Then deskew + RL-20 on ``fused`` with that PSF (its K terms planned by
    ``plan_separable_terms`` after the ``psf_crop_tol`` crop, one
    ``rl_half`` launch a half-step, or three a term past its block) at the
    production raw with the counts reset, timed as counted: ms, GVox/s,
    peak. On the deskewed volume the first 2 iterations against float64
    within RL2_RTOL, and RL-PSF_CROP_ITERATIONS on a PSF_CROP crop within
    STEP_RTOL. Once the timed runs are done, ``verb_stores`` (where given)
    takes phase 4v's inputs from here, the bead raw and the production raw
    as numpy arrays, to write them beside the float64 checks."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from shrimpy_tpu_torch.kernels import build
    from shrimpy_tpu_torch.ops.deconv import richardson_lucy
    from shrimpy_tpu_torch.ops.deskew import deskew_volume
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step
    from shrimpy_tpu_torch.psf import measure_volume_psf

    t_start = time.monotonic()
    raw, _ = bead_raw()
    settings = headline_settings()
    deskew, deconv = settings.deskew, settings.deconvolve
    scale = (BEAD_PX_UM / deskew.px_to_scan_ratio, BEAD_PX_UM, BEAD_PX_UM)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {k: build.BUILD_DIR / f"chip_smoke_psf_{k}" for k in ("card", "cpu")}
    table = zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = measure_volume_psf(raw, scale, out["card"], geometry="lightsheet", deskew=deskew)
    measure_s = time.perf_counter() - t0
    launched = {k: getattr(obj, attr) for k, (obj, attr) in table.items() if getattr(obj, attr)}
    if launched != {"deskew": 1}:
        raise AssertionError(f"the card's PSF measurement launched {launched}, want one deskew")
    psf = np.load(out["card"].with_suffix(".npy"))
    host_raw = raw.cpu()
    del raw
    beads = host_raw.numpy()

    def cpu_path():
        t = time.perf_counter()
        rep = measure_volume_psf(host_raw, scale, out["cpu"], geometry="lightsheet",
                                 deskew=deskew, device="cpu")
        return rep, time.perf_counter() - t

    with ThreadPoolExecutor(1) as pool:
        cpu_run = pool.submit(cpu_path)
        plan = config2_want(psf, deconv)
        psf_w, terms, radii, carry, route, layout = (
            plan[k] for k in ("psf_w", "terms", "radii", "carry", "route", "layout"))
        if route == "one_launch":
            build.build_geometries([("rl_half", (len(terms), *psf_w.shape, *layout["tile"]))])
        print(f"  measured PSF (31, 41, 41) from {report.n_beads} beads in {measure_s:.2f} s "
              f"(deskew launch and host code), FWHM zyx {np.round(report.fwhm_um_zyx, 4)} um "
              f"(the rendered bead's {np.round(bead_fwhm_um(), 4)}); cropped at psf_crop_tol "
              f"{deconv.psf_crop_tol:g} to {psf_w.shape} (radii {radii}), K = {len(terms)} "
              f"terms; rl_half route {route}, tile {layout.get('tile')} "
              f"({layout.get('smem_bytes')} B of shared memory)", flush=True)
        batch = uniform((1, *RAW_SHAPE), gen, 0.0, 100.0)
        step = build_reconstruct_step(settings, psf=psf, device="cuda")
        # Timed as counted: every kernel of the step is built and loaded
        # by now (a second run would add its length to the phase).
        t0 = time.perf_counter()
        rl20, counts, peak = drive(step, batch, plan["want"])
        ms = (time.perf_counter() - t0) * 1e3
        passes = config2_pass_ms(carry, terms[0], gen) if route == "three_pass" else {}
        vox = rl20[0].numel()
        # Phase 4v's config 2 through the CLI: this raw and this output.
        verb = {"psf": {"psf": psf, "report": report.as_dict()}, "cfg2_out": rl20[0]}
        if verb_stores is not None:
            verb_stores({"beads": beads, "cfg2_raw": batch[0].cpu().numpy()})
        del rl20
        vol = deskew_volume(batch[0], deskew)
        del batch
        torch.cuda.empty_cache()
        s2 = headline_settings(iterations=2).deconvolve
        t0 = time.monotonic()
        ref = rl_float64_banded(vol, psf_w, terms, s2, 2)
        rl2_s = time.monotonic() - t0
        rl2 = compare(f"RL-2 with the measured PSF, (128, 2888, 1600), vs float64 plain (the "
                      f"float64 run {rl2_s:.1f} s)", richardson_lucy(vol, psf, s2), ref, RL2_RTOL)
        del ref
        crop = vol[tuple(slice(0, n) for n in PSF_CROP)].contiguous()
        del vol
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        s_crop = headline_settings(iterations=PSF_CROP_ITERATIONS).deconvolve
        ref = richardson_lucy(crop, psf, s_crop, plain=True, dtype=torch.float64)
        crop_s = time.monotonic() - t0
        crop_err = compare(f"RL-{PSF_CROP_ITERATIONS} with the measured PSF on a {PSF_CROP} crop "
                           f"vs float64 plain (the float64 run {crop_s:.1f} s)",
                           richardson_lucy(crop, psf, s_crop), ref, STEP_RTOL)
        # The full-size reference's operator is the plain one: on the crop
        # the two float64 runs agree to their rounding.
        compare(f"RL-{PSF_CROP_ITERATIONS} on the crop: the banded float64 reference vs float64 "
                "plain", rl_float64_banded(crop, psf_w, terms, s_crop, PSF_CROP_ITERATIONS), ref,
                1e-10)
        del ref, crop
        cpu_report, cpu_s = cpu_run.result()
    psf_cpu = np.load(out["cpu"].with_suffix(".npy"))
    psf_err = float(np.abs(psf - psf_cpu).max() / psf_cpu.max())
    print(f"  the CPU plain path ({cpu_s:.2f} s, beside the card's RL): {cpu_report.n_beads} "
          f"beads, PSF max|a-b|/max|b| = {psf_err:.3e} (tol {PSF_RTOL:g})", flush=True)
    if cpu_report.n_beads != report.n_beads or not psf_err <= PSF_RTOL:
        raise AssertionError(f"the card's PSF ({report.n_beads} beads) against the CPU plain "
                             f"path's ({cpu_report.n_beads}): {psf_err:.3e}")
    res = {"n_beads": report.n_beads, "fwhm_um_zyx": list(report.fwhm_um_zyx),
           "bead_fwhm_um_zyx": list(bead_fwhm_um()), "measure_s": measure_s, "cpu_s": cpu_s,
           "psf_rel_err": psf_err, "k": len(terms), "psf_shape": psf_w.shape, "radii": radii,
           "route": route, "tile": layout.get("tile"), "ms": ms, "gvox_s": vox / ms / 1e6,
           "peak_gib": peak, "pass_ms": passes,
           "rl2_max_abs_err": rl2, "rl2_float64_s": rl2_s, "crop_max_abs_err": crop_err,
           "crop_float64_s": crop_s,
           "launches": counts, "verb": verb,
           "seconds": time.monotonic() - t_start}
    print(f"  deskew + RL-20 with the measured PSF at raw {RAW_SHAPE}: {ms:.1f} ms (the counted "
          f"run), {res['gvox_s']:.4f} GVox/s, peak {peak:.2f} GiB; one term's passes "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in passes.items())
          + f"; phase 4p took {res['seconds']:.1f} s", flush=True)
    return res


def rl_float64_banded(image, psf_w, terms, settings, iterations: int) -> torch.Tensor:
    """RL of the ``fused`` backend's operator in float64 on the card: the
    G grid, start and crop of ``ops/rl_fused.py::rl_fused``, and each 1-D
    pass of a term a product with its banded Toeplitz matrix
    (``conv3_cuda.py::toeplitz_banded``, zero boundary) on cuBLAS: the
    plain half-steps' operator with its sums in another order. Phase 4p's
    reference at full size (the plain tap passes took 67 s for RL-2)."""
    from shrimpy_tpu_torch.ops.conv3_cuda import toeplitz_banded
    from shrimpy_tpu_torch.ops.rl_fused import crop_grid, start_on_grid

    eps = float(settings.epsilon)
    shape = tuple(image.shape)
    conv, adj, data, est = start_on_grid(image, psf_w, terms, settings, torch.float64)
    gz, gy, gx = est.shape

    def matrices(st):
        return [tuple(toeplitz_banded(n, w, est.device) for n, w in zip(est.shape, term))
                for term in st.host]

    def conv3(v, mats):
        acc = None
        for tz, ty, tx in mats:
            w = (tz @ v.reshape(gz, gy * gx)).reshape(gz, gy, gx)
            wy = torch.empty_like(w)
            for z in range(gz):  # a plane at a time: no (gz, gy, gy) copy of ty
                torch.matmul(ty, w[z], out=wy[z])
            del w
            w = torch.matmul(wy, tx.T)
            del wy
            acc = w if acc is None else acc.add_(w)
        return acc

    fwd, bwd = matrices(conv), matrices(adj)
    for _ in range(iterations):
        ratio = data / torch.clamp_min(conv3(est, fwd), eps)
        est = est * conv3(ratio, bwd)
        del ratio
    del data
    return crop_grid(est, shape, conv.radii)


def config2_pass_ms(carry, term, gen) -> dict:
    """Device ms of one term's z, y and x passes (the x pass adding the
    earlier terms' sum) with the measured PSF's taps on config 2's carry,
    as the three-pass route launches them (CUDA events, warm)."""
    from shrimpy_tpu_torch.ops.rl_fused import Stencil, conv_axis_cuda, conv_x_cuda

    gz, gy, gx = carry
    st = Stencil([term], device="cuda")
    (kz, ky, kx), (hz, hy, hx) = st.dev[0], st.host32[0]
    v = uniform(carry, gen, 0.5, 10.5)
    a, b = torch.empty_like(v), torch.empty_like(v)
    res = {"z": gpu_ms(lambda: conv_axis_cuda(v, a, kz, hz, 1, gz, gy * gx), 5),
           "y": gpu_ms(lambda: conv_axis_cuda(a, b, ky, hy, gz, gy, gx), 5),
           "x": gpu_ms(lambda: conv_x_cuda(b, v, None, a, kx, "plain", 0.0, host=hx), 5)}
    del v, a, b
    torch.cuda.empty_cache()
    return res


STORE_TIMEPOINTS = 2  # 4u's input store: timepoints of one channel at the production raw
STORE_RAW_MAX = 4096  # the raw's counts, uniform in [0, 4096): a 12-bit camera
STORE_GAP_RTOL = 1e-3  # deskew then deconvolve against reconstruct (BASELINE.md's budget)
STORE_EQUAL_RTOL = 1e-6  # the CLI against the in-process step where not bit-equal
DEMO_CONFIG = "configs/reconstruct_demo.yml"
FIXTURES = "tests/data/ts_fixtures"
ENCODE_CLEVEL = 3  # the blosc-zstd level of the port's stores (io/ngff.py)
ENCODE_ONE_THREAD_BLOCKS = 512  # 4u(a)'s blocks encoded on one thread, for the pool's gain


def run_cli(runs: list) -> tuple[list, float]:
    """The CLI's command lines in turn in this process (``cli.main`` as the
    console script calls it, its standard output captured). Each entry of
    ``runs`` is ``(args, want)``: every count set to 0 just before the run
    and read just after, held to ``want`` as :func:`check_counts` holds them
    (None: only read); a ``(["unlink", path], None)`` entry removes a file
    between two runs. Returns each run's record (``args``, its standard
    output ``out``, its wall seconds ``s``, the counts that were not 0
    ``launches``, the card's peak allocated GiB ``peak_gib``, 0 on the CPU)
    and the seconds in all."""
    import contextlib
    import io
    import os

    from shrimpy_tpu_torch.cli.main import cli

    t0, records = time.monotonic(), []
    for args, want in runs:
        if args[0] == "unlink":
            os.unlink(args[1])
            continue
        sync()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        table = zero_counts()
        out = io.StringIO()
        t1 = time.monotonic()
        with contextlib.redirect_stdout(out):
            cli.main(args=list(args), standalone_mode=False)
        sync()
        counts = {name: getattr(obj, attr) for name, (obj, attr) in table.items()}
        check_counts(counts, want)
        records.append({"args": list(args), "out": out.getvalue(), "s": time.monotonic() - t1,
                        "launches": {k: v for k, v in counts.items() if v},
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30
                        if torch.cuda.is_available() else 0.0})
    return records, time.monotonic() - t0


def sync() -> None:
    """Wait for the card, where there is one (the CPU tests run 4v's pieces)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def store_bytes(root) -> int:
    from pathlib import Path

    return sum(p.stat().st_size for p in Path(root).rglob("*") if p.is_file())


BLOSC_TILE_BLOCKS = 4096  # 4u(a)'s production-size container: 4096 blocks, 1 GiB
BLOSC_TILE_FRAMES = 64  # the fixtures' 4 KiB zstd frames a block: 256 KiB blocks
BLOSC_TILE_KINDS = 4  # distinct blocks, repeated in turn
BLOSC_ONE_THREAD_BLOCKS = 512  # the blocks decoded on one thread, for the pool's gain


def tiled_blosc(chunks, n_blocks: int, frames: int = BLOSC_TILE_FRAMES,
                kinds: int = BLOSC_TILE_KINDS) -> tuple:
    """A blosc 1 container of ``n_blocks`` blocks, each stream ``frames``
    zstd frames copied from the single-block uint16 containers ``chunks``
    (tensorstore's: byte shuffle, zstd, one stream a block), and the bytes
    it decodes to, unshuffled here in numpy. Blosc blocks are independent
    and a block's stream may hold several zstd frames, so it is a
    production chunk of that many blocks in all but its data; ``kinds``
    distinct blocks repeat in turn. Returns (container, decoded), uint8."""
    import numpy as np

    from shrimpy_tpu_torch.io import chunkstore

    pieces, head = [], None
    for c in chunks:
        info = chunkstore.blosc_info(c)
        start = int.from_bytes(c[16:20], "little")
        size = int.from_bytes(c[start:start + 4], "little")
        if info["flags"] != 0x91 or info["typesize"] != 2 or info["units"] != 1 \
                or size == info["nbytes"]:  # not shuffled zstd, or a raw stream
            continue
        head, n = c[:2], info["nbytes"]
        frame = c[start + 4:start + 4 + size]
        pieces.append((frame, chunkstore.zstd_decompress(frame, n)))
    if not pieces or n_blocks % kinds:
        raise ValueError(f"no shuffled zstd uint16 chunk among {len(chunks)}, or {n_blocks} "
                         f"blocks not a multiple of {kinds}")
    streams, plain = [], []
    for g in range(kinds):
        use = [pieces[(g * frames + i) % len(pieces)] for i in range(frames)]
        stream = b"".join(f for f, _ in use)
        streams.append(np.frombuffer(len(stream).to_bytes(4, "little") + stream, np.uint8))
        shuffled = np.frombuffer(b"".join(r for _, r in use), np.uint8)
        plain.append(shuffled.reshape(2, -1).T.reshape(-1))
    block = frames * n
    reps, table = n_blocks // kinds, 16 + 4 * n_blocks
    group = np.concatenate(streams)
    within = np.cumsum([0] + [s.size for s in streams[:-1]])
    starts = table + (np.arange(reps)[:, None] * group.size + within[None, :]).reshape(-1)
    nbytes, cbytes = n_blocks * block, table + reps * group.size
    header = head + bytes([0x91, 2]) + b"".join(
        v.to_bytes(4, "little") for v in (nbytes, block, cbytes))
    container = np.concatenate([np.frombuffer(header, np.uint8),
                                starts.astype("<i4").view(np.uint8), np.tile(group, reps)])
    return container, np.tile(np.concatenate(plain), reps)


def phase_fixtures() -> dict:
    """4u(a): the committed stores tensorstore wrote (``tests/data/ts_fixtures``,
    zarr v2 and v3, blosc-zstd at clevel 3) through the port's chunk engine:
    each array to the SHA-256 recorded when they were made; the decoder's
    mode counters. Then its rate at production size: :func:`tiled_blosc`'s
    1 GiB container of the fixtures' frames, decoded twice by
    ``chunkstore.blosc_decode`` (its blocks on the decode pool), held to its
    bytes, and its first BLOSC_ONE_THREAD_BLOCKS blocks on one thread."""
    import hashlib
    import os
    from pathlib import Path

    import numpy as np

    from shrimpy_tpu_torch.io import chunkstore

    root = Path(__file__).resolve().parent / FIXTURES
    want = json.loads((root / "hashes.json").read_text())
    chunkstore.reset_counters()
    for name, rec in sorted(want.items()):
        store, array = name.rsplit("/", 1)
        spec = {"driver": "zarr" if "v2" in store else "zarr3",
                "kvstore": {"driver": "file", "path": str(root / store / array)}}
        got = np.ascontiguousarray(chunkstore.open(spec).result().read().result())
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        if list(got.shape) != rec["shape"] or got.dtype.name != rec["dtype"] \
                or digest != rec["sha256"]:
            raise AssertionError(f"(a) fixture {name}: {got.shape} {got.dtype} {digest}, want "
                                 f"{rec}")
    seen = {k: v for k, v in chunkstore.counters().items() if v}
    chunks = [p.read_bytes() for p in sorted(root.rglob("*"))
              if p.is_file() and p.name[0].isdigit() and p.parent.name != "ts_fixtures"]
    container, plain = tiled_blosc(chunks, BLOSC_TILE_BLOCKS)
    decoded, secs = np.empty(plain.size, np.uint8), []
    for _ in range(2):
        t0 = time.perf_counter()
        chunkstore.blosc_decode(container, decoded, key="tiled")
        secs.append(time.perf_counter() - t0)
    if not np.array_equal(decoded, plain):
        raise AssertionError("(a) the tiled container decodes to other bytes")
    one = BLOSC_ONE_THREAD_BLOCKS
    counts = np.zeros(len(chunkstore.COUNTERS), np.int64)
    t0 = time.perf_counter()
    rc = chunkstore.codec().zc_blosc_decode(container.ctypes.data, container.size,
                                            decoded.ctypes.data, decoded.size, 0, one,
                                            counts.ctypes.data)
    one_s = time.perf_counter() - t0
    if rc != 0 or not np.array_equal(decoded, plain):
        raise AssertionError(f"(a) the tiled container on one thread: rc {rc}")
    block = plain.size // BLOSC_TILE_BLOCKS
    res = {"arrays": len(want), "counters": seen, "decoded_bytes": int(plain.size),
           "compressed_bytes": int(container.size), "blocks": BLOSC_TILE_BLOCKS,
           "block_bytes": block, "s": secs, "mb_s": plain.size / min(secs) / 1e6,
           "one_thread_mb_s": one * block / one_s / 1e6, "threads": os.cpu_count()}
    print(f"  (a) {len(want)} tensorstore arrays in {FIXTURES} decoded to their SHA-256; the "
          f"decoder's counters {seen}; a blosc-zstd container of {BLOSC_TILE_BLOCKS} blocks of "
          f"{block} bytes ({BLOSC_TILE_FRAMES} of the fixtures' frames a block), "
          f"{res['compressed_bytes']} bytes to {res['decoded_bytes']}: "
          f"{[round(t, 4) for t in secs]} s, {res['mb_s']:.1f} MB/s on the decode pool "
          f"({res['threads']} cores), {res['one_thread_mb_s']:.1f} MB/s on one thread "
          f"({one} blocks), bytes as built", flush=True)
    return res


def camera_raw():
    """A production raw of camera counts from 4m's generator: TRACK_BLOBS
    blobs on the camera offset TRACK_BACKGROUND with N(0, TRACK_NOISE)
    noise (:func:`track_raws`' first timepoint), rendered on the card from
    its own seed and rounded to uint16 on the host (0.98 GB)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    centers, amps = track_blobs(gen)
    raw = track_raw(centers, amps).add_(torch.randn(RAW_SHAPE, generator=gen, device="cuda"),
                                        alpha=TRACK_NOISE)
    counts = camera_counts(raw)
    del raw
    torch.cuda.empty_cache()
    return counts


def camera_counts(raw: torch.Tensor):
    """A raw on the card as a camera gives it: rounded, clamped to uint16, on
    the host (numpy)."""
    import numpy as np

    return raw.round().clamp_(0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)


def phase_encode() -> dict:
    """4u(a), the encoder: :func:`camera_raw` as one blosc-zstd chunk at
    ENCODE_CLEVEL with byte shuffle (the codec of the port's stores), twice
    by ``chunkstore.blosc_encode`` (block ranges on the codec pool), and its
    first ENCODE_ONE_THREAD_BLOCKS blocks on one thread, to the pool's
    bytes; the container decoded back by the port's decoder, bit for bit,
    and its block, literal and sequence modes from the decoder's counters."""
    import numpy as np

    from shrimpy_tpu_torch.io import chunkstore

    raw = camera_raw()
    src = raw.reshape(-1).view(np.uint8)
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        pieces = chunkstore.blosc_encode(raw, 2, True, ENCODE_CLEVEL, key="camera")
        secs.append(time.perf_counter() - t0)
    container = np.concatenate([np.asarray(p).reshape(-1).view(np.uint8) for p in pieces])
    info = chunkstore.blosc_info(container)
    if info["flags"] != 0x91 or info["nbytes"] != src.size:
        raise AssertionError(f"(a) the camera raw's container: {info}")
    units, block = info["units"], info["blocksize"]
    one = min(ENCODE_ONE_THREAD_BLOCKS, units)
    buf, sizes = np.empty(one * (block + 4), np.uint8), np.zeros(one, np.int64)
    t0 = time.perf_counter()
    got = chunkstore.codec().zc_blosc_encode(src.ctypes.data, src.size, 2, 1, ENCODE_CLEVEL, 0,
                                             one, buf.ctypes.data, buf.size, sizes.ctypes.data)
    one_s = time.perf_counter() - t0
    at = 16 + 4 * units
    if got != int(sizes.sum()) or not np.array_equal(buf[:got], container[at:at + got]):
        raise AssertionError(f"(a) {one} blocks on one thread: {got} bytes, not the pool's")
    chunkstore.reset_counters()
    t0 = time.perf_counter()
    decoded = chunkstore.blosc_decode(container, key="camera")
    decode_s = time.perf_counter() - t0
    if not np.array_equal(decoded, src):
        raise AssertionError("(a) the camera raw's container decodes to other bytes")
    modes = {k: v for k, v in chunkstore.counters().items() if v}
    if not modes.get("block_compressed"):
        raise AssertionError(f"(a) no compressed zstd block in the camera raw's container: {modes}")
    res = {"raw_bytes": int(src.size), "bytes": int(container.size),
           "ratio": container.size / src.size, "s": secs, "mb_s": src.size / min(secs) / 1e6,
           "one_thread_mb_s": one * block / one_s / 1e6, "decode_mb_s": src.size / decode_s / 1e6,
           "blocks": units, "block_bytes": block, "modes": modes}
    print(f"  (a) the encoder: a camera raw {RAW_SHAPE} uint16 ({TRACK_BLOBS} blobs on "
          f"{TRACK_BACKGROUND:g} with N(0, {TRACK_NOISE:g}) noise), blosc-zstd clevel "
          f"{ENCODE_CLEVEL} with byte shuffle, {units} blocks of {block} bytes: {res['bytes']} "
          f"bytes for {res['raw_bytes']} ({res['ratio']:.4f}); {[round(t, 4) for t in secs]} s, "
          f"{res['mb_s']:.1f} MB/s on the codec pool, {res['one_thread_mb_s']:.1f} MB/s on one "
          f"thread ({one} blocks, the pool's bytes); decoded back bit for bit at "
          f"{res['decode_mb_s']:.1f} MB/s; modes {modes}", flush=True)
    return res


def store_inputs(tmp=None) -> dict:
    """4u's input stores, written by the port's ``io/ngff.py::create_fov`` in
    ``tmp``, or a temporary directory (removed at exit): ``raw.zarr``, an FOV store
    (OME-NGFF 0.5) of ``STORE_TIMEPOINTS`` timepoints of one channel at the
    production raw, uint16 from the seed, with the scale
    ``configs/reconstruct_demo.yml`` reads (pixel 0.116 um, scan step
    0.116 / 0.386 um), and ``raw1.zarr``, a copy of its first timepoint.
    Host work only: ``run_phases`` runs it in a thread beside phases 4n-4p."""
    import atexit
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from shrimpy_tpu_torch.io import ngff

    t0 = time.monotonic()
    if tmp is None:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_4u_"))
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    scale = loop_raw_scale(headline_settings().deskew)
    rng = np.random.default_rng(SEED + 21)
    pos = ngff.create_fov(tmp / "raw.zarr", shape=(STORE_TIMEPOINTS, 1, *RAW_SHAPE),
                          dtype="uint16", zyx_scale=scale, version="0.5")
    raws = []
    for t in range(STORE_TIMEPOINTS):
        raws.append(rng.integers(0, STORE_RAW_MAX, RAW_SHAPE, dtype=np.uint16))
        pos.write((t, 0), raws[-1])
    write_s = time.monotonic() - t0
    ngff.create_fov(tmp / "raw1.zarr", shape=(1, 1, *RAW_SHAPE), dtype="uint16",
                    zyx_scale=scale, version="0.5").write((0, 0), raws[0])
    return {"tmp": tmp, "raws": raws, "write_s": write_s, "seconds": time.monotonic() - t0}


def phase_store(inputs: dict | None = None) -> dict:
    """4u: the store path end to end, as users run it, on the card.

    (a) :func:`phase_fixtures`. (b) On :func:`store_inputs`' ``raw.zarr``
    (``inputs``; made here when None): ``python3 -m
    shrimpy_tpu_torch.cli.main reconstruct IN -o OUT -c
    configs/reconstruct_demo.yml`` in a subprocess with ``--device`` at its
    default (deskew, then RL-20 on ``auto``: the deskew kernel and the
    one-launch half-step, through ``reconstruct_store``'s prefetch,
    ``DeviceFeed`` and async writes); each output volume read back with the
    port's engine and held to ``build_reconstruct_step`` run here on the raw
    read back from the input store, bit for bit (else within
    ``STORE_EQUAL_RTOL`` of its max); the wall seconds, the run summary's
    stages, the output's bytes on disk against its raw bytes, the peak.
    Then the CLI runs in turn in this process (:func:`run_cli`, the counts
    set to 0 before each run and read after it): (c) the same command with
    ``--resume``, which does no volume and launches nothing, and again with
    one output chunk file deleted, which redoes that volume alone, to the
    same bits, with 1 deskew and 2 * ITERATIONS one-launch half-steps; (d)
    ``deskew`` (1 deskew) then ``deconvolve`` (2 * ITERATIONS half-steps) on
    ``raw1.zarr``, at the same width, within ``STORE_GAP_RTOL`` of (b)'s
    first volume. The stores stay for phase 4v (``store_inputs`` removes
    their directory at exit)."""
    t_start = time.monotonic()
    fixtures = phase_fixtures()
    encode = phase_encode()
    inputs = inputs or store_inputs()
    res = phase_store_runs(inputs["tmp"], inputs["raws"])
    res.update(fixtures=fixtures, encode=encode, write_input_s=inputs["write_s"],
               inputs_s=inputs["seconds"], seconds=time.monotonic() - t_start)
    print(f"  phase 4u took {res['seconds']:.1f} s (its inputs, {inputs['seconds']:.1f} s, "
          "written beside the phases before)", flush=True)
    return res


def store_step(cfg, src) -> tuple:
    """``build_reconstruct_step`` on the card as ``reconstruct -c cfg``
    builds it for the store ``src`` (its scale injected), and ``src``'s
    position."""
    from shrimpy_tpu_torch.cli.main import _inject_from_store
    from shrimpy_tpu_torch.config.schemas import ReconstructSettings, load_yaml_config
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step
    from shrimpy_tpu_torch.runtime.stream import _load_psf

    settings = load_yaml_config(cfg, ReconstructSettings)
    _, pos = _inject_from_store(settings, Path(src))
    return build_reconstruct_step(settings, psf=_load_psf(settings), device="cuda"), pos


def phase_store_runs(tmp, raws) -> dict:
    """(b)-(d) of :func:`phase_store` on the input stores in ``tmp``; keeps
    (b)'s first volume on the card (``recon0``) for phase 4v."""
    import os

    import numpy as np

    from shrimpy_tpu_torch.io import chunkstore, ngff

    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    torch.cuda.empty_cache()
    src, out = tmp / "raw.zarr", tmp / "recon.zarr"
    raw_bytes = STORE_TIMEPOINTS * int(np.prod(RAW_SHAPE)) * 2
    res: dict = {"in_disk": store_bytes(src), "in_raw": raw_bytes}
    if not res["in_disk"] < raw_bytes:
        raise AssertionError(f"(b) the input store takes {res['in_disk']} bytes for {raw_bytes}")
    print(f"  (b) input {src.name}: {STORE_TIMEPOINTS} x 1 x {RAW_SHAPE} uint16 in [0, "
          f"{STORE_RAW_MAX}), {res['in_disk']} bytes on disk for {raw_bytes} raw "
          f"({res['in_disk'] / raw_bytes:.6f}; its last z chunk of 512 planes holds "
          f"{RAW_SHAPE[0] % 512})", flush=True)

    t0 = time.monotonic()
    cmd = [sys.executable, "-m", "shrimpy_tpu_torch.cli.main", "reconstruct", str(src),
           "-o", str(out), "-c", str(repo / DEMO_CONFIG)]
    # Its log (the stages' lines once the volumes are done) timed as it
    # arrives: the first line less the stages bounds the child's start from
    # below (stages may overlap), the exit less the last line is its end.
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    log: list = []
    reader = threading.Thread(target=lambda: log.extend(
        (time.monotonic() - t0, line) for line in proc.stderr), daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"(b) reconstruct ran past 600 s: {''.join(l for _, l in log)[-4000:]}")
    reader.join()
    res["cli_s"] = time.monotonic() - t0
    if rc != 0 or not log:
        raise AssertionError(f"(b) reconstruct exited {rc}: {''.join(l for _, l in log)[-4000:]}")
    summary = json.loads((out / "reconstruct_summary.json").read_text())
    res["child_s"] = {"first_line": log[0][0], "stages": sum(summary["stages"].values()),
                      "end": res["cli_s"] - log[-1][0], "first": log[0][1].strip()}
    if summary["volumes"] != STORE_TIMEPOINTS or summary["failed"] \
            or not summary["device"].startswith("cuda"):
        raise AssertionError(f"(b) the run summary {summary}")
    out_bytes = int(np.prod(summary["out_shape"])) * 4 * STORE_TIMEPOINTS
    res.update(stages=summary["stages"], out_shape=tuple(summary["out_shape"]),
               out_disk=store_bytes(out), out_raw=out_bytes,
               peak_gib=summary["device_memory_gib"].get("cuda:0.peak_allocated"),
               chunks=tuple(ngff.open_ngff(out).position().array()
                            .chunk_layout.read_chunk_template.shape))
    if not res["out_disk"] < out_bytes:
        raise AssertionError(f"(b) the output takes {res['out_disk']} bytes for {out_bytes}")
    print(f"  (b) `python3 -m shrimpy_tpu_torch.cli.main reconstruct raw.zarr -o recon.zarr -c "
          f"{DEMO_CONFIG}` on {summary['device']}: {res['cli_s']:.2f} s wall; stages "
          f"{summary['stages']}; the child's first log line at "
          f"{res['child_s']['first_line']:.2f} s ({res['child_s']['first']!r}; its stages sum "
          f"{res['child_s']['stages']:.2f} s), its exit {res['child_s']['end']:.2f} s after its "
          f"last; output {res['out_shape']} float32 in chunks "
          f"{res['chunks']}, {res['out_disk']} bytes on disk for {out_bytes} raw "
          f"({res['out_disk'] / out_bytes:.6f}); peak "
          f"{res['peak_gib']:.2f} GiB", flush=True)

    step, in_pos = store_step(repo / DEMO_CONFIG, src)
    got_pos = ngff.open_ngff(out).position()

    def on_card(vol) -> torch.Tensor:
        return torch.from_numpy(vol).cuda()

    def gap(got: torch.Tensor, want: torch.Tensor) -> float:
        return 0.0 if torch.equal(got, want) else float(
            (got - want).abs().max() / want.abs().max())

    outs, res["gap"] = [], 0.0
    t0 = time.monotonic()
    chunkstore.reset_counters()
    for t in range(STORE_TIMEPOINTS):
        raw = in_pos.read((t, 0))
        if not np.array_equal(raw, raws[t]):
            raise AssertionError(f"(b) timepoint {t} of the input store reads back changed")
        want, counts, _ = drive(lambda b: step(b, None), on_card(raw.astype(np.float32)[None]),
                                None)
        if counts["deskew"] != 1 or counts["rl_half_one_launch"] != 2 * ITERATIONS:
            raise AssertionError(f"(b) the in-process step's launches {counts}")
        got = on_card(got_pos.read((t, 0)))
        res["gap"] = max(res["gap"], gap(got, want[0]))
        if not res["gap"] <= STORE_EQUAL_RTOL:
            raise AssertionError(f"(b) timepoint {t}: the CLI's volume is {res['gap']:.3e} of "
                                 "max from the in-process step's")
        outs.append(got)
        del want
    res["check_s"] = time.monotonic() - t0
    res["read_counts"] = {k: v for k, v in chunkstore.counters().items() if v}
    if not res["read_counts"].get("block_compressed"):
        raise AssertionError(f"(b) no compressed block read back: {res['read_counts']}")
    del step
    torch.cuda.empty_cache()
    print(f"  (b) each output volume "
          + ("bit-equal to" if res["gap"] == 0.0 else f"within {res['gap']:.3e} of")
          + " build_reconstruct_step run here on the raw read back (its launches: 1 deskew "
          f"and {2 * ITERATIONS} rl_half a volume); reads and checks {res['check_s']:.2f} s; the "
          f"decoder's counters over the reads {res['read_counts']}", flush=True)

    last = STORE_TIMEPOINTS - 1
    chunk = out / "0" / "c" / str(last) / "0" / "0" / "0" / "0"
    if not chunk.is_file():
        raise AssertionError(f"(c) no chunk file {chunk}")
    desk, deconv = tmp / "deskewed.zarr", tmp / "deconvolved.zarr"
    resume = cmd[3:] + ["--resume"]
    rl = {"rl_half_step": 2 * ITERATIONS, "rl_half_one_launch": 2 * ITERATIONS}
    runs = [(resume, {}), (["unlink", str(chunk)], None), (resume, {"deskew": 1, **rl}),
            (["deskew", str(tmp / "raw1.zarr"), "-o", str(desk), "--ls-angle-deg", "30"],
             {"deskew": 1}),
            (["deconvolve", str(desk), "-o", str(deconv), "--iterations", str(ITERATIONS)], rl)]
    records, res["runs_s"] = run_cli(runs)
    noop, redo = (json.loads(r["out"]) for r in records[:2])  # the verbs' summaries
    launches = [r["launches"] for r in records]
    res["launches"] = {k: sum(c.get(k, 0) for c in launches) for k in ("deskew", *rl)}
    if noop["volumes"] != 0 or noop["skipped_resume"] != STORE_TIMEPOINTS:
        raise AssertionError(f"(c) the first --resume did work: {noop}")
    if redo["volumes"] != 1 or redo["skipped_resume"] != last:
        raise AssertionError(f"(c) --resume after deleting {chunk.name} of timepoint {last}: "
                             f"{redo}")
    if not torch.equal(on_card(ngff.open_ngff(out).position().read((last, 0))), outs[last]):
        raise AssertionError(f"(c) timepoint {last} redone differs from its first run")
    print(f"  (c) --resume: no volume, no launch; with {chunk.relative_to(out)} deleted: "
          f"timepoint {last} alone redone, bit-equal, launches {launches[1]}", flush=True)
    got = on_card(ngff.open_ngff(deconv).position().read((0, 0)))
    if got.shape != outs[0].shape:
        raise AssertionError(f"(d) deskew -> deconvolve gave {tuple(got.shape)}, reconstruct "
                             f"{tuple(outs[0].shape)}")
    res["verbs_gap"] = gap(got, outs[0])
    if not res["verbs_gap"] <= STORE_GAP_RTOL:
        raise AssertionError(f"(d) deskew -> deconvolve is {res['verbs_gap']:.3e} of max from "
                             "reconstruct")
    print(f"  (d) deskew then deconvolve (RL-{ITERATIONS}) on a one-timepoint copy: "
          f"{res['verbs_gap']:.3e} of max from (b)'s volume, launches {launches[2]} then "
          f"{launches[3]}; (c) and (d) through the CLI in this process {res['runs_s']:.2f} s",
          flush=True)
    res["recon0"] = outs[0]
    del outs, got
    torch.cuda.empty_cache()
    return res


# --- Phase 4v: the rest of the CLI on the card, each verb as the console
# script runs it (``cli.main(args=..., standalone_mode=False)``), ``--device``
# at its default, on stores the port's io/ngff.py writes (blosc-zstd).
VERB_PHASE_SCALE = (0.25, 0.116, 0.116)  # phase_tf's z and yx pixel: the verb's TF is 4l's
PAIR_CHANNELS = ("phase", "nuclei", "membrane")  # train-vs's store: the input and two targets
# 25 steps: the verb validates every 25 (``train_vsunet``'s default), so one
# validation runs and the best weights are its.
TRAIN_VERB_ARGS = ["--steps", "25", "--batch", "4", "--patch", "128", "--learning-rate", "1e-4"]
REG_OFFSET_TOL, REG_DIAG_TOL = 0.3, 0.02  # 4g's gates on a recovered map: px, the diagonal
DRIFT_ATOL = 1.0  # px: pcc's shift against the drift baked into the frames (4m's gate)


def fov_store(path, volumes, channels, zyx_scale):
    """An FOV store (OME-NGFF 0.5, the port's ``io/ngff.py``: blosc-zstd) of
    ``volumes[t][c]`` (numpy arrays of one dtype and shape), with the
    channel names and the scale given, in the store runtime's chunks (a
    volume past blosc's largest chunk split in z). Returns its path."""
    from pathlib import Path

    from shrimpy_tpu_torch.io import ngff
    from shrimpy_tpu_torch.runtime.stream import _output_chunks

    first = volumes[0][0]
    shape, dtype = (len(volumes), len(channels), *first.shape), str(first.dtype)
    pos = ngff.create_fov(path, shape=shape, dtype=dtype, channel_names=list(channels),
                          zyx_scale=tuple(zyx_scale), chunks=_output_chunks(shape, dtype),
                          version="0.5")
    for t, vols in enumerate(volumes):
        for c, vol in enumerate(vols):
            pos.write((t, c), vol)
    return Path(path)


def pair_volumes(phase) -> list:
    """train-vs's channels of one volume: the input and the targets
    ``tanh(2 x)`` and ``sin(3 x)`` (:class:`MemoryPosition`'s)."""
    import numpy as np

    return [phase, np.tanh(2 * phase), np.sin(3 * phase)]


VERB_CHANNELS = {"beads": ["beads"], "lf": ["phase"], "ls": ["gfp"], "cfg2_raw": ["LS"],
                 "session": ["BF"], "bf": ["BF"], "lf_session": ["BF"],
                 "pairs": list(PAIR_CHANNELS)}


def verb_inputs(tmp, data: dict) -> dict:
    """4v's input stores ``<name>.zarr`` in ``tmp``, one for each entry of
    ``data``: ``beads`` (the bead raw), ``lf`` and ``ls`` (the registration's
    fixed and moving volumes), ``cfg2_raw`` (the raw config 2 deconvolves)
    and ``bf`` (a brightfield stack) a volume each; ``session``,
    ``lf_session`` and ``pairs`` a list of timepoints' volumes (``pairs``
    each a training volume with its targets, :func:`pair_volumes`). The
    channels are VERB_CHANNELS'; the raws (``beads``, ``cfg2_raw``,
    ``session``) take the raw's scale, the phase stacks VERB_PHASE_SCALE,
    the others a cubic BEAD_PX_UM. Returns their ``paths`` by name, what
    was ``written`` (path: (shape TCZYX, scale)) and the seconds."""
    from pathlib import Path

    t0 = time.monotonic()
    raw, cubic = loop_raw_scale(headline_settings().deskew), (BEAD_PX_UM,) * 3
    scales = {"beads": raw, "cfg2_raw": raw, "session": raw, "bf": VERB_PHASE_SCALE,
              "lf_session": VERB_PHASE_SCALE}
    out: dict = {"paths": {}, "written": {}}
    for name, value in data.items():
        vols = ([pair_volumes(v) for v in value] if name == "pairs" else
                [[v] for v in value] if isinstance(value, list) else [[value]])
        scale = scales.get(name, cubic)
        path = str(fov_store(Path(tmp) / f"{name}.zarr", vols, VERB_CHANNELS[name], scale))
        out["paths"][name] = path
        out["written"][path] = ((len(vols), len(vols[0]), *vols[0][0].shape), scale)
    out["seconds"] = time.monotonic() - t0
    return out


def lf_session_frames(n_t: int) -> list:
    """The label-free arm's timepoints for replay-dual: brightfield camera
    counts (uint16 in [900, 1100)) at PHASE_SMALL_SHAPE, from a seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 23)
    return [rng.integers(900, 1100, PHASE_SMALL_SHAPE, dtype=np.uint16) for _ in range(n_t)]


def verb_configs(tmp, psf_npy, transform, n_timepoints: int, deconvolve: str = "") -> dict:
    """The YAMLs 4v's verbs read, written in ``tmp``: ``cfg2.yml`` and
    ``cfg4.yml`` (``configs/reconstruct_demo.yml`` with ``psf_path`` the
    measured PSF's ``.npy``, and with ``registration.transform_path`` the
    register verb's JSON; ``deconvolve`` adds lines to its deconvolve
    block), ``phase.yml`` (the phase settings' defaults), ``plan.yml``
    (``configs/plan_demo.yml`` at ``n_timepoints``), ``track_deskew.yml``
    (``configs/dynatrack_demo.yml`` with ``preprocessing: [deskew]``) and
    ``dual.yml`` (arms ``labelfree`` on ``lf_session.zarr`` and
    ``lightsheet`` on ``session.zarr`` with the plan's DynaTrack block).
    Returns {name: path}."""
    from pathlib import Path

    import yaml

    tmp, repo = Path(tmp), Path(__file__).resolve().parent
    demo = (repo / DEMO_CONFIG).read_text()
    tol = "  separable_tol: 1.0e-4\n"
    plan = (repo / "configs/plan_demo.yml").read_text()
    track = (repo / "configs/dynatrack_demo.yml").read_text()
    if demo.count(tol) != 1 or plan.count("  n_timepoints: 4\n") != 1 \
            or track.count("# preprocessing: [deskew, phase, vs]\n") != 1:
        raise AssertionError("the demo configs changed: 4v's edits of them no longer apply")
    texts = {
        "cfg2": demo.replace(tol, f"{tol}{deconvolve}  psf_path: {psf_npy}\n"),
        "cfg4": demo.replace(tol, tol + deconvolve)
        + f"\nregistration:\n  transform_path: {transform}\n",
        "phase": "transfer_function:\n  z_padding: 5\n",
        "plan": plan.replace("  n_timepoints: 4\n", f"  n_timepoints: {n_timepoints}\n"),
        "track_deskew": track.replace("# preprocessing: [deskew, phase, vs]\n",
                                      "preprocessing: [deskew]\ndeskew:\n  ls_angle_deg: 30.0\n"),
    }
    paths = {k: tmp / f"{k}.yml" for k in texts}
    for k, text in texts.items():
        paths[k].write_text(text)
    arm_plan = yaml.safe_load(texts["plan"])
    dual = {"arms": {
        "labelfree": {"input": str(tmp / "lf_session.zarr"),
                      "plan": {"time": {"n_timepoints": n_timepoints}}},
        "lightsheet": {"input": str(tmp / "session.zarr"), "plan": arm_plan}},
        "barrier_timeout_s": LOOP_DRAIN_S}
    paths["dual"] = tmp / "dual.yml"
    paths["dual"].write_text(yaml.safe_dump(dual, sort_keys=False))
    paths["track"] = repo / "configs/dynatrack_demo.yml"
    return {k: str(v) for k, v in paths.items()}


def verb_runs(tmp, paths: dict, cfgs: dict, device: str | None = None) -> dict:
    """4v's command lines by letter, in the order an operator runs them:
    (a) measure-psf, (b) register, (c) reconstruct with the measured PSF,
    (d) with the transform, (e) on a one-device mesh, (g) phase, (i) track
    without and with a deskew, (h) ``plan validate`` then replay, (j)
    replay-dual, (k) train-vs, each verb that computes with ``device``
    appended as ``--device`` (None: at its default); (f) the verbs with no
    device: ``monitor --once`` of (d)'s and (h)'s stores, ``microscopes``
    and ``plan show``."""
    from pathlib import Path

    tmp = Path(tmp)
    dev = [] if device is None else ["--device", device]
    return {
        "a": [["measure-psf", paths["beads"], "-o", str(tmp / "psf"), "--geometry", "lightsheet",
               "--ls-angle-deg", "30", *dev]],
        "b": [["register", paths["lf"], "--fixed-channel", "phase", "--moving-input",
               paths["ls"], "--moving-channel", "gfp", "-o", str(tmp / "transform.json"), *dev]],
        "c": [["reconstruct", paths["cfg2_raw"], "-o", str(tmp / "cfg2.zarr"), "-c",
               cfgs["cfg2"], *dev]],
        "d": [["reconstruct", paths["raw1"], "-o", str(tmp / "cfg4.zarr"), "-c", cfgs["cfg4"],
               *dev]],
        "e": [["reconstruct", paths["raw1"], "-o", str(tmp / "mesh1.zarr"), "-c",
               str(Path(__file__).resolve().parent / DEMO_CONFIG), "--devices", "1", *dev]],
        "g": [["phase", paths["bf"], "-o", str(tmp / "phase.zarr"), "--config", cfgs["phase"],
               *dev]],
        "i": [["track", paths["session"], "-c", cfgs["track"], "-o", str(tmp / "shifts.csv"),
               *dev],
              ["track", paths["session"], "-c", cfgs["track_deskew"], "-o",
               str(tmp / "shifts_deskew.csv"), *dev]],
        "h": [["plan", "validate", cfgs["plan"], "--input", paths["session"]],
              ["replay", paths["session"], "-o", str(tmp / "replay"), "-n", "demo", "--plan",
               cfgs["plan"], *dev]],
        "j": [["replay-dual", cfgs["dual"], "-o", str(tmp / "dual"), "-n", "session", *dev]],
        "k": [["train-vs", paths["pairs"], "--input-channel", "phase", "--target-channels",
               ",".join(PAIR_CHANNELS[1:]), "-o", str(tmp / "ckpt"), *TRAIN_VERB_ARGS, *dev]],
        "f": [["monitor", str(tmp / "cfg4.zarr"), "--once"],
              ["monitor", str(tmp / "replay" / "demo.zarr"), "--once"],
              ["microscopes"], ["plan", "show", cfgs["plan"]]],
    }


def journal_rows(path) -> list:
    """A DynaTrack journal's rows (``ShiftJournal.rows``), its numbers as
    floats."""
    from shrimpy_tpu_torch.tracking.core import ShiftJournal

    return [{k: v if k in ("position", "method") else float(v) for k, v in row.items()}
            for row in ShiftJournal(path).rows()]


def journal_shifts(rows) -> list:
    return [[r["shift_z_px"], r["shift_y_px"], r["shift_x_px"]] for r in rows]


JOURNAL_UM_ATOL = 5e-5  # the journal writes the stage's moves to 4 decimals (um)


def stage_position(rows, before: float = math.inf) -> list:
    """The stage (x, y, z) um after the journal's updates of the timepoints
    before ``before``, from 0: each update sets the position acquired at
    less its stage shift (``tracking/core.py::corrected_position``)."""
    moves = [r for r in rows if r["timepoint"] < before]
    return [-sum(r[f"stage_d{a}_um"] for r in moves) for a in "xyz"]


def stage_offsets(rows, zyx_scale, n_timepoints: int, lag: int = 0) -> list:
    """The stage offset, whole pixels (ZYX) of a source at ``zyx_scale``,
    under which each timepoint was acquired: :func:`stage_position` before
    it (the tracking arm drains every update before the next timepoint),
    mapped as ``AcquisitionEngine._stage_offset_px`` maps the stage. With
    ``lag`` 1, after its own update too: an arm that shares the stage but
    does not track reads it at its own pace, before or after the tracking
    arm's update of the same timepoint lands."""
    sz, sy, sx = zyx_scale
    out = []
    for t in range(n_timepoints):
        x, y, z = stage_position(rows, t + lag)
        out.append((int(round(z / sz)), int(round(y / sy)), int(round(x / sx))))
    return out


def store_frames(path, device) -> list:
    """A one-channel store's timepoints (:func:`store_volume`)."""
    from shrimpy_tpu_torch.io.ngff import open_ngff

    return [store_volume(path, t, device=device)
            for t in range(open_ngff(path).position().shape[0])]


def replayed_as_served(frames: list, output, offsets, later=None) -> list:
    """Each timepoint of ``output``'s one position (one channel) against its
    source's frame (``frames``, :func:`store_frames`) rolled by minus its
    stage offset (``engine/replay.py::ReplaySource``), or by minus its
    ``later`` one where given (:func:`stage_offsets` with ``lag`` 1), on the
    frames' device: bit for bit, or AssertionError. Returns the offsets the
    frames were served at that moved them."""
    from shrimpy_tpu_torch.io.ngff import open_ngff

    (out,) = open_ngff(output).positions().values()
    if out.shape != (len(frames), 1, *frames[0].shape):
        raise AssertionError(f"{output}: shape {out.shape}, its source {len(frames)} x "
                             f"{tuple(frames[0].shape)}")
    served = []
    for t, frame in enumerate(frames):
        got = torch.from_numpy(out.volume(t, 0)).to(frame.device)
        offs = list(dict.fromkeys([offsets[t], *([later[t]] if later else [])]))
        off = next((o for o in offs if torch.equal(
            got, torch.roll(frame, tuple(-v for v in o), dims=(0, 1, 2)))), None)
        if off is None:
            raise AssertionError(f"{output}: t={t} is not its source's frame rolled by minus a "
                                 f"stage offset of {offs}")
        served.append(off)
    return [off for off in served if any(off)]


def config2_want(psf, deconv) -> dict:
    """The launches of deskew + RL-``deconv.iterations`` with ``psf`` at the
    production raw on ``fused`` (4p's count, and 4v(c)'s): the deskew, a
    half-step each, one ``rl_half`` launch a half-step or, past its block,
    three a term with the compiled passes where the tap lists allow. Returns
    {"want", "terms", "psf_w", "radii", "carry", "route", "layout"}."""
    from shrimpy_tpu_torch.ops.deconv import plan_terms, prepare_psf
    from shrimpy_tpu_torch.ops.rl_fused import (
        axis_pass_route,
        half_layout,
        half_step_route,
        x_pass_route,
    )

    psf_w = prepare_psf(psf, deconv)
    terms = plan_terms(psf_w, deconv)
    if terms is None:
        raise AssertionError(f"measured PSF {psf_w.shape} takes no separable terms")
    radii = tuple(k // 2 for k in psf_w.shape)
    carry = tuple(n + 2 * r for n, r in zip(deskewed_shape(), radii))
    route = half_step_route(carry, radii, len(terms))
    halves = 2 * deconv.iterations
    per_half = 1 if route == "one_launch" else 3 * len(terms)
    want = {"deskew": 1, "rl_half_step": halves, f"rl_half_{route}": halves * per_half}
    if route == "three_pass":
        want["axis_pass"] = halves * len(terms) * sum(
            axis_pass_route(k) == "compiled" for k in psf_w.shape[:2])
        want["x_pass"] = halves * len(terms) * (
            x_pass_route(carry[2], psf_w.shape[2]) == "compiled")
    return {"want": want, "terms": terms, "psf_w": psf_w, "radii": radii, "carry": carry,
            "route": route, "layout": half_layout(carry, radii, len(terms)) or {}}


def verb_line(tag: str, recs: list, checks: str, where: str = "on cuda (--device at its "
              "default)") -> None:
    """A 4v run's line: its verbs, where they ran, seconds, launches, the
    card's peak and its checks."""
    verbs = " then ".join(f"`{' '.join(r['args'][:2])}`" for r in recs)
    print(f"  ({tag}) {verbs}: exit 0 {where}, {sum(r['s'] for r in recs):.2f} s, "
          f"launches {[r['launches'] for r in recs]}, peak "
          f"{max(r['peak_gib'] for r in recs):.2f} GiB; {checks}", flush=True)


def store_volume(path, t: int = 0, c: int = 0, device="cuda") -> torch.Tensor:
    """A store's volume in float32 on ``device`` (a camera's uint16 made
    float on the host, as the store runtime reads it)."""
    import numpy as np

    from shrimpy_tpu_torch.io.ngff import open_ngff

    vol = open_ngff(path).position().volume(t, c)
    return torch.from_numpy(np.ascontiguousarray(vol, dtype=np.float32)).to(device)


def verb_psf(tmp, paths, runs, refs) -> dict:
    """(a) measure-psf of the bead store: one deskew launch; its PSF and
    report bit for bit 4p's ``measure_volume_psf`` of the same raw with the
    same defaults (``refs["psf"]``): 4v measures nothing in process."""
    import numpy as np

    (rec,), _ = run_cli([(runs["a"][0], {"deskew": 1})])
    report = json.loads(rec["out"])
    psf = np.load(tmp / "psf.npy")
    want, against = refs["psf"], "4p's measure_volume_psf of the same raw"
    if not (np.array_equal(psf, want["psf"])
            and json.dumps(report, sort_keys=True) == json.dumps(want["report"], sort_keys=True)):
        raise AssertionError(f"(a) the verb's PSF ({report}) is not {against} ({want['report']})")
    verb_line("a", [rec], f"PSF {psf.shape} from {report['n_beads']} beads, FWHM zyx "
              f"{np.round(report['fwhm_um_zyx'], 4).tolist()} um, bit for bit {against}")
    return {"n_beads": report["n_beads"], "fwhm_um_zyx": report["fwhm_um_zyx"], "rec": rec,
            "psf_npy": str(tmp / "psf.npy")}


def verb_register(tmp, paths, runs, refs) -> dict:
    """(b) register across the two single-arm stores (``pcc+refine``, the
    defaults): 4g's launches; the JSON's map against the truth's inverse
    within 4g's gates and bit for bit 4g's ``estimate_registration`` of the
    same volumes (``refs["register"]``): 4v estimates nothing in process."""
    import numpy as np

    from shrimpy_tpu_torch.config import registration_settings

    iters = registration_settings().refine_iterations
    (rec,), _ = run_cli([(runs["b"][0], {"refine_sums": iters + 2, "refine_grad": iters})])
    got = json.loads((tmp / "transform.json").read_text())
    matrix, offset = np.array(got["matrix_zyx"]), np.array(got["offset_zyx"])
    m, t = f32_map(*TRUE_MAP)
    inv = np.linalg.inv(m.astype(np.float64))
    off_err = float(np.abs(offset - (-inv @ t.astype(np.float64))).max())
    diag_err = float(np.abs(np.diag(matrix) - np.diag(inv)).max())
    if not (off_err <= REG_OFFSET_TOL and diag_err <= REG_DIAG_TOL):
        raise AssertionError(f"(b) the verb's map: offset {off_err:.4f} px, diagonal "
                             f"{diag_err:.2e} from the truth")
    want, against = refs["register"], "4g's estimate of the same volumes"
    if not (np.array_equal(matrix, want["matrix"]) and np.array_equal(offset, want["offset"])):
        raise AssertionError(f"(b) the verb's map {got} is not {against}: {want}")
    verb_line("b", [rec], f"offset error {off_err:.4f} px (tol {REG_OFFSET_TOL}), diagonal "
              f"{diag_err:.2e} (tol {REG_DIAG_TOL}), final loss {got['final_loss']:.5f}; the map "
              f"bit for bit {against}")
    return {"offset_err_px": off_err, "diag_err": diag_err, "rec": rec}


def verb_reconstructs(tmp, paths, runs, cfgs, refs, psf) -> dict:
    """(c) config 2 through the CLI with the measured PSF: its launches
    (:func:`config2_want`), bit for bit 4p's deskew + RL-20 of the same raw
    with the same PSF (``refs["cfg2_out"]``; (a) holds the PSF to 4p's). (d)
    config 4's deskew + register + RL-20 with the register verb's JSON: 1
    deskew, 1 warp and 40 ``rl_half``, bit for bit :func:`store_step` with
    the same YAML run here on 4u's raw (``refs["raw1"]``, the store's
    timepoint as 4u wrote it). (e) ``--devices 1`` (a one-device mesh,
    ``reconstruct_store(mesh=)``): 1 deskew and 40 ``rl_half``, bit for bit
    4u(b)'s timepoint 0 (``refs["recon0"]``, kept on the card)."""
    import numpy as np

    from shrimpy_tpu_torch.config.schemas import ReconstructSettings, load_yaml_config

    res = {}
    deconv = load_yaml_config(cfgs["cfg2"], ReconstructSettings).deconvolve
    plan = config2_want(np.load(psf), deconv)
    (rec,), _ = run_cli([(runs["c"][0], plan["want"])])
    same_bits("(c) the CLI against 4p's step", store_volume(tmp / "cfg2.zarr"),
              refs.pop("cfg2_out"))
    verb_line("c", [rec], f"K = {len(plan['terms'])} of {plan['psf_w'].shape}, route "
              f"{plan['route']}; bit for bit 4p's deskew + RL-20 of the same raw with the same PSF")
    res["c"] = {"rec": rec, "k": len(plan["terms"]), "route": plan["route"]}
    rl = {"rl_half_step": 2 * ITERATIONS, "rl_half_one_launch": 2 * ITERATIONS}
    (rec,), _ = run_cli([(runs["d"][0], {"deskew": 1, "affine_warp": 1, **rl})])
    step, _ = store_step(cfgs["cfg4"], paths["raw1"])
    want = step(torch.from_numpy(refs.pop("raw1")).cuda().float()[None])[0]
    del step
    same_bits("(d) the CLI against the step run here", store_volume(tmp / "cfg4.zarr"), want)
    del want
    verb_line("d", [rec], "deskew + register-apply + RL-20 bit for bit build_reconstruct_step "
              "run here with the same YAML")
    res["d"] = {"rec": rec}
    (rec,), _ = run_cli([(runs["e"][0], {"deskew": 1, **rl})])
    summary = json.loads((tmp / "mesh1.zarr" / "reconstruct_summary.json").read_text())
    same_bits("(e) --devices 1 against 4u(b)", store_volume(tmp / "mesh1.zarr"),
              refs.pop("recon0"))
    verb_line("e", [rec], f"the run summary's mesh {summary.get('mesh')}, device "
              f"{summary['device']}; bit for bit 4u(b)'s timepoint 0")
    res["e"] = {"rec": rec, "mesh": summary.get("mesh")}
    return res


def verb_phase(tmp, paths, runs, refs) -> dict:
    """(g) phase of the brightfield store: no kernel of the repository
    (cuFFT); the transfer function a hit of 4l's host cache (the store's
    scale is 4l's), and the output bit for bit 4l's step on the same stack
    (``refs["phase_out"]``)."""
    from shrimpy_tpu_torch.ops.phase import _compute_tf_cached

    before = _compute_tf_cached.cache_info()
    (rec,), _ = run_cli([(runs["g"][0], {})])
    after = _compute_tf_cached.cache_info()
    hit = after.hits == before.hits + 1 and after.misses == before.misses
    got = store_volume(tmp / "phase.zarr")
    if not hit:
        raise AssertionError(f"(g) the verb's TF missed 4l's host cache: {before} -> {after}")
    same_bits("(g) the CLI against 4l's step", got, torch.from_numpy(refs["phase_out"]).cuda())
    verb_line("g", [rec], f"output {tuple(got.shape)}, the host TF cache "
              f"{'hit' if hit else 'missed'} "
              f"({after}); bit for bit 4l's step on the same stack")
    shape = tuple(got.shape)
    del got
    return {"rec": rec, "tf_hit": hit, "shape": shape}


def verb_track(tmp, runs, frames: list) -> dict:
    """(i) track of the session store: without preprocessing (no kernel)
    the journal's shifts are the drift baked into the frames, (2, 0, 3) raw
    px a timepoint, within DRIFT_ATOL; with ``[deskew]`` (1 deskew launch a
    timepoint) they equal 4m's pcc (its settings, ``Preprocessor`` and
    ``Tracker``) run here on the frames read back, and its deskewed drift
    within DRIFT_ATOL; a row a timepoint."""
    import numpy as np

    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    n_t = len(frames)
    recs, _ = run_cli([(runs["i"][0], {}), (runs["i"][1], {"deskew": n_t})])
    raw_rows = journal_rows(tmp / "shifts.csv")
    desk_rows = journal_rows(tmp / "shifts_deskew.csv")
    r = headline_settings().deskew.px_to_scan_ratio
    baked = [np.array([t * TRACK_DRIFT[0], 0.0, t * TRACK_DRIFT[1]]) for t in range(n_t)]
    deskewed = [np.array([0.0, t * TRACK_DRIFT[0] / r, t * TRACK_DRIFT[1]]) for t in range(n_t)]
    if len(raw_rows) != n_t or len(desk_rows) != n_t:
        raise AssertionError(f"(i) {len(raw_rows)} and {len(desk_rows)} journal rows for {n_t}")
    raw_err = max(float(np.abs(np.array(s) - b).max())
                  for s, b in zip(journal_shifts(raw_rows), baked))
    cfg = track_config("pcc", preprocessing=["deskew"], deskew=vars(headline_settings().deskew))
    pre, tracker = Preprocessor(cfg), Tracker(cfg)
    here = [[float(f"{v:.4f}") for v in tracker.update(  # to the journal's 4 decimals
        pre.tracking_stack(frame), t).shift_px_zyx] for t, frame in enumerate(frames)]
    del pre, tracker
    desk_err = max(float(np.abs(np.array(s) - b).max())
                   for s, b in zip(journal_shifts(desk_rows), deskewed))
    if not (raw_err <= DRIFT_ATOL and desk_err <= DRIFT_ATOL and journal_shifts(desk_rows) == here):
        raise AssertionError(f"(i) raw shifts {journal_shifts(raw_rows)} (baked {baked}), "
                             f"deskewed {journal_shifts(desk_rows)} (here {here}, baked "
                             f"{deskewed})")
    verb_line("i", recs, f"{n_t} rows each; raw shifts {journal_shifts(raw_rows)} px (the baked "
              f"drift within {raw_err:.3f}); after [deskew] {journal_shifts(desk_rows)} (4m's pcc "
              f"run here on the frames read back: the same; the deskewed drift within "
              f"{desk_err:.3f})")
    return {"recs": recs, "raw_shifts": journal_shifts(raw_rows),
            "deskew_shifts": journal_shifts(desk_rows), "rows": raw_rows}


def verb_replay(tmp, paths, runs, frames: list, track_rows) -> dict:
    """(h) ``plan validate`` of the plan against the session store, then
    replay with it (DynaTrack ``pcc`` on BF, -I, autofocus on): each output
    frame bit for bit the source's rolled by minus the stage offset it was
    acquired under (``ReplaySource`` follows the stage: the journal's moves
    before its timepoint); every update finite; the journal's shifts equal
    (i)'s where no correction had moved the frame, and the shift (i) found
    less the offset within DRIFT_ATOL where one had."""
    import numpy as np

    from shrimpy_tpu_torch.io.ngff import open_ngff

    n_t = len(frames)
    recs, _ = run_cli([(runs["h"][0], {}), (runs["h"][1], {})])
    if json.loads(recs[0]["out"]) != {"valid": True, "plan": runs["h"][0][2]}:
        raise AssertionError(f"(h) plan validate: {recs[0]['out']}")
    out = tmp / "replay" / "demo.zarr"
    if recs[1]["out"].strip().splitlines()[-1] != str(out):
        raise AssertionError(f"(h) replay printed {recs[1]['out'][-400:]}")
    rows = journal_rows(tmp / "replay" / "demo_dynatrack_log.csv")
    shifts = journal_shifts(rows)
    if len(rows) != n_t or not np.isfinite(np.array(shifts, float)).all():
        raise AssertionError(f"(h) the journal's rows {rows}")
    scale = open_ngff(paths["session"]).position().zyx_scale
    offsets = stage_offsets(rows, scale, n_t)
    moved = replayed_as_served(frames, out, offsets)
    found = journal_shifts(track_rows)
    for t, (s, f, off) in enumerate(zip(shifts, found, offsets)):
        if not any(off) and s != f:
            raise AssertionError(f"(h) t={t}: the engine's shift {s}, track's {f} on the same "
                                 "frame")
        if any(off) and not np.abs(np.array(s) - (np.array(f) - np.array(off))).max() <= DRIFT_ATOL:
            raise AssertionError(f"(h) t={t}: the engine's shift {s} on a frame moved by {off}, "
                                 f"track's {f}")
    verb_line("h", recs, f"plan valid; {n_t} frames bit for bit the source's rolled by minus the "
              f"stage offsets {offsets} px; journal shifts {shifts} (track's {found}: equal on "
              f"unmoved frames, less the offset on moved ones)")
    return {"recs": recs, "offsets": offsets, "moved": moved, "shifts": shifts}


def verb_dual(tmp, paths, runs, frames: list) -> dict:
    """(j) replay-dual: the label-free arm untracked, the light-sheet arm
    with the plan's DynaTrack block, each on its own engine and thread
    sharing one stage: every arm's frames bit for bit its source's rolled by
    minus the shared stage's offset at its own scale (the label-free arm's
    read before or after the tracking arm's update of the same timepoint
    lands: the engines are in step only at the timepoint's barrier); the
    summary's final
    stage the position the tracking arm's journaled moves give
    (:func:`stage_position`, to the journal's 4 decimals)."""
    import numpy as np

    from shrimpy_tpu_torch.io.ngff import open_ngff

    n_t = len(frames)
    (rec,), _ = run_cli([(runs["j"][0], {})])
    lines = rec["out"].strip().splitlines()
    results = json.loads(lines[-1])
    if set(results) != {"labelfree", "lightsheet"} or any(r["error"] for r in results.values()):
        raise AssertionError(f"(j) the arms' results {results}")
    rows = journal_rows(tmp / "dual" / "session_lightsheet_dynatrack_log.csv")
    summary = json.loads((tmp / "dual" / "session_dualarm_summary.json").read_text())
    (final,) = summary["stage_final_um"].values()
    moved = stage_position(rows)
    if len(rows) != n_t or not np.allclose(final, moved, rtol=0, atol=JOURNAL_UM_ATOL * n_t):
        raise AssertionError(f"(j) final stage {final}, the journal's moves {moved} ({rows})")
    offsets = {}
    for arm, src, arm_frames in (("labelfree", paths["lf_session"],
                                  store_frames(paths["lf_session"], "cuda")),
                                 ("lightsheet", paths["session"], frames)):
        scale = open_ngff(src).position().zyx_scale
        later = stage_offsets(rows, scale, n_t, lag=1) if arm == "labelfree" else None
        offsets[arm] = replayed_as_served(arm_frames, tmp / "dual" / f"session_{arm}.zarr",
                                          stage_offsets(rows, scale, n_t), later)
    verb_line("j", [rec], f"both arms' frames bit for bit their sources' rolled by minus the "
              f"shared stage's offsets (the moved frames' {offsets}); final stage {final} um, "
              f"the position the tracking arm's {n_t} journaled moves give")
    return {"rec": rec, "final_um": final, "offsets": offsets}


def verb_train(tmp, paths, runs) -> dict:
    """(k) train-vs (unet25d) on the pairs store: no kernel of the
    repository (cuDNN, cuBLAS); the losses and the best validation loss
    finite; the checkpoint and its sidecar reload into the port's stainer,
    whose weights are the saved tensors bit for bit and whose ``predict``
    of one volume is finite."""
    import math as _math

    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models.vsunet import STATE_DICT_FILE, VirtualStainer

    (rec,), _ = run_cli([(runs["k"][0], {})])
    report = json.loads(rec["out"].strip().splitlines()[-1])
    if not (0 < report["steps"] <= int(TRAIN_VERB_ARGS[1]) and _math.isfinite(report["final_loss"])
            and _math.isfinite(report["best_val_loss"])):
        raise AssertionError(f"(k) train-vs reported {report}")
    ckpt = tmp / "ckpt"
    saved = torch.load(ckpt / STATE_DICT_FILE, map_location="cpu")
    loaded = VirtualStainer(vs_settings(ckpt_path=str(ckpt)))
    state = loaded.model.state_dict()
    if sorted(state) != sorted(saved) or any(not torch.equal(state[k].cpu(), v)
                                             for k, v in saved.items()):
        raise AssertionError("(k) the reloaded stainer's weights are not the saved tensors")
    vol = store_volume(paths["pairs"])
    pred = loaded.predict(vol)
    if sorted(pred) != sorted(PAIR_CHANNELS[1:]) or not all(bool(torch.isfinite(v).all())
                                                             for v in pred.values()):
        raise AssertionError(f"(k) predict of the reloaded checkpoint: {sorted(pred)}")
    verb_line("k", [rec], f"{report['steps']} steps, final loss {report['final_loss']:.4f}, best "
              f"validation {report['best_val_loss']:.4f}; the checkpoint's {len(saved)} tensors "
              f"reload bit for bit, predict of a {tuple(vol.shape)} volume finite")
    del loaded, vol, pred
    return {"rec": rec, "report": report}


def verb_status(tmp, paths, runs, cfgs, n_t: int, written: dict) -> dict:
    """(f) ``monitor --once`` of (d)'s output and of (h)'s replay store (the
    status counts the timepoints written; the card's machine has no
    matplotlib, so no PNG there, and the status is printed all the same),
    ``info`` of every store 4v wrote (their shapes and scales as written),
    ``microscopes`` and ``plan show``."""
    import importlib.util

    recs, _ = run_cli([(args, {}) for args in runs["f"]])
    status = [json.loads(r["out"].strip().splitlines()[-1]) for r in recs[:2]]
    for st, n, store in zip(status, (1, n_t), (tmp / "cfg4.zarr", tmp / "replay" / "demo.zarr")):
        (one,) = st.values()
        if one["timepoints_written"] != n or one["of"] != n:
            raise AssertionError(f"(f) monitor {store}: {st}, want {n} written")
    plt = importlib.util.find_spec("matplotlib") is not None
    pngs = sorted(p.name for p in (tmp / "cfg4.zarr" / "_preview").glob("*.png"))
    if bool(pngs) != plt:
        raise AssertionError(f"(f) matplotlib {'present' if plt else 'absent'}, PNGs {pngs}")
    info = {}
    for name, (shape, scale) in written.items():
        (rec,), _ = run_cli([(["info", str(name)], {})])
        (pos,) = json.loads(rec["out"])["positions"].values()
        if tuple(pos["shape_tczyx"]) != tuple(shape) or (
                scale is not None and tuple(pos["zyx_scale_um"]) != tuple(scale)):
            raise AssertionError(f"(f) info {name}: {pos}, written {shape} at {scale}")
        info[name] = pos["shape_tczyx"]
    scopes = json.loads(recs[2]["out"])
    shown = json.loads(recs[3]["out"])
    if "mantis" not in scopes or shown["time"]["n_timepoints"] != n_t:
        raise AssertionError(f"(f) microscopes {sorted(scopes)}, plan show {shown['time']}")
    verb_line("f", recs, f"monitor status {status} (matplotlib "
              f"{'present' if plt else 'absent'}: PNGs {pngs}); info of {len(info)} stores, "
              f"shapes and scales as written; microscopes {sorted(scopes)}; plan show "
              f"n_timepoints {n_t}", where="(verbs with no --device)")
    return {"recs": recs, "status": status, "info": len(info), "matplotlib": plt}


def phase_verbs(tmp, inputs: dict, refs: dict, n_t: int) -> dict:
    """4v: every CLI verb 4u does not run, on the card as the console script
    runs it, in the order an operator would (:func:`verb_runs`): (a)
    measure-psf, (b) register, (c) reconstruct with the measured PSF
    (``BASELINE.md`` config 2), (d) with the transform (config 4), (e) on a
    one-device mesh, (g) phase, (i) track, (h) replay, (j) replay-dual, (k)
    train-vs, then (f) monitor, info, microscopes and plan. ``inputs`` are
    :func:`verb_inputs`' stores in ``tmp`` beside 4u's ``raw1.zarr``,
    ``refs`` what the phases before computed in process on the same data:
    4p's PSF and deskew + RL-20 (``psf``, ``cfg2_out``), 4g's map
    (``register``), 4l's phase step (``phase_out``), 4u's raw and its
    reconstruction (``raw1``, ``recon0``). Each run's counts
    are set to 0 before and held after (:func:`run_cli`), and each run
    prints its wall seconds, launches and checks."""
    from pathlib import Path

    t_start = time.monotonic()
    tmp = Path(tmp)
    paths = {**inputs["paths"], "raw1": str(tmp / "raw1.zarr")}
    cfgs = verb_configs(tmp, tmp / "psf.npy", tmp / "transform.json", n_t)
    runs = verb_runs(tmp, paths, cfgs)
    res = {"a": verb_psf(tmp, paths, runs, refs), "b": verb_register(tmp, paths, runs, refs)}
    res.update(verb_reconstructs(tmp, paths, runs, cfgs, refs, res["a"]["psf_npy"]))
    res["g"] = verb_phase(tmp, paths, runs, refs)
    torch.cuda.empty_cache()
    frames = store_frames(paths["session"], "cuda")  # the source of (i), (h) and (j)
    res["i"] = verb_track(tmp, runs, frames)
    res["h"] = verb_replay(tmp, paths, runs, frames, res["i"]["rows"])
    res["j"] = verb_dual(tmp, paths, runs, frames)
    del frames
    res["k"] = verb_train(tmp, paths, runs)
    torch.cuda.empty_cache()
    shape = {name: inputs["written"][paths[name]][0] for name in ("bf", "session", "lf_session")}
    desk = (1, 1, *deskewed_shape())
    written = {**inputs["written"], str(tmp / "cfg2.zarr"): (desk, None),
               str(tmp / "cfg4.zarr"): (desk, None), str(tmp / "mesh1.zarr"): (desk, None),
               str(tmp / "phase.zarr"): (shape["bf"], None),
               str(tmp / "replay" / "demo.zarr"): (shape["session"], None),
               str(tmp / "dual" / "session_lightsheet.zarr"): (shape["session"], None),
               str(tmp / "dual" / "session_labelfree.zarr"): (shape["lf_session"], None)}
    res["f"] = verb_status(tmp, paths, runs, cfgs, n_t, written)
    recs = [r for v in res.values() for r in ([v["rec"]] if "rec" in v else v.get("recs", []))]
    res["launches"] = {k: sum(r["launches"].get(k, 0) for r in recs)
                       for k in ("deskew", "rl_half_one_launch", "rl_half_three_pass", "axis_pass",
                                 "x_pass", "affine_warp", "refine_sums", "refine_grad")}
    res["verbs_s"] = sum(r["s"] for r in recs)
    res["seconds"] = time.monotonic() - t_start
    print(f"  phase 4v took {res['seconds']:.1f} s ({res['verbs_s']:.1f} s in the verbs); its "
          f"launches {res['launches']}", flush=True)
    return res


MESH_RANKS = 4  # ranks sharing cuda:0 over gloo: the one-card stand-in for four cards
MESH_SMALL_RAW = (2, 16, 12, 256)  # __graft_entry__.py's pass 1 on a (2, 2) mesh
MESH_SMALL_PSF = ((3, 3, 3), (0.8, 0.8, 0.8))
MESH_SHARD_RAW = (1, 8, 16, 256)  # its pass 3 on a (1, 4) mesh
MESH_SHARD_PSF = ((3, 7, 7), (0.8, 1.2, 1.2))
MESH_MAIN_BATCH = 4  # production raws over a (2, 2) mesh: one whole volume a rank after the reshard
MESH_RTOL = 1e-5  # the dryrun's gate against the single-device step
MESH_PLAIN_RTOL = 1e-3  # pass 3 against the float64 plain path
MESH_SHARD_EST_GIB = 5.21  # __graft_entry__.py pass 4(b)'s per-device estimate
# 4t(d)'s depth: __graft_entry__.py's pass 4(b) runs RL-2, 16 slab transposes
# of 1.0-1.7 s; cut to RL-1 (8 of them) for phase 4u's time.
MESH_PASS4_ITERATIONS = 1


def mesh_settings(which: str):
    """The settings of ``__graft_entry__.py``'s dryrun passes, as
    namespaces: ``pass1`` deskew + RL-5 on ``auto``; ``pass3`` phase
    (``transform: matmul``) + ``dft2z`` RL-2 under ``shard_volumes``;
    ``pass4`` ``dft2z`` RL-MESH_PASS4_ITERATIONS alone under ``shard_volumes``;
    ``*_whole``
    the same without ``shard_volumes`` (the single-device reference)."""
    from shrimpy_tpu_torch.config import (
        deconvolve_settings,
        deskew_settings,
        phase_settings,
        reconstruct_settings,
    )

    name, _, whole = which.partition("_")
    if name == "pass1":
        return reconstruct_settings(
            deskew=deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386),
            deconvolve=deconvolve_settings(iterations=5))
    extra = {}
    if name == "pass3":
        extra["phase"] = phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.25,
                                         "z_padding": 0}, {"transform": "matmul"})
    return reconstruct_settings(
        deconvolve=deconvolve_settings(iterations=MESH_PASS4_ITERATIONS if name == "pass4" else 2,
                                       algorithm="fft", fft_backend="dft2z"),
        shard_volumes=not whole, **extra)


def rank_stats(mesh, mine: dict) -> list:
    """Every rank's ``mine``, gathered (on rank 0's return)."""
    import torch.distributed as dist

    if mesh.world is None:
        return [mine]
    every = [None] * mesh.devices.size
    dist.all_gather_object(every, mine)
    return every


def mesh_rank_batch(raw, settings, psf, *, mesh) -> dict:
    """A rank of checks (a), (c) and (e): ``reconstruct_batch`` on the
    mesh, the global output on the host; with one rank on NCCL also an
    ``all_reduce`` on the card (the mesh itself calls no collective)."""
    import torch.distributed as dist

    from shrimpy_tpu_torch.parallel.pipeline import reconstruct_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = reconstruct_batch(raw, settings, psf=psf, mesh=mesh)
    torch.cuda.synchronize()
    mine = {"s": time.perf_counter() - t0, "backend": mesh.backend, "device": str(mesh.device)}
    if mesh.backend == "nccl":
        t = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
        dist.all_reduce(t)
        mine["all_reduce"] = float(t.sum())
    return {"out": out, "ranks": rank_stats(mesh, mine)}


def mesh_rank_main(raws, ref, settings, psf, *, mesh) -> list:
    """A rank of check (b): the step on this rank's block of the
    production batch with every count at 0 just before and read just
    after, its output against the single-device step's on the host, and
    the reshard's all_to_all timed alone at its size."""
    from shrimpy_tpu_torch.parallel.fft import _all_to_all_tiled
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    step = build_reconstruct_step(settings, psf=psf, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    table = zero_counts()
    t0 = time.perf_counter()
    blk = step(raws)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: getattr(obj, attr) for name, (obj, attr) in table.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    got, want = blk.data, ref[blk.index]
    del blk
    equal = bool(torch.equal(got, want))
    err = 0.0 if equal else rel_err(got, want)
    del got, want
    b_row = raws.shape[0] // mesh.devices.shape[0]
    zyx = ref.shape[1:]
    local = torch.zeros((b_row, *zyx[:2], zyx[2] // mesh.devices.shape[1]), device=mesh.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _all_to_all_tiled(local, mesh.group("space"), 0, 3)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t1
    return rank_stats(mesh, {"rank": mesh.rank, "s": seconds, "counts": counts, "peak_gib": peak,
                             "reserved_gib": reserved, "equal": equal, "rel_err": err,
                             "reshard_s": reshard_s,
                             "reshard_gib": local.numel() * 4 / 2**30})


def mesh_rank_shard(vol, ref, settings, psf, *, mesh) -> list:
    """A rank of check (d): ``shard_volumes`` RL-2 at the production
    carry, the rank's carry and peak, its X slab against the
    single-device output on the host, and one slab transpose of the
    carry's size timed alone."""
    from shrimpy_tpu_torch.parallel.fft import _all_to_all_tiled
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    step = build_reconstruct_step(settings, psf=psf, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    blk = step(vol)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    carry = (blk.data.shape[0], *step.sharded.carry)
    err = rel_err(blk.data, ref[blk.index])
    del blk
    block = torch.zeros(carry[1:], dtype=torch.complex64, device=mesh.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _all_to_all_tiled(block, mesh.group("space"), 1, 2)
    torch.cuda.synchronize()
    transpose_s = time.perf_counter() - t1
    return rank_stats(mesh, {"rank": mesh.rank, "s": seconds, "carry": carry, "peak_gib": peak,
                             "before_gib": before, "rel_err": err, "transpose_s": transpose_s,
                             "transpose_gib": block.numel() * 8 / 2**30})


def host_shared(shape) -> torch.Tensor:
    """A host float32 tensor in shared memory: the ranks map it rather
    than take a copy each through their pipes (a tensor on the card
    reaches them as a CUDA IPC handle)."""
    return torch.empty(shape, dtype=torch.float32).share_memory_()


def mesh_gate(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    equal = bool(torch.equal(got, want))
    err = 0.0 if equal else rel_err(got, want)
    print(f"  {name}: {'bit-equal' if equal else f'max|a-b|/max|b| = {err:.3e}'} (tol {tol:g}) "
          f"{'ok' if err <= tol else 'FAIL'}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: relative error {err:.3e} > {tol:g}")
    return err


def card_free_gib() -> float:
    return torch.cuda.mem_get_info()[0] / 2**30


def mesh_ranks() -> tuple:
    """4t's ranks: four sharing cuda:0 over gloo and one on NCCL (the
    card's default backend). Their caching allocators take expandable
    segments: five processes share the card, and a rank's fragmented
    reserve (up to 2.3x its 9.4 GiB peak in 4t(b)) would not leave the
    others theirs."""
    import os

    from shrimpy_tpu_torch.parallel import launch

    torch.cuda.empty_cache()
    key, saved = "PYTORCH_CUDA_ALLOC_CONF", os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ[key] = "expandable_segments:True"
    try:
        return (launch.Ranks(MESH_RANKS, backend="gloo", devices=["cuda:0"] * MESH_RANKS),
                launch.Ranks(1))
    finally:
        if saved is None:
            del os.environ[key]
        else:
            os.environ[key] = saved


def phase_mesh(gen, ranks=None, nccl_rank=None) -> dict:
    """Phase 4t: the mesh on one card. Four ranks share cuda:0 over gloo
    (``launch.Ranks``): (a) ``__graft_entry__.py``'s pass 1 on a (2, 2)
    mesh; (b) the main path at full width, four production raws over
    (2, 2): the deskew on X slabs of 800, the reshard to one whole volume a
    rank, RL-20 on the fused kernels; (c) pass 3, ``shard_volumes`` phase +
    ``dft2z`` RL-2 over (1, 4); (d) pass 4(b) run for real, the
    non-separable PSF under ``shard_volumes`` at the production carry over
    (1, 4); then (e) one rank on NCCL (the card's default backend) on
    pass 1's inputs. Each against the single-device step run here on the
    same inputs. Four ranks on one card measure correctness and the gloo
    transfers, not multi-GPU speed. ``ranks`` and ``nccl_rank`` are
    :func:`mesh_ranks`' (started here when None); they stop in the
    thread ``out["closing"]``, which the caller joins."""
    from concurrent.futures import ThreadPoolExecutor

    from shrimpy_tpu_torch.io.synthetic import tilted_gaussian_psf
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf
    from shrimpy_tpu_torch.parallel import launch
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step, reconstruct_batch

    t_phase = time.monotonic()
    out = {"host_gib_before": host_available_gib()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    s1, psf1 = mesh_settings("pass1"), gaussian_psf(*MESH_SMALL_PSF)
    raw_a = uniform(MESH_SMALL_RAW, gen).cpu()

    def on_nccl():
        t0 = time.monotonic()
        try:
            return nccl_rank.run(mesh_rank_batch, args=(raw_a, s1, psf1)), time.monotonic() - t0
        finally:
            nccl_rank.close()

    card_before = card_free_gib()
    if ranks is None:
        ranks, nccl_rank = mesh_ranks()
    # (e) runs beside the rest: its own process group of one rank.
    pool = ThreadPoolExecutor(1)
    nccl = pool.submit(on_nccl)
    try:
        # The references, on the card in this process, while the ranks start.
        t0 = time.monotonic()
        ref_a = reconstruct_batch(raw_a, s1, psf=psf1, device="cuda").cpu()
        headline, psf_b = headline_settings(), gaussian_psf(PSF_SHAPE, PSF_SIGMA)
        # (b)'s batch and outputs stay on the card: the ranks map them by
        # CUDA IPC ((d)'s input is a host tensor).
        raws = torch.empty((MESH_MAIN_BATCH, *RAW_SHAPE), device="cuda")
        ref_b = torch.empty((MESH_MAIN_BATCH, *deskewed_shape()), device="cuda")
        single = build_reconstruct_step(headline, psf=psf_b, device="cuda")
        for k in range(MESH_MAIN_BATCH):
            raws[k] = uniform(RAW_SHAPE, gen, 0.0, 100.0)
            ref_b[k] = single(raws[k:k + 1])[0]
        s3, psf3 = mesh_settings("pass3"), gaussian_psf(*MESH_SHARD_PSF)
        raw_c = (uniform(MESH_SHARD_RAW, gen) * 50.0).cpu()
        ref_c = reconstruct_batch(raw_c, mesh_settings("pass3_whole"), psf=psf3,
                                  device="cuda").cpu()
        ref_c64 = build_reconstruct_step(mesh_settings("pass3_whole"), psf=psf3, device="cuda",
                                         plain=True, dtype=torch.float64)(raw_c).cpu()
        s4, psf4 = mesh_settings("pass4"), tilted_gaussian_psf()
        vol_d = host_shared((1, *deskewed_shape()))
        vol_d[0].copy_(uniform(deskewed_shape(), gen, 0.0, 100.0))
        ref_d = reconstruct_batch(vol_d, mesh_settings("pass4_whole"), psf=psf4, device="cuda")
        del single
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["refs_s"] = time.monotonic() - t0
        print(f"  references on the card: {out['refs_s']:.1f} s; the card's free memory "
              f"{card_before:.1f} GiB before them, {card_free_gib():.1f} after; {host_line()}",
              flush=True)

        t0 = time.monotonic()
        got = ranks.run(mesh_rank_batch, space=2, args=(raw_a, s1, psf1))
        print(f"  (a) pass 1, mesh (2, 2), raw {MESH_SMALL_RAW}: {time.monotonic() - t0:.1f} s, "
              f"step {[round(r['s'], 3) for r in got['ranks']]} s", flush=True)
        out["a"] = {"rel_err": mesh_gate("(a) mesh vs the single-device step", got["out"], ref_a,
                                         MESH_RTOL),
                    "s": [r["s"] for r in got["ranks"]], "wall_s": time.monotonic() - t0}

        t0 = time.monotonic()
        every = ranks.run(mesh_rank_main, space=2, args=(raws, ref_b, headline, psf_b))
        wall = time.monotonic() - t0
        print(f"  (b) the main path: {MESH_MAIN_BATCH} raws {RAW_SHAPE} over (2, 2), deskew on "
              f"X slabs of {RAW_SHAPE[2] // 2}, reshard, RL-20 on fused: {wall:.1f} s", flush=True)
        for r in every:
            parity = "bit-equal" if r["equal"] else f"rel err {r['rel_err']:.3e}"
            print(f"    rank {r['rank']}: step {r['s']:.2f} s, peak {r['peak_gib']:.2f} GiB "
                  f"({r['reserved_gib']:.2f} reserved), {parity}; "
                  f"reshard all_to_all of {r['reshard_gib']:.2f} GiB alone {r['reshard_s']:.3f} s; "
                  f"launches {dict((k, v) for k, v in r['counts'].items() if v)}", flush=True)
            want = {"deskew": MESH_MAIN_BATCH // 2, "rl_half_step": 2 * ITERATIONS,
                    "rl_half_one_launch": 2 * ITERATIONS}
            bad = {k: v for k, v in r["counts"].items()
                   if k not in PASS_COUNTS and v != want.get(k, 0)}
            if bad:
                raise AssertionError(f"(b) rank {r['rank']}: launch counts {bad}, want {want}")
            if not r["rel_err"] <= MESH_RTOL:
                raise AssertionError(f"(b) rank {r['rank']}: rel err {r['rel_err']:.3e}")
        out["b"] = {"ranks": every, "wall_s": wall,
                    "launches": {k: sum(r["counts"][k] for r in every)
                                 for k in ("deskew", "rl_half_one_launch")}}
        print(f"  after (b): {host_line()}", flush=True)
        del raws, ref_b
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()

        t0 = time.monotonic()
        got = ranks.run(mesh_rank_batch, space=4, args=(raw_c, s3, psf3))
        print(f"  (c) pass 3, shard_volumes phase + dft2z RL-2, mesh (1, 4), raw "
              f"{MESH_SHARD_RAW}: {time.monotonic() - t0:.1f} s", flush=True)
        out["c"] = {"rel_err": mesh_gate("(c) mesh vs the single-device step", got["out"], ref_c,
                                         MESH_RTOL),
                    "rel_err_f64": mesh_gate("(c) mesh vs the float64 plain path", got["out"],
                                             ref_c64.float(), MESH_PLAIN_RTOL),
                    "wall_s": time.monotonic() - t0}

        t0 = time.monotonic()
        every = ranks.run(mesh_rank_shard, space=4, args=(vol_d, ref_d, s4, psf4))
        wall = time.monotonic() - t0
        print(f"  (d) pass 4(b) for real: tilted_gaussian_psf() under shard_volumes, dft2z "
              f"RL-{MESH_PASS4_ITERATIONS} at "
              f"{deskewed_shape()} over (1, 4): {wall:.1f} s", flush=True)
        for r in every:
            print(f"    rank {r['rank']}: carry {r['carry']}, step {r['s']:.2f} s, peak "
                  f"{r['peak_gib']:.2f} GiB (estimate {MESH_SHARD_EST_GIB}; "
                  f"{r['before_gib']:.2f} held before), rel err {r['rel_err']:.3e}; one slab "
                  f"transpose of {r['transpose_gib']:.2f} GiB alone {r['transpose_s']:.3f} s",
                  flush=True)
            if tuple(r["carry"]) != (1, 144, 2920, 416):
                raise AssertionError(f"(d) rank {r['rank']}: carry {r['carry']}")
            if not r["rel_err"] <= MESH_RTOL:
                raise AssertionError(f"(d) rank {r['rank']}: rel err {r['rel_err']:.3e}")
        out["d"] = {"ranks": every, "wall_s": wall}
        del vol_d, ref_d
        print(f"  after (d): {host_line()}", flush=True)
    except BaseException:
        ranks.close(force=True)
        raise
    finally:
        got, seconds = nccl.result()
        pool.shutdown()
    # The ranks exit beside the next phases (their teardown and their pinned
    # host buffers, which gloo stages CUDA tensors through, take seconds;
    # 4l's host thread waits for that memory).
    out["closing"] = threading.Thread(target=ranks.close)
    out["closing"].start()

    (rank,) = got["ranks"]
    print(f"  (e) mesh (1, 1) on {rank['backend']} ({rank['device']}), pass 1's inputs, "
          f"all_reduce {rank['all_reduce']}: {seconds:.1f} s (beside the others)", flush=True)
    if rank["backend"] != "nccl" or rank["all_reduce"] != 4.0:
        raise AssertionError(f"(e) backend {rank['backend']}, all_reduce {rank['all_reduce']}")
    out["e"] = {"rel_err": mesh_gate("(e) NCCL mesh vs the single-device step", got["out"], ref_a,
                                     MESH_RTOL), "wall_s": seconds}
    out["seconds"] = time.monotonic() - t_phase
    print(f"  phase 4t took {out['seconds']:.1f} s; the host's available memory "
          f"{out['host_gib_before']:.1f} GiB before it, {host_available_gib():.1f} at its end "
          "(its ranks still exiting)", flush=True)
    return out


def build_all(build) -> None:
    """The common library and, beside it, the kernels compiled for their
    geometry (the one-launch half-step and its circular build, the whole
    iteration and the z+y march) for every geometry this script runs, all compilers at once (a
    geometry missed here is compiled at its first launch)."""
    from concurrent.futures import ThreadPoolExecutor

    from shrimpy_tpu_torch.io.synthetic import tilted_gaussian_psf
    from shrimpy_tpu_torch.ops.conv3_cuda import convzy_layout
    from shrimpy_tpu_torch.ops.rl_fused import half_layout
    from shrimpy_tpu_torch.ops.rl_fused_iter import iter_layout

    terms, carry = production_terms()
    jobs = []
    for tt in (terms, two_term_psf(), *other_terms().values()):
        lengths = tuple(len(w) for w in tt[0])
        tile = half_layout(carry, tuple(k // 2 for k in lengths), len(tt))["tile"]
        jobs.append(("rl_half", (len(tt), *lengths, *tile)))
    for shape, tt in ((carry, terms), (SMALL, two_term_psf())):
        lengths = tuple(len(w) for w in tt[0])
        tile = iter_layout(shape, tuple(k // 2 for k in lengths), len(tt))["tile"]
        jobs.append(("rl_iter", (len(tt), *lengths, *tile)))
    marches = {(shape, tuple(len(w) for w in tt[0][:2])) for shape, tt, _, _ in convzy_cases(terms, carry)}
    marches.add(((4, 10, 60020), (3, 5)))  # phase_routes' x row in pieces
    for shape, lengths in sorted(marches):
        tile = convzy_layout(shape, tuple(k // 2 for k in lengths))["tile"]
        jobs += [("convzy", (*lengths, *tile, wrap)) for wrap in (0, 1)]
    wrapped = set()
    for shape, tt, _, _ in conv3_cases(terms, carry):
        lengths = tuple(len(w) for w in tt[0])
        layout = half_layout(shape, tuple(k // 2 for k in lengths), len(tt))
        if layout is not None:
            wrapped.add((len(tt), *lengths, *layout["tile"], 1))
    jobs += [("rl_half_wrap", g) for g in sorted(wrapped)]
    # The hybrid's warm phase (bench.py configs 8 and 9) on its K terms.
    from shrimpy_tpu_torch.ops.deconv import (
        plan_hybrid_terms,
        prepare_psf,
        resolve_separable_backend,
    )

    s = nonsep_settings("config8")
    psf_w = prepare_psf(tilted_gaussian_psf(), s)
    hterms, _ = plan_hybrid_terms(psf_w, s)
    if resolve_separable_backend(s.separable_backend, NONSEP_SHAPE, psf_w.shape) == "fused":
        radii = tuple(k // 2 for k in psf_w.shape)
        layout = half_layout(tuple(n + 2 * r for n, r in zip(NONSEP_SHAPE, radii)), radii,
                             len(hterms))
        if layout is not None:
            jobs.append(("rl_half", (len(hterms), *psf_w.shape, *layout["tile"])))
    # 4t(a)'s step: dryrun pass 1's PSF on its deskewed volume, run here and
    # in each rank.
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf, plan_terms
    from shrimpy_tpu_torch.parallel.pipeline import output_shape

    s1 = mesh_settings("pass1")
    psf_a = prepare_psf(gaussian_psf(*MESH_SMALL_PSF), s1.deconvolve)
    terms_a = plan_terms(psf_a, s1.deconvolve)
    radii_a = tuple(k // 2 for k in psf_a.shape)
    shape_a = tuple(n + 2 * r for n, r in zip(output_shape(MESH_SMALL_RAW[1:], s1), radii_a))
    layout = half_layout(shape_a, radii_a, len(terms_a))
    if terms_a is not None and layout is not None:
        jobs.append(("rl_half", (len(terms_a), *(len(w) for w in terms_a[0]), *layout["tile"])))
    # The compiled passes (csrc/rl_pass.cu), one library a tap count: every
    # list of 63 taps or fewer that a three-pass or two-pass route, or an x
    # pass of linear_pallas, zy_pallas or conv3_circular, runs below (a
    # cropped PSF's count missed here is compiled at its first launch).
    pass_taps = {1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 45, 61, *CONFIG2_LENGTHS}
    jobs += [("rl_pass", (k,)) for k in sorted(pass_taps)]
    with ThreadPoolExecutor(2) as pool:
        geometries = pool.submit(build.build_geometries, jobs)
        build.load_library()
        geometries.result()


def main(argv) -> int:
    t_start = time.monotonic()
    # --parent-iter DIR: the source of the whole-iteration kernel before its
    # redesign, timed beside the new one in phase 3.
    parent_dir = argv[argv.index("--parent-iter") + 1] if "--parent-iter" in argv else None
    # --parent-convzy DIR: the source of the z+y kernel before the march,
    # timed beside it in phase 3.
    parent_zy = argv[argv.index("--parent-convzy") + 1] if "--parent-convzy" in argv else None
    # --parent-deskew DIR: the source of the deskew kernel before its
    # redesign, held to the new one's bits and timed beside it in phase 3.
    parent_desk = argv[argv.index("--parent-deskew") + 1] if "--parent-deskew" in argv else None
    # --parent-affine DIR: the source of the affine kernels before the
    # two-launch refine step, timed beside it in phase 3.
    parent_aff = argv[argv.index("--parent-affine") + 1] if "--parent-affine" in argv else None
    # --parent-probes DIR: the source of the probe kernels before their
    # redesign, held to the new ones and timed beside them in phase 3.
    parent_prb = argv[argv.index("--parent-probes") + 1] if "--parent-probes" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # Fails here, before any output, where the repository is missing.
    from shrimpy_tpu_torch.kernels import build

    # The plain versions use neither; stated so no reference runs TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.monotonic()
    build_all(build)
    print(f"[2] kernels built from {build.CSRC_DIR.name}/ and loaded in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    # 4t's ranks start here: their imports and CUDA set-up (~15 s of the
    # host) run beside phase 3, which waits on the card.
    ranks = mesh_ranks()
    try:
        return run_phases(t_start, card, ranks, parent_dir, parent_zy, parent_desk,
                          parent_aff, parent_prb)
    finally:
        for r in ranks:
            r.close(force=True)


def run_phases(t_start, card, ranks, parent_dir, parent_zy, parent_desk, parent_aff,
               parent_prb) -> int:
    """Phases 3 to 5 of ``main``, after the build."""
    import atexit
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from shrimpy_tpu_torch.io.synthetic import tilted_gaussian_psf
    from shrimpy_tpu_torch.kernels import build

    built = set(build.BUILD_DIR.glob("*.so"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("[3] kernels against their plain versions", flush=True)
    desk = phase_deskew(gen, parent_desk)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    rl, rl3 = phase_rl(gen)
    accel = phase_accel(gen)
    stamp(t_start, "  (phase 3 so far)")
    print("  the three-pass route through richardson_lucy:", flush=True)
    three = phase_three_pass()
    stamp(t_start, "  (phase 3 so far)")
    print(f"  the three-pass route's compiled passes at BASELINE.md config 2's grid "
          f"{config2_carry()} (csrc/rl_pass.cu):", flush=True)
    axis_p, x_p = phase_passes(gen)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    zy = phase_convzy(gen, parent_zy)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    czy, c3, xcirc = phase_circular(gen, parent_zy)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    print("  the z+y step's two-pass route and the repaired carries through richardson_lucy:",
          flush=True)
    routes = phase_routes()
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    it = phase_iter(gen, parent_dir)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    p_slice, p_smem, p_dot = phase_probes(parent_prb)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    print("  the affine warp and its gradient (csrc/affine.cu):", flush=True)
    aff = phase_affine(gen)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    rsums, rgrad = phase_refine(gen, parent_aff)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    print("  the band of the fft2z RL (csrc/zband.cu):", flush=True)
    band = phase_band(gen)
    torch.cuda.empty_cache()
    print("  the FFT RL's transforms and update on a z chunk (csrc/rl_fft.cu):", flush=True)
    ratio, scale = phase_fft_chunk(gen)
    torch.cuda.empty_cache()
    stamp(t_start, "  (phase 3 so far)")
    # Phase 4t runs here, before the host-heavy phases (4l's TF, 4n, 4o, 4s)
    # have grown this process: its ranks' gloo transfers stage through host
    # memory, and after those phases the machine's 96 GiB do not hold both.
    # Its own seed, so that the later phases draw what they drew without it.
    stamp(t_start, f"[4t] the mesh on one card: {MESH_RANKS} ranks on cuda:0 over gloo, "
          f"(a) dryrun pass 1, (b) {MESH_MAIN_BATCH} production raws over (2, 2), (c) pass 3, "
          "(d) pass 4(b) at the production carry; (e) one rank on NCCL")
    mesh = phase_mesh(torch.Generator(device="cuda").manual_seed(SEED + 20), *ranks)
    torch.cuda.empty_cache()
    # Phase 4l's host transfer function (~85 s of float64 numpy, one host
    # thread) beside the card's phases 4-4k.
    tf_pool = ThreadPoolExecutor(1)
    tf_host = tf_pool.submit(phase_tf)
    steps = Steps(gen)
    stamp(t_start, "[4] main path: deskew + RL-20 at raw (1201, 256, 1600)")
    step = phase_step(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4b] deskew + Biggs RL-10 (in-kernel) at raw (1201, 256, 1600)")
    biggs = phase_biggs(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4c] the same steps on separable_backend linear_pallas")
    rl20 = step.pop("out")
    lin = phase_linear(steps, rl20, biggs.pop("out"))
    torch.cuda.empty_cache()
    stamp(t_start, "[4d] deskew + RL-20 and Biggs RL-10 on separable_backend zy_pallas")
    zyp = phase_zy(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4e] deskew + RL-20 on separable_backend matmul")
    mmp = phase_matmul(steps)
    torch.cuda.empty_cache()
    stamp(t_start, "[4f] deskew + RL-20 and Biggs RL-10 on separable_backend fused_iter")
    fip = phase_fused_iter(steps, rl20)
    del rl20
    torch.cuda.empty_cache()
    stamp(t_start, f"[4g] estimate_registration (pcc+refine, defaults) at {deskewed_shape()}")
    reg = phase_register(gen, parent_aff)
    torch.cuda.empty_cache()
    stamp(t_start, "[4h] deskew + register-apply + RL-20 at raw (1201, 256, 1600)")
    sreg = phase_step_reg(steps)
    del steps
    torch.cuda.empty_cache()
    t_fft = time.monotonic()
    stamp(t_start, f"[4i] bench.py config 6: RL-20 with tilted_gaussian_psf() (non-separable) at "
          f"{NONSEP_SHAPE}, fft_backend auto")
    nvol, npsf = uniform(NONSEP_SHAPE, gen, 0.0, 100.0), tilted_gaussian_psf()
    nonsep = phase_nonsep(nvol, npsf)
    torch.cuda.empty_cache()
    stamp(t_start, "[4j] bench.py config 8: hybrid, 16 warm + 6 exact iterations")
    hyb8 = phase_hybrid(nvol, npsf, "config8")
    torch.cuda.empty_cache()
    stamp(t_start, "[4k] bench.py config 9: hybrid with Biggs, 16 warm + 3 exact iterations")
    hyb9 = phase_hybrid(nvol, npsf, "config9")
    del nvol
    torch.cuda.empty_cache()
    stamp(t_start, "[4l] phase reconstruction of a brightfield stack")
    ph = phase_phase(gen, tf_host.result())
    tf_pool.shutdown()
    fft_s = time.monotonic() - t_fft
    stamp(t_start, f"[4m] tracking: deskew + each method at raw {RAW_SHAPE}; phase + pcc at "
          f"{ph['shape']}")
    trk = phase_track(gen, ph["shape"])
    torch.cuda.empty_cache()
    stamp(t_start, f"[4q] DynaTrack closed loop: {LOOP_TIMEPOINTS} timepoints at raw {RAW_SHAPE}, "
          "PositionUpdateManager over deskew + pcc, the stage seam rolling each raw")
    loop = phase_loop(gen)
    torch.cuda.empty_cache()
    stamp(t_start, f"[4r] the acquisition engine: {len(ENGINE_POSITIONS)} positions x "
          f"{len(ENGINE_RUN_CHANNELS)} channels x {ENGINE_TIMEPOINTS} timepoints at raw {RAW_SHAPE}, "
          "AcquisitionEngine(device='cuda').acquire with a plan namespace, DynaTrack pcc after "
          "[deskew]")
    eng = phase_engine()
    torch.cuda.empty_cache()
    stamp(t_start, f"[4s] the live viewer beside the acquisition engine: 1 position x "
          f"{len(ENGINE_CHANNELS)} channels x {VIEWER_TIMEPOINTS} timepoint at raw {RAW_SHAPE}, "
          "replay --viewer's feeder (native ring, spawned monitor) and a monitor attached here")
    view = phase_viewer(eng["host_s_per_volume"])
    torch.cuda.empty_cache()
    # Phase 4u's and 4v's input stores (host work: numpy and file writes)
    # beside 4n-4p, in a directory removed after 4v (or at exit).
    store_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_store_"))
    atexit.register(shutil.rmtree, store_tmp, ignore_errors=True)
    store_pool = ThreadPoolExecutor(1)
    store_in = store_pool.submit(store_inputs, store_tmp)
    verb_data = {**reg.pop("verb"), **ph.pop("verb"), **trk.pop("verb")}
    refs = {"register": verb_data.pop("map"), "phase_out": verb_data.pop("phase_out")}
    n_t = len(verb_data["session"])
    verb_in = [store_pool.submit(lambda d: verb_inputs(store_tmp, {
        **d, "lf_session": lf_session_frames(n_t)}), verb_data)]
    del verb_data
    stamp(t_start, f"[4n] virtual staining: unet25d through the tracker at {ph['shape']}; "
          f"unext2 at ConvNeXt-V2 Tiny widths; [deskew, phase, vs] at raw {VS_CHAIN_RAW}")
    vs = phase_vs(gen, ph["shape"])
    torch.cuda.empty_cache()
    stamp(t_start, f"[4o] virtual-staining training: unext2 Tiny at batch 4, patch 128 (unet25d "
          f"through the CLI in 4v(k)); {TRAIN_VOLUMES} volumes of {TRAIN_SHAPE}")
    trn = phase_train()
    verb_in.append(store_pool.submit(verb_inputs, store_tmp, trn.pop("verb")))
    torch.cuda.empty_cache()
    stamp(t_start, f"[4p] BASELINE.md config 2: a PSF measured from {BEAD_COUNT} beads at raw "
          f"{BEAD_RAW}, then deskew + RL-20 with it at raw {RAW_SHAPE}")
    mpsf = phase_psf(gen, lambda d: verb_in.append(store_pool.submit(verb_inputs, store_tmp, d)))
    torch.cuda.empty_cache()
    # All of 4v's stores written before 4u(a) times the codec pool alone.
    inputs: dict = {"paths": {}, "written": {}}
    for f in verb_in:
        done = f.result()
        for k in inputs:
            inputs[k].update(done[k])
    store_pool.shutdown()
    stamp(t_start, "  (4v's input stores written)")
    u_in = store_in.result()
    refs["raw1"] = u_in["raws"][0]
    stamp(t_start, f"[4u] the store path and the CLI: the tensorstore fixtures; `reconstruct -c "
          f"{DEMO_CONFIG}` over {STORE_TIMEPOINTS} production raws store to store on the card; "
          "--resume; the deskew and deconvolve verbs")
    store = phase_store(u_in)
    del u_in
    refs["recon0"] = store.pop("recon0")
    torch.cuda.empty_cache()
    stamp(t_start, "[4v] the other verbs through the CLI on the card: measure-psf -> register -> "
          "reconstruct with the measured PSF and the transform, --devices 1, phase, track, "
          "replay, replay-dual, train-vs, monitor, info, microscopes, plan")
    refs.update(mpsf.pop("verb"))
    try:
        verbs = phase_verbs(store_tmp, inputs, refs, n_t)
    finally:
        del refs
        shutil.rmtree(store_tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    mesh.pop("closing").join()
    print(f"[5] {card}: RL-20 kernel path {step['gvox_s']:.4f} GVox/s; Biggs RL-10 kernel "
          f"path {biggs['gvox_s']:.4f} RL-20-equivalent GVox/s, max rel err "
          f"{biggs['rel_err']:.3e}; linear_pallas RL-20 {lin['RL-20']['ms']:.1f} ms, "
          f"Biggs RL-10 {lin['Biggs RL-10']['ms']:.1f} ms; deskew kernel {desk['ms']:.3f} ms "
          f"(before the redesign {desk.get('ms_parent', 'not timed')}, plain "
          f"{desk['plain_ms']:.3f}, bound {desk['bound_ms']:.3f}, F.grid_sample "
          f"{desk['library_ms']:.3f}; config 1 {desk['config1_ms']:.3f}, before "
          f"{desk.get('config1_ms_parent', 'not timed')}, bound {desk['config1_bound_ms']:.3f}); "
          f"RL half-step {rl['ms']:.3f} ms in one launch (three "
          f"passes {rl['ms_three_pass']:.3f}, plain {rl['plain_ms']:.3f}; PSF {OTHER_PSF[0]} "
          f"{rl['ms_other_psf']:.3f}, {OTHER_TERMS} terms of {PSF_SHAPE} "
          f"{rl['ms_two_terms']:.3f}); ratio_accel "
          f"{accel['ms_ratio_accel']:.3f} ms (three passes "
          f"{accel['ms_ratio_accel_three_pass']:.3f}, plain "
          f"{accel['plain_ms_ratio_accel']:.3f}); mult_accel {accel['ms_mult_accel']:.3f} ms "
          f"(three passes {accel['ms_mult_accel_three_pass']:.3f}, plain "
          f"{accel['plain_ms_mult_accel']:.3f}); convzy_linear {zy['ms']:.3f} ms (before the "
          f"march {zy.get('ms_parent', 'not timed')}, two passes {zy['ms_two_pass']:.3f}, plain "
          f"{zy['plain_ms']:.3f}, bound {zy['bound_ms']:.3f}); peak {step['peak_gib']:.2f} / "
          f"{biggs['peak_gib']:.2f} / {lin['RL-20']['peak_gib']:.2f} / "
          f"{lin['Biggs RL-10']['peak_gib']:.2f} GiB", flush=True)
    print(f"[5] {card}: zy_pallas RL-20 {zyp['ms']:.1f} ms, {zyp['gvox_s']:.4f} GVox/s, "
          f"rel err {zyp['rel_err']:.3e}, peak "
          f"{zyp['peak_gib']:.2f} GiB; its Biggs RL-10 {zyp['biggs']['ms']:.1f} ms, max rel err "
          f"{zyp['biggs']['rel_err']:.3e}, peak {zyp['biggs']['peak_gib']:.2f} GiB; matmul RL-20 "
          f"{mmp['ms']:.1f} ms, {mmp['gvox_s']:.4f} GVox/s, rel err {mmp['rel_err']:.3e}, peak "
          f"{mmp['peak_gib']:.2f} GiB; convzy_circular {czy['ms']:.3f} ms (before the march "
          f"{czy.get('ms_parent', 'not timed')}, two passes {czy['ms_two_pass']:.3f}, plain "
          f"{czy['plain_ms']:.3f}); circular x pass {xcirc['ms']:.3f} ms (plain "
          f"{xcirc['plain_ms']:.3f}, bound {xcirc['bound_ms']:.3f} by {xcirc['bound_by']}); "
          f"conv3_circular {c3['ms']:.3f} ms (plain "
          f"{c3['plain_ms']:.3f})", flush=True)
    print(f"[5] {card}: fused_iter RL-20 {fip['ms']:.1f} ms, {fip['gvox_s']:.4f} GVox/s (fused "
          f"{step['ms']:.1f} ms), rel err {fip['rel_err']:.3e}, "
          f"peak {fip['peak_gib']:.2f} GiB (fused {step['peak_gib']:.2f}); its Biggs RL-10 "
          f"{fip['biggs']['ms']:.1f} ms, max rel err {fip['biggs']['rel_err']:.3e}, peak "
          f"{fip['biggs']['peak_gib']:.2f} GiB; through richardson_lucy "
          f"{fip['biggs']['peak_rl_gib']:.2f} GiB, with donate_input "
          f"{fip['biggs']['peak_rl_donated_gib']:.2f} GiB; rl_iter {it['ms']:.3f} ms (before the "
          f"redesign {it.get('ms_parent', 'not timed')}, plain {it['plain_ms']:.3f}, bound "
          f"{it['bound_ms']:.3f} by {it['bound_by']}, of its own FMAs "
          f"{it['bound_ms_kernel_fmas']:.3f}); split-dot "
          f"errors vs float64 {p_dot['errors']}; probes alone: slice {p_slice['ms']:.4f} ms "
          f"(floor {p_slice['floor_ms']:.4f}), largest block {p_smem['ms']:.4f} ms (floor "
          f"{p_smem['floor_ms']:.4f}, one SM's bound {p_smem['bound_ms_smem']:.4f}), five "
          f"products {p_dot['ms']:.4f} ms (before {p_dot.get('ms_parent', 'not timed')}), fma "
          f"{p_dot['fma_ms']:.4f} ms beside torch.matmul {p_dot['fma_library_ms']:.4f}",
          flush=True)
    print(f"[5] {card}: deskew + register + RL-20 {sreg['ms']:.1f} ms, {sreg['gvox_s']:.4f} GVox/s "
          f"(without the registration {step['ms']:.1f} ms), "
          f"rel err {sreg['rel_err']:.3e}, peak {sreg['peak_gib']:.2f} GiB (without "
          f"{step['peak_gib']:.2f}); affine_warp {aff['ms']:.3f} ms (bound {aff['bound_ms']:.3f}, "
          f"plain {aff['plain_ms']:.3f}, F.grid_sample {aff['library_ms']:.3f}; "
          + ", ".join(f"{k} {v['ms']:.3f}" for k, v in aff["maps"].items())
          + f"); refine sums {rsums['ms']:.3f} ms, gradient {rgrad['ms']:.3f} ms (before "
          f"{rgrad.get('ms_parent', 'not timed')}; bounds {rsums['bound_ms']:.3f} by voxels, "
          f"{rsums['bound_ms_sectors']:.3f} by sectors); estimate "
          f"{reg['first_s']:.3f} s first, {reg['warm_s']:.3f} s warm, refine step "
          f"{reg['step_ms']:.3f} ms in it, {reg['step_ms_alone']:.3f} alone (before "
          f"{reg.get('step_ms_parent', 'not timed')}), offset error "
          f"{reg['offset_err_px']:.4f} px, peak "
          f"{reg['peak_gib']:.2f} GiB", flush=True)
    print(f"[5] {card}: RL-20 fft2z (config 6) {nonsep['ms']:.1f} ms, {nonsep['gvox_s']:.4f} "
          f"GVox/s, rel err {nonsep['rel_err']:.3e}, peak {nonsep['peak_gib']:.2f} GiB; fft3 "
          f"{nonsep['fft3_ms']:.1f} ms, peak {nonsep['fft3_peak_gib']:.2f} GiB; hybrid config 8 "
          f"{hyb8['ms']:.1f} ms (warm {hyb8['warm_ms']:.1f} on {hyb8['warm_backend']}, K "
          f"{hyb8['k']}, tail {hyb8['tail_ms']:.1f}), rel err {hyb8['rel_err']:.3e}, peak "
          f"{hyb8['peak_gib']:.2f} GiB; config 9 {hyb9['ms']:.1f} ms (warm "
          f"{hyb9['warm_ms']:.1f}, tail {hyb9['tail_ms']:.1f}), max rel err "
          f"{hyb9['rel_err']:.3e}, peak {hyb9['peak_gib']:.2f} GiB; band {band['ms']:.3f} ms "
          f"(corr {band['ms_corr']:.3f}, bound {band['bound_ms']:.3f}, plain "
          f"{band['plain_ms']:.3f}, einsum {band['library_ms']}); phase {ph['shape']}: host TF "
          f"{ph['tf_s']:.2f} s, inverse {ph['ms']:.3f} ms, rel err {ph['rel_err']:.3e}, peak "
          f"{ph['peak_gib']:.2f} GiB; the FFT phases took {fft_s:.1f} s", flush=True)
    print(f"[5] {card}: tracking at raw {RAW_SHAPE} (deskewed {deskewed_shape()}), warm update "
          "ms from the card / from a host numpy stack: "
          + ", ".join(f"{m} {v['warm_ms']:.1f} / {v['host_ms']:.1f}" for m, v in
                      trk["methods"].items())
          + f"; blur {trk['ops']['blur_ms']:.3f} ms, multi-Otsu {trk['ops']['multi_otsu_ms']:.3f}, "
          f"NCC {trk['ops']['ncc_ms']:.3f}, PCC {trk['ops']['pcc_ms']:.3f}; label-free pcc at "
          f"{trk['lf']['shape']} {trk['lf']['warm_ms']:.1f} ms warm, {trk['lf']['first_ms']:.1f} "
          f"first; focus {trk['lf']['focus_ms']:.3f} ms; phase 4m took {trk['seconds']:.1f} s",
          flush=True)
    print(f"[5] {card}: DynaTrack loop at raw {RAW_SHAPE}: update {loop['first_ms']:.1f} ms first, "
          f"{loop['warm_ms']:.1f} ms warm (4m's pcc {trk['methods']['pcc']['first_ms']:.1f} / "
          f"{trk['methods']['pcc']['warm_ms']:.1f}); drains max {max(loop['drain_s']):.3f} s; "
          f"residual after each correction {loop['residual_px']} px; peak "
          f"{loop['peak_gib']:.2f} GiB; phase 4q took {loop['seconds']:.1f} s", flush=True)
    print(f"[5] {card}: the acquisition engine at raw {RAW_SHAPE}: {eng['volumes']} volumes, "
          f"{eng['host_s_per_volume']:.3f} host s a volume; update {eng['first_ms']:.1f} ms "
          f"first, {eng['warm_ms']:.1f} ms warm; drains max {max(eng['drain_s']):.3f} s; "
          f"residual after each correction {eng['residual_px']} px; peak "
          f"{eng['peak_gib']:.2f} GiB; phase 4r took {eng['seconds']:.1f} s", flush=True)
    print(f"[5] {card}: the live viewer at raw {view['raw']} (/dev/shm {view['shm_bytes']} "
          f"bytes): the feeder {view['feeder_s_per_volume']:.3f} s a volume on the acquisition "
          f"thread (each {[round(v, 3) for v in view['feeder_s']]}), the engine "
          f"{view['host_s_per_volume']:.3f} host s a volume beside it (4r "
          f"{view['engine_4r_host_s_per_volume']:.3f}), the attached monitor's work "
          f"{[round(v, 3) for v in view['watch_s']]} s, gathers "
          f"{[round(v, 1) for v in view['gather_ms']]} ms a volume, {view['evicted']} older volumes "
          f"evicted, {view['n_slots']} slots, preview correlation "
          f"{view['corr']:.6f}, matplotlib {'present' if view['matplotlib'] else 'absent'}, the "
          f"monitor subprocess's exit code {view['monitor_exit']}; phase 4s took "
          f"{view['seconds']:.1f} s", flush=True)
    print(f"[5] {card}: virtual staining at {vs['unet25d']['shape']}: unet25d VS "
          f"{vs['unet25d']['vs_ms']:.1f} ms warm (bound {vs['unet25d']['bound_ms']:.1f}), "
          f"{vs['unet25d']['first_vs_ms']:.1f} first, update {vs['unet25d']['update_ms']:.1f} ms, "
          f"peak {vs['unet25d']['peak_gib']:.2f} GiB at batch {vs['unet25d']['batch']}, rel err "
          f"{vs['unet25d']['rel_err']:.3e}; "
          + ", ".join(f"{k} {v['ms']:.1f} ms (bound {v['bound_ms']:.1f}), peak "
                      f"{v['peak_gib']:.2f} GiB, rel err {v['rel_err']:.3e}"
                      for k, v in vs["unext2"].items())
          + f"; chain {vs['chain']['ms']:.1f} ms, rel err {vs['chain']['rel_err']:.3e}; phase 4n "
          f"took {vs['seconds']:.1f} s", flush=True)
    print(f"[5] {card}: VS training: "
          + ", ".join(f"{r['net']} at batch {r['batch']}, patch {r['patch']}: step "
                      f"{r['step_ms']:.2f} ms (first {r['first_step_ms']:.1f}, bound "
                      f"{r['bound_ms']:.3f}), peak {r['peak_gib']:.2f} GiB, loss "
                      f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}" for r in trn["runs"])
          + f"; phase 4o took {trn['seconds']:.1f} s; config 2: {mpsf['n_beads']} beads measured "
          f"in {mpsf['measure_s']:.2f} s, K {mpsf['k']} of {mpsf['psf_shape']}, deskew + RL-20 "
          f"{mpsf['ms']:.1f} ms, {mpsf['gvox_s']:.4f} GVox/s, peak {mpsf['peak_gib']:.2f} GiB; "
          f"phase 4p took {mpsf['seconds']:.1f} s", flush=True)
    print(f"[5] {card}: the compiled passes at config 2's grid {config2_carry()}: z "
          f"{axis_p['z_ms']:.3f} ms (runtime-length kernel {axis_p['z_runtime_ms']:.3f}, bound "
          f"{axis_p['z_bound_ms']:.3f}, F.conv3d {axis_p['z_library_ms']:.3f}), y "
          f"{axis_p['ms']:.3f} ms ({axis_p['runtime_ms']:.3f}, bound {axis_p['bound_ms']:.3f}, "
          f"F.conv3d {axis_p['library_ms']:.3f}), x mid term {x_p['ms']:.3f} ms "
          f"({x_p['runtime_ms']:.3f}, bound {x_p['bound_ms']:.3f}, F.conv3d "
          f"{x_p['library_ms']:.3f}), x last term {x_p['last_ms']:.3f} ms "
          f"({x_p['last_runtime_ms']:.3f}, bound {x_p['last_bound_ms']:.3f}); with the measured "
          f"taps " + ", ".join(f"{k} {v:.3f}" for k, v in mpsf["pass_ms"].items()), flush=True)
    mb, md = mesh["b"], mesh["d"]
    print(f"[5] {card}: the mesh on one card ({MESH_RANKS} gloo ranks): (a) pass 1 "
          f"{mesh['a']['rel_err']:.3e}; (b) {MESH_MAIN_BATCH} production raws over (2, 2): steps "
          f"{[round(r['s'], 2) for r in mb['ranks']]} s, peaks "
          f"{[round(r['peak_gib'], 2) for r in mb['ranks']]} GiB, reshard alone "
          f"{[round(r['reshard_s'], 3) for r in mb['ranks']]} s, "
          f"{'bit-equal' if all(r['equal'] for r in mb['ranks']) else 'within 1e-5'}, launches "
          f"{mb['launches']}; (c) pass 3 {mesh['c']['rel_err']:.3e} ({mesh['c']['rel_err_f64']:.3e} "
          f"of float64); (d) pass 4(b) carry {tuple(md['ranks'][0]['carry'])}, steps "
          f"{[round(r['s'], 2) for r in md['ranks']]} s, peaks "
          f"{[round(r['peak_gib'], 2) for r in md['ranks']]} GiB (estimate {MESH_SHARD_EST_GIB}), "
          f"a transpose alone {[round(r['transpose_s'], 3) for r in md['ranks']]} s, rel err "
          f"{max(r['rel_err'] for r in md['ranks']):.3e}; (e) NCCL {mesh['e']['rel_err']:.3e}; "
          f"phase 4t took {mesh['seconds']:.1f} s", flush=True)
    st = store["stages"]
    fx, enc = store["fixtures"], store["encode"]
    print(f"[5] {card}: the store path (4u): blosc-zstd decoded at {fx['mb_s']:.1f} MB/s (1 GiB "
          f"of the fixtures' frames, {fx['threads']} cores; {fx['one_thread_mb_s']:.1f} on one); "
          f"encoded at {enc['mb_s']:.1f} MB/s ({enc['one_thread_mb_s']:.1f} on one) to "
          f"{enc['ratio']:.4f} of a camera raw; "
          f"`reconstruct` of {STORE_TIMEPOINTS} production raws {store['cli_s']:.2f} s wall "
          f"(read {st['read']:.2f}, h2d {st['h2d']:.2f}, compute {st['compute']:.2f}, d2h {st['d2h']:.4f}, write {st['write']:.2f} s), "
          + ("bit-equal to the step" if store["gap"] == 0.0 else f"{store['gap']:.3e} of the step")
          + f", peak {store['peak_gib']:.2f} GiB, {store['out_disk']} bytes on disk for "
          f"{store['out_raw']} ({store['out_disk'] / store['out_raw']:.4f}); input "
          f"{store['in_disk']} for {store['in_raw']} ({store['in_disk'] / store['in_raw']:.4f}); "
          "--resume and "
          f"the verbs {store['runs_s']:.2f} s (gap {store['verbs_gap']:.3e}, launches "
          f"{store['launches']}); phase 4u took "
          f"{store['seconds']:.1f} s", flush=True)
    vl = verbs["launches"]
    print(f"[5] {card}: the other verbs through the CLI (4v): "
          + ", ".join(f"({k}) {sum(r['s'] for r in v.get('recs', [v.get('rec')])):.2f} s"
                      for k, v in verbs.items()
                      if isinstance(v, dict) and ("rec" in v or "recs" in v))
          + f"; measured PSF from {verbs['a']['n_beads']} beads, the map's offset error "
          f"{verbs['b']['offset_err_px']:.4f} px, config 2 K {verbs['c']['k']}, the phase TF "
          f"{'a cache hit' if verbs['g']['tf_hit'] else 'missed'}, replay's stage offsets "
          f"{verbs['h']['offsets']}, train-vs best validation "
          f"{verbs['k']['report']['best_val_loss']:.4f}; launches {vl}; phase 4v took "
          f"{verbs['seconds']:.1f} s", flush=True)
    kernels = [
        {"name": "deskew", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/deskew.cu",
         "replaces": "shrimpy_tpu/ops/deskew_pallas.py:293",
         "launches": step["launches"]["deskew"] + eng["launches"] + view["launches"]
         + mb["launches"]["deskew"] + store["launches"]["deskew"] + vl["deskew"], **desk},
        {"name": "rl_half_step", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_half.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": step["launches"]["rl_half_one_launch"] + mb["launches"]["rl_half_one_launch"]
         + store["launches"]["rl_half_one_launch"] + vl["rl_half_one_launch"], **rl},
        {"name": "rl_half_step_accel", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_half.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": biggs["launches"]["rl_half_one_launch"], **accel},
        {"name": "rl_half_step_three_pass", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_pass.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": three["rl_half_step"] + three["rl_half_step_accel"], **rl3},
        {"name": "axis_pass", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_pass.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": mpsf["launches"]["axis_pass"] + vl["axis_pass"], **axis_p},
        {"name": "x_pass", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_pass.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused.py:312",
         "launches": mpsf["launches"]["x_pass"] + vl["x_pass"], **x_p},
        {"name": "convzy_linear", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/convzy.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:356",
         "launches": lin["RL-20"]["launches"]["convzy_march"], **zy},
        {"name": "convzy_circular", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/convzy.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:175",
         "launches": zyp["launches"]["convzy_march"], **czy,
         "x_pass_max_abs_err": xcirc["max_abs_err"], "x_pass_ms": xcirc["ms"],
         "x_pass_plain_ms": xcirc["plain_ms"], "x_pass_bound_ms": xcirc["bound_ms"],
         "x_pass_bound_by": xcirc["bound_by"]},
        {"name": "convzy_two_pass", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_pass.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:356",
         "launches": routes["launches"], "max_abs_err": 0.0, "ms": zy["ms_two_pass"],
         "ms_circular": czy["ms_two_pass"],
         **{k: zy[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "conv3_circular", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/rl_half.cu",
         "replaces": "shrimpy_tpu/ops/conv3_pallas.py:104", **c3},
        {"name": "rl_iter", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/rl_iter.cu",
         "replaces": "shrimpy_tpu/ops/rl_fused_iter.py:246",
         "launches": fip["launches"]["rl_iter"], **it},
        {"name": "affine_warp", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/affine.cu",
         "replaces": "shrimpy_tpu/ops/register.py:472 (XLA, no TPU kernel)",
         "launches": sreg["launches"]["affine_warp"] + vl["affine_warp"], **aff},
        {"name": "affine_refine_sums", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/affine.cu",
         "replaces": "shrimpy_tpu/ops/register.py:609 (XLA, no TPU kernel)",
         "launches": reg["launches"]["refine_sums"] + vl["refine_sums"], **rsums},
        {"name": "affine_refine_grad", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/affine.cu",
         "replaces": "shrimpy_tpu/ops/register.py:609 (XLA, no TPU kernel)",
         "launches": reg["launches"]["refine_grad"] + vl["refine_grad"], **rgrad},
        {"name": "probe_smem_slice", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/probe_mosaic.py:22", **p_slice},
        {"name": "probe_smem", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/probe_mosaic.py:47", **p_smem},
        {"name": "probe_split_dot", "route": "cuda",
         "source": "shrimpy_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/probe_mosaic.py:65", **p_dot},
        {"name": "zband", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/zband.cu",
         "replaces": "shrimpy_tpu/ops/deconv.py:445 (XLA band of _rl_fft2z_jit :340, no TPU "
                     "kernel)",
         "launches": nonsep["launches"]["zband"], **band},
        {"name": "rl_ratio", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/rl_fft.cu",
         "replaces": "shrimpy_tpu/ops/deconv.py:340 (XLA update of _rl_fft2z_jit, no TPU "
                     "kernel)",
         "launches": nonsep["launches"]["rl_ratio"], **ratio},
        {"name": "rl_scale", "route": "cuda", "source": "shrimpy_tpu_torch/csrc/rl_fft.cu",
         "replaces": "shrimpy_tpu/ops/deconv.py:340 (XLA update of _rl_fft2z_jit, no TPU "
                     "kernel)",
         "launches": nonsep["launches"]["rl_scale"], **scale},
    ]
    for entry in kernels:  # gpu_ms times a call over SLOW_CALL_MS once, as its first run
        lib = entry["library_ms"]
        entry["library_timing"] = None if lib is None else (
            "one cold call" if lib > SLOW_CALL_MS else "warm")
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for entry in kernels:
        if keys - set(entry) or not entry["launches"] > 0:
            raise AssertionError(f"kernel entry {entry.get('name')}: missing "
                                 f"{sorted(keys - set(entry))} or never launched")
    late = sorted(p.name for p in build.BUILD_DIR.glob("*.so") if p not in built)
    print(f"[5] libraries compiled after phase 2, at their first launch: {len(late)} {late}",
          flush=True)
    print(f"[5] chip_smoke.py total {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The reconstruction step: deskew -> phase -> register -> deconvolve,
on one device or over a ``(batch, space)`` mesh (counterpart of
``shrimpy_tpu/parallel/pipeline.py``: ``build_reconstruct_step``,
``reconstruct_batch``, ``output_shape``, ``_stage_fns``,
``_register_fn``, ``_deconv_fn``, ``_fft_stages_sharded``,
``_stage_input_shape_for_phase``).

The JAX step is one jit program mapped over the batch and sharded over
a mesh. PyTorch runs eagerly, so the port's step is a Python loop over
the volumes of a ``(B, S, T, X)`` batch, in the JAX order: the deskew
kernel; the phase inverse (``torch.fft``, with the transfer function
the caller passes or the step computes once per shape on the host); the
affine warp of a transform JSON when ``registration.transform_path`` is
set (one kernel launch); then RL as ``richardson_lucy`` dispatches it:
separable (the half-step kernels), ``hybrid`` (separable warm
iterations, then the FFT RL) or the FFT RL (``torch.fft`` and, on
``fft2z``, the band kernel) for ``fft`` and for a PSF no separable tier
takes.

With a mesh (:func:`~shrimpy_tpu_torch.parallel.mesh.make_mesh`) every
rank runs the step on the same global batch, a numpy array or a host
tensor, and moves only its own block to its device: its row's volumes
and its X slab (JAX's ``P("batch", None, None, "space")``). The deskew
runs on the slab (it is pointwise in X). Then, as in JAX:

* with a phase, registration or deconvolution stage, the volumes are
  resharded to whole volumes (one ``all_to_all`` over the row when the
  batch divides the device count, JAX's ``P(("batch", "space"))``; else
  every rank of a row gathers the row's volumes, JAX's replicated
  ``P("batch")``, and computes them all), and the per-volume stages run
  unchanged, kernels included;
* under ``shard_volumes`` the volumes stay X-sharded and the phase
  inverse and the FFT RL run as distributed slab FFTs
  (:mod:`~shrimpy_tpu_torch.parallel.fft`); the RL's OTF slab is built
  analytically on each rank, and the grid's X pad and crop move columns
  between the ranks of a row with uneven ``all_to_all`` splits (JAX
  leaves both to GSPMD's halo exchanges). No rank holds a whole volume.

The mesh step returns the rank's :class:`Block`: its output and its
place in the global output. :func:`reconstruct_batch` with a mesh
gathers the blocks and returns the global ``(B, Z, Y, X)`` on the host,
on every rank (JAX's ``np.asarray`` of its global array). The sharded
stages run volume by volume (the JAX block holds a rank's volumes at
once; each volume's arithmetic is the same).

Settings are read by attribute: a pydantic ``ReconstructSettings`` or
a :class:`types.SimpleNamespace` with the same field names (see
:mod:`shrimpy_tpu_torch.config`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shrimpy_tpu_torch.ops.deconv import (
    _padded_grid_shape,
    check_ported,
    plan_hybrid_terms,
    plan_terms,
    prepare_psf,
    rl_hybrid,
    rl_separable,
)
from shrimpy_tpu_torch.ops.deskew import (
    DESKEW_BACKENDS,
    deskew_plain,
    deskew_volume,
    get_deskewed_shape,
)
from shrimpy_tpu_torch.ops.phase import (
    apply_inverse_transfer_function,
    compute_transfer_function,
    resolve_transform,
    tf_tensor,
)
from shrimpy_tpu_torch.ops.register import affine_apply, affine_apply_plain
from shrimpy_tpu_torch.ops.rl_fft import rl_fft
from shrimpy_tpu_torch.parallel.fft import _all_to_all_tiled, fft3_sharded, ifft3_sharded
from shrimpy_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, all_to_all, assemble
from shrimpy_tpu_torch.utils.device import as_tensor, resolve_device
from shrimpy_tpu_torch.utils.fft import _pad
from shrimpy_tpu_torch.utils.timing import span


def _deskew_fn(settings, *, plain: bool, dtype: torch.dtype):
    desk = settings.deskew
    if desk is None:
        return None
    if desk.backend not in DESKEW_BACKENDS:
        raise ValueError(f"deskew backend {desk.backend!r} not in {DESKEW_BACKENDS}")
    if plain:
        return lambda raw: deskew_plain(raw, desk, dtype=dtype)
    return lambda raw: deskew_volume(raw, desk)


def _phase_fn(settings, *, dtype: torch.dtype):
    """Per-volume phase inverse ``fn(vol, tf)``, ``tf`` a complex tensor
    on the volume's device; None without ``settings.phase``."""
    phase = settings.phase
    if phase is None:
        return None
    z_padding = phase.transfer_function.z_padding

    def inverse(vol: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
        return apply_inverse_transfer_function(vol, tf, phase.apply_inverse,
                                               z_padding=z_padding, dtype=dtype)

    return inverse


def _register_fn(settings, *, plain: bool, dtype: torch.dtype):
    """Affine-apply stage from the transform JSON the ``register`` verb
    writes (``{"matrix_zyx", "offset_zyx"}``), read once here; None
    without ``registration.transform_path``, as in the JAX package."""
    reg = settings.registration
    if reg is None or reg.transform_path is None:
        return None
    import json

    with open(reg.transform_path) as f:
        transform = json.load(f)
    matrix = np.asarray(transform["matrix_zyx"], np.float32)
    offset = np.asarray(transform["offset_zyx"], np.float32)
    if plain:
        return lambda vol: affine_apply_plain(vol, matrix, offset, tuple(vol.shape), dtype=dtype)
    # The map on each device the step meets, copied there once: a copy from
    # the host a volume would wait for the card to finish the deskew.
    maps = {}

    def apply(vol: torch.Tensor) -> torch.Tensor:
        if vol.device not in maps:
            maps[vol.device] = (torch.from_numpy(matrix).to(vol.device),
                                torch.from_numpy(offset).to(vol.device))
        return affine_apply(vol, *maps[vol.device], tuple(vol.shape))

    return apply


def _deconv_fn(settings, psf, *, terms=None, plain: bool, dtype: torch.dtype):
    """Per-volume RL stage with the PSF (and its separable or warm terms)
    fixed at build time, dispatched as JAX's ``_deconv_fn`` and
    ``richardson_lucy`` do: ``hybrid`` (with warm iterations) through
    :func:`~shrimpy_tpu_torch.ops.deconv.rl_hybrid`, ``auto`` and
    ``separable`` through the separable path where the PSF decomposes,
    the FFT RL otherwise and under ``fft``. ``terms`` overrides the
    planned separable (or, under ``hybrid``, warm) terms."""
    deconv = settings.deconvolve
    if deconv is None:
        return None
    if psf is None:
        raise ValueError("deconvolve stage enabled but no PSF provided")
    check_ported(deconv)
    psf_np = prepare_psf(psf, deconv)
    kw = {"plain": plain, "dtype": dtype}
    if getattr(settings, "shard_volumes", False):
        # The mesh runs _fft_stages_sharded; no separable plan is made.
        if deconv.algorithm == "hybrid":
            raise ValueError(_HYBRID_SHARDED)
        return lambda vol: rl_fft(vol, psf_np, deconv, deconv.iterations, **kw)
    if deconv.algorithm == "hybrid" and deconv.hybrid_separable_iters:
        warm = terms if terms is not None else plan_hybrid_terms(psf_np, deconv)[0]
        return lambda vol: rl_hybrid(vol, psf_np, warm, deconv, deconv.iterations, **kw)
    if deconv.algorithm in ("auto", "separable"):
        if terms is None:
            terms = plan_terms(psf_np, deconv)
        if terms is not None:
            return lambda vol: rl_separable(vol, psf_np, terms, deconv, deconv.iterations, **kw)
    return lambda vol: rl_fft(vol, psf_np, deconv, deconv.iterations, **kw)


def _stage_fns(settings, psf, mesh=None, *, terms=None, plain=False,
               dtype=torch.float32):
    """``(deskew_fn, phase_fn, register_fn, deconv_fn)`` per-volume
    stages, each None where the settings leave it out."""
    return (
        _deskew_fn(settings, plain=plain, dtype=dtype),
        _phase_fn(settings, dtype=dtype),
        _register_fn(settings, plain=plain, dtype=dtype),
        _deconv_fn(settings, psf, terms=terms, plain=plain, dtype=dtype),
    )


_HYBRID_SHARDED = (
    "shard_volumes runs the plain sharded RL update; "
    "algorithm='hybrid' (separable warm phase on volume-"
    "local kernels) is not supported on the distributed "
    "slab path"
)

# fft_backend -> the slab transform's name (the grid policy follows it).
_SHARDED_TRANSFORM = {"dft2z": "matmul", "dftz": "matmul", "fft2z": "xla", "fft3": "xla"}


def _reslab_x(vol: torch.Tensor, src: np.ndarray, out_width: int, group, index: int,
              n: int) -> torch.Tensor:
    """Columns moved between the X slabs of a row: ``vol`` (..., w) is
    slab ``index`` of ``n`` of a global X axis; output column ``p`` of
    the global ``out_width * n`` takes global input column ``src[p]``
    (zero where it is -1). Each rank sends each other rank only the
    columns that rank's slab reads, in one ``all_to_all`` with uneven
    splits; no rank holds the whole axis."""
    w = vol.shape[-1]
    lo = index * w
    send, in_splits = [], []
    for r in range(n):
        s = src[r * out_width:(r + 1) * out_width]
        cols = s[(s >= lo) & (s < lo + w)] - lo
        send.append(cols)
        in_splits.append(len(cols))
    mine = src[index * out_width:(index + 1) * out_width]
    recv, out_splits = [], []
    for r in range(n):
        pos = np.nonzero((mine >= r * w) & (mine < (r + 1) * w))[0]
        recv.append(pos)
        out_splits.append(len(pos))
    cols = vol.movedim(-1, 0)
    idx = torch.from_numpy(np.concatenate(send).astype(np.int64)).to(vol.device)
    got = all_to_all(cols.index_select(0, idx), group, out_splits, in_splits)
    out = vol.new_zeros((out_width, *cols.shape[1:]))
    pos = torch.from_numpy(np.concatenate(recv).astype(np.int64)).to(vol.device)
    out.index_copy_(0, pos, got)
    return out.movedim(0, -1).contiguous()


def _local_otf_block(psf_np: np.ndarray, grid, index: int, n_shards: int,
                     device) -> torch.Tensor:
    """This rank's X slab of ``fftn(embed_psf(psf, grid))``, JAX's
    ``_local_otf_block``: the embedded PSF is nonzero on only
    ``kz*ky*kx`` voxels, so ``OTF[i,j,l] = sum_abc psf[a,b,c] Az[i,a]
    Ay[j,b] Ax[l,c]`` with ``A_N[i,a] = exp(-2j pi i (a - c_axis) / N)``,
    the phases in float32 and three ``einsum``s; never a whole-grid
    array."""
    gz, gy, gx = grid
    kz, ky, kx = psf_np.shape
    cz, cy, cx = kz // 2, ky // 2, kx // 2
    xloc = gx // n_shards
    x0 = index * xloc
    psf_c = torch.from_numpy(psf_np.astype(np.complex64) / np.float32(psf_np.sum())).to(device)

    def factor(i_idx, n, k, c):
        a = torch.arange(k, dtype=torch.float32, device=device)[None, :] - np.float32(c)
        step = torch.tensor(-2.0 * np.pi / n, dtype=torch.float32, device=device)
        ph = step * i_idx.to(torch.float32)[:, None] * a
        return torch.polar(torch.ones_like(ph), ph)

    az = factor(torch.arange(gz, device=device), gz, kz, cz)
    ay = factor(torch.arange(gy, device=device), gy, ky, cy)
    ax = factor(x0 + torch.arange(xloc, device=device), gx, kx, cx)
    t1 = torch.einsum("ia,abc->ibc", az, psf_c)
    t2 = torch.einsum("jb,ibc->ijc", ay, t1)
    return torch.einsum("lc,ijc->ijl", ax, t2)


def sharded_rl_grid(vol_shape, psf_shape, deconv, n_space: int) -> tuple:
    """``(transform, grid, pads)`` of the sharded FFT RL for a working PSF
    of ``psf_shape``: the slab transform named by ``fft_backend``
    (``dft2z`` and ``dftz`` -> ``matmul``, ``fft2z`` and ``fft3`` ->
    ``xla``, ``auto`` -> ``xla`` as off the TPU) and the padded grid of
    its policy, whose Y and X must divide over ``n_space``. Each rank's
    carry is ``(gz, gy, gx / n_space)``."""
    rl_tr = _SHARDED_TRANSFORM.get(deconv.fft_backend, "xla")
    grid, pads = _padded_grid_shape(tuple(vol_shape), tuple(psf_shape), transform=rl_tr)
    if grid[1] % n_space or grid[2] % n_space:
        raise ValueError(
            f"shard_volumes: padded RL grid {grid} must be divisible by "
            f"the space axis ({n_space}) on Y and X"
        )
    return rl_tr, grid, pads


def _fft_stages_sharded(settings, psf, mesh: Mesh):
    """Volumetric stages on X-sharded volumes: distributed slab FFTs.

    The >HBM ``shard_volumes`` path: ``fn(vol, tf_slab)`` runs the phase
    inverse and the FFT RL on this rank's X slab ``(Z, Y, X / space)`` of
    one volume, with :mod:`~shrimpy_tpu_torch.parallel.fft`'s slab
    transforms over the row; ``tf_slab`` is the transfer function's X
    slab. None without a phase or deconvolution stage. ``fn.carry`` is
    the rank's padded RL carry ``(gz, gy, gx / space)`` of the last
    volume.
    """
    phase = settings.phase
    deconv = settings.deconvolve
    if settings.registration is not None and settings.registration.transform_path:
        raise ValueError(
            "shard_volumes does not support the registration-apply stage "
            "(affine gathers span shards); register on whole volumes"
        )
    if phase is None and deconv is None:
        return None
    psf_np = None
    if deconv is not None:
        if psf is None:
            raise ValueError("deconvolve stage enabled but no PSF provided")
        if deconv.acceleration != "none":
            raise ValueError(
                "shard_volumes runs the plain sharded RL update; "
                f"acceleration='{deconv.acceleration}' is not supported "
                "on the distributed slab path (single-chip FFT RL only)"
            )
        if deconv.algorithm == "hybrid":
            raise ValueError(_HYBRID_SHARDED)
        psf_np = prepare_psf(psf, deconv)
    group = mesh.group("space")
    n_space = mesh.devices.shape[1]
    index = mesh.axis_index("space")

    def run(vol: torch.Tensor, tf) -> torch.Tensor:
        vol = vol.to(torch.float32)
        if phase is not None:
            with span("shrimpy.phase"):
                zp = phase.transfer_function.z_padding
                reg = float(phase.apply_inverse.regularization_strength)
                if zp:
                    vol = _pad(vol, ((zp, zp), (0, 0), (0, 0)), "reflect")
                if vol.shape[1] % n_space:
                    raise ValueError(
                        f"shard_volumes: Y extent {vol.shape[1]} must be divisible "
                        f"by the space axis ({n_space}) for the slab transpose"
                    )
                ph_tr = resolve_transform(phase.apply_inverse)
                mean = all_reduce(vol.mean().reshape(1), group) / n_space
                spectrum = fft3_sharded((vol - mean).to(torch.complex64), group, ph_tr)
                recon = tf.conj() * spectrum / (tf.abs() ** 2 + reg)
                del spectrum
                vol = ifft3_sharded(recon, group, ph_tr).real.to(torch.float32)
                if zp:
                    vol = vol[zp:-zp]

        if deconv is not None:
            with span("shrimpy.rl"):
                shape = tuple(vol.shape[:2]) + (vol.shape[2] * n_space,)
                rl_tr, grid, pads = sharded_rl_grid(shape, psf_np.shape, deconv, n_space)
                eps = float(deconv.epsilon)
                mode = deconv.pad_mode
                with span("shrimpy.rl.start"):
                    padded = _pad(vol, (*pads[:2], (0, 0)), mode)
                    del vol
                    (xlo, xhi), gl = pads[2], grid[2] // n_space
                    src = np.pad(np.arange(shape[2]), (xlo, xhi), mode=mode,
                                 **({"constant_values": -1} if mode == "constant" else {}))
                    padded = _reslab_x(padded, src, gl, group, index, n_space)
                    run.carry = tuple(padded.shape)

                    # Each rank builds ITS X slab of the OTF analytically: a
                    # whole-grid fftn would hold a whole volume on one rank.
                    otf = _local_otf_block(psf_np, grid, index, n_space, padded.device)
                    data = torch.clamp_min(padded, 0.0)
                    est = torch.clamp_min(padded, eps)
                    del padded

                def conv(u, kernel):
                    f = fft3_sharded(u.to(torch.complex64), group, rl_tr)
                    return ifft3_sharded(f.mul_(kernel), group, rl_tr).real

                for _ in range(deconv.iterations):
                    with span("shrimpy.rl.iteration"):
                        ratio = data / torch.clamp_min(conv(est, otf), eps)
                        est = est * conv(ratio, otf.conj())
                        del ratio
                del data, otf
                with span("shrimpy.rl.crop"):
                    est = est[tuple(slice(lo, lo + n)
                                    for (lo, _), n in zip(pads[:2], shape[:2]))]
                    crop = np.arange(shape[2]) + xlo
                    vol = _reslab_x(est, crop, shape[2] // n_space, group, index, n_space)
        return vol

    return run


class Block(NamedTuple):
    """A rank's part of the mesh step's output: ``data`` (on the rank's
    device) is ``global[batch, :, :, x]``."""

    data: torch.Tensor
    batch: slice
    x: slice

    @property
    def index(self) -> tuple:
        return (self.batch, Ellipsis, self.x)


def block_places(mesh: Mesh, n_batch: int, n_x: int, whole: bool) -> list[tuple]:
    """Every rank's place in the global output of a mesh step (an index
    tuple): its row's volumes and its X slab, or, with ``whole``
    volumes, its volumes of the reshard (``P(("batch", "space"))`` when
    the batch divides the device count, else its row's)."""
    nb, ns = mesh.devices.shape
    b, xw = n_batch // nb, n_x // ns
    flat = ns > 1 and n_batch % mesh.devices.size == 0
    places = []
    for r in range(mesh.devices.size):
        i, j = divmod(r, ns)
        if not whole:
            places.append((slice(i * b, (i + 1) * b), Ellipsis, slice(j * xw, (j + 1) * xw)))
        elif flat:
            q = n_batch // mesh.devices.size
            places.append((slice(i * b + j * q, i * b + (j + 1) * q), Ellipsis, slice(0, n_x)))
        else:
            places.append((slice(i * b, (i + 1) * b), Ellipsis, slice(0, n_x)))
    return places


def _host_block(x, index: tuple, device) -> torch.Tensor:
    """``x[index]`` on ``device``: only this block leaves the host (or
    the caller's device)."""
    if isinstance(x, torch.Tensor):
        return x[index].to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[index])).to(device)


def build_reconstruct_step(
    settings,
    *,
    psf: np.ndarray | None = None,
    mesh: Mesh | None = None,
    device: str | torch.device | None = None,
    terms=None,
    plain: bool = False,
    dtype: torch.dtype = torch.float32,
    donate: bool = True,
):
    """Batched step ``fn(batch_raw, tf=None)``.

    ``batch_raw`` is ``(B, S, T, X)``: a tensor, which stays on its
    device unless ``device`` moves it, or a numpy array, which goes to
    ``device`` (the card when None, raising where there is none;
    ``"cpu"`` asks for the CPU). The output is ``(B, Z, Y, X)`` on the
    same device. ``tf`` is the phase stage's transfer function for the
    volume entering it (:func:`compute_transfer_function` of
    :func:`_stage_input_shape_for_phase`): complex, or the (2, Z, Y, X)
    real pair the JAX step takes. With the phase stage set and ``tf``
    None, the step computes it on the host once per volume shape and
    keeps it on the device. ``terms`` overrides the planned separable
    decomposition (numpy ``(wz, wy, wx)`` triples; under ``hybrid`` the
    warm terms). On a CUDA device the stages run the CUDA kernels;
    ``plain=True`` runs their plain PyTorch versions in ``dtype`` instead
    (the reference path).

    With ``mesh`` the step runs on the mesh's device and returns this
    rank's :class:`Block`; every rank passes the same global batch (and
    ``tf``, whole), and only the rank's block is moved to its device.
    ``B`` must divide over the mesh's ``batch`` axis and ``X`` over its
    ``space`` axis.

    ``donate`` (JAX's default, True) lets the step drop its own reference
    to the batch once the last volume has entered the first stage, so a
    device copy the step made of a numpy batch returns to the allocator
    before the later stages run. The step never writes or empties the
    caller's tensor (unlike ``donate_input``, which consumes the image,
    ``ops/rl_fused.py::consume``), so a caller may reuse its batch under
    both values; ``donate=False`` keeps the reference for the whole call.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a shrimpy_tpu_torch.parallel.mesh.Mesh (make_mesh), "
                        f"got {type(mesh).__name__}")
    if mesh is not None and device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device!r} is not this rank's mesh device {mesh.device}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    deskew_fn, phase_fn, register_fn, deconv_fn = _stage_fns(
        settings, psf, mesh, terms=terms, plain=plain, dtype=dtype
    )
    shard = bool(getattr(settings, "shard_volumes", False))
    if shard and (mesh is None or mesh.devices.shape[1] < 2):
        # Without a space axis the >HBM flag would silently run whole
        # volumes (and run out of memory on exactly those volumes).
        raise ValueError(
            "shard_volumes requires a device mesh with space > 1 "
            "(pass --devices N --space S to the CLI, or make_mesh(n, "
            "space=s))"
        )
    computed = {}

    def phase_tf(vol: torch.Tensor, tf) -> torch.Tensor:
        if tf is not None:
            return tf_tensor(tf, vol.device)
        key = (tuple(vol.shape), vol.device)
        if key not in computed:
            computed.clear()
            computed[key] = tf_tensor(compute_transfer_function(
                key[0], settings.phase.transfer_function), vol.device)
        return computed[key]

    def volume(vol: torch.Tensor, tf) -> torch.Tensor:
        """The per-volume stages after the deskew."""
        if phase_fn is not None:
            with span("shrimpy.phase"):
                vol = phase_fn(vol, phase_tf(vol, tf))
        if register_fn is not None:
            with span("shrimpy.register"):
                vol = register_fn(vol)
        if deconv_fn is not None:
            with span("shrimpy.rl"):
                vol = deconv_fn(vol)
        return vol

    def deskew(vol: torch.Tensor) -> torch.Tensor:
        if deskew_fn is None:
            return vol
        with span("shrimpy.deskew"):
            return deskew_fn(vol)

    def step(batch_raw, tf=None) -> torch.Tensor:
        batch = as_tensor(batch_raw, dev)
        if batch.dim() != 4:
            raise ValueError(f"batch must be (B, S, T, X), got {tuple(batch.shape)}")
        outs, n = [], batch.shape[0]
        for b in range(n):
            with span("shrimpy.volume"):
                vol = batch[b]
                if donate and b == n - 1:
                    batch = None
                outs.append(volume(deskew(vol), tf).to(dtype))
        return outs[0][None] if len(outs) == 1 else torch.stack(outs)

    if mesh is None:
        return step

    sharded = _fft_stages_sharded(settings, psf, mesh) if shard else None
    whole = not shard and (phase_fn or register_fn or deconv_fn) is not None
    n_batch_ax, n_space_ax = mesh.devices.shape
    row = mesh.group("space")
    slab_tf = {}

    def tf_slab(vol_shape, tf, x_index) -> torch.Tensor:
        """The transfer function's X slab for the sharded phase (the JAX
        mesh takes it X-sharded too: a whole one would cost ~2x volume
        bytes on every rank)."""
        if tf is None:
            key = (vol_shape, dev)
            if key not in slab_tf:
                slab_tf.clear()
                full = compute_transfer_function(vol_shape, settings.phase.transfer_function)
                slab_tf[key] = tf_tensor(np.ascontiguousarray(full[..., x_index]), dev)
            return slab_tf[key]
        if isinstance(tf, torch.Tensor):
            return tf_tensor(tf[..., x_index], dev)
        return tf_tensor(np.ascontiguousarray(np.asarray(tf)[..., x_index]), dev)

    def mesh_step(batch_raw, tf=None) -> Block:
        shape = tuple(batch_raw.shape)
        if len(shape) != 4:
            raise ValueError(f"batch must be (B, S, T, X), got {shape}")
        # Even shards, checked before any transfer (JAX's messages).
        if shape[0] % n_batch_ax:
            raise ValueError(
                f"batch size {shape[0]} must be divisible by the mesh "
                f"batch axis ({n_batch_ax}); pad the work list or pick a mesh "
                "with --devices/--batch so volumes shard evenly"
            )
        if shape[3] % n_space_ax:
            raise ValueError(
                f"X extent {shape[3]} must be divisible by the mesh space "
                f"axis ({n_space_ax}); use a space factor that divides "
                "X (or space=1)"
            )
        places = block_places(mesh, shape[0], shape[3], False)
        rows, _, cols = places[mesh.rank]
        block = _host_block(batch_raw, places[mesh.rank], dev)
        vols = []
        for b in range(block.shape[0]):
            with span("shrimpy.volume"):
                vol = block[b]
                if donate and b == block.shape[0] - 1:
                    block = None
                vols.append(deskew(vol))
        if sharded is not None:
            tf_x = None if settings.phase is None else tf_slab(
                _stage_input_shape_for_phase(shape[1:], settings), tf, cols)
            outs = []
            for v in vols:
                with span("shrimpy.volume"):
                    outs.append(sharded(v, tf_x))
            vols = outs
        if not whole:
            return Block(torch.stack(vols).to(dtype), rows, cols)
        local = torch.stack(vols)
        del vols
        mine = block_places(mesh, shape[0], shape[3], True)[mesh.rank]
        if n_space_ax > 1:
            if shape[0] % mesh.devices.size == 0:
                # One all_to_all over the row: P(("batch", "space")).
                local = _all_to_all_tiled(local, row, 0, 3)
            else:
                # Every rank of the row holds the row's volumes: P("batch").
                local = torch.cat(all_gather(local, row), dim=3)
        if tf is not None and phase_fn is not None:
            tf = tf_tensor(tf, dev)  # once for the rank's volumes
        outs = []
        for b in range(local.shape[0]):
            with span("shrimpy.volume"):
                outs.append(volume(local[b], tf).to(dtype))
        return Block(torch.stack(outs), mine[0], mine[2])

    mesh_step.whole_volumes = whole
    mesh_step.sharded = sharded
    return mesh_step


def reconstruct_batch(batch_raw, settings, *, psf=None, mesh=None, device=None,
                      terms=None) -> torch.Tensor:
    """One-shot convenience: build the step and run it (``device`` as in
    :func:`build_reconstruct_step`). With ``mesh`` every rank calls it on
    the same batch, and every rank gets the global ``(B, Z, Y, X)`` on
    the host."""
    step = build_reconstruct_step(settings, psf=psf, mesh=mesh, device=device, terms=terms,
                                  donate=False)
    if mesh is None:
        return step(batch_raw)
    blk = step(batch_raw)
    n_batch, n_x = batch_raw.shape[0], batch_raw.shape[3]
    places = block_places(mesh, n_batch, n_x, step.whole_volumes)
    return assemble(mesh, blk.data, places, (n_batch, *blk.data.shape[1:3], n_x))


def _stage_input_shape_for_phase(raw_shape: tuple[int, int, int],
                                 settings) -> tuple[int, int, int]:
    """Shape of the volume entering the phase stage (post-deskew if any)."""
    if settings.deskew is not None:
        shape, _ = get_deskewed_shape(tuple(raw_shape), settings.deskew)
        return shape
    return tuple(raw_shape)


def output_shape(raw_shape: tuple[int, int, int], settings) -> tuple[int, int, int]:
    """Static output ZYX shape of the reconstruction for ``raw_shape``."""
    return _stage_input_shape_for_phase(raw_shape, settings)

"""Streaming reconstruction of an OME-Zarr store on one device
(counterpart of ``shrimpy_tpu/runtime/stream.py``).

Same contract as the JAX runtime: the work plan enumerates independent
(position, timepoint, channel) volumes; the chunk engine's async reads
prefetch the next batch while the current one computes; writes are
async and awaited one batch later; every read/write retries in place
and persistent failures are journaled failed-and-skipped; a JSON-lines
progress journal makes runs resumable. What changes is the device
transfer: ``jax.device_put`` becomes a copy into a pinned host buffer
and a ``non_blocking`` host-to-device copy, and the previous batch's
device-to-host copy runs on a side CUDA stream while the next batch
computes.

With a mesh (:mod:`shrimpy_tpu_torch.parallel.mesh`, one process a
device) every rank runs the loop on the same work list; rank 0 owns the
output store's creation and the journal, and the ranks that hold whole
output volumes write them (:func:`_reconstruct_on_mesh`). That path
reads and writes synchronously, without the feed's side stream.

This layer reads and writes stores through the port's own
:mod:`shrimpy_tpu_torch.io.ngff` on its chunk engine
(:mod:`shrimpy_tpu_torch.io.chunkstore`). ``plan_work``, ``_Progress``,
``_load_psf`` and ``_as_output_dtype`` are copies of the JAX module's, and
``_create_output_store`` is but for the output's chunks: a chunk is one
(t, c) volume, its z split evenly where the volume passes blosc's largest
chunk (:func:`_output_chunks`). A resumed run also redoes a volume the
journal has done with fewer chunks on disk than the journal recorded
(:func:`_redo_unstored`). With a phase stage
the transfer function is computed once per store, for the post-deskew
volume, and handed to every step on the device.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from shrimpy_tpu_torch.io import chunkstore, ngff
from shrimpy_tpu_torch.ops.deconv import gaussian_psf
from shrimpy_tpu_torch.ops.deskew import get_deskewed_shape
from shrimpy_tpu_torch.ops.phase import compute_transfer_function, tf_tensor
from shrimpy_tpu_torch.parallel.mesh import all_reduce, barrier, gather
from shrimpy_tpu_torch.parallel.pipeline import (
    _stage_input_shape_for_phase,
    build_reconstruct_step,
    output_shape,
)
from shrimpy_tpu_torch.runtime.feed import DeviceFeed
from shrimpy_tpu_torch.utils.device import resolve_device
from shrimpy_tpu_torch.utils.retry import robust_call
from shrimpy_tpu_torch.utils.shapes import round_up
from shrimpy_tpu_torch.utils.timing import StageTimer, device_memory_stats

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class WorkItem:
    position: str
    t: int
    c: int

    @property
    def key(self) -> str:
        return f"{self.position}|{self.t}|{self.c}"


def plan_work(store: ngff.NgffStore, settings) -> list[WorkItem]:
    """Enumerate the independent volumes selected by ``settings``."""
    items: list[WorkItem] = []
    for pos_key, pos in store.positions().items():
        if settings.positions is not None and pos_key not in settings.positions:
            continue
        t_size, c_size = pos.shape[0], pos.shape[1]
        # Unlabeled channels fall back to their index.
        names = [
            pos.channel_names[i]
            if pos.channel_names and i < len(pos.channel_names)
            else str(i)
            for i in range(c_size)
        ]
        for t in range(t_size):
            if settings.time_indices is not None and t not in settings.time_indices:
                continue
            for c in range(c_size):
                if settings.channels is not None and names[c] not in settings.channels:
                    continue
                items.append(WorkItem(pos_key, t, c))
    return items


def _load_psf(settings) -> np.ndarray | None:
    if settings.deconvolve is None:
        return None
    path = settings.deconvolve.psf_path
    if path is None:
        # Default synthetic PSF; real pipelines set psf_path.
        return gaussian_psf((9, 15, 15), (1.5, 2.5, 2.5))
    p = Path(path)
    if p.suffix == ".npy":
        return np.load(p).astype(np.float32)
    pos = ngff.open_ngff(p).position()
    return pos.volume(0, 0).astype(np.float32)


def _create_output_store(in_store, out_path: Path, settings, out_zyx, out_voxel, items):
    """Mirror the input layout (FOV or HCS) for the reconstructed data."""
    dtype = settings.output_dtype
    positions_out: dict[str, ngff.NgffPosition] = {}
    by_pos: dict[str, list[WorkItem]] = {}
    for it in items:
        by_pos.setdefault(it.position, []).append(it)

    if in_store.is_plate:
        first = next(iter(in_store.positions().values()))
        out_store = ngff.create_hcs(
            out_path, channel_names=first.channel_names, version=in_store.version
        )
        for pos_key in by_pos:
            positions_out[pos_key] = _create_plate_position(
                out_store, in_store.positions()[pos_key], pos_key,
                out_zyx, out_voxel, dtype,
            )
    else:
        in_pos = in_store.position()
        shape = (in_pos.shape[0], in_pos.shape[1], *out_zyx)
        pos = ngff.create_fov(
            out_path,
            shape=shape,
            dtype=dtype,
            channel_names=in_pos.channel_names,
            zyx_scale=out_voxel,
            chunks=_output_chunks(shape, dtype),
            version=in_store.version,
        )
        positions_out[ngff.DEFAULT_POSITION_KEY] = pos
    return positions_out


def _create_plate_position(out_store, in_pos, pos_key: str, out_zyx, out_voxel, dtype: str):
    row, col, fov = pos_key.split("/")
    pos = out_store.create_position(
        row, col, fov, channel_names=in_pos.channel_names, zyx_scale=out_voxel
    )
    shape = (in_pos.shape[0], in_pos.shape[1], *out_zyx)
    pos.create_array(shape, dtype=dtype, chunks=_output_chunks(shape, dtype))
    return pos


def _output_chunks(shape, dtype: str) -> tuple[int, ...]:
    """``ngff.default_chunks``, its z split evenly where one chunk would pass
    blosc 1's largest buffer (``chunkstore.BLOSC_MAX_BUFFERSIZE``): the
    production output (128, 2888, 1600) float32 is 2.37 GB, which neither
    the chunk engine nor tensorstore writes as one blosc chunk."""
    t, c, z, y, x = ngff.default_chunks(shape)
    plane = y * x * np.dtype(dtype).itemsize
    pieces = -(-z * plane // chunkstore.BLOSC_MAX_BUFFERSIZE)
    return (t, c, -(-z // pieces), y, x)


def _stored_chunks(positions_out, it) -> tuple[int, int]:
    """(the item's output chunks on disk, the chunks its volume spans)."""
    return positions_out[it.position].array()[it.t, it.c].stored_chunks()


def _redo_unstored(progress, positions_out, items) -> None:
    """On resume, take out of ``progress.done`` every volume with fewer
    output chunks on disk than its journal line recorded (a chunk lost or
    deleted since), so it is done again. The count, not the volume's span:
    a chunk equal to the fill value everywhere is not stored (by the engine
    as by tensorstore), so an all-zero volume has none. A line without a
    count (JAX's journal) is trusted."""
    for it in items:
        want = progress.chunks.get(it.key)
        if it.key not in progress.done or want is None:
            continue
        present, total = _stored_chunks(positions_out, it)
        if present < want:
            logger.warning("resume: %s is journaled done with %d of its %d chunks on disk, "
                           "%d now; redoing it", it.key, want, total, present)
            progress.done.discard(it.key)


def _as_output_dtype(batch: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "uint16":
        # NaN->uint16 is undefined: zero non-finite voxels explicitly.
        batch = np.nan_to_num(batch, nan=0.0, posinf=65535.0, neginf=0.0)
        return np.clip(batch, 0, 65535).astype(np.uint16)
    return batch.astype(np.float32)


class _Progress:
    """JSON-lines journal of completed work items (resume support).
    Lines with a ``failed`` field record contained per-item IO failures
    and do NOT count as done. JAX's journal but for a line's ``chunks``:
    how many of the item's output chunks were on disk when it was
    journaled (:func:`_redo_unstored`); JAX's reader takes these lines."""

    def __init__(self, path: Path):
        self.path = path
        self.done: set[str] = set()
        self.chunks: dict[str, int] = {}
        self.failed: list[dict] = []
        if path.exists():
            for line in path.read_text().splitlines():
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict) or "failed" in rec:
                        continue
                    self.done.add(rec["key"])
                    if isinstance(rec.get("chunks"), int):
                        self.chunks[rec["key"]] = rec["chunks"]
                except (json.JSONDecodeError, KeyError):
                    continue

    def mark(self, items: list[WorkItem], positions_out: dict | None = None) -> None:
        """Journal ``items`` as done, with the output chunks each has on
        disk where ``positions_out`` is given."""
        with open(self.path, "a") as f:
            for it in items:
                rec = {"key": it.key}
                if positions_out is not None:
                    rec["chunks"] = _stored_chunks(positions_out, it)[0]
                    self.chunks[it.key] = rec["chunks"]
                f.write(json.dumps(rec) + "\n")
                self.done.add(it.key)

    def mark_failed(self, item: WorkItem, stage: str, error: str) -> None:
        rec = {"key": item.key, "failed": stage, "error": error}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self.failed.append(rec)

    @staticmethod
    def iter_done_keys(path: Path):
        """Yield (position, t, c) for every DONE record in a journal: dict
        records only, lines with a ``failed`` field are not done, ``key`` is
        ``"pos|t|c"``; torn or corrupt lines are skipped. What the store-mode
        ``monitor`` reads (the JAX package's method, statement for
        statement)."""
        try:
            text = Path(path).read_text()
        except OSError:
            return
        for line in text.splitlines():
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or "failed" in rec:
                    continue
                pos_key, t, c = rec["key"].split("|")
                yield pos_key, int(t), int(c)
            except (json.JSONDecodeError, KeyError, ValueError):
                continue  # torn/corrupt line


def _prepare_output(in_store, output_path: Path, settings, out_zyx, out_voxel, items,
                    resume: bool):
    """(progress journal, output positions): a stale journal dropped,
    the output store created or checked against this run."""
    progress_path = output_path.with_suffix(output_path.suffix + ".progress.jsonl")
    if progress_path.exists() and (not resume or not output_path.exists()):
        # A journal without its output store is stale.
        progress_path.unlink()
    progress = _Progress(progress_path)

    if not output_path.exists():
        positions_out = _create_output_store(
            in_store, output_path, settings, out_zyx, out_voxel, items
        )
    else:
        out_store = ngff.open_ngff(output_path)
        positions_out = {
            k: v
            for k, v in out_store.positions().items()
            if k in {it.position for it in items}
        }
        # The existing output must match THIS run's geometry/dtype.
        for pos_key, pos in positions_out.items():
            in_tc = tuple(in_store.positions()[pos_key].shape[:2])
            want = (*in_tc, *out_zyx)
            if tuple(pos.shape) != want or str(pos.dtype) != settings.output_dtype:
                raise ValueError(
                    f"existing output {output_path} position {pos_key} has "
                    f"shape {tuple(pos.shape)} dtype {pos.dtype}, but this "
                    f"run produces {want} {settings.output_dtype}; remove "
                    "it or point -o elsewhere"
                )
        missing = {it.position for it in items} - set(positions_out)
        if missing and out_store.is_plate:
            for pos_key in sorted(missing):
                positions_out[pos_key] = _create_plate_position(
                    out_store, in_store.positions()[pos_key], pos_key,
                    out_zyx, out_voxel, settings.output_dtype,
                )
        elif missing:
            raise ValueError(
                f"existing FOV output {output_path} lacks positions "
                f"{sorted(missing)}; remove it or reconcile the selection"
            )
    return progress, positions_out


def reconstruct_store(
    input_path: str | Path,
    output_path: str | Path,
    settings,
    *,
    mesh=None,
    batch_size: int | None = None,
    resume: bool = False,
    timer: StageTimer | None = None,
    device: str | torch.device = "cuda",
    terms=None,
) -> dict:
    """Reconstruct every selected volume of ``input_path`` into
    ``output_path`` on ``device``; returns a summary dict.

    ``batch_size`` defaults to 1. With ``resume=True``, previously
    completed items (per the progress journal sidecar) are skipped.
    ``terms`` overrides the planned separable PSF decomposition.

    With ``mesh`` every rank calls it with the same arguments and the
    step runs on the rank's mesh device (``device`` is not read);
    ``batch_size`` defaults to the mesh's device count, rounded up to its
    batch axis; rank 0 returns the summary, with the mesh's shape, and
    the other ranks None (:func:`_reconstruct_on_mesh`).
    """
    input_path, output_path = Path(input_path), Path(output_path)
    dev = mesh.device if mesh is not None else resolve_device(device)
    timer = timer or StageTimer()
    in_store = ngff.open_ngff(input_path)
    items = plan_work(in_store, settings)
    if not items:
        raise ValueError(f"no work selected in {input_path}")

    first_pos = in_store.positions()[items[0].position]
    raw_zyx = tuple(first_pos.shape[2:])
    raw_scale = first_pos.zyx_scale
    for it in items:
        shape = tuple(in_store.positions()[it.position].shape[2:])
        if shape != raw_zyx:
            raise ValueError(
                f"position {it.position!r} has volume shape {shape} != "
                f"{raw_zyx}; reconstruct heterogeneous stores in "
                "per-shape runs using settings.positions"
            )

    out_zyx = output_shape(raw_zyx, settings)
    if settings.deskew is not None:
        _, out_voxel = get_deskewed_shape(
            raw_zyx, settings.deskew, pixel_size_um=raw_scale[1]
        )
    else:
        out_voxel = raw_scale

    # Builds the step first: unported settings raise before any output
    # store or journal is touched.
    psf = _load_psf(settings)
    step = build_reconstruct_step(settings, psf=psf, mesh=mesh, device=dev, terms=terms)
    tf = None
    if settings.phase is not None:
        # Once per store, for the volume entering the phase stage;
        # compute_transfer_function pads by z_padding itself (a padded
        # shape here would pad twice). The mesh step takes it on the host
        # and moves what its rank needs.
        tf = compute_transfer_function(_stage_input_shape_for_phase(raw_zyx, settings),
                                       settings.phase.transfer_function)
        if mesh is None:
            tf = tf_tensor(tf, dev or torch.device("cpu"))
    if mesh is not None:
        return _reconstruct_on_mesh(in_store, input_path, output_path, settings, mesh, items,
                                    raw_zyx, out_zyx, out_voxel, step, tf, batch_size, resume,
                                    timer)
    batch_size = batch_size or 1
    progress, positions_out = _prepare_output(in_store, output_path, settings, out_zyx,
                                              out_voxel, items, resume)
    if resume:
        _redo_unstored(progress, positions_out, items)
    todo = [it for it in items if it.key not in progress.done]

    in_positions = in_store.positions()
    batches = [todo[i : i + batch_size] for i in range(0, len(todo), batch_size)]
    retry_cfg = settings.io_retry
    # Its two pinned host buffers of a batch are slow to allocate: none for
    # a run with nothing to do (a finished store resumed).
    feed = DeviceFeed(dev or torch.device("cpu"), (batch_size, *raw_zyx)) if batches else None

    def start_reads(batch: list[WorkItem]):
        # An issue-time failure leaves None: read_item re-issues with
        # the full retry budget.
        futs = []
        for it in batch:
            try:
                futs.append(in_positions[it.position].read_async((it.t, it.c)))
            except Exception as e:  # noqa: BLE001 — per-item containment
                logger.warning("read issue failed for %s: %s (will retry)", it.key, e)
                futs.append(None)
        return futs

    def read_item(it: WorkItem, fut) -> np.ndarray | None:
        state = {"fut": fut}

        def once():
            f = state.pop("fut", None)
            if f is None:
                f = in_positions[it.position].read_async((it.t, it.c))
            return np.asarray(f.result(), dtype=np.float32)

        try:
            return robust_call(once, attempts=retry_cfg.attempts, wait_s=retry_cfg.wait_s)
        except Exception as e:  # noqa: BLE001 — containment policy
            if not retry_cfg.contain_failures:
                raise
            logger.error("read failed for %s after %d attempts: %s",
                         it.key, retry_cfg.attempts, e)
            progress.mark_failed(it, "read", str(e))
            return None

    # A batch is journaled done only after its own writes resolve.
    pending = None
    n_done = 0

    def flush_writes() -> None:
        nonlocal pending, n_done
        if pending is None:
            return
        batch_written, futs, data = pending
        committed: list[WorkItem] = []
        for it, fut, vol in zip(batch_written, futs, data):
            state = {"fut": fut}

            def once(it=it, vol=vol, state=state):
                f = state.pop("fut", None)
                if f is not None:
                    f.result()
                    return
                positions_out[it.position].write_async((it.t, it.c), vol).result()

            try:
                robust_call(once, attempts=retry_cfg.attempts, wait_s=retry_cfg.wait_s)
                committed.append(it)
            except Exception as e:  # noqa: BLE001 — containment policy
                if not retry_cfg.contain_failures:
                    raise
                logger.error("write failed for %s after %d attempts: %s",
                             it.key, retry_cfg.attempts, e)
                progress.mark_failed(it, "write", str(e))
        pending = None
        progress.mark(committed, positions_out)
        n_done += len(committed)
        logger.info("reconstructed %d/%d volumes", n_done, len(todo))

    def retire(entry) -> None:
        """Wait for a batch's D2H copy and issue its writes."""
        nonlocal pending
        batch_done, handle = entry
        with timer.stage("d2h"):
            out_host = feed.collect(handle)[: len(batch_done)]
        with timer.stage("write"):
            flush_writes()
            out_cast = _as_output_dtype(out_host, settings.output_dtype)
            futs = []
            for it, vol in zip(batch_done, out_cast):
                try:
                    futs.append(positions_out[it.position].write_async((it.t, it.c), vol))
                except Exception as e:  # noqa: BLE001 — per-item containment
                    logger.warning("write issue failed for %s: %s (will retry)", it.key, e)
                    futs.append(None)
            pending = (batch_done, futs, out_cast)

    read_futures = start_reads(batches[0]) if batches else []
    inflight = None
    for bi, batch in enumerate(batches):
        with timer.stage("read"):
            vols = [read_item(it, f) for it, f in zip(batch, read_futures)]
            batch = [it for it, v in zip(batch, vols) if v is not None]
            vols = [v for v in vols if v is not None]
        if bi + 1 < len(batches):
            read_futures = start_reads(batches[bi + 1])
        if not batch:
            continue
        with timer.stage("h2d"):
            pad = batch_size - len(vols)
            stacked = vols[0][None] if len(vols) == 1 and not pad else np.stack(
                vols + [np.zeros(raw_zyx, np.float32)] * pad)
            device_batch = feed.to_device(stacked)
        with timer.stage("compute"):
            out = step(device_batch, tf)
            handle = feed.start_to_host(out)
        # The previous batch's D2H ran on the side stream during this
        # batch's compute; its writes overlap the next reads.
        if inflight is not None:
            retire(inflight)
        inflight = (batch, handle)
    if inflight is not None:
        retire(inflight)
    flush_writes()

    return _finish(input_path, output_path, settings, positions_out, items, todo, progress,
                   n_done, raw_zyx, out_zyx, out_voxel, timer, {"device": str(dev)})


def _finish(input_path: Path, output_path: Path, settings, positions_out, items, todo,
            progress, n_done: int, raw_zyx, out_zyx, out_voxel, timer, where: dict) -> dict:
    """The pyramid levels, then the run summary (``where``: the device, and
    the mesh's shape on a mesh) written beside the output and returned."""
    if settings.pyramid_levels > 0:
        written = {it.position for it in todo if it.key in progress.done}
        with timer.stage("pyramid"):
            for pos_key in {it.position for it in items}:
                pos = positions_out[pos_key]
                unleveled = len(pos.attrs["multiscales"][0]["datasets"]) == 1
                if unleveled or pos_key in written:
                    ngff.add_pyramid_levels(pos, settings.pyramid_levels)

    summary = {
        "input": str(input_path),
        "output": str(output_path),
        **where,
        "volumes": n_done,
        "skipped_resume": len(items) - len(todo),
        "failed": progress.failed,
        "raw_shape": raw_zyx,
        "out_shape": out_zyx,
        "out_voxel_um": tuple(float(v) for v in out_voxel),
        "stages": timer.as_dict(),
        "device_memory_gib": device_memory_stats(),
    }
    output_path.mkdir(parents=True, exist_ok=True)
    with open(output_path / "reconstruct_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _agree(mesh, failed: bool) -> bool:
    """True on every rank when any rank of the mesh reports ``failed``."""
    flag = torch.tensor([1.0 if failed else 0.0], device=mesh.device)
    return bool(all_reduce(flag, mesh.world).item() > 0)


def _reconstruct_on_mesh(in_store, input_path: Path, output_path: Path, settings, mesh, items,
                         raw_zyx, out_zyx, out_voxel, step, tf, batch_size, resume,
                         timer) -> dict | None:
    """``reconstruct_store`` on a mesh, called by every rank with the
    same arguments.

    As in JAX, the batch is rounded up to the mesh's batch axis and a
    short batch is zero-padded. Rank 0 alone creates (or checks) the
    output store, keeps the progress journal and returns the summary
    (the others return None). Every rank reads the batch and the step
    moves its own block; a read that fails on any rank fails on all. An
    output chunk is one whole (t, c) volume, so two ranks never write
    one chunk: with whole volumes out of the step, the ranks that hold
    distinct volumes write them; X-sharded outputs (deskew only, or
    ``shard_volumes``) are gathered on the host by each row's first rank,
    which writes the row's volumes. Writes are awaited before the
    batch's outcome is agreed over the mesh (the barrier), and then rank
    0 journals it.
    """
    nb, ns = mesh.devices.shape
    lead = mesh.rank == 0
    batch_size = round_up(batch_size or mesh.devices.size, nb)
    setup_error = None
    if lead:
        try:
            progress, positions_out = _prepare_output(in_store, output_path, settings, out_zyx,
                                                      out_voxel, items, resume)
        except Exception as e:  # noqa: BLE001 — re-raised below, after the other ranks hear
            setup_error = e
    if _agree(mesh, setup_error is not None):
        if setup_error is not None:
            raise setup_error
        raise RuntimeError(f"rank 0 failed to prepare the output store {output_path}")
    if not lead:
        progress = _Progress(output_path.with_suffix(output_path.suffix + ".progress.jsonl"))
        wanted = {it.position for it in items}
        positions_out = {k: v for k, v in ngff.open_ngff(output_path).positions().items()
                         if k in wanted}
    if resume:
        _redo_unstored(progress, positions_out, items)
    todo = [it for it in items if it.key not in progress.done]
    in_positions = in_store.positions()
    retry_cfg = settings.io_retry
    batches = [todo[i : i + batch_size] for i in range(0, len(todo), batch_size)]
    j_col = mesh.coords[1]
    row = mesh.group("space")
    n_done = 0

    def read_item(it: WorkItem):
        def once():
            return np.asarray(in_positions[it.position].read_async((it.t, it.c)).result(),
                              dtype=np.float32)

        try:
            return robust_call(once, attempts=retry_cfg.attempts, wait_s=retry_cfg.wait_s), None
        except Exception as e:  # noqa: BLE001 — containment policy
            if not retry_cfg.contain_failures:
                raise
            logger.error("read failed for %s after %d attempts: %s",
                         it.key, retry_cfg.attempts, e)
            return None, str(e)

    def write_item(it: WorkItem, vol: np.ndarray):
        try:
            robust_call(lambda: positions_out[it.position].write_async((it.t, it.c), vol).result(),
                        attempts=retry_cfg.attempts, wait_s=retry_cfg.wait_s)
            return None
        except Exception as e:  # noqa: BLE001 — containment policy
            if not retry_cfg.contain_failures:
                raise
            logger.error("write failed for %s after %d attempts: %s",
                         it.key, retry_cfg.attempts, e)
            return str(e)

    for batch in batches:
        with timer.stage("read"):
            got = [read_item(it) for it in batch]
            bad = torch.tensor([0.0 if v is not None else 1.0 for v, _ in got]
                               + [0.0] * (batch_size - len(batch)), device=mesh.device)
            bad = all_reduce(bad, mesh.world).cpu().numpy() > 0
            stacked = np.zeros((batch_size, *raw_zyx), np.float32)
            for k, (v, _) in enumerate(got):
                if not bad[k]:
                    stacked[k] = v
        with timer.stage("compute"):
            blk = step(stacked, tf)
        with timer.stage("d2h"):
            if step.whole_volumes:
                flat = ns > 1 and batch_size % mesh.devices.size == 0
                host = blk.data.cpu().numpy() if (flat or j_col == 0) else None
            else:
                parts = gather(blk.data, row)
                host = None if parts is None else torch.cat(parts, dim=-1).numpy()
            first = blk.batch.start
        with timer.stage("write"):
            wrote_bad = np.zeros(batch_size)
            if host is not None:
                for k, vol in enumerate(_as_output_dtype(host, settings.output_dtype)):
                    g = first + k
                    if g < len(batch) and not bad[g]:
                        wrote_bad[g] = 1.0 if write_item(batch[g], vol) is not None else 0.0
            wrote_bad = all_reduce(torch.tensor(wrote_bad, device=mesh.device),
                                   mesh.world).cpu().numpy() > 0
        committed = [it for k, it in enumerate(batch) if not bad[k] and not wrote_bad[k]]
        if lead:
            for k, it in enumerate(batch):
                if bad[k]:
                    progress.mark_failed(it, "read", got[k][1] or "read failed on another rank")
                elif wrote_bad[k]:
                    progress.mark_failed(it, "write", "write failed (see the writing rank's log)")
            progress.mark(committed, positions_out)
        n_done += len(committed)
        logger.info("reconstructed %d/%d volumes", n_done, len(todo))

    barrier()
    if not lead:
        return None
    return _finish(input_path, output_path, settings, positions_out, items, todo, progress,
                   n_done, raw_zyx, out_zyx, out_voxel, timer,
                   {"device": str(mesh.device), "mesh": mesh.shape})

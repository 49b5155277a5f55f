"""Device meshes for the reconstruction pipeline (counterpart of
``shrimpy_tpu/parallel/mesh.py``: ``init_distributed``, ``make_mesh``).

The mesh is JAX's ``(batch, space)`` grid: ``batch`` spans independent
(position, timepoint, channel) volumes, ``space`` shards each volume's X
extent. What differs is the process model. JAX drives every device of
its mesh from one controller; PyTorch runs one process a device (SPMD
over :mod:`torch.distributed`), so every rank calls :func:`make_mesh`
with the same arguments and gets the same grid, plus its own place in
it: its coordinates, its ``torch.device`` and the process groups of its
row (the ``space`` axis) and its column (the ``batch`` axis).

Differences from the JAX module, each named:

* :func:`init_distributed` wraps ``torch.distributed.init_process_group``
  and takes a ``backend`` (``"nccl"`` where the ranks' devices are CUDA,
  ``"gloo"`` on the CPU). With no arguments it reads torchrun's
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``), as JAX auto-detects its cluster.
* ``devices`` lists one device a rank. By default rank ``r`` runs on
  ``cuda:(r % cards)`` when the process group's backend is NCCL, else on
  the CPU. A card may appear more than once only when the list is given
  and the backend is gloo: several ranks sharing one card stand in for a
  multi-card host (NCCL refuses two ranks of one communicator on a card).
* ``n_devices`` must be the number of ranks: a rank outside the mesh
  would have nothing to run. Without a process group, ``make_mesh(1)``
  gives a one-device mesh in this process.
* The collectives (:func:`all_to_all` and the helpers beside it) take
  the ranks' tensors on either backend: gloo moves CUDA tensors through
  host copies of its own, NCCL between the cards.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

AXIS_NAMES = ("batch", "space")


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """Join the process group before :func:`make_mesh`.

    ``coordinator_address`` is ``host:port`` of rank 0; with no
    arguments torchrun's environment gives the address, the world size
    and the rank. ``backend`` defaults to ``"nccl"`` where CUDA is
    available and ``"gloo"`` otherwise. Under torchrun the rank's card is
    ``cuda:LOCAL_RANK``.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
        kwargs["world_size"] = 1 if num_processes is None else num_processes
        kwargs["rank"] = 0 if process_id is None else process_id
    else:
        kwargs["init_method"] = "env://"
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, **kwargs)


def _world() -> tuple[int, int, str | None]:
    """(world size, rank, backend); (1, 0, None) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def check_devices(devices, backend: str | None) -> list[torch.device]:
    """The devices as ``torch.device``; raises where NCCL would get one
    card twice."""
    devs = [torch.device(d) for d in devices]
    if backend == "nccl":
        cuda = [d if d.index is not None else torch.device("cuda", 0)
                for d in devs if d.type == "cuda"]
        repeated = sorted({str(d) for d in cuda if cuda.count(d) > 1})
        if repeated:
            raise ValueError(
                f"NCCL cannot run two ranks of one communicator on one card "
                f"({', '.join(repeated)} repeated in devices); pass "
                "backend='gloo' to share a card between ranks"
            )
        if any(d.type != "cuda" for d in devs):
            raise ValueError("the NCCL backend needs a CUDA device for every rank")
    return devs


def default_devices(n: int, backend: str | None) -> list[torch.device]:
    """One device a rank: ``cuda:(r % cards)`` on NCCL, else the CPU."""
    if backend == "nccl":
        count = max(torch.cuda.device_count(), 1)
        return [torch.device("cuda", r % count) for r in range(n)]
    return [torch.device("cpu")] * n


@dataclass(eq=False)
class Mesh:
    """A ``(batch, space)`` grid of devices, one rank a device.

    ``devices`` is the ``(n // space, space)`` object array of
    ``torch.device`` and ``axis_names`` is ``("batch", "space")``, as on
    JAX's mesh, so ``mesh.devices.shape`` and ``.size`` read the same.
    ``rank`` is this process's rank, ``coords`` its (row, column) and
    ``device`` its device; ``groups`` maps each axis name to the process
    group along it (None where the axis has one device).
    """

    devices: np.ndarray
    axis_names: tuple = AXIS_NAMES
    rank: int = 0
    backend: str | None = None
    groups: dict = field(default_factory=dict)

    @property
    def coords(self) -> tuple[int, int]:
        return divmod(self.rank, self.devices.shape[1])

    @property
    def device(self) -> torch.device:
        return self.devices[self.coords]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def group(self, axis_name: str):
        """The process group along the mesh axis ``axis_name``."""
        if axis_name not in self.axis_names:
            raise ValueError(f"{axis_name!r} is not an axis of the mesh {self.axis_names}")
        return self.groups.get(axis_name)

    @property
    def world(self):
        """The group of every rank of the mesh (None for one rank)."""
        return dist.group.WORLD if self.devices.size > 1 else None

    def axis_index(self, axis_name: str) -> int:
        """This rank's index along ``axis_name`` (``jax.lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis_name)]


def make_mesh(n_devices: int | None = None, *, space: int = 1, devices=None) -> Mesh:
    """A ``(batch, space)`` mesh over the process group's ranks.

    ``space=1`` (default) gives pure volume-parallelism; ``space>1``
    additionally shards each volume's X axis across ``space`` ranks.
    Every rank calls it with the same arguments (the process groups of
    the rows and columns are made here, by all ranks together).
    """
    world, rank, backend = _world()
    if devices is None:
        if backend is None:
            devices = ["cuda" if torch.cuda.is_available() else "cpu"]
        else:
            devices = default_devices(world, backend)
    devices = list(devices)
    n = len(devices) if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if space < 1:
        raise ValueError(f"space must be >= 1, got {space}")
    if n % space:
        raise ValueError(f"n_devices={n} not divisible by space={space}")
    if n != world:
        raise ValueError(
            f"n_devices={n} but the process group has {world} rank(s): the port "
            "runs one process a mesh device (launch.spawn or torchrun)")
    devs = check_devices(devices[:n], backend)
    grid = np.empty((n // space, space), dtype=object)
    for r, d in enumerate(devs):
        grid[divmod(r, space)] = d
    groups = {}
    if world > 1:
        rows = [list(range(i * space, (i + 1) * space)) for i in range(n // space)]
        cols = [list(range(j, n, space)) for j in range(space)]
        # Every rank makes every group, in one order (new_group's rule).
        for name, sets in (("space", rows), ("batch", cols)):
            for ranks in sets:
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[name] = g
    return Mesh(grid, AXIS_NAMES, rank, backend, groups)


_ACTIVE: list[Mesh] = []


@contextmanager
def use_mesh(mesh: Mesh):
    """Run the block under ``mesh``: a collective named by a mesh axis
    (``fft3_sharded(block, "space")``) resolves to this mesh's group."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def resolve_group(axis_name):
    """The process group of ``axis_name``: a mesh axis of the mesh in use
    (:func:`use_mesh`), or a process group (None: one rank) as given."""
    if not isinstance(axis_name, str):
        return axis_name
    if not _ACTIVE:
        raise ValueError(
            f"axis_name {axis_name!r} names a mesh axis but no mesh is in use; run "
            "under parallel.mesh.use_mesh(mesh) or pass a process group")
    return _ACTIVE[-1].group(axis_name)


def assemble(mesh: Mesh, block: torch.Tensor, places, shape) -> torch.Tensor:
    """The global array of ``shape`` on the host, on every rank: each
    rank's ``block`` (one shape on all ranks) gathered over the mesh and
    put at ``places[rank]`` (an index tuple into the global array)."""
    out = torch.empty(shape, dtype=block.dtype)
    for r, b in enumerate(all_gather(block, mesh.world)):
        out[places[r]] = b.cpu()
    return out


# --- collectives ---------------------------------------------------------
# A group of None is one rank (no communication). Complex tensors travel
# as their real view. gloo takes CUDA tensors itself (through host
# copies of its own: a 1.30 GiB transpose a rank of four on one H100 in
# 0.97 s, against 1.9 s staged through pageable host tensors here).


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_to_all(inp: torch.Tensor, group, out_splits=None, in_splits=None) -> torch.Tensor:
    """``all_to_all_single`` along dim 0 of ``inp``: rank ``k`` gets the
    ``k``-th piece (``in_splits`` rows each, or equal pieces), and the
    output holds the pieces received, by sender."""
    if group is None:
        return inp
    rows = sum(out_splits) if out_splits is not None else inp.shape[0]
    out = inp.new_empty((rows, *inp.shape[1:]))
    dist.all_to_all_single(_real(out), _real(inp.contiguous()), out_splits, in_splits,
                           group=group)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor on ``t``'s device)."""
    out = t.clone()
    if group is not None:
        dist.all_reduce(_real(out), group=group)
    return out


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on all ranks), by rank in ``group``."""
    if group is None:
        return [t]
    outs = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather([_real(o) for o in outs], _real(t.contiguous()), group=group)
    return outs


def gather(t: torch.Tensor, group, dst: int = 0) -> list[torch.Tensor] | None:
    """Every rank's ``t`` on the host of the group's rank ``dst``, by rank
    in ``group``; None on the others (gloo gathers host copies; NCCL the
    card's tensors, then copied)."""
    if group is None:
        return [t.cpu()]
    src = t.cpu() if dist.get_backend(group) == "gloo" else t.contiguous()
    me = group_rank(group)
    outs = [torch.empty_like(src) for _ in range(group_size(group))] if me == dst else None
    dist.gather(_real(src), None if outs is None else [_real(o) for o in outs],
                dst=dist.get_global_rank(group, dst), group=group)
    return None if outs is None else [o.cpu() for o in outs]


def barrier(group=None) -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)

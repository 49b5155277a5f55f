"""Local ranks of a mesh, started from one process (no JAX file: the
port's named difference of the process model).

JAX drives every local device from one process. The port runs one
process a device (:mod:`shrimpy_tpu_torch.parallel.mesh`), so a program
that wants a mesh on this host starts its ranks here: :func:`spawn`
starts ``n_devices`` processes (``multiprocessing``'s ``spawn`` start
method, through :mod:`torch.multiprocessing`, so a CPU tensor argument
reaches the ranks through shared memory rather than a copy each),
joins them into one process group, builds each rank's mesh with
:func:`~shrimpy_tpu_torch.parallel.mesh.make_mesh`, runs
``fn(*args, mesh=mesh, **kwargs)`` in every rank and returns rank 0's
result. :class:`Ranks` keeps the processes for several runs (a mesh of
another ``space`` each time, if asked).

A failure in any rank raises :class:`RankError` in the parent with that
rank's traceback, and the other ranks are stopped (they may be waiting
in a collective the failed rank never joins). ``fn`` must be importable
by the ranks (a function of a module, not of ``__main__`` unless the
main module guards its work behind ``if __name__ == "__main__"``).
"""

from __future__ import annotations

import socket
import traceback
from multiprocessing.connection import wait

import torch

from shrimpy_tpu_torch.parallel.mesh import check_devices, init_distributed, make_mesh


class RankError(RuntimeError):
    """A rank of :func:`spawn` failed; the message holds its traceback."""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve_launch(n_devices: int, backend: str | None, devices) -> tuple[str, list]:
    """(backend, one device a rank): NCCL on cards ``cuda:0..n-1`` where
    CUDA is available, else gloo on the CPU; raises where the host has
    fewer cards than asked for or NCCL would get one card twice."""
    if devices is None:
        if backend == "gloo" or (backend is None and not torch.cuda.is_available()):
            devices = ["cpu"] * n_devices
        else:
            have = torch.cuda.device_count()
            if n_devices > have:
                raise ValueError(f"requested {n_devices} devices, have {have}")
            devices = [f"cuda:{r}" for r in range(n_devices)]
    devices = [str(d) for d in devices]
    if backend is None:
        backend = "nccl" if all(d.startswith("cuda") for d in devices) else "gloo"
    check_devices(devices, backend)
    if len(devices) < n_devices:
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    return backend, devices[:n_devices]


def _rank_main(rank: int, world: int, address: str, backend: str, devices: list, conn) -> None:
    import torch.distributed as dist

    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    try:
        init_distributed(address, world, rank, backend=backend)
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, space, args, kwargs = task
            mesh = make_mesh(world, space=space, devices=devices)
            result = fn(*args, mesh=mesh, **kwargs)
            # An idle rank holds nothing of the task (a tensor shared with
            # the parent goes back to it) and returns its cache to the card.
            task = fn = args = kwargs = mesh = None
            if device.type == "cuda":
                torch.cuda.empty_cache()
            conn.send(("ok", result))
            result = None
    except BaseException:  # noqa: BLE001 — reported to the parent, which stops every rank
        conn.send(("error", traceback.format_exc()))
        return
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    conn.close()


def describe(*, mesh) -> list[dict]:
    """What every rank of ``mesh`` sees, gathered on each: its rank,
    coordinates, device, the process group's backend and the top-level
    packages it has loaded (a rank target for checks of a launch)."""
    import sys

    import torch.distributed as dist

    mine = {"rank": mesh.rank, "coords": mesh.coords, "device": str(mesh.device),
            "shape": tuple(mesh.devices.shape), "axis_names": tuple(mesh.axis_names),
            "backend": mesh.backend, "packages": sorted({m.split(".")[0] for m in sys.modules})}
    if mesh.world is None:
        return [mine]
    every = [None] * mesh.devices.size
    dist.all_gather_object(every, mine)
    return every


class Ranks:
    """``n_devices`` local ranks joined in one process group, kept for
    several :meth:`run` calls; a context manager that stops them."""

    def __init__(self, n_devices: int, *, backend: str | None = None, devices=None):
        backend, devices = resolve_launch(n_devices, backend, devices)
        self.backend, self.devices = backend, devices
        ctx = torch.multiprocessing.get_context("spawn")
        address = f"127.0.0.1:{_free_port()}"
        self._conns, self._procs = [], []
        for r in range(n_devices):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main,
                            args=(r, n_devices, address, backend, devices, child), daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)

    def run(self, fn, *, space: int = 1, args=(), kwargs=None):
        """``fn(*args, mesh=mesh, **kwargs)`` in every rank on a mesh of
        ``space``; rank 0's result."""
        if not self._procs:
            raise RankError("the ranks were stopped")
        for c in self._conns:
            c.send((fn, space, tuple(args), dict(kwargs or {})))
        results = {}
        waiting = {c: r for r, c in enumerate(self._conns)}
        sentinels = {p.sentinel: r for r, p in enumerate(self._procs)}
        while waiting:
            for ready in wait(list(waiting) + list(sentinels)):
                if ready in waiting:
                    r = waiting.pop(ready)
                    try:
                        status, value = ready.recv()
                    except EOFError:
                        status, value = "error", "the rank exited without a result"
                    if status == "error":
                        self.close(force=True)
                        raise RankError(f"rank {r} of {len(self._conns)} failed:\n{value}")
                    results[r] = value
                elif ready in sentinels:
                    r = sentinels[ready]
                    conn = self._conns[r]
                    if conn in waiting and not conn.poll():
                        code = self._procs[r].exitcode
                        self.close(force=True)
                        raise RankError(f"rank {r} of {len(self._conns)} exited with code "
                                        f"{code} before it returned")
        return results[0]

    def close(self, force: bool = False) -> None:
        procs, self._procs = self._procs, []
        if not force:
            for c in self._conns:
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
            for p in procs:
                p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for c in self._conns:
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


def spawn(fn, n_devices: int, *, space: int = 1, backend: str | None = None, devices=None,
          args=(), kwargs=None):
    """Start ``n_devices`` local ranks, run ``fn(*args, mesh=mesh,
    **kwargs)`` in each on a ``(n_devices // space, space)`` mesh, stop
    them, and return rank 0's result. ``backend`` defaults to NCCL on
    the host's cards ``cuda:0..n-1`` and to gloo on the CPU; ``devices``
    (one a rank) may repeat a card on gloo only."""
    with Ranks(n_devices, backend=backend, devices=devices) as ranks:
        return ranks.run(fn, space=space, args=args, kwargs=kwargs)

"""Host<->device transfers of the streaming runtime.

Kept apart from :mod:`shrimpy_tpu_torch.runtime.stream` (which reads and
writes stores through ``shrimpy_tpu_torch.io`` and its chunk engine) so
the transfers can be tested without a store.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceFeed:
    """Host<->device transfers of the streaming loop.

    On CUDA: batches are staged in one of two pinned host buffers and
    copied ``non_blocking``; an event per buffer guards its reuse until
    its copy has run. Outputs are copied back into pinned memory on a
    side stream that waits for the compute, so a batch's D2H overlaps
    the next batch's compute; :meth:`collect` waits for it. On the CPU
    both directions are plain tensor views.
    """

    def __init__(self, device: torch.device, batch_shape: tuple[int, ...]):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.host_in = [
                torch.empty(batch_shape, dtype=torch.float32, pin_memory=True)
                for _ in range(2)
            ]
            self.in_done = [None, None]
            self.side = torch.cuda.Stream(device)
            self.turn = 0

    def to_device(self, stacked: np.ndarray) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(stacked)
        i = self.turn
        self.turn ^= 1
        if self.in_done[i] is not None:
            self.in_done[i].synchronize()
        self.host_in[i].numpy()[...] = stacked
        dev = self.host_in[i].to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.in_done[i] = ev
        return dev

    def start_to_host(self, out: torch.Tensor):
        """Begin the D2H copy of ``out``; returns a handle for :meth:`collect`."""
        if not self.cuda:
            return out, None
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        # The allocator must not hand out's memory to the next batch
        # before the side stream has read it.
        out.record_stream(self.side)
        return host, ev

    @staticmethod
    def collect(handle) -> np.ndarray:
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return host.numpy()

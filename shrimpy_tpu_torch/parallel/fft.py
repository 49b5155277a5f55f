"""Distributed slab FFT over a mesh axis (counterpart of
``shrimpy_tpu/parallel/fft.py``: ``fft3_sharded``, ``ifft3_sharded``,
``_fft1``).

3-D FFTs of volumes whose X extent is sharded over the mesh's ``space``
axis, for the >HBM path on which no device holds a whole volume. The
scheme is JAX's: the Z and Y transforms are local (each shard holds
full Z and Y; here one ``torch.fft.fftn`` over both, which holds no
intermediate carry); the X transform sits between two tiled transposes,
``all_to_all`` over the axis's process group, the first splitting Y and
gathering X, the second reversing it. The split axis is moved to dim 0
and made contiguous for ``all_to_all_single``, and the pieces received
are laid on the concat axis by sender in one copy, so every rank's
layout is the one JAX's ``all_to_all(..., tiled=True)`` gives.

``axis_name`` is a mesh axis, looked up in the mesh in use
(:func:`~shrimpy_tpu_torch.parallel.mesh.use_mesh`), or a process group.

How ``transform`` maps (the port has no matmul-DFT; ``ops/dft.py``
exists for the TPU's FFT):

===========  ==================================  ================
Setting      JAX                                 Port
===========  ==================================  ================
``matmul``   matmul-DFT einsums (``cdft``)       ``torch.fft``
``xla``      ``jnp.fft``                         ``torch.fft``
``auto``     ``matmul`` on the TPU, else ``xla``  ``torch.fft``
===========  ==================================  ================

The callers' grid policy still follows the name (the padded RL grid of
``_padded_grid_shape(transform=...)``).
"""

from __future__ import annotations

import numpy as np
import torch

from shrimpy_tpu_torch.parallel.mesh import (
    Mesh,
    all_to_all,
    assemble,
    group_size,
    resolve_group,
    use_mesh,
)

TRANSFORMS = ("auto", "matmul", "xla")


def _fft1(block: torch.Tensor, axis, inverse: bool, transform: str) -> torch.Tensor:
    """The 1-D transform along ``axis`` (or the transforms along each axis
    of a tuple, one ``torch.fft`` call: no intermediate carry)."""
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform {transform!r}; use one of {TRANSFORMS}")
    if isinstance(axis, tuple):
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(block, dim=axis)
    return (torch.fft.ifft if inverse else torch.fft.fft)(block, dim=axis)


def _all_to_all_tiled(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, ..., split_axis, concat_axis, tiled=True)``:
    piece ``k`` of ``x`` along ``split_axis`` goes to rank ``k``; the
    pieces received are laid along ``concat_axis`` by sender. Holds at
    most ``x``, the pieces received and the result (the contiguous copy
    sent is freed before the result is made)."""
    n = group_size(group)
    if n == 1:
        return x
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    size = x.shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: axis {split_axis} of extent {size} does not split "
                         f"into {n} pieces")
    send = x.movedim(split_axis, 0).contiguous()
    got = all_to_all(send, group)
    del send
    shape = list(x.shape)
    shape[split_axis] //= n
    pieces = got.reshape(n, size // n, *got.shape[1:]).movedim(1, split_axis + 1)
    shape[concat_axis] *= n
    return pieces.movedim(0, concat_axis).reshape(shape)


def fft3_sharded(block: torch.Tensor, axis_name, transform: str = "auto") -> torch.Tensor:
    """Forward 3-D FFT of ``(..., Z, Y, X_local)`` complex blocks.

    Returns the same layout with frequency content: the local X chunk
    holds this rank's contiguous slice of the X frequency axis. Requires
    ``Y % axis_size == 0``. (The Z and Y transforms are one call.)
    """
    group = resolve_group(axis_name)
    nd = block.dim()
    f = _fft1(block, (-3, -2), False, transform)
    g = _all_to_all_tiled(f, group, nd - 2, nd - 1)
    del f
    g = _fft1(g, -1, False, transform)
    return _all_to_all_tiled(g, group, nd - 1, nd - 2)


def ifft3_sharded(block: torch.Tensor, axis_name, transform: str = "auto") -> torch.Tensor:
    """Inverse of :func:`fft3_sharded` (same layout contract)."""
    group = resolve_group(axis_name)
    nd = block.dim()
    g = _all_to_all_tiled(block, group, nd - 2, nd - 1)
    g = _fft1(g, -1, True, transform)
    f = _all_to_all_tiled(g, group, nd - 1, nd - 2)
    del g
    return _fft1(f, (-3, -2), True, transform)


def slab_fft(x, *, mesh: Mesh, transform: str = "auto", inverse: bool = False) -> torch.Tensor:
    """The slab FFT of a global ``(B, Z, Y, X)`` host array on ``mesh``:
    each rank moves its row's volumes and its X slab (``P("batch", None,
    None, "space")``) to its device, transforms them over ``space``, and
    the global result comes back on the host on every rank."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    nb, ns = mesh.devices.shape
    b, xw = x.shape[0] // nb, x.shape[-1] // ns
    places = []
    for r in range(mesh.devices.size):
        i, j = divmod(r, ns)
        places.append((slice(i * b, (i + 1) * b), Ellipsis, slice(j * xw, (j + 1) * xw)))
    block = x[places[mesh.rank]].to(mesh.device, torch.complex64)
    with use_mesh(mesh):
        fn = ifft3_sharded if inverse else fft3_sharded
        out = fn(block, "space", transform)
    return assemble(mesh, out, places, tuple(x.shape))

"""Shared Richardson-Lucy outer loop: plain or Biggs-Andrews accelerated
(counterpart of ``shrimpy_tpu/ops/rl_outer.py::run_rl_outer``).

Every RL backend iterates ``step(est) -> est``, one multiplicative RL
iteration. Accelerated mode is Biggs-Andrews vector extrapolation
(Appl. Opt. 36(8):1766, 1997): the step is applied at
``y = max(x + alpha * dx, 0)`` instead of ``x``, with ``dx = x - x_prev``,
``g = x_new - y`` and ``alpha = <g, g_prev> / <g_prev, g_prev>`` clipped
to [0, 0.999]. As in the JAX loop:

* ``dx`` and ``g_prev`` are held in ``state_dtype`` (bf16): two half
  carries instead of two float32 ones. ``den_prev`` and ``alpha`` are
  0-d float32 tensors on the carry's device, so the loop never waits
  for the host (no ``.item()``).
* ``g`` is rebuilt from values still live, ``(x_new - x) - max(alpha *
  dx, -x)`` (the exact identity ``y - x = max(alpha * dx, -x)``), and
  rounded to bf16 before both reductions, so ``y`` has no reader after
  the step: a step may overwrite its input in place.
* alpha is 0 until two gradients exist, so runs of <= 2 iterations
  equal plain RL bitwise (``est >= eps > 0`` makes ``max(x + 0*dx, 0)``
  equal to ``x``).

The ``fused`` backend does not use this loop for Biggs: it runs the
extrapolation inside its half-step kernels (``rl_fused.py``, modes
``ratio_accel``/``mult_accel``). ``linear_pallas`` does, as in the JAX
package.
"""

from __future__ import annotations

import torch

from shrimpy_tpu_torch.utils.timing import span


def biggs_state(carry: torch.Tensor, state_dtype: torch.dtype = torch.bfloat16):
    """The zero Biggs state of a run on ``carry``: ``(dx, g_prev,
    den_prev, alpha)``, the first two in ``state_dtype`` and the last two
    0-d float32 on the carry's device."""
    dx = torch.zeros(carry.shape, dtype=state_dtype, device=carry.device)
    den_prev = torch.zeros((), dtype=torch.float32, device=carry.device)
    return dx, torch.zeros_like(dx), den_prev, torch.zeros_like(den_prev)


def next_alpha(num: torch.Tensor, den_prev: torch.Tensor) -> torch.Tensor:
    """``alpha = clip(<g, g_prev> / (<g_prev, g_prev> + 1e-30), 0, 0.999)``
    in float32, on the device."""
    return torch.clamp(num.float() / (den_prev + 1e-30), 0.0, 0.999)


def run_rl_outer(phases, est0: torch.Tensor, accelerated: bool,
                 state_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run the RL ``phases``, a sequence of ``(step, length)``; the
    accelerated state persists across phase boundaries and zero-length
    phases are skipped. ``step`` may update its argument in place (the
    loop never reads it afterwards). Each iteration is the span
    ``shrimpy.rl.iteration``.
    """
    if not accelerated:
        est = est0
        for step, length in phases:
            for _ in range(length):
                with span("shrimpy.rl.iteration"):
                    est = step(est)
        return est

    x = est0
    dx, g_prev, den_prev, alpha = biggs_state(est0, state_dtype)
    for step, length in phases:
        for _ in range(length):
            with span("shrimpy.rl.iteration"):
                # In place where it saves a carry, each value rounded as in
                # the JAX loop: (alpha * dx) + x is x + alpha * dx, and
                # d + min(-alpha * dx, x) is d - max(alpha * dx, -x).
                y = dx.to(x.dtype, copy=True).mul_(alpha).add_(x).clamp_min_(0.0)
                x_new = step(y)
                del y
                d = x_new - x
                t = dx.to(x.dtype, copy=True).mul_(alpha).neg_()
                g = torch.minimum(t, x, out=t).add_(d).to(state_dtype)
                dx = d.to(state_dtype)
                del t, d
                gf = g.to(x.dtype)
                den = torch.sum(gf * gf).float()
                num = torch.sum(gf.mul_(g_prev.to(x.dtype)))
                del gf
                alpha = next_alpha(num, den_prev)
                g_prev, den_prev, x = g, den, x_new
    return x

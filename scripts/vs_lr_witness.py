"""Virtual-staining training at ConvNeXt-V2 Tiny widths in JAX and in the
PyTorch port, on the CPU, at given learning rates: does the loss diverge in
both?

``chip_smoke.py`` phase 4o trains unext2 at Tiny widths (plane head) on four
in-memory (16, 1024, 1024) volumes (seed 7, targets ``tanh(2 x)`` and
``sin(3 x)``) at batch 4, patch 128, 20 steps, validation every 5 steps on a
quarter of the volumes. This script runs that configuration through JAX's
``shrimpy_tpu.models.train.train_vsunet`` (optax's ``adamw``; its store
opening handed the same in-memory positions) and the port's
``shrimpy_tpu_torch.models.train.train_positions`` (``torch.optim.AdamW``),
both from the same weights (JAX's ``init`` of the net, carried to the port by
``state_dict_from_flax``) and both in float32 (``compute_dtype``; the port
without TF32), then prints each run's training and validation losses, the
largest relative gap between the two packages' losses at each step, and one
JSON line.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/vs_lr_witness.py --lr 1e-3 1e-4
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as smoke
from shrimpy_tpu.io import ngff as jngff
from shrimpy_tpu.models import train as jtrain
from shrimpy_tpu.models import vsunet as jvs
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.models import train as ttrain
from shrimpy_tpu_torch.models import vsunet as tvs
from shrimpy_tpu_torch.models.convert import state_dict_from_flax
from shrimpy_tpu_torch.models.torch_import import load_state

NET = "unext2 plane head"


class _Store:
    def __init__(self, positions):
        self._positions = {str(i): p for i, p in enumerate(positions)}

    def positions(self):
        return self._positions


class _Stainer32(tvs.VirtualStainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.model.compute_dtype = torch.float32


def checkpoints(root: Path) -> tuple[str, str]:
    """JAX's seeded weights of the net as its orbax checkpoint and, carried,
    as the port's ``state_dict.pt``: (JAX's path, the port's)."""
    kw = {**smoke.VS_NETS[NET], "out_channels": smoke.TRAIN_TARGETS}
    jset, tset = jvs.VSModelSettings(**kw), tconfig.vs_settings(**kw)
    model, _ = jvs.build_model(jset)
    sample = jnp.zeros((1, 128, 128, jset.in_slices), jnp.float32)
    params = jax.jit(model.init)(jax.random.key(jset.seed), sample)
    saver = object.__new__(jvs.VirtualStainer)
    saver.settings, saver.params = jset, params
    saver.save_ckpt(root / "jax")
    carried = tvs.VirtualStainer(tset, device="cpu")
    load_state(carried.model, state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                   tset), tset.architecture)
    carried.save_ckpt(root / "port")
    return str(root / "jax"), str(root / "port")


def run(positions, lr: float, jax_ckpt: str, port_ckpt: str) -> dict:
    kw = {**smoke.VS_NETS[NET], "out_channels": smoke.TRAIN_TARGETS}
    common = {"input_channel": "phase", "target_channels": smoke.TRAIN_TARGETS, "steps": 20,
              "batch": 4, "patch": 128, "learning_rate": lr, "seed": smoke.SEED,
              **smoke.TRAIN_VAL}
    build, open_ngff, stainer = jvs.build_model, jngff.open_ngff, ttrain.VirtualStainer
    jvs.build_model = lambda s: ((m := build(s))[0].clone(compute_dtype=jnp.float32), m[1])
    jngff.open_ngff = lambda path: _Store(positions)
    ttrain.VirtualStainer = _Stainer32
    try:
        t0 = time.perf_counter()
        _, want = jtrain.train_vsunet("memory", settings=jvs.VSModelSettings(
            **kw, ckpt_path=jax_ckpt), **common)
        jax_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with tvs.exact_float32():
            _, got = ttrain.train_positions(positions, settings=tconfig.vs_settings(
                **kw, ckpt_path=port_ckpt), device="cpu", **common)
        port_s = time.perf_counter() - t0
    finally:
        jvs.build_model, jngff.open_ngff, ttrain.VirtualStainer = build, open_ngff, stainer
    gap = [abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses)]
    return {"lr": lr, "jax_losses": want.losses, "port_losses": got.losses,
            "jax_val_losses": want.val_losses, "port_val_losses": got.val_losses,
            "rel_gap": gap, "jax_s": jax_s, "port_s": port_s}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lr", type=float, nargs="+", default=[1e-3, 1e-4])
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(smoke.SEED + 7)
    positions = [smoke.MemoryPosition(rng.standard_normal(smoke.TRAIN_SHAPE, dtype=np.float32))
                 for _ in range(smoke.TRAIN_VOLUMES)]
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        jax_ckpt, port_ckpt = checkpoints(Path(tmp))
        for lr in args.lr:
            r = run(positions, lr, jax_ckpt, port_ckpt)
            out.append(r)
            for who in ("jax", "port"):
                print(f"lr {lr:g} {who}: losses {[f'{v:.4g}' for v in r[f'{who}_losses']]}, "
                      f"validation {[f'{v:.4g}' for v in r[f'{who}_val_losses']]} "
                      f"({r[f'{who}_s']:.1f} s)", flush=True)
            print(f"lr {lr:g}: relative gap of the port's loss to JAX's by step "
                  f"{[f'{v:.1e}' for v in r['rel_gap']]}", flush=True)
    print(json.dumps({"net": NET, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

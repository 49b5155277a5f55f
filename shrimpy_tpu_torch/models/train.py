"""Virtual-staining training (counterpart of ``shrimpy_tpu/models/train.py``).

Fits a :mod:`~shrimpy_tpu_torch.models.vsunet` net on paired channels:
random z-window crops with flip augmentation, AdamW, MSE, a held-out
validation split and early stopping on the validation loss; the result is
a :class:`~shrimpy_tpu_torch.models.vsunet.VirtualStainer` with the
best-validation weights, saved as ``state_dict.pt`` beside the
``vs_model.json`` sidecar.

The host side is the JAX package's: :class:`TrainReport`,
:class:`_VolumeBank` and :func:`_sample_batch` are copies (pinned by
``tests/test_torch_train.py``), the split and the draws come in its order
(the split's permutation from ``default_rng(seed)``, the fixed validation
crops from ``default_rng(seed + 1)``, then every step's batch from the
first generator), so both packages train on the same batches. The device
side:

* ``torch.optim.AdamW`` with optax's ``adamw`` defaults (:data:`ADAMW`:
  decay 1e-4, where torch's default is 1e-2), one group over every tensor
  (optax decays biases and norms too): the same update, decay taken from
  the old parameters, eps outside the square root;
* the net casts where flax casts (no autocast), so gradients reach float32
  master weights as ``jax.value_and_grad``'s do; forward and backward run
  without TF32 (:func:`~shrimpy_tpu_torch.models.vsunet.exact_float32`);
* the NHWC batch becomes NCHW once, after sampling, and goes to the device
  once a step;
* the best weights are a copy (``state_dict()`` aliases the live tensors).

:func:`train_vsunet` opens a store; :func:`train_positions` takes the
positions themselves (anything with ``channel_names``, ``shape`` (T, C, Z,
Y, X) and ``volume(t, c)``). The bank keys a volume by ``id(pos)``, so
positions must outlive the run.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from shrimpy_tpu_torch.config import resolved_arch_config, vs_settings
from shrimpy_tpu_torch.models.vsunet import VirtualStainer, exact_float32
from shrimpy_tpu_torch.utils.device import as_tensor, resolve_device

logger = logging.getLogger(__name__)

# optax.adamw(learning_rate)'s defaults.
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


@dataclass
class TrainReport:
    steps: int
    final_loss: float
    losses: list
    val_losses: list = field(default_factory=list)
    best_val_loss: float | None = None
    stopped_early: bool = False


class _VolumeBank:
    """Lazily-read, per-volume-normalized training volumes.

    A production store's volumes (positions x timepoints x channels)
    would OOM the host if materialized up front; the bank reads each
    (input, targets) pair from the store on demand and keeps a bounded
    LRU of normalized volumes, so small stores behave like the old
    eager path while big ones stream with eviction.
    """

    def __init__(self, entries: list, budget_bytes: int = 2 << 30):
        from shrimpy_tpu_torch.utils.cache import LruCache

        self.entries = entries  # (pos, t, ci, cts, y_slice)
        self.budget_bytes = budget_bytes
        self._cache = LruCache(maxsize=8)  # resized on first load

    def __len__(self) -> int:
        return len(self.entries)

    def load(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(vin (1, Z, Y, X), vout (C, Z, Y, X)), z-score normalized."""
        pos, t, ci, cts, ysl = self.entries[i]
        key = (id(pos), t, ysl.start, ysl.stop)
        if key in self._cache:
            return self._cache[key]
        vin = pos.volume(t, ci).astype(np.float32)[None][:, :, ysl]
        vin = (vin - vin.mean()) / (vin.std() + 1e-6)
        outs = []
        for ct in cts:
            v = pos.volume(t, ct).astype(np.float32)[:, ysl]
            outs.append((v - v.mean()) / (v.std() + 1e-6))
        pair = (vin, np.stack(outs))
        nbytes = pair[0].nbytes + pair[1].nbytes
        self._cache.maxsize = max(1, int(self.budget_bytes // max(nbytes, 1)))
        self._cache[key] = pair
        return pair


def _sample_batch(
    rng: np.random.Generator,
    bank: _VolumeBank,
    *,
    in_slices: int,
    patch: int,
    batch: int,
    augment: bool = False,
):
    """Random (z-window, y, x) crops -> (x NHWC, y NHWC) arrays."""
    xs, ys = [], []
    half = in_slices // 2
    for _ in range(batch):
        i = int(rng.integers(len(bank)))
        vin, vout = bank.load(i)
        nz, ny, nx = vin.shape[1:]
        # Window [z0, z0 + in_slices) with target plane z0 + half —
        # exactly in_slices planes for BOTH parities of in_slices (the
        # old z-half:z+half+1 slice always produced an odd count).
        z0 = int(rng.integers(0, nz - in_slices + 1))
        z = z0 + half
        y0 = int(rng.integers(0, max(ny - patch + 1, 1)))
        x0 = int(rng.integers(0, max(nx - patch + 1, 1)))
        window = vin[0, z0 : z0 + in_slices, y0 : y0 + patch, x0 : x0 + patch]
        target = vout[:, z, y0 : y0 + patch, x0 : x0 + patch]
        x = np.moveaxis(window, 0, -1)  # (H, W, in_slices)
        y = np.moveaxis(target, 0, -1)  # (H, W, n_out)
        if augment:
            # In-plane flips are exact symmetries of the staining task.
            if rng.integers(2):
                x, y = x[::-1], y[::-1]
            if rng.integers(2):
                x, y = x[:, ::-1], y[:, ::-1]
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


def to_nchw(batch: np.ndarray, device) -> torch.Tensor:
    """A stacked NHWC batch of :func:`_sample_batch` as one NCHW tensor on
    ``device`` (a contiguous copy: the flips leave negative strides)."""
    return as_tensor(np.ascontiguousarray(batch.transpose(0, 3, 1, 2)), device)


def adamw(model: torch.nn.Module, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` over every parameter of ``model``."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, **ADAMW)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """One step on the MSE of ``model(x)`` against ``y`` (NCHW); returns the
    loss before the update, a 0-d tensor on the device."""
    opt.zero_grad(set_to_none=True)
    with exact_float32():
        loss = F.mse_loss(model(x), y)
        loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def evaluate(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor) -> float:
    """The MSE of ``model(x)`` against ``y``."""
    return float(F.mse_loss(model(x), y))


def _snapshot(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _checked_settings(settings, target_channels):
    settings = settings or vs_settings(out_channels=target_channels)
    assert list(settings.out_channels) == list(target_channels)
    if settings.architecture == "unext2" and resolved_arch_config(settings).out_stack_depth > 1:
        raise ValueError(
            "training targets single center planes; voxel-stack heads "
            "(out_stack_depth > 1) are inference/import-only — train "
            "with out_stack_depth=1 or import a trained cytoland "
            "checkpoint"
        )
    return settings


def position_entries(positions, input_channel: str, target_channels: list[str]):
    """``(entries, nz_min, ny0)``: one ``(pos, t, ci, cts, slice(None))``
    entry a timepoint of each position, the thinnest z extent and the
    first position's y extent."""
    full = slice(None)
    entries: list = []
    nz_min = None
    ny0 = None
    for pos in positions:
        names = pos.channel_names
        ci = names.index(input_channel)
        cts = [names.index(c) for c in target_channels]
        nz_min = pos.shape[2] if nz_min is None else min(nz_min, pos.shape[2])
        ny0 = pos.shape[3] if ny0 is None else ny0
        for t in range(pos.shape[0]):
            entries.append((pos, t, ci, cts, full))
    return entries, nz_min, ny0


def split_entries(entries: list, ny0: int, rng: np.random.Generator, *,
                  val_fraction: float, patch: int) -> tuple[list, list]:
    """(train, validation) entries: whole volumes when there are several
    (``rng.permutation`` picks them), else a y split of the one volume,
    else no validation tier."""
    n_val = min(int(round(len(entries) * val_fraction)), len(entries) - 1)
    if n_val >= 1 and len(entries) > 1:
        order = rng.permutation(len(entries))
        val_idx = set(order[:n_val].tolist())
        train_e = [e for i, e in enumerate(entries) if i not in val_idx]
        val_e = [e for i, e in enumerate(entries) if i in val_idx]
    elif val_fraction > 0:
        ny = ny0
        split = max(patch, int(ny * (1 - val_fraction)))
        split = min(split, ny - 1)
        train_e = [(pos, t, ci, cts, slice(0, split)) for pos, t, ci, cts, _ in entries]
        val_e = [(pos, t, ci, cts, slice(split, None)) for pos, t, ci, cts, _ in entries]
        if ny - split < patch:  # too small to crop: no val tier
            train_e, val_e = entries, []
    else:
        train_e, val_e = entries, []
    return train_e, val_e


def validation_crops(val_bank: _VolumeBank, settings, *, patch: int, batch: int, seed: int):
    """The fixed validation crops (NHWC), drawn from ``default_rng(seed +
    1)``, so the early-stop signal is comparable across evaluations."""
    vrng = np.random.default_rng(seed + 1)
    return _sample_batch(vrng, val_bank, in_slices=settings.in_slices, patch=patch,
                         batch=max(batch * 4, 8), augment=False)


def train_vsunet(
    store_path: str | Path,
    *,
    input_channel: str,
    target_channels: list[str],
    settings=None,
    steps: int = 200,
    batch: int = 4,
    patch: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    ckpt_path: str | Path | None = None,
    val_fraction: float = 0.2,
    val_every: int = 25,
    early_stop_patience: int = 4,
    augment: bool = True,
    device=None,
) -> tuple[VirtualStainer, TrainReport]:
    """Fit VS weights on paired channels of ``store_path``.

    Inputs/targets are z-score normalized per volume (matching the
    inference-time normalization). ``val_fraction`` of the volumes is
    held out (when only one volume exists, a y-split of that volume);
    validation MSE is evaluated every ``val_every`` steps on fixed
    crops, and training stops after ``early_stop_patience`` evaluations
    without improvement. The returned stainer carries the
    best-validation parameters; ``ckpt_path`` saves them with the
    architecture sidecar. ``settings`` is read by attribute
    (``config.vs_settings`` or the schema's ``VSModelSettings``); the
    net trains on ``device``, the card when None (``"cpu"`` asks for the
    CPU).
    """
    from shrimpy_tpu_torch.io.ngff import open_ngff

    settings = _checked_settings(settings, target_channels)
    store = open_ngff(store_path)
    return train_positions(
        store.positions().values(), input_channel=input_channel,
        target_channels=target_channels, settings=settings, steps=steps, batch=batch,
        patch=patch, learning_rate=learning_rate, seed=seed, ckpt_path=ckpt_path,
        val_fraction=val_fraction, val_every=val_every,
        early_stop_patience=early_stop_patience, augment=augment, device=device,
    )


def train_positions(
    positions,
    *,
    input_channel: str,
    target_channels: list[str],
    settings=None,
    steps: int = 200,
    batch: int = 4,
    patch: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    ckpt_path: str | Path | None = None,
    val_fraction: float = 0.2,
    val_every: int = 25,
    early_stop_patience: int = 4,
    augment: bool = True,
    device=None,
) -> tuple[VirtualStainer, TrainReport]:
    """:func:`train_vsunet` on ``positions`` (a store's or in memory)."""
    settings = _checked_settings(settings, target_channels)
    dev = resolve_device("cuda" if device is None else device)
    entries, nz_min, ny0 = position_entries(positions, input_channel, target_channels)
    if not entries:
        raise ValueError("no training volumes found")
    if nz_min < settings.in_slices:
        raise ValueError(
            f"volumes have only {nz_min} z planes but in_slices="
            f"{settings.in_slices}; use a thicker store or fewer slices"
        )
    if not 0.0 <= val_fraction < 1.0:
        raise ValueError(f"val_fraction={val_fraction} must be in [0, 1)")

    rng = np.random.default_rng(seed)
    train_e, val_e = split_entries(entries, ny0, rng, val_fraction=val_fraction, patch=patch)
    train_bank = _VolumeBank(train_e)
    val_bank = _VolumeBank(val_e) if val_e else None

    stainer = VirtualStainer(settings, device=dev)
    m = 2**stainer.pad_exp
    if patch % m:
        raise ValueError(
            f"patch={patch} must be divisible by {m} "
            f"(2**pad_exp of the {settings.architecture} architecture)"
        )
    model = stainer.model.to(dev).train()
    opt = adamw(model, learning_rate)

    val_xy = None
    if val_bank is not None:
        vx, vy = validation_crops(val_bank, settings, patch=patch, batch=batch, seed=seed)
        val_xy = (to_nchw(vx, dev), to_nchw(vy, dev))

    losses: list[float] = []
    val_losses: list[float] = []
    best_val = np.inf
    best_state = _snapshot(model)
    stale = 0
    stopped_early = False
    for i in range(steps):
        x, y = _sample_batch(
            rng, train_bank,
            in_slices=settings.in_slices, patch=patch, batch=batch,
            augment=augment,
        )
        losses.append(float(train_step(model, opt, to_nchw(x, dev), to_nchw(y, dev))))
        if i % max(steps // 5, 1) == 0:
            logger.info("vs train step %d/%d loss=%.5f", i, steps, losses[-1])
        if val_xy is not None and (i + 1) % val_every == 0:
            v = evaluate(model, *val_xy)
            val_losses.append(v)
            if v < best_val - 1e-7:
                best_val = v
                best_state = _snapshot(model)
                stale = 0
            else:
                stale += 1
                if stale >= early_stop_patience:
                    logger.info(
                        "early stop at step %d: val loss %.5f has not "
                        "improved for %d evaluations (best %.5f)",
                        i + 1, v, stale, best_val,
                    )
                    stopped_early = True
                    break

    # The best weights exist only once a validation has run; with
    # steps < val_every the trained weights win (the initial ones would
    # otherwise be saved silently).
    if val_losses:
        model.load_state_dict(best_state)
    model.eval()
    if ckpt_path is not None:
        stainer.save_ckpt(ckpt_path)
        logger.info("saved VS checkpoint to %s", ckpt_path)
    return stainer, TrainReport(
        steps=len(losses),
        final_loss=losses[-1],
        losses=losses,
        val_losses=val_losses,
        best_val_loss=None if np.isinf(best_val) else best_val,
        stopped_early=stopped_early,
    )

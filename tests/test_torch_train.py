"""PyTorch port of virtual-staining training against the JAX package (CPU).

``shrimpy_tpu_torch/models/train.py`` against ``shrimpy_tpu/models/train.py``
on stores written by ``create_fov``, with the small nets of
``tests/vs_nets.py`` (unet25d base 8, depth 2; unext2 dims (8, 16)) and
their weights carried across by ``state_dict_from_flax`` (JAX reads them
from an orbax checkpoint, the port from ``state_dict.pt``). Tolerances:
batches bit for bit; AdamW against ``optax.adamw`` on the float32 twins
(unext2 with ``compute_dtype`` float32, unet25d's flax twin ``_UNet32``) at
a learning rate of 1e-2: each step's loss within 1e-4 relative; after 1
and 3 steps every parameter element within 1e-4 of its tensor's max|.|,
but for elements whose gradient in JAX was, at some step, below 1e-4 of
its tensor's largest (a near-cancelling sum): Adam's step is
``m / (sqrt(v) + 1e-8)``, the sign of such a gradient is float32
rounding's, and so is a share of the learning rate; those stay within
1e-3. Torch's default decay of 1e-2, and eps inside the square root,
each fail that gate. In bfloat16 the port's losses deviate from JAX's
float32 run, on the mean over the run, by at most twice JAX's own bf16
deviation, and each by at most 5e-2.
"""

import ast
import contextlib
import inspect
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu.io import ngff as jngff
from shrimpy_tpu.models import train as jtrain
from shrimpy_tpu.models import vsunet as jvs
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.io import ngff as tngff
from shrimpy_tpu_torch.models import train as ttrain
from shrimpy_tpu_torch.models import vsunet as tvs
from shrimpy_tpu_torch.models.convert import state_dict_from_flax
from shrimpy_tpu_torch.models.torch_import import load_state
from tests.vs_nets import NETS, Pair

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F32_RTOL = 1e-4
G_NEAR_ZERO, ADAM_MAX = 1e-4, 1e-3  # the parameters' two-tier gate
BF16_RATIO, BF16_RTOL = 2.0, 5e-2
TRAIN_NETS = ("unet25d", "unext2")
LR = 1e-2
PATCH = 32


def _write(path: Path, shape, target) -> Path:
    """A (T, 2, Z, Y, X) store: channel ``phase`` uniform from a seed,
    channel ``n`` ``target(phase)``."""
    data = np.random.default_rng(shape[0]).random(shape, dtype=np.float32)
    data[:, 1] = target(data[:, 0])
    jngff.create_fov(path, shape=shape, dtype="float32",
                     channel_names=["phase", "n"]).write(Ellipsis, data)
    return path


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    learnable = lambda x: np.tanh(3 * x - 1.5)  # noqa: E731
    return {
        "four": _write(root / "four.zarr", (4, 2, 6, 48, 48), learnable),
        "one": _write(root / "one.zarr", (1, 2, 6, 64, 64), learnable),
        "thin": _write(root / "thin.zarr", (1, 2, 2, 32, 32), learnable),
        "noise": _write(root / "noise.zarr", (1, 2, 6, 48, 48),
                        lambda x: np.random.default_rng(7).random(x.shape, dtype=np.float32)),
    }


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Each net of TRAIN_NETS with target channel ``n``: the pair and its
    weights as JAX's orbax checkpoint and as the port's checkpoint."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name in TRAIN_NETS:
        pair = Pair(name, out_channels=["n"])
        saver = object.__new__(jvs.VirtualStainer)
        saver.settings = pair.jset
        saver.params = jax.tree_util.tree_map(jnp.asarray, pair.params)
        saver.save_ckpt(root / f"{name}_jax")
        carried = tvs.VirtualStainer(pair.tset, device="cpu")
        load_state(carried.model, state_dict_from_flax(pair.params, pair.tset),
                   pair.tset.architecture)
        carried.save_ckpt(root / f"{name}_port")
        out[name] = (pair, str(root / f"{name}_jax"), str(root / f"{name}_port"))
    return out


def _settings(net, *, port: bool):
    pair, jax_ckpt, port_ckpt = net
    kw = {**NETS[pair.tset.architecture], "out_channels": ["n"]}
    if port:
        return tconfig.vs_settings(**kw, ckpt_path=port_ckpt)
    return jvs.VSModelSettings(**kw, ckpt_path=jax_ckpt)


@contextlib.contextmanager
def _float32(monkeypatch, net):
    """Both packages train the float32 twins: JAX's ``build_model`` gives
    the pair's float32 flax net (the same parameter tree), the port's
    stainer computes in float32."""
    pair = net[0]
    build = jvs.build_model

    class Stainer32(tvs.VirtualStainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.model.compute_dtype = torch.float32

    with monkeypatch.context() as m:
        m.setattr(jvs, "build_model", lambda s: (pair.jmodel32, build(s)[1]))
        m.setattr(ttrain, "VirtualStainer", Stainer32)
        yield


def _train_both(store, net, **kw):
    """(JAX's (stainer, report), the port's) on ``store`` from the pair's
    weights."""
    common = {"input_channel": "phase", "target_channels": ["n"], "patch": PATCH, **kw}
    want = jtrain.train_vsunet(store, settings=_settings(net, port=False), **common)
    got = ttrain.train_vsunet(store, settings=_settings(net, port=True), device="cpu",
                              **common)
    return want, got


def _carried(jax_stainer, settings) -> dict:
    params = jax.tree_util.tree_map(np.asarray, jax_stainer.params)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in
            state_dict_from_flax(params, settings).items()}


def _max_rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))


def _nodes(path: Path, names) -> list[str]:
    """The named top-level classes and functions of a module, docstrings
    dropped and the package name normalised."""
    tree = ast.parse(path.read_text().replace("shrimpy_tpu_torch", "shrimpy_tpu"))
    out = []
    for node in tree.body:
        if getattr(node, "name", None) in names:
            for sub in ast.walk(node):
                body = getattr(sub, "body", None)
                if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                        and isinstance(body[0].value, ast.Constant) \
                        and isinstance(body[0].value.value, str):
                    sub.body = body[1:] or [ast.Pass()]
            out.append(ast.dump(node))
    return out


def test_host_copies_are_the_originals_statement_for_statement():
    names = ("TrainReport", "_VolumeBank", "_sample_batch")
    ours = _nodes(REPO / "shrimpy_tpu_torch/models/train.py", names)
    assert len(ours) == 3
    assert ours == _nodes(REPO / "shrimpy_tpu/models/train.py", names)


def test_adamw_settings_are_optax_s():
    """torch's AdamW defaults to a decay of 1e-2; optax's ``adamw`` to 1e-4."""
    defaults = {k: p.default for k, p in inspect.signature(optax.adamw).parameters.items()}
    assert ttrain.ADAMW == {"betas": (defaults["b1"], defaults["b2"]), "eps": defaults["eps"],
                            "weight_decay": defaults["weight_decay"]}
    assert defaults["eps_root"] == 0.0 and defaults["mask"] is None
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    groups = ttrain.adamw(net, 1e-3).param_groups
    assert len(groups) == 1 and len(groups[0]["params"]) == len(list(net.parameters()))


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("in_slices", [3, 4])
def test_batches_are_jax_s_bit_for_bit(stores, in_slices, augment):
    """Both parities of ``in_slices``, flips on and off, the bank's LRU size
    after its first load; the port's NCHW tensor is the NHWC batch
    transposed."""
    banks = []
    for ngff, train in ((jngff, jtrain), (tngff, ttrain)):
        pos = ngff.open_ngff(stores["four"]).position()
        banks.append((train, train._VolumeBank([(pos, t, 0, [1], slice(None))
                                                 for t in range(4)])))
    rngs = [np.random.default_rng(3) for _ in banks]
    for _ in range(3):
        (jx, jy), (tx, ty) = (train._sample_batch(rng, bank, in_slices=in_slices, patch=16,
                                                  batch=5, augment=augment)
                              for (train, bank), rng in zip(banks, rngs))
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.shape == (5, 16, 16, in_slices) and ty.shape == (5, 16, 16, 1)
        nchw = ttrain.to_nchw(tx, "cpu")
        assert nchw.is_contiguous()
        np.testing.assert_array_equal(nchw.numpy(), jx.transpose(0, 3, 1, 2))
    (_, jbank), (_, tbank) = banks
    assert tbank._cache.maxsize == jbank._cache.maxsize == (2 << 30) // (2 * 6 * 48 * 48 * 4)


class _Stop(Exception):
    pass


def _split_of(train, monkeypatch, store, **kw):
    """The (train, validation) entries ``train.train_vsunet`` builds its
    banks from, as (t, ci, cts, y start, y stop); stopped where it builds
    its net."""
    seen = []

    class Bank:
        def __init__(self, entries):
            seen.append([(t, ci, cts, ysl.start, ysl.stop) for _, t, ci, cts, ysl in entries])

    def stop(*args, **kwargs):
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(train, "_VolumeBank", Bank)
        m.setattr(train, "VirtualStainer", stop)
        with pytest.raises(_Stop):
            extra = {"device": "cpu"} if train is ttrain else {}
            train.train_vsunet(store, input_channel="phase", target_channels=["n"], **kw,
                               **extra)
    return seen


@pytest.mark.parametrize(("store", "val_fraction", "patch"), [
    ("four", 0.25, 16), ("four", 0.5, 16), ("four", 0.0, 16), ("four", 0.9, 16),
    ("one", 0.25, 16),  # a y split of the one volume
    ("one", 0.25, 32),  # too small to crop: no validation tier
])
def test_split_is_jax_s(stores, monkeypatch, store, val_fraction, patch):
    kw = {"val_fraction": val_fraction, "patch": patch, "seed": 5}
    want = _split_of(jtrain, monkeypatch, stores[store], **kw)
    got = _split_of(ttrain, monkeypatch, stores[store], **kw)
    assert got == want and got[0]


def _recording_optax(grads: list):
    """``optax`` for JAX's ``train_vsunet``: its ``adamw`` appends each
    step's gradient tree (on the host) to ``grads``."""

    def adamw(learning_rate, **kw):
        inner = optax.adamw(learning_rate, **kw)

        def update(g, state, params=None):
            jax.debug.callback(lambda g: grads.append(jax.tree_util.tree_map(np.asarray, g)), g)
            return inner.update(g, state, params)

        return optax.GradientTransformation(inner.init, update)

    return types.SimpleNamespace(adamw=adamw, apply_updates=optax.apply_updates)


def _adam_steps(stores, net, monkeypatch, steps):
    """JAX's and the port's float32 twins ``steps`` steps from the same
    weights on the same batches (no validation): (JAX's losses, the port's,
    JAX's weights, the port's, JAX's gradient at each step), the tensors in
    the port's layout."""
    grads = []
    with monkeypatch.context() as m:
        m.setattr(jtrain, "optax", _recording_optax(grads))
        with _float32(monkeypatch, net):
            (js, jr), (ts, tr) = _train_both(stores["four"], net, steps=steps, batch=2,
                                             learning_rate=LR, val_fraction=0.0)
    assert tr.steps == jr.steps == len(grads) == steps
    carried = [{k: torch.as_tensor(np.asarray(v)) for k, v in
                state_dict_from_flax(g, ts.settings).items()} for g in grads]
    return jr.losses, tr.losses, _carried(js, ts.settings), ts.model.state_dict(), carried


def _adam_gate(want, got, grads) -> list:
    """The parameters that fail the gate: an element further than F32_RTOL
    of its tensor's max|.| from JAX's, unless JAX's gradient there was, at
    some step, below G_NEAR_ZERO of the tensor's largest; then further than
    ADAM_MAX. Each as (name, elements past F32_RTOL, of them near zero,
    largest error)."""
    failed = []
    for k, w in want.items():
        err = (got[k] - w).abs() / float(w.abs().max())
        g = torch.stack([step[k].abs() for step in grads])
        near_zero = (g < G_NEAR_ZERO * g.amax(dim=tuple(range(1, g.ndim)), keepdim=True)
                     ).any(dim=0)
        past = err > F32_RTOL
        if (past & ~near_zero).any() or float(err.max()) > ADAM_MAX:
            failed.append((k, int(past.sum()), int((past & near_zero).sum()), float(err.max())))
    return failed


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", TRAIN_NETS)
def test_adamw_steps_match_optax(stores, nets, monkeypatch, name, steps):
    """Every step's loss within F32_RTOL; after the last step every
    parameter passes ``_adam_gate``, and the steps moved the weights far
    past it."""
    jl, tl, want, got, grads = _adam_steps(stores, nets[name], monkeypatch, steps)
    assert _max_rel(tl, jl) <= F32_RTOL
    init = tvs.VirtualStainer(_settings(nets[name], port=True), device="cpu").model.state_dict()
    assert set(got) == set(want) == set(init)
    assert _adam_gate(want, got, grads) == []
    assert max(float((want[k] - init[k]).abs().max()) for k in init) > 10 * F32_RTOL


class _AdamWritten(torch.optim.Optimizer):
    """optax's ``adamw`` written out: decay from the old weights, then
    ``m_hat / (sqrt(v_hat + eps_root) + eps)``."""

    def __init__(self, params, lr, betas, eps, weight_decay, eps_root=0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay, "eps_root": eps_root})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), lr = group["betas"], group["lr"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state.update(t=0, m=torch.zeros_like(p), v=torch.zeros_like(p))
                state["t"] += 1
                state["m"].mul_(b1).add_(p.grad, alpha=1 - b1)
                state["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                m_hat = state["m"] / (1 - b1 ** state["t"])
                v_hat = state["v"] / (1 - b2 ** state["t"])
                update = m_hat / ((v_hat + group["eps_root"]).sqrt() + group["eps"])
                p.mul_(1 - lr * group["weight_decay"]).sub_(lr * update)


# The port's optimizer replaced: (the optimizer, whether the gate passes).
OPTIMIZERS = {
    "written out": (lambda ps, lr: _AdamWritten(ps, lr, **ttrain.ADAMW), True),
    "torch's default decay": (
        lambda ps, lr: torch.optim.AdamW(ps, lr, **{**ttrain.ADAMW, "weight_decay": 1e-2}),
        False),
    "eps inside the square root": (
        lambda ps, lr: _AdamWritten(ps, lr, **{**ttrain.ADAMW, "eps": 0.0, "eps_root": 1e-8}),
        False),
}


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
@pytest.mark.parametrize("name", TRAIN_NETS)
def test_adam_gate_tells_optax_s_algebra(stores, nets, monkeypatch, name, optimizer):
    """The port's AdamW swapped for another over 3 steps: optax's algebra
    written out passes ``_adam_gate``; torch's default decay or eps inside
    the square root fails it."""
    make, passes = OPTIMIZERS[optimizer]
    monkeypatch.setattr(ttrain, "adamw", lambda model, lr: make(model.parameters(), lr))
    _, _, want, got, grads = _adam_steps(stores, nets[name], monkeypatch, 3)
    assert (_adam_gate(want, got, grads) == []) is passes


@pytest.mark.parametrize("name", TRAIN_NETS)
def test_train_vsunet_matches_jax(stores, nets, monkeypatch, name):
    """bfloat16, a validation volume of four, evaluations every 2 steps:
    the steps run, the early stop and the evaluations equal JAX's; over the
    run's losses (training and validation) the port's mean relative
    deviation from JAX's float32 run is at most BF16_RATIO times JAX's
    bf16 run's (one loss is one draw of the rounding, so the mean), and
    none deviates past BF16_RTOL."""
    kw = {"steps": 10, "batch": 2, "val_fraction": 0.25, "val_every": 2,
          "early_stop_patience": 3, "learning_rate": 1e-3}
    (_, jr), (_, tr) = _train_both(stores["four"], nets[name], **kw)
    with _float32(monkeypatch, nets[name]):
        (_, jr32), _ = _train_both(stores["four"], nets[name], **kw)
    assert (tr.steps, tr.stopped_early, len(tr.val_losses)) == \
        (jr.steps, jr.stopped_early, len(jr.val_losses)) == \
        (jr32.steps, jr32.stopped_early, len(jr32.val_losses))
    assert len(tr.val_losses) >= 2 and tr.best_val_loss == min(tr.val_losses)
    ref = np.array(jr32.losses + jr32.val_losses)
    jax_dev = np.abs(np.array(jr.losses + jr.val_losses) - ref) / ref
    dev = np.abs(np.array(tr.losses + tr.val_losses) - ref) / ref
    assert dev.mean() <= BF16_RATIO * jax_dev.mean() and dev.max() <= BF16_RTOL, \
        (dev.mean(), jax_dev.mean(), dev.max())


def _small(**kw):
    return tconfig.vs_settings(**{**NETS["unet25d"], "out_channels": ["n"], **kw})


def test_early_stop_on_unlearnable_target(stores):
    """``tests/test_vsunet.py::test_early_stop_on_unlearnable_target``:
    noise targets cannot improve the validation loss."""
    _, report = ttrain.train_vsunet(
        stores["noise"], input_channel="phase", target_channels=["n"], settings=_small(),
        steps=400, batch=2, patch=16, learning_rate=1e-2, val_every=2,
        early_stop_patience=3, val_fraction=0.4, device="cpu")
    assert report.stopped_early
    assert report.steps < 400
    assert len(report.val_losses) >= 4


def test_short_run_keeps_trained_weights(stores):
    """``tests/test_vsunet.py::test_train_short_run_keeps_trained_params``:
    with steps < val_every no evaluation runs, and the trained weights
    are kept, not the initial ones."""
    init = tvs.VirtualStainer(_small(), device="cpu").model.state_dict()
    stainer, report = ttrain.train_vsunet(
        stores["four"], input_channel="phase", target_channels=["n"], settings=_small(),
        steps=8, batch=2, patch=16, val_every=100, val_fraction=0.5, device="cpu")
    assert report.val_losses == [] and report.best_val_loss is None
    state = stainer.model.state_dict()
    assert max(float((state[k] - init[k]).abs().max()) for k in init) > 0


def test_returns_the_best_evaluation_s_weights(stores, monkeypatch, tmp_path):
    """Validation losses scripted 3, 1, 2, 4: the returned and saved weights
    are those of the second evaluation (a copy taken then, not the live
    tensors), not the last."""
    scripted, seen = iter([3.0, 1.0, 2.0, 4.0]), []

    def evaluate(model, x, y):
        seen.append({k: v.clone() for k, v in model.state_dict().items()})
        return next(scripted)

    monkeypatch.setattr(ttrain, "evaluate", evaluate)
    stainer, report = ttrain.train_vsunet(
        stores["four"], input_channel="phase", target_channels=["n"], settings=_small(),
        steps=8, batch=2, patch=16, val_every=2, val_fraction=0.25, early_stop_patience=10,
        learning_rate=1e-2, ckpt_path=tmp_path / "ckpt", device="cpu")
    assert report.val_losses == [3.0, 1.0, 2.0, 4.0] and report.best_val_loss == 1.0
    state = stainer.model.state_dict()
    saved = torch.load(tmp_path / "ckpt" / tvs.STATE_DICT_FILE, weights_only=True)
    for k, best in seen[1].items():
        assert torch.equal(state[k], best) and torch.equal(saved[k], best), k
    assert any(not torch.equal(state[k], seen[-1][k]) for k in state)


VOXEL_STACK = {"architecture": "unext2", "in_slices": 15,
               "arch_config": {"encoder_blocks": [1, 1], "dims": [12, 24], "stem_kernel_z": 5,
                               "out_stack_depth": 5}}


@pytest.mark.parametrize(("store", "settings", "kw"), [
    ("thin", {}, {}),
    ("four", None, {"patch": 10}),  # the pair's checkpoint: JAX's eager init takes 18 s
    ("four", {}, {"val_fraction": 1.5}),
    ("four", VOXEL_STACK, {}),
])
def test_rejections_match_jax(stores, nets, store, settings, kw):
    """A store thinner than ``in_slices``, a patch the net cannot halve,
    ``val_fraction`` out of range, a voxel-stack head: JAX's messages."""
    kw = {"input_channel": "phase", "target_channels": ["n"], "steps": 1, **kw}
    if settings is None:
        jset, tset = (_settings(nets["unet25d"], port=p) for p in (False, True))
    else:
        over = {**NETS["unet25d"], "out_channels": ["n"], **settings}
        jset, tset = jvs.VSModelSettings(**over), tconfig.vs_settings(**over)
    with pytest.raises(ValueError) as want:
        jtrain.train_vsunet(stores[store], settings=jset, **kw)
    with pytest.raises(ValueError) as got:
        ttrain.train_vsunet(stores[store], settings=tset, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_train_without_a_card_asks_for_one(stores, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.train_vsunet(stores["four"], input_channel="phase", target_channels=["n"],
                            settings=_small(), steps=1)


def test_checkpoint_round_trips_into_virtual_stainer(stores, tmp_path):
    stainer, _ = ttrain.train_vsunet(
        stores["four"], input_channel="phase", target_channels=["n"], settings=_small(),
        steps=4, batch=2, patch=16, val_every=2, val_fraction=0.25,
        ckpt_path=tmp_path / "ckpt", device="cpu")
    loaded = tvs.VirtualStainer.from_ckpt(tmp_path / "ckpt", device="cpu")
    assert loaded.settings.architecture == "unet25d" and loaded.settings.out_channels == ["n"]
    vol = np.random.default_rng(2).random((5, 32, 32), dtype=np.float32)
    want, got = stainer.predict(vol)["n"], loaded.predict(vol)["n"]
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_train_vs_verb_matches_jax_cli(stores, nets, monkeypatch, tmp_path):
    """``train-vs`` in both CLIs from the unet25d pair's weights (each CLI's
    settings get the pair's checkpoint, whose sidecar gives the small
    widths, and its ``in_slices``, which both ``train_vsunet`` read from
    the settings they are given): the same keys, steps and early stop,
    losses within BF16_RTOL; the port's checkpoint loads."""
    _, jax_ckpt, port_ckpt = nets["unet25d"]
    real_j, real_t = jvs.VSModelSettings, tconfig.vs_settings
    k = NETS["unet25d"]["in_slices"]
    monkeypatch.setattr(jvs, "VSModelSettings",
                        lambda **kw: real_j(**{"ckpt_path": jax_ckpt, "in_slices": k, **kw}))
    monkeypatch.setattr(tconfig, "vs_settings",
                        lambda **kw: real_t(**{"ckpt_path": port_ckpt, "in_slices": k, **kw}))
    args = [str(stores["four"]), "--input-channel", "phase", "--target-channels", "n",
            "--steps", "4", "--batch", "2", "--patch", "16", "--val-fraction", "0.25",
            "--early-stop-patience", "2"]
    runner = CliRunner()
    want = runner.invoke(jax_cli, ["train-vs", *args, "-o", str(tmp_path / "jax")])
    got = runner.invoke(cli, ["train-vs", *args, "-o", str(tmp_path / "port"), "--device",
                              "cpu"])
    assert want.exit_code == 0, want.output
    assert got.exit_code == 0, got.output
    w, g = json.loads(want.output.strip().splitlines()[-1]), \
        json.loads(got.output.strip().splitlines()[-1])
    assert set(g) == set(w)
    assert (g["steps"], g["stopped_early"], g["best_val_loss"] is None) == \
        (w["steps"], w["stopped_early"], w["best_val_loss"] is None)
    assert abs(g["final_loss"] - w["final_loss"]) <= BF16_RTOL * abs(w["final_loss"])
    assert g["ckpt"] == str(tmp_path / "port")
    monkeypatch.setattr(tconfig, "vs_settings", real_t)
    loaded = tvs.VirtualStainer.from_ckpt(tmp_path / "port", device="cpu")
    assert tconfig.resolved_arch_config(loaded.settings).base_width == \
        NETS["unet25d"]["base_width"]

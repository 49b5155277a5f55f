"""PyTorch port of virtual staining against the JAX package (CPU).

``shrimpy_tpu_torch/models`` and the preprocessor's ``vs`` step against
``shrimpy_tpu/models/vsunet.py``, ``models/torch_import.py`` and
``tracking/preprocess.py`` at small widths (unet25d base 8, depth 2; unext2
blocks (1, 1), dims (8, 16), ``in_slices`` 3; the voxel-stack head at
``in_slices`` 15 with three stem z levels, so dims (12, 24), the smallest
pair of that form divisible by 3). Weights come from ``model.init`` with a
``jax.random.key`` and cross by ``state_dict_from_flax``. Tolerances: in
float32 (unext2 ``compute_dtype=float32``; for unet25d, whose flax net is
bfloat16 only, a float32 twin defined here with flax's names) within 1e-4 of
max|JAX|; in bfloat16 the port's error against the float32 reference is at
most twice JAX's bfloat16 error against it, and at most 5e-2 of the
reference's scale; the preprocessor's deskew and phase products within
1e-5 of the scale, as ``tests/test_torch_tracking.py`` holds them.
"""

import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimpy_tpu.config import DynaTrackConfig as JaxDynaTrackConfig
from shrimpy_tpu.models import vsunet as jvs
from shrimpy_tpu.models.torch_import import convert_unext2_state_dict
from shrimpy_tpu.tracking.preprocess import Preprocessor as JaxPreprocessor
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.config.schemas import DynaTrackConfig
from shrimpy_tpu_torch.models import vsunet as tvs
from shrimpy_tpu_torch.models.convert import state_dict_from_flax
from shrimpy_tpu_torch.models.torch_import import load_state, load_torch_state_dict
from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

torch.set_num_threads(1)

F32_RTOL = 1e-4
BF16_RATIO, BF16_RTOL = 2.0, 5e-2
PRODUCT_RTOL = 1e-5
YX = 32

NETS = {
    "unet25d": {"architecture": "unet25d", "base_width": 8, "depth": 2, "in_slices": 3},
    "unext2": {"architecture": "unext2", "in_slices": 3,
               "arch_config": {"encoder_blocks": [1, 1], "dims": [8, 16]}},
    "unext2_stack": {"architecture": "unext2", "in_slices": 15,
                     "arch_config": {"encoder_blocks": [1, 1], "dims": [12, 24],
                                     "stem_kernel_z": 5, "out_stack_depth": 5}},
}


class _ConvBlock(fnn.Module):
    """``jvs._ConvBlock`` computing in float32 (same names)."""

    width: int

    @fnn.compact
    def __call__(self, x):
        x = fnn.gelu(fnn.Conv(self.width, (3, 3))(x))
        x = fnn.Conv(self.width, (3, 3))(x)
        return fnn.gelu(fnn.LayerNorm()(x))


class _UNet32(fnn.Module):
    """``jvs.VSUNet`` computing in float32: its param tree is VSUNet's."""

    n_out: int
    base_width: int
    depth: int

    @fnn.compact
    def __call__(self, x):
        skips, width = [], self.base_width
        for _ in range(self.depth):
            x = _ConvBlock(width)(x)
            skips.append(x)
            x = fnn.max_pool(x, (2, 2), strides=(2, 2))
            width *= 2
        x = _ConvBlock(width)(x)
        for skip in reversed(skips):
            width //= 2
            b, h, w, c = x.shape
            x = jax.image.resize(x, (b, h * 2, w * 2, c), method="nearest")
            x = _ConvBlock(width)(jnp.concatenate([x, skip], axis=-1))
        return fnn.Conv(self.n_out, (1, 1))(x)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port_layout(y) -> np.ndarray:
    """flax (B, H, W, n) / (B, H, W, d, n) -> the port's (B, n, H, W) / (B, n, d, H, W)."""
    y = np.asarray(y)
    return y.transpose(0, 3, 1, 2) if y.ndim == 4 else y.transpose(0, 4, 3, 1, 2)


class Pair:
    """One net in both packages with the same weights."""

    def __init__(self, name: str, seed: int = 0, **extra):
        kw = {**NETS[name], **extra}
        self.jset, self.tset = jvs.VSModelSettings(**kw), tconfig.vs_settings(**kw)
        self.jmodel, self.pad_exp = jvs.build_model(self.jset)
        sample = jnp.zeros((1, YX, YX, kw["in_slices"]), jnp.float32)
        self.params = jax.tree_util.tree_map(
            np.asarray, jax.jit(self.jmodel.init)(jax.random.key(seed), sample))
        self.net = self.port_net()
        if kw["architecture"] == "unet25d":
            self.jmodel32 = _UNet32(len(self.jset.out_channels), kw["base_width"], kw["depth"])
        else:
            self.jmodel32 = self.jmodel.clone(compute_dtype=jnp.float32)
        self._apply = {False: jax.jit(self.jmodel.apply), True: jax.jit(self.jmodel32.apply)}

    def port_net(self, dtype=torch.bfloat16):
        net, pad_exp = tvs.build_model(self.tset)
        assert pad_exp == self.pad_exp
        load_state(net, state_dict_from_flax(self.params, self.tset), self.tset.architecture)
        net.compute_dtype = dtype
        return net.eval()

    def jax(self, x, dtype32: bool = False) -> np.ndarray:
        return _port_layout(self._apply[dtype32](self.params, jnp.asarray(x.transpose(0, 2, 3, 1))))

    def port(self, x, dtype=torch.bfloat16) -> np.ndarray:
        self.net.compute_dtype = dtype
        with torch.no_grad():
            return self.net(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def pairs():
    return {name: Pair(name) for name in NETS}


@pytest.fixture(scope="module")
def ckpts(pairs, tmp_path_factory):
    """The unext2 pair's weights as a JAX orbax checkpoint (JAX's
    ``save_ckpt``; its ``__init__`` would init them anew, eagerly) and as the
    port's checkpoint, carried by ``state_dict_from_flax``."""
    pair, root = pairs["unext2"], tmp_path_factory.mktemp("vs")
    saver = object.__new__(jvs.VirtualStainer)
    saver.settings = pair.jset
    saver.params = jax.tree_util.tree_map(jnp.asarray, pair.params)
    saver.save_ckpt(root / "jax")
    carried = tvs.VirtualStainer(tconfig.vs_settings(**NETS["unext2"]), device="cpu")
    load_state(carried.model, state_dict_from_flax(pair.params, carried.settings), "unext2")
    carried.save_ckpt(root / "port")
    return root / "jax", root / "port"


def _windows(name: str, seed: int = 1, batch: int = 2) -> np.ndarray:
    k = NETS[name]["in_slices"]
    return np.random.default_rng(seed).standard_normal((batch, k, YX, YX)).astype(np.float32)


@pytest.mark.parametrize("name", list(NETS))
def test_net_float32_matches_jax(name, pairs):
    pair, x = pairs[name], _windows(name)
    want = pair.jax(x, dtype32=True)
    got = pair.port(x, torch.float32)
    assert got.shape == want.shape
    assert _rel(got, want) <= F32_RTOL


@pytest.mark.parametrize("name", list(NETS))
def test_net_bf16_error_is_jax_s(name, pairs):
    pair, x = pairs[name], _windows(name)
    ref = pair.jax(x, dtype32=True)
    jax_err, err = _rel(pair.jax(x), ref), _rel(pair.port(x), ref)
    assert err <= BF16_RATIO * jax_err and err <= BF16_RTOL, (err, jax_err)


def test_gelu_forms_and_layer_norm_epsilon_are_flax_s(pairs):
    """unet25d's GELU is flax's default (tanh), unext2's the erf form; every
    LayerNorm has flax's epsilon."""
    x = torch.linspace(-4, 4, 161)
    xj = jnp.asarray(x.numpy())
    tanh, erf = (torch.nn.functional.gelu(x, approximate=a) for a in ("tanh", "none"))
    assert _rel(tanh, fnn.gelu(xj)) <= 1e-6 and _rel(erf, jvs._gelu_exact(xj)) <= 1e-6
    assert _rel(tanh, erf) > 1e-4  # the two forms are told apart at F32_RTOL
    norms = [m for p in pairs.values() for m in p.net.modules()
             if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.eps == 1e-6 for m in norms)


def test_exact_float32_turns_tf32_off_and_restores_it():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        with cudnn.flags(enabled=cudnn.enabled, allow_tf32=True):
            with tvs.exact_float32():
                assert not matmul.allow_tf32 and not cudnn.allow_tf32
            assert matmul.allow_tf32 and cudnn.allow_tf32
    finally:
        matmul.allow_tf32 = was


@pytest.mark.parametrize(("name", "nz", "batch"), [("unet25d", 7, 3), ("unet25d", 4, 8),
                                                   ("unext2", 5, 2)])
def test_infer_volume_matches_jax(name, nz, batch, pairs):
    """Ragged batches (7 planes in 3s), a batch past the depth, edge windows."""
    pair = pairs[name]
    vol = (np.random.default_rng(nz).random((nz, YX, YX)) * 50 + 3).astype(np.float32)
    k = pair.tset.in_slices
    want = np.asarray(jvs._infer_volume_jit(pair.params, jnp.asarray(vol),
                                            apply_fn=pair.jmodel32.apply, in_slices=k,
                                            batch=batch))
    net = pair.port_net(torch.float32)
    got = tvs.infer_volume(net, torch.from_numpy(vol), in_slices=k, batch=batch)
    assert got.shape == want.shape == (len(pair.tset.out_channels), nz, YX, YX)
    assert _rel(got, want) <= F32_RTOL
    jb = np.asarray(jvs._infer_volume_jit(pair.params, jnp.asarray(vol),
                                          apply_fn=pair.jmodel.apply, in_slices=k, batch=batch))
    gb = tvs.infer_volume(pair.port_net(), torch.from_numpy(vol), in_slices=k, batch=batch)
    assert _rel(gb, want) <= max(BF16_RATIO * _rel(jb, want), 1e-6)


@pytest.mark.parametrize(("nz", "step", "batch"), [(11, 1, 4), (11, 3, 8), (5, 1, 8),
                                                   (12, 3, 2)])
def test_infer_volume_stack_matches_jax(nz, step, batch, pairs):
    """Windows slide by 1 and 3 (overlaps averaged), ragged batches (JAX pads
    them with zero-weight duplicates), the single window of nz == d."""
    pair = pairs["unext2_stack"]
    vol = (np.random.default_rng(nz + step).random((nz, YX, YX)) * 20 - 4).astype(np.float32)
    kw = {"in_slices": 15, "out_stack_depth": 5, "step": step, "n_out": 2, "batch": batch}
    want = np.asarray(jvs._infer_volume_stack_jit(pair.params, jnp.asarray(vol),
                                                  apply_fn=pair.jmodel32.apply, **kw))
    got = tvs.infer_volume_stack(pair.port_net(torch.float32), torch.from_numpy(vol), **kw)
    assert got.shape == want.shape == (2, nz, YX, YX)
    assert _rel(got, want) <= F32_RTOL


class _Windows(torch.nn.Module):
    """A stand-in net whose voxel-stack output is its window's centre
    planes (the input as normalised) plus the window's first input plane
    index, so the assembly's sums and counts show in the output."""

    out_stack_depth = 5

    def forward(self, x):
        off = (x.shape[1] - self.out_stack_depth) // 2
        centre = x[:, off:off + self.out_stack_depth]
        return torch.stack([centre, centre * 0 + x[:, :1]], 1)


@pytest.mark.parametrize("step", [1, 2, 5])
def test_infer_volume_stack_counts(step):
    """With a net that passes its window's planes through, every plane is
    the normalised input (each window covering it adds it once, the count
    divides it out), for every step up to d."""
    vol = torch.from_numpy(np.random.default_rng(step).random((13, 8, 8)).astype(np.float32))
    out = tvs.infer_volume_stack(_Windows(), vol, in_slices=9, out_stack_depth=5, step=step,
                                 n_out=2, batch=3)
    norm = (vol - vol.mean()) / (vol.std(correction=0) + 1e-6)
    assert torch.allclose(out[0], norm, atol=1e-6)


def test_seeded_weights_are_deterministic(pairs):
    net, _ = tvs.build_model(pairs["unext2"].tset)
    a, b, c = (tvs.seeded_state_dict(net, s) for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    w = a["decoder.stages.0.proj.weight"]  # (8, 16, 3, 3): fan-in 144
    std = (1 / 144) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) / std - 0.88) < 0.1
    assert torch.equal(a["encoder.stages.1.downsample.0.weight"], torch.ones(8))
    assert not a["decoder.stages.0.proj.bias"].any() and not a["head.proj.bias"].any()
    assert not a["encoder.stages.0.blocks.0.grn.gamma"].any()
    vol = np.random.default_rng(0).random((3, YX, YX)).astype(np.float32)
    s1, s2 = (tvs.VirtualStainer(tconfig.vs_settings(**NETS["unext2"], seed=s), device="cpu")
              for s in (3, 3))
    torch.testing.assert_close(s1.predict(vol)["vs_nuclei"], s2.predict(vol)["vs_nuclei"],
                               rtol=0, atol=0)


def test_vs_settings_defaults_equal_the_schema():
    ns, model = tconfig.vs_settings(), jvs.VSModelSettings()
    assert {k: getattr(ns, k) for k in tconfig.VS_DEFAULTS} == model.model_dump()
    assert tconfig.UNET25D_DEFAULTS == jvs.UNet25DConfig().model_dump()
    assert tconfig.UNEXT2_DEFAULTS == jvs.UNeXt2Config().model_dump()
    assert ns.fields_set == frozenset()
    partial = {"dims": [4, 8], "encoder_blocks": [1, 2]}
    for kw in ({}, {"base_width": 16}, {"arch_config": {"depth": 2}, "base_width": 8},
               {"architecture": "unext2"}, {"architecture": "unext2", "arch_config": partial}):
        assert vars(tconfig.resolved_arch_config(tconfig.vs_settings(**kw))) == \
            jvs.VSModelSettings(**kw).resolved_arch_config().model_dump()


@pytest.mark.parametrize(("arch_config", "match"), [
    ({"bogus": 1}, "bogus"),
    ({"encoder_blocks": [1, 1], "dims": [8]}, r"must have the same number of stages"),
    ({"encoder_blocks": [1], "dims": [8]}, "at least 2 stages"),
    ({"out_stack_depth": 0}, "out_stack_depth must be >= 1"),
])
def test_arch_config_rejected_as_jax_rejects(arch_config, match):
    with pytest.raises(ValueError, match=match):
        jvs.VSModelSettings(architecture="unext2", arch_config=arch_config).resolved_arch_config()
    with pytest.raises(ValueError, match=match):
        tconfig.resolved_arch_config(tconfig.vs_settings(architecture="unext2",
                                                         arch_config=arch_config))


@pytest.mark.parametrize("kw", [
    {"in_slices": 5, "arch_config": {"stem_kernel_z": 2}},
    {"in_slices": 6,
     "arch_config": {"stem_kernel_z": 2, "dims": [8, 16], "encoder_blocks": [1, 1]}},
    {"in_slices": 3, "arch_config": {"out_stack_depth": 4}},
])
def test_build_model_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jvs.build_model(jvs.VSModelSettings(architecture="unext2", **kw))
    with pytest.raises(ValueError) as got:
        tvs.build_model(tconfig.vs_settings(architecture="unext2", **kw))
    assert str(got.value) == str(want.value)


def test_predict_checks_match_jax(pairs):
    stainer = tvs.VirtualStainer(tconfig.vs_settings(**NETS["unext2_stack"], window_step=6),
                                 device="cpu")
    with pytest.raises(ValueError, match="divisible by 8"):
        stainer.predict(np.zeros((6, 30, 32), np.float32))
    with pytest.raises(ValueError, match="shallower than the model's out_stack_depth 5"):
        stainer.predict(np.zeros((4, 32, 32), np.float32))
    with pytest.raises(ValueError, match=r"window_step=6 must be in \[1, out_stack_depth=5\]"):
        stainer.predict(np.zeros((6, 32, 32), np.float32))
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\)"):
        tvs.VirtualStainer(tconfig.vs_settings(**NETS["unext2"])).predict(
            np.zeros((3, 32, 32), np.float32))


def _sidecar(path: Path, **fields) -> str:
    path.mkdir(parents=True, exist_ok=True)
    (path / "vs_model.json").write_text(json.dumps(fields))
    return str(path)


SIDECAR = {"format_version": 2, "architecture": "unet25d",
           "arch_config": {"base_width": 8, "depth": 2}, "in_slices": 3,
           "out_channels": ["vs_nuclei"]}


@pytest.mark.parametrize(("sidecar", "given"), [
    ({}, {}),  # ckpt_path alone adopts the sidecar
    ({}, {"arch_config": {"depth": 2}, "base_width": 8}),  # partial arch_config, shorthand
    ({}, {"in_slices": 3, "seed": 4}),
    ({}, {"architecture": "unext2"}),  # conflict
    ({}, {"in_slices": 5}),  # conflict
    ({}, {"base_width": 16}),  # conflict with the sidecar's arch_config
    ({"architecture": "unext2", "format_version": 1}, {}),  # old unext2 tree
    ({"architecture": "unext2", "arch_config": dict(tconfig.UNEXT2_DEFAULTS),
      "format_version": 2}, {"arch_config": {"dims": [48, 96, 192]}}),
])
def test_sidecar_reconciliation_matches_jax(sidecar, given, tmp_path):
    path = _sidecar(tmp_path / "ck", **{**SIDECAR, **sidecar})
    try:
        want = jvs.VirtualStainer._reconcile_with_sidecar(
            jvs.VSModelSettings(ckpt_path=path, **given)).model_dump()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tvs.VirtualStainer._reconcile_with_sidecar(tconfig.vs_settings(ckpt_path=path, **given))
        assert str(got.value) == str(exc)
        return
    got = tvs.VirtualStainer._reconcile_with_sidecar(tconfig.vs_settings(ckpt_path=path, **given))
    assert {k: getattr(got, k) for k in tconfig.VS_DEFAULTS} == want


def test_save_load_round_trip_and_the_orbax_carry(ckpts, tmp_path):
    """The port's checkpoint rebuilds the net from its sidecar alone (the
    JAX package's sidecar, key for key); a JAX orbax checkpoint raises,
    naming the carry; its params carried across give JAX's predictions."""
    jax_dir, port_dir = ckpts
    stainer = tvs.VirtualStainer(tconfig.vs_settings(**NETS["unext2"], seed=7), device="cpu")
    stainer.save_ckpt(tmp_path / "port")
    loaded = tvs.VirtualStainer.from_ckpt(tmp_path / "port", device="cpu")
    assert loaded.settings.architecture == "unext2" and loaded.settings.in_slices == 3
    vol = np.random.default_rng(1).random((4, YX, YX)).astype(np.float32)
    torch.testing.assert_close(loaded.predict(vol)["vs_nuclei"], stainer.predict(vol)["vs_nuclei"],
                               rtol=0, atol=0)
    assert json.loads((jax_dir / "vs_model.json").read_text()) == \
        json.loads((tmp_path / "port/vs_model.json").read_text())
    with pytest.raises(FileNotFoundError, match="state_dict_from_flax"):
        tvs.VirtualStainer.from_ckpt(jax_dir, device="cpu")
    restored = jvs.VirtualStainer(jvs.VSModelSettings(ckpt_path=str(jax_dir)))
    carried = tvs.VirtualStainer.from_ckpt(port_dir, device="cpu")
    carried.model.compute_dtype = torch.float32
    restored.model = restored.model.clone(compute_dtype=jnp.float32)
    assert _rel(carried.predict(vol)["vs_nuclei"], restored.predict(vol)["vs_nuclei"]) <= F32_RTOL


def test_state_dict_from_flax_lists_what_does_not_match(pairs):
    pair = pairs["unet25d"]
    inner = pair.params["params"]
    broken = {**inner, "Extra_0": {"kernel": np.zeros(1)}}
    broken.pop("Conv_0")
    with pytest.raises(ValueError, match=r"missing \['Conv_0/kernel', 'Conv_0/bias'\]; "
                                         r"unexpected \['Extra_0/kernel'\]"):
        state_dict_from_flax(broken, pair.tset)
    bad = {**inner, "Conv_0": {**inner["Conv_0"], "kernel": np.zeros((1, 1, 8, 3))}}
    with pytest.raises(ValueError, match=r"shape mismatch for Conv_0/kernel -> head.weight"):
        state_dict_from_flax(bad, pair.tset)


def _lightning(state: dict, path: Path) -> Path:
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 3}, path)
    return path


def test_loader_matches_jax_convert(pairs, tmp_path):
    """A Lightning checkpoint named by the port's unext2 (some tensors
    bf16) loads strictly; JAX's ``convert_unext2_state_dict`` of the same
    dict gives the same net."""
    pair = pairs["unext2_stack"]
    net, _ = tvs.build_model(pair.tset)
    state = tvs.seeded_state_dict(net, 11)
    state["head.proj.weight"] = state["head.proj.weight"].bfloat16()
    path = _lightning(state, tmp_path / "epoch=3.ckpt")
    loaded = load_torch_state_dict(path)
    assert set(loaded) == set(state) and loaded["head.proj.weight"].dtype == torch.float32
    kw = {**NETS["unext2_stack"], "ckpt_path": str(path)}
    stainer = tvs.VirtualStainer(tconfig.vs_settings(**kw), device="cpu")
    stainer.model.compute_dtype = torch.float32
    jset = jvs.VSModelSettings(**kw)
    params = convert_unext2_state_dict({k: v.numpy() for k, v in loaded.items()}, jset)
    x = _windows("unext2_stack")
    with torch.no_grad():
        got = stainer.model(torch.from_numpy(x)).numpy()
    assert _rel(got, _port_layout(pair._apply[True](params, jnp.asarray(
        x.transpose(0, 2, 3, 1))))) <= F32_RTOL


@pytest.mark.parametrize("change", ["missing", "unexpected", "shape mismatch"])
def test_loader_rejects_what_jax_rejects(change, pairs, tmp_path):
    pair = pairs["unext2"]
    net, _ = tvs.build_model(pair.tset)
    state = tvs.seeded_state_dict(net, 0)
    if change == "missing":
        del state["head.proj.weight"]
    elif change == "unexpected":
        state["extra.weight"] = torch.zeros(1)
    else:
        state["head.proj.weight"] = torch.zeros(3, 4, 1, 1)
    np_state = {k: v.numpy() for k, v in state.items()}
    with pytest.raises(ValueError, match=change):
        convert_unext2_state_dict(np_state, pair.jset)
    path = _lightning(state, tmp_path / "x.pt")
    with pytest.raises(ValueError, match=change):
        tvs.VirtualStainer(tconfig.vs_settings(**NETS["unext2"], ckpt_path=str(path)))


def test_torch_file_needs_unext2(tmp_path):
    path = _lightning({}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="supports architecture='unext2'"):
        tvs.VirtualStainer(tconfig.vs_settings(ckpt_path=str(path)))
    with pytest.raises(ValueError, match="missing keys"):
        tvs.VirtualStainer.from_ckpt(path)


def _chain_config(steps, channel, ckpt):
    return {"input_channel": "BF", "tracking_channel": channel, "preprocessing": steps,
            "deskew": {"px_to_scan_ratio": 0.386, "pixel_size_um": 0.116},
            "phase": {"transfer_function": {"yx_pixel_size": 0.116, "z_pixel_size": 0.116}},
            "virtual_staining": {"ckpt_path": str(ckpt), "batch_slices": 4}}


def test_preprocessor_chain_matches_jax(ckpts):
    """``[deskew, phase, vs]``, the same weights in both packages (JAX's orbax
    checkpoint and its carry), both computing in float32: every product
    against JAX's, the VS products (on a YX reflect-padded to multiples of 8
    and cropped back) within F32_RTOL; ``tracking_stack`` gives the VS
    channel."""
    raw = (np.random.default_rng(30).random((60, 24, 28)) * 100 + 10).astype(np.float32)
    jpre = JaxPreprocessor(JaxDynaTrackConfig(
        **_chain_config(["deskew", "phase", "vs"], "vs_membrane", ckpts[0])))
    jpre.stainer.model = jpre.stainer.model.clone(compute_dtype=jnp.float32)
    want = jpre(raw)
    base = _chain_config(["deskew", "phase", "vs"], "vs_membrane", ckpts[1])
    for cfg in (tconfig.dynatrack_settings(**base), DynaTrackConfig(**base)):
        pre = Preprocessor(cfg, device="cpu")
        pre.stainer.model.compute_dtype = torch.float32
        got = pre(raw)
        assert set(got) == set(want) == {"raw", "deskewed", "phase", "vs_nuclei", "vs_membrane"}
        assert want["phase"].shape[1] % 8 and want["phase"].shape[2] % 8  # padded and cropped
        for key, value in want.items():
            assert tuple(got[key].shape) == value.shape
            rtol = F32_RTOL if key.startswith("vs_") else PRODUCT_RTOL
            assert _rel(got[key].numpy(), value) <= rtol, key
        torch.testing.assert_close(pre.tracking_stack(raw), got["vs_membrane"], rtol=0, atol=0)
        assert "vs" in pre.timer.as_dict()


def test_tracking_stack_skips_vs_unless_it_is_tracked(ckpts):
    raw = (np.random.default_rng(31).random((40, 16, 16)) * 100 + 10).astype(np.float32)
    base = _chain_config(["phase", "vs"], "BF", ckpts[1])
    jbase = _chain_config(["phase", "vs"], "BF", ckpts[0])
    pre, jpre = (Preprocessor(tconfig.dynatrack_settings(**base), device="cpu"),
                 JaxPreprocessor(JaxDynaTrackConfig(**jbase)))
    stack = pre.tracking_stack(raw)
    assert "vs" not in pre.timer.as_dict()
    assert _rel(stack.numpy(), jpre.tracking_stack(raw)) <= PRODUCT_RTOL
    torch.testing.assert_close(stack, pre(raw, run_vs=False)["phase"], rtol=0, atol=0)
    pre = Preprocessor(tconfig.dynatrack_settings(**_chain_config(["phase", "vs"], "vs_nuclei",
                                                                  ckpts[1])), device="cpu")
    vs = pre.tracking_stack(torch.from_numpy(raw))
    assert "vs" in pre.timer.as_dict() and vs.device.type == "cpu"
    assert tuple(vs.shape) == raw.shape and bool(torch.isfinite(vs).all())


def test_track_verb_runs_vs_as_jax_does(ckpts, tmp_path):
    """The ``track`` verb with ``[phase, vs]`` and a ``vs_*`` tracking
    channel, the same weights in both packages (bf16, as both ship): the
    journals agree (integer ``pcc`` shifts)."""
    from click.testing import CliRunner

    from shrimpy_tpu.cli.main import cli as jax_cli
    from shrimpy_tpu.io.synthetic import synthetic_blob_fov
    from shrimpy_tpu.tracking import core as jcore
    from shrimpy_tpu_torch.cli.main import cli
    from shrimpy_tpu_torch.tracking import core

    synthetic_blob_fov(tmp_path / "tl.zarr", shape_zyx=(8, 32, 32), n_timepoints=3)
    runner = CliRunner()
    for name, app, ckpt, extra in (("jax", jax_cli, ckpts[0], []),
                                   ("ours", cli, ckpts[1], ["--device", "cpu"])):
        cfg = tmp_path / f"{name}.yml"
        cfg.write_text("input_channel: BF\ntracking_channel: vs_nuclei\n"
                       "preprocessing: [phase, vs]\nphase:\n  transfer_function:\n"
                       "    yx_pixel_size: 0.5\n    z_pixel_size: 1.0\n"
                       f"virtual_staining:\n  ckpt_path: {ckpt}\n")
        res = runner.invoke(app, ["track", str(tmp_path / "tl.zarr"), "-c", str(cfg), "-o",
                                  str(tmp_path / f"{name}.csv"), *extra])
        assert res.exit_code == 0, res.output
    ours = core.ShiftJournal(tmp_path / "ours.csv").rows()
    theirs = jcore.ShiftJournal(tmp_path / "jax.csv").rows()
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert {k: v for k, v in a.items() if k != "wall_time"} == \
            {k: v for k, v in b.items() if k != "wall_time"}

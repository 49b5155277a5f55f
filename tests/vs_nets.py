"""The virtual-staining nets both packages build in the port's tests, with
the same weights: the small widths of ``NETS``, flax's float32 twin of
unet25d (``_UNet32``; its flax net is bfloat16 only) and ``Pair``, one net
in both packages (JAX's ``model.init`` weights carried by
``state_dict_from_flax``). Shared by ``tests/test_torch_vs.py`` and
``tests/test_torch_train.py``."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from shrimpy_tpu.models import vsunet as jvs
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.models import vsunet as tvs
from shrimpy_tpu_torch.models.convert import state_dict_from_flax
from shrimpy_tpu_torch.models.torch_import import load_state

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

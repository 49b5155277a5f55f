"""Tracking preprocessor: deskew -> phase (counterpart of
``shrimpy_tpu/tracking/preprocess.py``).

:class:`Preprocessor` maps a raw ZYX stack to a dict of products
(``"raw"``, ``"deskewed"``, ``"phase"``, ``"vs_*"``), each a tensor on the stack's
device; the tracker consumes ``config.tracking_channel`` from it
(:meth:`Preprocessor.tracking_stack`). The steps are the port's own:

* deskew through :func:`shrimpy_tpu_torch.ops.deskew.deskew_volume`, which
  is ``csrc/deskew.cu`` on a CUDA tensor (the float64 reference runs the
  plain deskew);
* phase through :mod:`shrimpy_tpu_torch.ops.phase`: the host transfer
  function of ``compute_transfer_function`` (cached per shape and settings)
  goes to the device once per (shape, settings, device, dtype) and stays
  there; each update then runs ``apply_inverse_transfer_function`` with the
  device TF. ``reconstruct_phase`` would hand the host TF over at every
  call (~5 GB at (74, 2048, 2048)). ``timer`` keeps ``phase_tf`` (host TF
  and its move) apart from ``phase`` (the inverse).

* virtual staining (``"vs"``) through
  :class:`~shrimpy_tpu_torch.models.vsunet.VirtualStainer` on the phase
  volume, its YX reflect-padded up to the net's multiple and the products
  (``"vs_nuclei"``, ...) cropped back; the weights go to the volume's
  device at the first update. :meth:`Preprocessor.tracking_stack` skips it
  when the tracking channel is not a VS product.

The config is read by attribute: a pydantic ``DynaTrackConfig`` of either
package or :func:`shrimpy_tpu_torch.config.dynatrack_settings`. Its
``deskew``, ``phase`` and ``virtual_staining`` dicts become the port's
settings namespaces (:func:`~shrimpy_tpu_torch.config.deskew_settings`,
:func:`~shrimpy_tpu_torch.config.phase_settings`,
:func:`~shrimpy_tpu_torch.config.vs_settings`); a listed step without its
block runs with the defaults, never a silent skip.
"""

from __future__ import annotations

import torch

from shrimpy_tpu_torch.config import deskew_settings, phase_settings, vs_settings
from shrimpy_tpu_torch.utils.device import as_tensor
from shrimpy_tpu_torch.utils.fft import _pad
from shrimpy_tpu_torch.utils.timing import StageTimer


class Preprocessor:
    """Configured deskew/phase/VS chain over raw ZYX stacks. A tensor stays
    on its device; a numpy array goes to ``device`` (the card when None;
    ``"cpu"`` asks for the CPU). ``dtype`` float64 is the reference run:
    the plain deskew and the phase inverse in float64; the VS net
    normalises in float32 and computes in its ``compute_dtype`` whatever
    ``dtype`` is (``stainer.model.compute_dtype = torch.float32`` makes its
    reference run)."""

    def __init__(self, config, *, device=None, dtype: torch.dtype = torch.float32):
        self.config = config
        self.device = device
        self.dtype = dtype
        self.steps = tuple(config.preprocessing or ())
        self.deskew = deskew_settings(**(config.deskew or {})) if "deskew" in self.steps else None
        self.phase = None
        if "phase" in self.steps:
            parts = dict(config.phase or {})
            unknown = set(parts) - {"transfer_function", "apply_inverse"}
            if unknown:
                raise TypeError(f"unknown phase settings fields: {sorted(unknown)}")
            self.phase = phase_settings(**parts)
        self.stainer = None
        if "vs" in self.steps:
            from shrimpy_tpu_torch.models.vsunet import VirtualStainer

            self.stainer = VirtualStainer(vs_settings(**(config.virtual_staining or {})),
                                          device=device)
        self.timer = StageTimer()
        self._tf_key = None
        self._tf = None

    def __call__(self, raw_zyx, *, run_vs: bool = True) -> dict[str, torch.Tensor]:
        out = {"raw": as_tensor(raw_zyx, self.device).to(self.dtype)}
        vol = out["raw"]
        if self.deskew is not None:
            from shrimpy_tpu_torch.ops.deskew import deskew_plain, deskew_volume

            with self.timer.stage("deskew"):
                if self.dtype == torch.float32:
                    vol = deskew_volume(vol, self.deskew)
                else:
                    vol = deskew_plain(vol, self.deskew, dtype=self.dtype)
            out["deskewed"] = vol
        if self.phase is not None:
            from shrimpy_tpu_torch.ops.phase import apply_inverse_transfer_function

            tfs = self.phase.transfer_function
            with self.timer.stage("phase_tf"):
                tf = self._device_tf(vol)
            with self.timer.stage("phase"):
                vol = apply_inverse_transfer_function(
                    vol, tf, self.phase.apply_inverse, z_padding=tfs.z_padding,
                    dtype=self.dtype)
            out["phase"] = vol
        if self.stainer is not None and run_vs:
            with self.timer.stage("vs"):
                preds = self.stainer.predict(_pad_for_unet(vol, self.stainer.pad_exp))
            for name, pred in preds.items():
                out[name] = pred[..., : vol.shape[1], : vol.shape[2]]
        return out

    def _device_tf(self, vol: torch.Tensor) -> torch.Tensor:
        """The stack's TF on its device, moved there once per (shape,
        settings, device, dtype); one geometry live at a time."""
        from shrimpy_tpu_torch.ops.phase import (
            _settings_key,
            compute_transfer_function,
            tf_tensor,
        )

        tfs = self.phase.transfer_function
        key = (tuple(vol.shape), _settings_key(tfs), vol.device, self.dtype)
        if key != self._tf_key:
            self._tf = None  # free the old geometry's TF first
            cdtype = torch.complex128 if self.dtype == torch.float64 else torch.complex64
            host = compute_transfer_function(tuple(vol.shape), tfs)
            self._tf = tf_tensor(host, vol.device).to(cdtype)
            self._tf_key = key
        return self._tf

    def tracking_scale_zyx(
        self,
        raw_shape_zyx: tuple[int, int, int],
        raw_scale_zyx: tuple[float, float, float],
    ) -> tuple[float, float, float]:
        """Voxel scale (um) of the stack the tracker consumes: deskew
        changes the grid to ``(n_avg * px, px, px)``, so px -> um and the
        um limits use the deskewed scale; phase keeps its input grid."""
        if self.deskew is not None:
            from shrimpy_tpu_torch.ops.deskew import get_deskewed_shape

            _, voxel = get_deskewed_shape(
                tuple(raw_shape_zyx), self.deskew,
                pixel_size_um=self.deskew.pixel_size_um
                or float(raw_scale_zyx[1]),
            )
            return voxel
        return tuple(float(v) for v in raw_scale_zyx)

    def tracking_stack(self, raw_zyx) -> torch.Tensor:
        """The stack the tracker consumes (``config.tracking_channel``): the
        product of that name, else (the input channel's name) the most
        processed product before VS. VS runs only when the channel is one of
        its targets: with ``[deskew, phase, vs]`` and the input channel, an
        inference a timepoint would make an output nobody reads. (The JAX
        package skips VS only for the intermediate products' names, which
        the config's channel rules reject, so there it always runs; the
        stack returned is the same.)"""
        channel = self.config.tracking_channel
        needs_vs = self.stainer is not None and channel in self.stainer.settings.out_channels
        products = self(raw_zyx, run_vs=needs_vs)
        if channel in products:
            return products[channel]
        for key in ("phase", "deskewed", "raw"):
            if key in products:
                return products[key]
        raise KeyError(channel)


def _pad_for_unet(vol: torch.Tensor, depth: int) -> torch.Tensor:
    """YX reflect-padded up to multiples of ``2**depth`` (cropped back
    after), as ``np.pad(mode="reflect")``."""
    m = 2**depth
    py, px = (-vol.shape[1]) % m, (-vol.shape[2]) % m
    return _pad(vol, ((0, 0), (0, py), (0, px)), "reflect") if py or px else vol

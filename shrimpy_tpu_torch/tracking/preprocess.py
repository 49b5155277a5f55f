"""Tracking preprocessor: deskew -> phase (counterpart of
``shrimpy_tpu/tracking/preprocess.py``).

:class:`Preprocessor` maps a raw ZYX stack to a dict of products
(``"raw"``, ``"deskewed"``, ``"phase"``), each a tensor on the stack's
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

Virtual staining (``"vs"``) is ROADMAP queue 1 item 10 and raises.

The config is read by attribute: a pydantic ``DynaTrackConfig`` of either
package or :func:`shrimpy_tpu_torch.config.dynatrack_settings`. Its
``deskew`` and ``phase`` dicts become the port's settings namespaces
(:func:`~shrimpy_tpu_torch.config.deskew_settings`,
:func:`~shrimpy_tpu_torch.config.phase_settings`); a listed step without
its block runs with the defaults, never a silent skip.
"""

from __future__ import annotations

import torch

from shrimpy_tpu_torch.config import deskew_settings, phase_settings
from shrimpy_tpu_torch.utils.device import as_tensor
from shrimpy_tpu_torch.utils.timing import StageTimer


class Preprocessor:
    """Configured deskew/phase chain over raw ZYX stacks. A tensor stays on
    its device; a numpy array goes to ``device`` (the card when None;
    ``"cpu"`` asks for the CPU). ``dtype`` float64 is the reference run:
    the plain deskew and the phase inverse in float64."""

    def __init__(self, config, *, device=None, dtype: torch.dtype = torch.float32):
        self.config = config
        self.device = device
        self.dtype = dtype
        self.steps = tuple(config.preprocessing or ())
        if "vs" in self.steps:
            raise NotImplementedError(
                "virtual staining ('vs' preprocessing) is not ported yet "
                "(ROADMAP queue 1 item 10)"
            )
        self.deskew = deskew_settings(**(config.deskew or {})) if "deskew" in self.steps else None
        self.phase = None
        if "phase" in self.steps:
            parts = dict(config.phase or {})
            unknown = set(parts) - {"transfer_function", "apply_inverse"}
            if unknown:
                raise TypeError(f"unknown phase settings fields: {sorted(unknown)}")
            self.phase = phase_settings(**parts)
        self.timer = StageTimer()
        self._tf_key = None
        self._tf = None

    def __call__(self, raw_zyx) -> dict[str, torch.Tensor]:
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
        processed product."""
        channel = self.config.tracking_channel
        products = self(raw_zyx)
        if channel in products:
            return products[channel]
        for key in ("phase", "deskewed", "raw"):
            if key in products:
                return products[key]
        raise KeyError(channel)

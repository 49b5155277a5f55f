"""Synthetic OME-Zarr fixtures and test scenes.

The port's own copy of ``shrimpy_tpu/io/synthetic.py`` (the demo stores the
CLI drive and the tests write), pinned by ``tests/test_torch_config.py``.

Three generators, modeled on the reference's test strategy:

* :func:`coordinate_encoded_plate` / :func:`coordinate_encoded_value` —
  datasets whose pixel values encode their own (p, t, c, z) coordinates
  (``value = p*30000 + t*10000 + c*1000 + z``), the flagship fake of the
  reference's ReplayCamera tests (``tests/test_replay_camera.py:33-49``).
* :func:`synthetic_blob_fov` — a drifting Gaussian blob time-lapse for
  end-to-end tracking tests (positions must converge back to center).
* :func:`synthetic_ls_stack` — beads rendered **in skewed light-sheet
  coordinates** from known lab-space positions, so deskew can be
  validated geometrically (a bead at lab (z,y,x) must land at voxel
  (z,y,x) of the deskewed volume).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from shrimpy_tpu_torch.io.ngff import NgffPosition, NgffStore, create_fov, create_hcs


def coordinate_encoded_value(p: int, t: int, c: int, z: int) -> int:
    """The reference's coordinate encoding (test_replay_camera.py:33-49).

    The strides are the reference's verbatim (parity), which makes the
    encoding AMBIGUOUS past t=2 when p>0 (one position step == three
    timepoint steps: (p=1, t=0) == (p=0, t=3)); a fixture in that
    regime could not catch a served-wrong-position bug, so it is
    rejected rather than silently weakened.
    """
    if p > 0 and t > 2:
        raise ValueError(
            f"coordinate encoding is ambiguous for (p={p}, t={t}): "
            "p*30000 collides with t*10000 past t=2; use t <= 2 in "
            "multi-position fixtures"
        )
    value = p * 30000 + t * 10000 + c * 1000 + z
    if value > 65535:
        raise ValueError(
            f"coordinate encoding {value} for (p={p}, t={t}, c={c}, z={z}) "
            "exceeds uint16; use smaller fixture extents"
        )
    return value


def coordinate_encoded_fov(
    path: str | Path,
    *,
    shape: tuple[int, int, int, int, int] = (2, 2, 4, 32, 32),
    version: str = "0.5",
) -> NgffPosition:
    """Single-FOV dataset with coordinate-encoded uint16 values (p=0)."""
    t, c, z, y, x = shape
    pos = create_fov(path, shape=shape, dtype="uint16", version=version)
    data = np.zeros(shape, dtype=np.uint16)
    for ti in range(t):
        for ci in range(c):
            for zi in range(z):
                data[ti, ci, zi] = coordinate_encoded_value(0, ti, ci, zi)
    pos.write(Ellipsis, data)
    return pos


def coordinate_encoded_plate(
    path: str | Path,
    *,
    n_positions: int = 2,
    shape_tczyx: tuple[int, int, int, int, int] = (2, 2, 4, 32, 32),
    version: str = "0.5",
) -> NgffStore:
    """HCS plate with coordinate-encoded values, one FOV per position."""
    t, c, z, y, x = shape_tczyx
    channel_names = [f"ch{i}" for i in range(c)]
    store = create_hcs(path, channel_names=channel_names, version=version)
    for p in range(n_positions):
        pos = store.create_position("0", str(p), f"{p:03d}", channel_names=channel_names)
        pos.create_array(shape_tczyx, dtype="uint16")
        data = np.zeros(shape_tczyx, dtype=np.uint16)
        for ti in range(t):
            for ci in range(c):
                for zi in range(z):
                    data[ti, ci, zi] = coordinate_encoded_value(p, ti, ci, zi)
        pos.write(Ellipsis, data)
    return store


def gaussian_blob(
    shape_zyx: tuple[int, int, int],
    center_zyx: tuple[float, float, float],
    sigma_zyx: tuple[float, float, float],
    amplitude: float = 1000.0,
) -> np.ndarray:
    """A single separable 3-D Gaussian blob (float32)."""
    z, y, x = (np.arange(n, dtype=np.float32) for n in shape_zyx)
    gz = np.exp(-0.5 * ((z - center_zyx[0]) / sigma_zyx[0]) ** 2)
    gy = np.exp(-0.5 * ((y - center_zyx[1]) / sigma_zyx[1]) ** 2)
    gx = np.exp(-0.5 * ((x - center_zyx[2]) / sigma_zyx[2]) ** 2)
    return amplitude * gz[:, None, None] * gy[None, :, None] * gx[None, None, :]


def tilted_gaussian_psf(
    shape_zyx: tuple[int, int, int] = (15, 31, 31),
    shears: tuple[float, float] = (0.9, 0.8),
    sigma_zyx: tuple[float, float, float] = (1.5, 2.5, 5.0),
) -> np.ndarray:
    """A sheared anisotropic Gaussian PSF — genuinely NON-separable.

    The principal axes are rotated out of the (z, y, x) grid axes via
    zy and yx shears, so the separable rank grows with the shear; at
    the default 0.9/0.8 the rank-24 residual is 8.7e-2 — beyond the
    extended-rank tier. Shared by bench config 6 and the DFT bake-off
    (``scripts/bench_dft.py``) so they measure the same PSF.
    """
    kz, ky, kx = shape_zyx
    zz, yy, xx = np.meshgrid(
        np.arange(kz) - kz // 2.0,
        np.arange(ky) - ky // 2.0,
        np.arange(kx) - kx // 2.0,
        indexing="ij",
    )
    zr = zz + shears[0] * yy
    yr = yy + shears[1] * xx
    psf = np.exp(
        -0.5 * (
            (zr / sigma_zyx[0]) ** 2
            + (yr / sigma_zyx[1]) ** 2
            + (xx / sigma_zyx[2]) ** 2
        )
    ).astype(np.float32)
    return psf / psf.sum()


def synthetic_blob_fov(
    path: str | Path,
    *,
    shape_zyx: tuple[int, int, int] = (16, 64, 64),
    n_timepoints: int = 4,
    drift_zyx: tuple[float, float, float] = (0.5, 2.0, -3.0),
    sigma_zyx: tuple[float, float, float] = (2.0, 4.0, 4.0),
    noise: float = 5.0,
    seed: int = 0,
    version: str = "0.5",
    zyx_scale: tuple[float, float, float] = (1.0, 0.5, 0.5),
) -> NgffPosition:
    """Time-lapse of a bright blob drifting by ``drift_zyx`` px/timepoint."""
    rng = np.random.default_rng(seed)
    z, y, x = shape_zyx
    shape = (n_timepoints, 1, z, y, x)
    pos = create_fov(
        path, shape=shape, dtype="float32", version=version, zyx_scale=zyx_scale,
        channel_names=["BF"],
    )
    center0 = np.array([z / 2, y / 2, x / 2], dtype=np.float64)
    for t in range(n_timepoints):
        center = center0 + t * np.asarray(drift_zyx)
        vol = gaussian_blob(shape_zyx, tuple(center), sigma_zyx)
        vol += rng.normal(0.0, noise, size=shape_zyx).astype(np.float32)
        pos.write((t, 0), vol.astype(np.float32))
    return pos


def render_beads_skewed(
    raw_shape_szx: tuple[int, int, int],
    beads_lab_zyx: np.ndarray,
    *,
    ls_angle_deg: float = 30.0,
    px_to_scan_ratio: float = 0.386,
    sigma_px: float = 1.5,
    amplitude: float = 1000.0,
) -> np.ndarray:
    """Render point emitters into skewed (scan, tilt, x) camera coordinates.

    Lab coordinates are in camera-pixel units with the deskew convention
    of :mod:`shrimpy_tpu_torch.ops.deskew`::

        z_lab = t * sin(theta);  y_lab = s / r + t * cos(theta);  x_lab = x

    so a lab point (z, y, x) images at raw coordinates
    ``t = z / sin(theta)``, ``s = r * (y - z / tan(theta))``, ``x = x``.
    """
    theta = math.radians(ls_angle_deg)
    ns, nt, nx = raw_shape_szx
    raw = np.zeros(raw_shape_szx, dtype=np.float32)
    s_idx = np.arange(ns, dtype=np.float32)[:, None, None]
    t_idx = np.arange(nt, dtype=np.float32)[None, :, None]
    x_idx = np.arange(nx, dtype=np.float32)[None, None, :]
    for z, y, x in np.asarray(beads_lab_zyx, dtype=np.float64):
        t_c = z / math.sin(theta)
        s_c = px_to_scan_ratio * (y - z / math.tan(theta))
        raw += amplitude * np.exp(
            -0.5
            * (
                ((s_idx - s_c) * (1.0 / px_to_scan_ratio) / sigma_px) ** 2
                + ((t_idx - t_c) / sigma_px) ** 2
                + ((x_idx - x) / sigma_px) ** 2
            )
        ).astype(np.float32)
    return raw


def synthetic_ls_stack(
    path: str | Path | None = None,
    *,
    raw_shape_szx: tuple[int, int, int] = (64, 48, 48),
    n_beads: int = 5,
    ls_angle_deg: float = 30.0,
    px_to_scan_ratio: float = 0.386,
    seed: int = 1,
    version: str = "0.5",
    pixel_size_um: float = 0.116,
) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic skewed light-sheet stack with known bead lab positions.

    Returns ``(raw_szx, beads_lab_zyx)``; optionally writes the stack as
    a single-FOV OME-Zarr with the mantis scale metadata when ``path``
    is given.
    """
    rng = np.random.default_rng(seed)
    theta = math.radians(ls_angle_deg)
    ns, nt, nx = raw_shape_szx
    # Sample beads safely inside the fully-covered deskewed region:
    # the raw scan coordinate of lab (z, y) is s = r*(y - z/tan(theta)),
    # so y is parameterized RELATIVE to its z-dependent lower coverage
    # bound — an absolute y range would push beads off the scan edge
    # for tall-tilt shapes (nt large vs ns).
    z_max = (nt - 1) * math.sin(theta)
    z = rng.uniform(0.2 * z_max, 0.8 * z_max, n_beads)
    u = rng.uniform(0.1, 0.9, n_beads)  # fractional scan position
    y = z / math.tan(theta) + u * (ns - 1) / px_to_scan_ratio
    beads = np.stack(
        [
            z,  # z (lab)
            y,  # y (lab): s = r*(y - z/tan) = u*(ns-1), always in range
            rng.uniform(0.2 * nx, 0.8 * nx, n_beads),  # x
        ],
        axis=1,
    )
    raw = render_beads_skewed(
        raw_shape_szx,
        beads,
        ls_angle_deg=ls_angle_deg,
        px_to_scan_ratio=px_to_scan_ratio,
    )
    if path is not None:
        scan_step_um = pixel_size_um / px_to_scan_ratio
        pos = create_fov(
            path,
            shape=(1, 1, ns, nt, nx),
            dtype="float32",
            version=version,
            zyx_scale=(scan_step_um, pixel_size_um, pixel_size_um),
            channel_names=["GFP"],
        )
        pos.write((0, 0), raw)
    return raw, beads

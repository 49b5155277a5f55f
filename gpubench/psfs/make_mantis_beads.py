"""Make the benchmark's frozen stand-in for a bead-measured PSF once, on a
CUDA card.

    python3 gpubench/psfs/make_mantis_beads.py chiprun_out/mantis-beads-31x41x41

An assumed stand-in for ``BASELINE.md`` config 2's PSF, not a measurement
of a real microscope: ``chip_smoke.bead_raw()``'s 50 noise-free synthetic
Gaussian beads (raw (400, 256, 1600), 30 degrees, scan ratio 0.386, sigma
1.5 px isotropic in raw pixels, seed ``SEED + 5``) measured by
``psf.py::measure_volume_psf`` as the ``measure-psf`` verb runs it
(light-sheet geometry: the deskew on the card, then the host's bead
detection and averaging; patch (31, 41, 41)), exactly as
``chip_smoke.py``'s phase 4p does. Its axial FWHM comes out narrower than
its lateral one, unlike a real light sheet's, so the separable tier a
real bead scan's PSF takes is not shown by it. Writes ``<out>.npy`` (float32) and
``<out>.json`` (the report), and prints the array's sha256 and the port's
plan for it under ``mantis-ls-meas``'s settings (K, residual, working
shape). Copy the ``.npy`` to ``gpubench/psfs/`` and its hash into the
configuration. The benchmark never runs this: it loads the committed
array and refuses one whose hash differs.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(out: str) -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from gpubench import spec
    from shrimpy_tpu_torch.ops.deconv import plan_separable_terms, prepare_psf
    from shrimpy_tpu_torch.psf import measure_volume_psf

    raw, _ = chip_smoke.bead_raw()
    deskew = chip_smoke.headline_settings().deskew
    px = chip_smoke.BEAD_PX_UM
    report = measure_volume_psf(raw, (px / deskew.px_to_scan_ratio, px, px), out,
                                geometry="lightsheet", deskew=deskew)
    path = Path(out).with_suffix(".npy")
    psf = np.load(path).astype(np.float32)
    np.save(path, psf)
    from gpubench.cell import port_settings

    settings = port_settings(spec.load_named("configs", "mantis-ls-sep")).deconvolve
    work = prepare_psf(psf, settings)
    terms = plan_separable_terms(work, settings)
    unit = work.astype(np.float64) / work.astype(np.float64).sum()
    approx = sum(np.einsum("z,y,x->zyx", *(np.asarray(w, np.float64) for w in t)) for t in terms)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "n_beads": report.n_beads, "fwhm_um_zyx": list(report.fwhm_um_zyx),
        "shape": list(psf.shape), "dtype": str(psf.dtype),
        "sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
        "working_shape": list(work.shape), "k": len(terms),
        "residual": float(np.linalg.norm(unit - approx) / np.linalg.norm(unit))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))

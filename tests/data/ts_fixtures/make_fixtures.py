"""Writes the committed tensorstore fixtures of the port's chunk engine.

Run from the repository root with tensorstore installed:

    PYTHONPATH=. python tests/data/ts_fixtures/make_fixtures.py

The JAX package's ``io/ngff.py`` (tensorstore, blosc-zstd at clevel 3 with
byte shuffle) writes one FOV store in each format, ``fov_v2.zarr`` (OME-NGFF
0.4, zarr v2, ``dimension_separator`` "/") and ``fov_v3.zarr`` (0.5, zarr
v3), each with two arrays whose chunks are partial at the edges: ``0``, a
coordinate-encoded uint16 array, and ``f32``, a float32 array drawn from a
seed. ``hashes.json`` beside them records each array's shape, dtype and the
SHA-256 of its C-order bytes; ``tests/test_torch_chunkstore.py`` and
``chip_smoke.py`` phase 4u hold reads of the stores to it.
"""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

from shrimpy_tpu.io import ngff

HERE = Path(__file__).resolve().parent
U16_SHAPE, U16_CHUNKS = (2, 1, 21, 34, 45), (1, 1, 8, 16, 16)
F32_SHAPE, F32_CHUNKS = (1, 1, 13, 30, 37), (1, 1, 8, 16, 16)
SEED = 21


def coordinate_encoded(shape) -> np.ndarray:
    """uint16 whose value names its voxel: t, z, y and x in fields."""
    t, c, z, y, x = np.indices(shape)
    return ((t * 4096 + z * 157 + y * 41 + x * 7 + c) % 65536).astype(np.uint16)


def seeded(shape) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal(shape) * 50.0 + 100.0).astype(np.float32)


def digest(a: np.ndarray) -> dict:
    return {"shape": list(a.shape), "dtype": a.dtype.name,
            "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}


def main() -> None:
    hashes = {}
    u16, f32 = coordinate_encoded(U16_SHAPE), seeded(F32_SHAPE)
    for name, version in (("fov_v2.zarr", "0.4"), ("fov_v3.zarr", "0.5")):
        root = HERE / name
        shutil.rmtree(root, ignore_errors=True)
        pos = ngff.create_fov(root, shape=U16_SHAPE, dtype="uint16", chunks=U16_CHUNKS,
                              zyx_scale=(0.5, 0.2, 0.2), version=version)
        pos.write(Ellipsis, u16)
        pos.create_array(F32_SHAPE, dtype="float32", chunks=F32_CHUNKS, name="f32")
        pos.array("f32").write(f32).result()
        hashes[f"{name}/0"] = digest(u16)
        hashes[f"{name}/f32"] = digest(f32)
    (HERE / "hashes.json").write_text(json.dumps(hashes, indent=2, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()

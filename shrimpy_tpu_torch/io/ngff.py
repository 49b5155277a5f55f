"""OME-Zarr (OME-NGFF 0.4 / 0.5) stores on the port's chunk engine.

The port's own copy of ``shrimpy_tpu/io/ngff.py``, statement for statement
but one: the array IO runs on :mod:`shrimpy_tpu_torch.io.chunkstore`
(imported as ``ts``), the port's zarr v2 / v3 chunk engine with blosc-zstd
decoded in C (``native/zarrcodec.c``), where JAX's runs on tensorstore; the
card's machine has no tensorstore. ``tests/test_torch_config.py`` pins the
copy and reads a store written by either package with the other.

The reference reads/writes OME-Zarr via iohub + ome-writers/acquire-zarr
(reference ``shrimpy/replay_camera.py:86-308``, ``mantis_engine.py:486-493``,
``docs/data_structure.md:60-94``). This module owns the NGFF group metadata
(multiscales / plate / well JSON).

Two layouts, as in the reference:

* **FOV**: a single position at the store root — one TCZYX multiscale
  image.
* **HCS plate**: ``<root>/<row>/<col>/<fov>`` positions with plate and
  well metadata; position keys look like ``"0/2/000"``
  (``replay_camera.py:244-268``).

Two format versions:

* **0.4** — zarr v2 (``.zgroup``/``.zattrs`` + v2 arrays, blosc-zstd
  compressor), the long-term-storage format named in
  ``docs/data_structure.md:60``.
* **0.5** — zarr v3 (``zarr.json`` with an ``ome`` attributes block +
  v3 arrays with blosc-zstd codec), the format the live engine writes
  (``tests/test_mantis_integration.py:93-151`` asserts zarr v3 /
  OME-NGFF 0.5).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from shrimpy_tpu_torch.io import chunkstore as ts

AXES_TCZYX = [
    {"name": "t", "type": "time"},
    {"name": "c", "type": "channel"},
    {"name": "z", "type": "space", "unit": "micrometer"},
    {"name": "y", "type": "space", "unit": "micrometer"},
    {"name": "x", "type": "space", "unit": "micrometer"},
]

# Key for the single position of a non-HCS (FOV) dataset, mirroring the
# reference's DEFAULT_POSITION_KEY (replay_camera.py:82-84).
DEFAULT_POSITION_KEY = "0"

_DTYPE_V2 = {
    "uint8": "|u1",
    "uint16": "<u2",
    "int16": "<i2",
    "uint32": "<u4",
    "float32": "<f4",
    "float64": "<f8",
}


def _write_json(path: Path, obj: dict) -> None:
    # Atomic publish (utils/fileio.py): monitors poll a growing store's
    # zarr.json/.zattrs while the engine updates them — a truncate-
    # then-write here would serve torn JSON to a concurrent reader.
    from shrimpy_tpu_torch.utils.fileio import atomic_write_text

    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(path, json.dumps(obj, indent=2))


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _write_group(path: Path, attributes: dict, version: str) -> None:
    if version == "0.4":
        _write_json(path / ".zgroup", {"zarr_format": 2})
        _write_json(path / ".zattrs", attributes)
    else:  # 0.5 -> zarr v3 group with OME attributes under "ome"
        _write_json(
            path / "zarr.json",
            {
                "zarr_format": 3,
                "node_type": "group",
                "attributes": {"ome": {"version": "0.5", **attributes}},
            },
        )


def _read_group_attrs(path: Path) -> tuple[dict, str]:
    """Return (attributes, ngff_version) for a group directory."""
    zjson = path / "zarr.json"
    if zjson.exists():
        meta = _read_json(zjson)
        ome = meta.get("attributes", {}).get("ome", {})
        return ome, ome.get("version", "0.5")
    zattrs = path / ".zattrs"
    if zattrs.exists():
        attrs = _read_json(zattrs)
        version = "0.4"
        if "multiscales" in attrs and attrs["multiscales"]:
            version = attrs["multiscales"][0].get("version", "0.4")
        elif "plate" in attrs:
            version = attrs["plate"].get("version", "0.4")
        return attrs, version
    return {}, "0.4"


def _is_group(path: Path) -> bool:
    if (path / ".zgroup").exists():
        return True
    zjson = path / "zarr.json"
    if zjson.exists():
        try:
            return _read_json(zjson).get("node_type") == "group"
        except (OSError, json.JSONDecodeError):
            return False
    return False


def _array_spec(
    path: Path,
    *,
    version: str,
    shape: tuple[int, ...] | None = None,
    chunks: tuple[int, ...] | None = None,
    dtype: str | None = None,
    create: bool = False,
    overwrite: bool = False,
) -> dict:
    kv = {"driver": "file", "path": str(path)}
    if version == "0.4":
        spec: dict = {"driver": "zarr", "kvstore": kv}
        if create:
            spec["metadata"] = {
                "shape": list(shape),
                "chunks": list(chunks),
                "dtype": _DTYPE_V2[dtype],
                "compressor": {"id": "blosc", "cname": "zstd", "clevel": 3, "shuffle": 1},
                "dimension_separator": "/",
            }
            spec["create"] = True
            spec["delete_existing"] = bool(overwrite)
    else:
        spec = {"driver": "zarr3", "kvstore": kv}
        if create:
            spec["delete_existing"] = bool(overwrite)
            spec["metadata"] = {
                "shape": list(shape),
                "chunk_grid": {
                    "name": "regular",
                    "configuration": {"chunk_shape": list(chunks)},
                },
                "data_type": dtype,
                "codecs": [
                    {"name": "bytes", "configuration": {"endian": "little"}},
                    {
                        "name": "blosc",
                        "configuration": {"cname": "zstd", "clevel": 3, "shuffle": "shuffle"},
                    },
                ],
            }
            spec["create"] = True
    return spec


def default_chunks(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Reference chunking: one (t, c) per chunk, z-chunk ``min(512, nz)``
    (``mantis_engine.py:489-491``), full YX planes."""
    t, c, z, y, x = shape
    return (1, 1, min(512, max(1, z)), y, x)


# ---------------------------------------------------------------------------
# Position / store wrappers
# ---------------------------------------------------------------------------


@dataclass
class NgffPosition:
    """One position (FOV): a TCZYX multiscale image node."""

    path: Path
    version: str
    attrs: dict
    _arrays: dict[str, ts.TensorStore] = field(default_factory=dict)

    # -- metadata -----------------------------------------------------------
    @property
    def multiscales(self) -> list[dict]:
        return self.attrs.get("multiscales", [])

    @property
    def scale(self) -> tuple[float, ...]:
        """(t, c, z, y, x) scale of resolution level 0 (um for space axes)."""
        try:
            ds = self.multiscales[0]["datasets"][0]
            for tr in ds.get("coordinateTransformations", []):
                if tr.get("type") == "scale":
                    return tuple(tr["scale"])
        except (KeyError, IndexError):
            pass
        return (1.0, 1.0, 1.0, 1.0, 1.0)

    @property
    def zyx_scale(self) -> tuple[float, float, float]:
        return tuple(self.scale[-3:])

    @property
    def channel_names(self) -> list[str]:
        omero = self.attrs.get("omero", {})
        return [ch.get("label", f"ch{i}") for i, ch in enumerate(omero.get("channels", []))]

    # -- array access ---------------------------------------------------------
    def array(self, name: str = "0") -> ts.TensorStore:
        if name not in self._arrays:
            spec = _array_spec(self.path / name, version=self.version)
            self._arrays[name] = ts.open(spec).result()
        return self._arrays[name]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.array().shape)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.array().dtype.name)

    def read(self, selection=Ellipsis) -> np.ndarray:
        """Blocking read of a selection (numpy basic indexing)."""
        return np.asarray(self.array()[selection].read().result())

    def read_async(self, selection=Ellipsis):
        """Non-blocking read returning a tensorstore future."""
        return self.array()[selection].read()

    def write(self, selection, data: np.ndarray) -> None:
        self.array()[selection].write(data).result()

    def write_async(self, selection, data: np.ndarray):
        return self.array()[selection].write(data)

    def volume(self, t: int, c: int) -> np.ndarray:
        """One ZYX volume (blocking)."""
        return self.read((t, c))

    def written_timepoints(self, name: str = "0") -> list[int]:
        """Timepoint indices with at least one chunk on disk.

        Reads only the chunk-store DIRECTORY layout (zarr v3:
        ``<array>/c/<t>/...``; v2: dot-keyed ``<array>/t.c.z.y.x``
        files) — O(written chunks), never touching voxel data. This is
        how growing acquisitions are monitored without O(T x volume)
        scans (reference viewers track written frames via events;
        offline we recover the same from the store itself).
        """
        arr_dir = self.path / name
        if not arr_dir.exists():
            return []
        t_chunk = int(self.array(name).chunk_layout.read_chunk_template.shape[0])
        found: set[int] = set()
        cdir = arr_dir / "c"
        if cdir.is_dir():  # zarr v3 nested keys
            for entry in cdir.iterdir():
                if entry.name.isdigit():
                    found.add(int(entry.name))
        else:  # zarr v2 dot keys
            for entry in arr_dir.iterdir():
                head = entry.name.split(".", 1)[0]
                if head.isdigit():
                    found.add(int(head))
        n_t = self.shape[0]
        out: set[int] = set()
        for ci in found:
            out.update(
                t for t in range(ci * t_chunk, min((ci + 1) * t_chunk, n_t))
            )
        return sorted(out)

    # -- creation --------------------------------------------------------------
    def create_array(
        self,
        shape: tuple[int, ...],
        dtype: str = "uint16",
        chunks: tuple[int, ...] | None = None,
        name: str = "0",
        overwrite: bool = False,
    ) -> ts.TensorStore:
        chunks = chunks or default_chunks(shape)
        spec = _array_spec(
            self.path / name,
            version=self.version,
            shape=shape,
            chunks=chunks,
            dtype=dtype,
            create=True,
            overwrite=overwrite,
        )
        arr = ts.open(spec).result()
        self._arrays[name] = arr
        return arr


class NgffStore:
    """An OME-Zarr store: single FOV or HCS plate.

    ``positions()`` maps HCS keys (``"row/col/fov"``) — or
    ``DEFAULT_POSITION_KEY`` for a FOV store — to :class:`NgffPosition`,
    matching the reference's position discovery
    (``replay_camera.py:244-268``).
    """

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.attrs, self.version = _read_group_attrs(self.root)
        self._positions: dict[str, NgffPosition] | None = None

    @property
    def is_plate(self) -> bool:
        return "plate" in self.attrs

    def positions(self) -> dict[str, NgffPosition]:
        if self._positions is None:
            self._positions = self._collect_positions()
        return self._positions

    def _collect_positions(self) -> dict[str, NgffPosition]:
        out: dict[str, NgffPosition] = {}
        if not self.is_plate:
            attrs, version = _read_group_attrs(self.root)
            out[DEFAULT_POSITION_KEY] = NgffPosition(self.root, version, attrs)
            return out
        plate = self.attrs["plate"]
        for well in plate.get("wells", []):
            well_path = self.root / well["path"]
            well_attrs, _ = _read_group_attrs(well_path)
            images = well_attrs.get("well", {}).get("images", [{"path": "0"}])
            for img in images:
                pos_path = well_path / img["path"]
                key = f"{well['path']}/{img['path']}"
                attrs, version = _read_group_attrs(pos_path)
                out[key] = NgffPosition(pos_path, version, attrs)
        return out

    def position(self, key: str | None = None) -> NgffPosition:
        positions = self.positions()
        if key is None:
            return next(iter(positions.values()))
        return positions[key]

    # -- plate creation --------------------------------------------------------
    def create_position(
        self,
        row: str,
        col: str,
        fov: str,
        *,
        channel_names: list[str] | None = None,
        zyx_scale: tuple[float, float, float] = (1.0, 1.0, 1.0),
    ) -> NgffPosition:
        """Add a position to an HCS plate store, updating plate metadata."""
        assert self.is_plate, "create_position requires an HCS store"
        plate = self.attrs["plate"]
        if not any(r["name"] == row for r in plate["rows"]):
            plate["rows"].append({"name": row})
        if not any(c["name"] == col for c in plate["columns"]):
            plate["columns"].append({"name": col})
        well_path = f"{row}/{col}"
        row_idx = next(i for i, r in enumerate(plate["rows"]) if r["name"] == row)
        col_idx = next(i for i, c in enumerate(plate["columns"]) if c["name"] == col)
        if not any(w["path"] == well_path for w in plate["wells"]):
            plate["wells"].append(
                {"path": well_path, "rowIndex": row_idx, "columnIndex": col_idx}
            )
        _write_group(self.root, self.attrs, self.version)

        # well group metadata
        well_dir = self.root / well_path
        well_attrs, _ = _read_group_attrs(well_dir)
        well_meta = well_attrs.get("well", {"images": []})
        if not any(img["path"] == fov for img in well_meta["images"]):
            well_meta["images"].append({"path": fov, "acquisition": 0})
        if self.version == "0.4":
            well_meta.setdefault("version", "0.4")
        _write_group(well_dir, {"well": well_meta}, self.version)
        _write_group(self.root / row, {}, self.version)

        pos = _init_position(
            well_dir / fov,
            version=self.version,
            channel_names=channel_names or self._plate_channel_names(),
            zyx_scale=zyx_scale,
        )
        if self._positions is not None:
            self._positions[f"{well_path}/{fov}"] = pos
        return pos

    def _plate_channel_names(self) -> list[str]:
        return self.attrs.get("_shrimpy_channel_names", ["0"])


def _multiscales_attrs(
    name: str,
    zyx_scale: tuple[float, float, float],
    channel_names: list[str],
    version: str,
) -> dict:
    ms = {
        "axes": AXES_TCZYX,
        "datasets": [
            {
                "path": "0",
                "coordinateTransformations": [
                    {"type": "scale", "scale": [1.0, 1.0, *map(float, zyx_scale)]}
                ],
            }
        ],
        "name": name,
    }
    if version == "0.4":
        ms["version"] = "0.4"
    return {
        "multiscales": [ms],
        "omero": {"channels": [{"label": n} for n in channel_names]},
    }


def _init_position(
    path: Path,
    *,
    version: str,
    channel_names: list[str],
    zyx_scale: tuple[float, float, float],
) -> NgffPosition:
    attrs = _multiscales_attrs(path.name, zyx_scale, channel_names, version)
    _write_group(path, attrs, version)
    return NgffPosition(path, version, attrs)


def _mean_pool_zyx(vol: np.ndarray, factors: tuple[int, int, int]) -> np.ndarray:
    """Mean-pool a ZYX volume by integer factors (trailing partials
    dropped); dimensions smaller than their factor are left unpooled
    (a size-1 axis must stay size 1, not become size 0)."""
    fz, fy, fx = (min(f, n) or 1 for f, n in zip(factors, vol.shape))
    z, y, x = (n - n % f for n, f in zip(vol.shape, (fz, fy, fx)))
    v = vol[:z, :y, :x].reshape(
        z // fz, fz, y // fy, fy, x // fx, fx
    )
    return v.mean(axis=(1, 3, 5)).astype(vol.dtype)


def add_pyramid_levels(
    pos: NgffPosition,
    n_levels: int = 2,
    *,
    factors_zyx: tuple[int, int, int] = (1, 2, 2),
) -> None:
    """Append mean-pooled resolution levels to a position.

    Writes arrays ``"1" .. "<n>"`` (each level pooled by ``factors_zyx``
    from the previous) and extends the multiscales ``datasets`` metadata
    with the scaled coordinate transforms — the NGFF pyramid the
    reference's viewers consume for coarse browsing.

    Resume-safe: level arrays left by a crashed earlier attempt (the
    metadata is only written after all levels complete) are reopened
    and overwritten rather than erroring; scale transforms record the
    ACTUAL per-axis shrink (an axis clamped at size 1 stops scaling).
    """
    base = pos.array("0")
    t_size, c_size = base.shape[0], base.shape[1]
    ms = pos.attrs["multiscales"][0]
    # Cumulative ACTUAL per-axis factor (axes at size 1 stop shrinking,
    # and their transform must stop scaling with them).
    cum = [1.0, 1.0, 1.0]
    scale0 = list(pos.scale)

    prev_name = "0"
    for level in range(1, n_levels + 1):
        prev = pos.array(prev_name)
        shape_zyx = tuple(prev.shape[2:])
        eff = tuple(
            f if n >= f else 1 for n, f in zip(shape_zyx, factors_zyx)
        )
        new_zyx = tuple(n // f for n, f in zip(shape_zyx, eff))
        cum = [c * f for c, f in zip(cum, eff)]
        name = str(level)
        try:
            level_arr = pos.array(name)  # crashed-attempt leftover
            if tuple(level_arr.shape) != (t_size, c_size, *new_zyx):
                # stale/mismatched: recreate (delete_existing — a plain
                # create=True would ALREADY_EXISTS here).
                pos.create_array(
                    (t_size, c_size, *new_zyx), dtype=str(pos.dtype),
                    name=name, overwrite=True,
                )
                level_arr = pos.array(name)
        except Exception:
            pos.create_array(
                (t_size, c_size, *new_zyx), dtype=str(pos.dtype), name=name
            )
            level_arr = pos.array(name)
        # ONE read + ONE write in flight: overlap tensorstore IO with
        # pooling while bounding host memory to two volumes (issuing
        # every read up front buffers the whole level — ~T*C volumes of
        # concurrent read buffers on a production store).
        keys = [(t, c) for t in range(t_size) for c in range(c_size)]
        next_fut = prev[keys[0]].read() if keys else None
        pending_write = None
        for i, (t, c) in enumerate(keys):
            fut = next_fut
            next_fut = (
                prev[keys[i + 1]].read() if i + 1 < len(keys) else None
            )
            vol = np.asarray(fut.result())
            pooled = _mean_pool_zyx(vol, eff)[
                : new_zyx[0], : new_zyx[1], : new_zyx[2]
            ]
            if pending_write is not None:
                pending_write.result()
            pending_write = level_arr[t, c].write(pooled)
        if pending_write is not None:
            pending_write.result()
        level_scale = [
            scale0[0],
            scale0[1],
            *(s0 * c for s0, c in zip(scale0[2:], cum)),
        ]
        entry = {
            "path": name,
            "coordinateTransformations": [
                {"type": "scale", "scale": [float(v) for v in level_scale]}
            ],
        }
        datasets = ms["datasets"]
        if len(datasets) > level:
            datasets[level] = entry
        else:
            datasets.append(entry)
        prev_name = name
    _write_group(pos.path, pos.attrs, pos.version)


# ---------------------------------------------------------------------------
# Public constructors
# ---------------------------------------------------------------------------


def open_ngff(path: str | Path) -> NgffStore:
    """Open an existing OME-Zarr store (FOV or HCS plate, 0.4 or 0.5)."""
    root = Path(path)
    if not root.exists():
        raise FileNotFoundError(root)
    if not _is_group(root):
        raise ValueError(f"{root} is not a zarr group")
    return NgffStore(root)


def create_fov(
    path: str | Path,
    *,
    shape: tuple[int, int, int, int, int],
    dtype: str = "uint16",
    channel_names: list[str] | None = None,
    zyx_scale: tuple[float, float, float] = (1.0, 1.0, 1.0),
    chunks: tuple[int, ...] | None = None,
    version: str = "0.5",
) -> NgffPosition:
    """Create a single-FOV OME-Zarr store with one TCZYX array."""
    t, c, z, y, x = shape
    channel_names = channel_names or [f"ch{i}" for i in range(c)]
    assert len(channel_names) == c
    pos = _init_position(
        Path(path), version=version, channel_names=channel_names, zyx_scale=zyx_scale
    )
    pos.create_array(shape, dtype=dtype, chunks=chunks)
    return pos


def create_hcs(
    path: str | Path,
    *,
    channel_names: list[str],
    version: str = "0.5",
) -> NgffStore:
    """Create an empty HCS plate store; add FOVs with ``create_position``."""
    root = Path(path)
    plate_attrs = {
        "plate": {
            "acquisitions": [{"id": 0}],
            "columns": [],
            "rows": [],
            "wells": [],
            "field_count": 1,
            **({"version": "0.4"} if version == "0.4" else {}),
        },
        "_shrimpy_channel_names": channel_names,
    }
    _write_group(root, plate_attrs, version)
    store = NgffStore(root)
    return store

"""Position-list / platemap CSVs.

The reference's data contract carries stage-position lists and
plate maps alongside the OME-Zarr stores (reference
``docs/data_structure.md:60-94``; the archived engine round-trips
position lists with MM Studio, archive
``microscope_operations.py:77-158``, and pushes autotracker-corrected
positions back between acquisition chunks, ``acq_engine.py:526-538``).

The port's own copy of ``shrimpy_tpu/io/platemap.py``, pinned statement for
statement by ``tests/test_torch_config.py`` (``COPIES``); standard library
only, so it loads where the card's host has neither pydantic nor
tensorstore.

Schema: ``name,row,col,fov,x_um,y_um,z_um`` — one row per position;
``row/col/fov`` empty for non-HCS lists.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from pathlib import Path

FIELDS = ("name", "row", "col", "fov", "x_um", "y_um", "z_um")


@dataclass
class PositionEntry:
    name: str
    x_um: float = 0.0
    y_um: float = 0.0
    z_um: float = 0.0
    row: str = ""
    col: str = ""
    fov: str = ""

    @property
    def hcs_key(self) -> str | None:
        if self.row and self.col and self.fov:
            return f"{self.row}/{self.col}/{self.fov}"
        return None


@dataclass
class PositionList:
    entries: list[PositionEntry] = field(default_factory=list)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def names(self) -> list[str]:
        return [e.name for e in self.entries]

    def get(self, name: str) -> PositionEntry:
        for e in self.entries:
            if e.name == name:
                return e
        raise KeyError(name)

    def update_coords(self, name: str, x_um: float, y_um: float, z_um: float) -> None:
        """Write back corrected coordinates (the between-chunk push of
        autotracker positions, archive ``acq_engine.py:526-538``)."""
        e = self.get(name)
        e.x_um, e.y_um, e.z_um = float(x_um), float(y_um), float(z_um)

    # -- IO -------------------------------------------------------------
    @classmethod
    def read(cls, path: str | Path) -> "PositionList":
        entries = []
        with open(path, newline="") as f:
            for rec in csv.DictReader(f):
                entries.append(
                    PositionEntry(
                        name=rec["name"],
                        row=rec.get("row", "") or "",
                        col=rec.get("col", "") or "",
                        fov=rec.get("fov", "") or "",
                        x_um=float(rec.get("x_um", 0) or 0),
                        y_um=float(rec.get("y_um", 0) or 0),
                        z_um=float(rec.get("z_um", 0) or 0),
                    )
                )
        return cls(entries)

    def write(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=FIELDS)
            writer.writeheader()
            for e in self.entries:
                writer.writerow(
                    {
                        "name": e.name,
                        "row": e.row,
                        "col": e.col,
                        "fov": e.fov,
                        "x_um": e.x_um,
                        "y_um": e.y_um,
                        "z_um": e.z_um,
                    }
                )

    # -- plate helpers ----------------------------------------------------
    @classmethod
    def from_plate_grid(
        cls,
        rows: list[str],
        cols: list[str],
        *,
        fovs_per_well: int = 1,
        well_pitch_um: tuple[float, float] = (9000.0, 9000.0),
        fov_pitch_um: tuple[float, float] = (500.0, 500.0),
    ) -> "PositionList":
        """Generate a well-plate grid (the WellPlatePlan role of the
        reference's useq plans, ``config/mda/mantis/mantis.yaml:16-35``)."""
        entries = []
        grid = int(fovs_per_well**0.5) or 1
        names = set()
        for ri, row in enumerate(rows):
            for ci, col in enumerate(cols):
                for f in range(fovs_per_well):
                    fy, fx = divmod(f, grid)
                    # '/'-joined name: bare concatenation collides for
                    # label pairs like ('A','11') vs ('A1','1'), and
                    # get()/update_coords act on the first match.
                    name = f"{row}/{col}-{f:03d}"
                    if name in names:
                        raise ValueError(
                            f"duplicate position name {name!r} (rows/cols "
                            "labels overlap)"
                        )
                    names.add(name)
                    entries.append(
                        PositionEntry(
                            name=name,
                            row=row,
                            col=col,
                            fov=f"{f:03d}",
                            x_um=ci * well_pitch_um[1] + fx * fov_pitch_um[1],
                            y_um=ri * well_pitch_um[0] + fy * fov_pitch_um[0],
                        )
                    )
        return cls(entries)

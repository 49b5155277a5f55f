"""Microscope profiles — the multi-microscope extension seam.

The port's own copy of ``shrimpy_tpu/config/microscopes.py``, pinned to it
by ``tests/test_torch_config.py``.

The reference keeps an explicit second-microscope seam: an empty
``shrimpy/isim/`` package plus a CLI dispatch stub that answers
``shrimpy acquire isim`` with a friendly "coming soon" (reference
``shrimpy/cli/acquire.py:150-163``, ``shrimpy/isim/__init__.py``). The
TPU-idiom equivalent is a profile registry: each microscope registers a
:class:`MicroscopeProfile` carrying its optical defaults, and the CLI
verbs dispatch on ``--microscope``. ``mantis`` is the shipped,
implemented profile; ``isim`` is declared-but-unimplemented and errors
with the reference's message instead of silently acquiring with wrong
optics.

Derived per-dataset parameters (pixel size, z step) still come from
store metadata and override nothing here (reference
``manager.py:242-262`` — single source of truth); profiles carry only
the per-INSTRUMENT constants a dataset cannot know about itself.
"""

from __future__ import annotations

from pydantic import BaseModel, ConfigDict


class MicroscopeProfile(BaseModel):
    """Per-instrument constants + implementation status."""

    model_config = ConfigDict(extra="forbid")

    name: str
    description: str = ""
    implemented: bool = True
    # Light-sheet tilt: the default for `deskew --ls-angle-deg` when
    # the user gives none (reference seeds LS_ANGLE_DEG per scope).
    ls_angle_deg: float | None = None
    # The instrument's arm inventory: `replay-dual` rejects configs
    # whose arm names don't match (PARITY 2.13).
    arms: list[str] = []
    # Hardware-sequence length the instrument's trigger firmware can
    # program (reference archive acq_engine.py:171-183, TriggerScope
    # NR_DAC_STATES/NR_DO_STATES). None = no instrument cap known;
    # replay-dual seeds plan.camera.max_sequenced_events from this
    # when the plan doesn't set one itself.
    max_sequenced_events: int | None = None


_REGISTRY: dict[str, MicroscopeProfile] = {}


def register_microscope(profile: MicroscopeProfile) -> None:
    """Register (or replace) a microscope profile.

    The extension point: a downstream package registers its instrument
    at import time and every ``--microscope``-aware CLI verb picks it
    up (the role of dropping a package next to ``shrimpy/isim/`` in
    the reference).
    """
    _REGISTRY[profile.name] = profile


def available_microscopes() -> list[str]:
    return sorted(_REGISTRY)


def get_microscope(name: str) -> MicroscopeProfile:
    """Look up a profile; unknown names list what exists.

    Declared-but-unimplemented profiles are returned as-is — callers
    that need a working instrument must check ``implemented`` (the CLI
    prints the reference's "coming soon" for those).
    """
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown microscope {name!r}; registered: "
            f"{', '.join(available_microscopes())}"
        ) from None


register_microscope(MicroscopeProfile(
    name="mantis",
    description=(
        "simultaneous label-free + oblique-plane light-sheet "
        "(Ivanov et al., PNAS Nexus)"
    ),
    ls_angle_deg=30.0,
    arms=["labelfree", "lightsheet"],
    max_sequenced_events=1200,
))

register_microscope(MicroscopeProfile(
    name="isim",
    description="iSIM (instant structured illumination) — coming soon",
    implemented=False,
))

"""The two packages under test for the acquisition layer (ROADMAP item 12c):
the JAX tests of ``devices/``, ``engine/engine.py`` and ``engine/dual.py`` run
on ``shrimpy_tpu`` and on ``shrimpy_tpu_torch`` through :class:`Pkg`.

The port's engine runs its tracking and refocus metric where ``device``
says, the card when None; on the CPU the tests ask for it
(:meth:`Pkg.engine`, :meth:`Pkg.dual`). A module that imports
:func:`package_logging` has each of its tests leave both packages' loggers
as it found them."""

import importlib
import logging

import pytest

PACKAGES = ["shrimpy_tpu", "shrimpy_tpu_torch"]


@pytest.fixture(autouse=True)
def package_logging():
    """Restores both packages' loggers after a test: an acquisition's (or a
    verb's) ``configure_logging`` adds a console handler and stops the
    package's records from reaching the root logger, where later tests'
    ``caplog`` listens."""
    loggers = [logging.getLogger(name) for name in PACKAGES]
    saved = [(list(lg.handlers), lg.level, lg.propagate) for lg in loggers]
    yield
    for lg, (handlers, level, propagate) in zip(loggers, saved):
        for h in list(lg.handlers):
            if h not in handlers:
                lg.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in lg.handlers:
                lg.addHandler(h)
        lg.setLevel(level)
        lg.propagate = propagate


class Pkg:
    """A package under test: ``pkg("engine.plan")`` is its module of that
    name."""

    def __init__(self, name: str):
        self.name = name
        self.is_port = name == "shrimpy_tpu_torch"
        self.cpu = {"device": "cpu"} if self.is_port else {}

    def __call__(self, module: str):
        return importlib.import_module(f"{self.name}.{module}")

    def __repr__(self) -> str:
        return self.name

    def engine(self, source, **kw):
        """``AcquisitionEngine(source, **kw)``, on the CPU."""
        return self("engine.engine").AcquisitionEngine(source, **kw, **self.cpu)

    def dual(self, arms, **kw):
        """``DualArmAcquisition(arms, **kw)``, on the CPU."""
        return self("engine.dual").DualArmAcquisition(arms, **kw, **self.cpu)

    def plan(self, **kw):
        return self("engine.plan").AcquisitionPlan(**kw)

    def source(self, path):
        return self("engine.replay").ReplaySource(path)

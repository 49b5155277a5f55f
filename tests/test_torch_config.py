"""PyTorch port: its own config and store modules against the JAX
package's, which they are copies of (CPU).

The port imports nothing of ``shrimpy_tpu``, so ``config/schemas.py``,
``config/microscopes.py``, ``config/vs_sidecar.py``, ``io/ngff.py``,
``io/synthetic.py``, ``io/platemap.py``, ``utils/fileio.py``,
``utils/cache.py``, ``utils/retry.py``, ``utils/logging.py``, the engine's
``control.py``, ``autoexposure.py``, ``plan.py`` and ``replay.py``, and the
tracking's ``position.py`` and ``debug.py``, the devices, ``native/`` and the
viewer's ``ring.py``, ``feeder.py`` and ``web.py`` are copies. Each is pinned to its original: the code is the same statement
for statement (comments and docstrings apart; the logging copy's two
provenance functions record torch in the place of jax), the pydantic models agree field for field and schema
for schema, one YAML loads to equal dumps, and a store written by either
package is read by the other with equal arrays and scales; the ``info``
and ``microscopes`` verbs print the JAX CLI's JSON.
"""

import ast
import json
import logging
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from pydantic import BaseModel, ValidationError

from shrimpy_tpu.config import microscopes as jmicro
from shrimpy_tpu.config import schemas as jschemas
from shrimpy_tpu.config import vs_sidecar as jsidecar
from shrimpy_tpu.io import ngff as jngff
from shrimpy_tpu.io import synthetic as jsynth
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.config import microscopes as tmicro
from shrimpy_tpu_torch.config import schemas as tschemas
from shrimpy_tpu_torch.config import vs_sidecar as tsidecar
from shrimpy_tpu_torch.io import ngff as tngff
from shrimpy_tpu_torch.io import synthetic as tsynth
from shrimpy_tpu_torch.parallel.pipeline import reconstruct_batch
from shrimpy_tpu_torch.runtime import stream as tstream
from shrimpy_tpu_torch.utils import logging as tlogging
from shrimpy_tpu_torch.utils.fileio import atomic_write_text

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COPIES = ["config/schemas.py", "config/microscopes.py", "config/vs_sidecar.py", "io/ngff.py",
          "io/synthetic.py", "utils/fileio.py", "utils/cache.py", "utils/retry.py",
          "io/platemap.py", "engine/control.py", "engine/autoexposure.py", "engine/plan.py",
          "engine/replay.py", "tracking/position.py", "tracking/debug.py",
          "devices/__init__.py", "devices/bus.py", "devices/daq.py", "devices/kim101.py",
          "devices/rig.py", "devices/shutter.py", "devices/vortran.py",
          "native/__init__.py", "native/build.py", "viewer/__init__.py", "viewer/ring.py",
          "viewer/feeder.py", "viewer/web.py"]
MODELS = sorted(n for n, v in vars(jschemas).items()
                if isinstance(v, type) and issubclass(v, BaseModel) and v is not BaseModel)


class _WithoutDevice(ast.NodeTransformer):
    """Takes out the port's ``device``: the parameter, the keyword passed on,
    and ``self.device = device``."""

    def visit_arguments(self, node):
        for args, defaults in ((node.args, node.defaults), (node.kwonlyargs, node.kw_defaults)):
            while any(a.arg == "device" for a in args):
                i = next(i for i, a in enumerate(args) if a.arg == "device")
                j = i - (len(args) - len(defaults))  # the default's index
                del args[i]
                if j >= 0:
                    del defaults[j]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return node

    def visit_Assign(self, node):
        self.generic_visit(node)
        target = node.targets[0]
        if isinstance(target, ast.Attribute) and target.attr == "device" \
                and isinstance(node.value, ast.Name) and node.value.id == "device":
            return None
        return node


def _code(path: Path, skip=(), drop_imports=(), deferred=(), without_device=False,
          replace=()) -> str:
    """The module's statements without docstrings (comments are not in
    the tree), the package name normalised, each ``(old, new)`` of
    ``replace`` made in the source text first (each ``old`` must occur);
    top-level functions and methods
    (``Class.method``) named in ``skip``, imports from the modules in
    ``drop_imports``, and imports from those in ``deferred`` at any depth
    (the port defers them into the function that needs them) left out; with
    ``without_device`` the port's ``device`` too (:class:`_WithoutDevice`)."""
    text = path.read_text()
    for old, new in replace:
        assert old in text, (path, old)
        text = text.replace(old, new)
    tree = ast.parse(text.replace("shrimpy_tpu_torch", "shrimpy_tpu"))
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.FunctionDef) and n.name in skip)
                 and not (isinstance(n, ast.ImportFrom) and n.module in drop_imports)]
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef):
            cls.body = [n for n in cls.body
                        if not (isinstance(n, ast.FunctionDef) and f"{cls.name}.{n.name}" in skip)]
    if without_device:
        tree = _WithoutDevice().visit(tree)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if deferred and isinstance(body, list):
            node.body = body = [n for n in body
                                if not (isinstance(n, ast.ImportFrom) and n.module in deferred)]
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


# The one statement of a copy that is not the original's, made in the
# original's text: the port's stores run on its own chunk engine, not on
# tensorstore.
COPY_REPLACE = {"io/ngff.py": (("import tensorstore as ts",
                                "from shrimpy_tpu_torch.io import chunkstore as ts"),)}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_original_statement_for_statement(rel):
    assert _code(REPO / "shrimpy_tpu_torch" / rel) == _code(REPO / "shrimpy_tpu" / rel,
                                                            replace=COPY_REPLACE.get(rel, ()))


def test_ngff_differs_from_the_original_in_its_engine_alone():
    """``io/ngff.py`` is JAX's but for the import of its array engine; the
    replacement is needed (the two differ without it) and names the port's
    engine, which the module then uses under tensorstore's name."""
    ours, theirs = REPO / "shrimpy_tpu_torch/io/ngff.py", REPO / "shrimpy_tpu/io/ngff.py"
    assert _code(ours) != _code(theirs)
    assert _code(ours) == _code(theirs, replace=COPY_REPLACE["io/ngff.py"])
    from shrimpy_tpu_torch.io import chunkstore
    assert tngff.ts is chunkstore


# engine/engine.py's module-level imports of JAX's that the port defers to
# their use, and the one method that differs past ``device``
# (tests/test_torch_acquire.py tests each difference on its own).
ENGINE_DEFERRED = ("shrimpy_tpu.config.schemas", "shrimpy_tpu.engine.plan",
                   "shrimpy_tpu.engine.replay", "shrimpy_tpu.io")
ENGINE_SKIP = ("AcquisitionEngine._setup_tracking",)


def test_engine_is_the_original_but_for_its_four_differences():
    """``engine/engine.py`` is JAX's statement for statement once the deferred
    imports, ``device`` and ``_setup_tracking`` (the namespace config) are
    left out; the port's module level imports none of the deferred modules,
    and each difference is there."""
    rel = "engine/engine.py"
    ours, theirs = REPO / "shrimpy_tpu_torch" / rel, REPO / "shrimpy_tpu" / rel
    kw = {"skip": ENGINE_SKIP, "deferred": ENGINE_DEFERRED}
    assert _code(ours, without_device=True, **kw) == _code(theirs, without_device=True, **kw)
    assert _code(ours, **kw) != _code(theirs, **kw)  # device
    assert _code(ours, without_device=True, deferred=ENGINE_DEFERRED) != _code(
        theirs, without_device=True, deferred=ENGINE_DEFERRED)  # _setup_tracking
    top = [n.module for n in ast.parse(ours.read_text()).body if isinstance(n, ast.ImportFrom)]
    assert not {m.replace("shrimpy_tpu_torch", "shrimpy_tpu") for m in top} & set(
        ENGINE_DEFERRED), top
    assert {m for m in (n.module for n in ast.parse(theirs.read_text()).body
                        if isinstance(n, ast.ImportFrom))} & set(ENGINE_DEFERRED) == set(
        ENGINE_DEFERRED)


def test_dual_is_the_original_but_for_device():
    rel = "engine/dual.py"
    ours, theirs = REPO / "shrimpy_tpu_torch" / rel, REPO / "shrimpy_tpu" / rel
    assert _code(ours, without_device=True) == _code(theirs, without_device=True)
    assert _code(ours) != _code(theirs)
    text = ours.read_text()
    assert "device=self.device" in text and "self.device = device" in text


def test_logging_copy_is_the_original_but_for_its_provenance(tmp_path):
    """``utils/logging.py`` is the original statement for statement but for
    the two provenance functions, which record torch where the original
    records jax (the port imports no jax); the CLI configures it."""
    skip = ("environment_provenance", "log_environment")
    rel = "utils/logging.py"
    assert _code(REPO / "shrimpy_tpu_torch" / rel, skip) == _code(REPO / "shrimpy_tpu" / rel, skip)
    assert _code(REPO / "shrimpy_tpu_torch" / rel) != _code(REPO / "shrimpy_tpu" / rel)
    env = tlogging.environment_provenance()
    assert env["torch"] == torch.__version__ and "jax" not in env and "jaxlib" not in env
    logger = logging.getLogger("shrimpy_tpu_torch")
    try:
        for _ in range(2):  # repeated calls replace the console handler
            log_file = tlogging.configure_logging(logging.INFO, log_dir=tmp_path,
                                                  acquisition_name="acq")
        assert sum(type(h) is logging.StreamHandler for h in logger.handlers) == 1
        logging.getLogger("shrimpy_tpu_torch.ops.deconv").debug("to the file")
        tlogging.release_log_file(log_file)
        assert log_file.parent == tmp_path / "logs" and "to the file" in log_file.read_text()
        assert CliRunner().invoke(cli, ["-v", "reconstruct", "--help"]).exit_code == 0
        assert [h.level for h in logger.handlers] == [logging.DEBUG]
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def test_corrected_comments_are_in_the_copy_only():
    ours = (REPO / "shrimpy_tpu_torch/config/schemas.py").read_text()
    theirs = (REPO / "shrimpy_tpu/config/schemas.py").read_text()
    assert '"auto" picks linear_pallas on TPU' in theirs
    assert "picks linear_pallas" not in ours and '"auto" picks "fused"' in ours
    assert "netting ~1.0x today" in theirs and "netting" not in ours


def _schema(model) -> dict:
    """A model's JSON schema with the one docstring sentence the copy
    words differently (which benchmark ``iterations=20`` matches) made
    the same."""
    text = json.dumps(model.model_json_schema())
    return json.loads(re.sub(r"matches the \w+ benchmark config", "matches the benchmark config",
                             text))


@pytest.mark.parametrize("name", MODELS)
def test_models_agree_field_for_field(name):
    ours, theirs = getattr(tschemas, name), getattr(jschemas, name)
    assert ours is not theirs and ours.__module__ == "shrimpy_tpu_torch.config.schemas"
    assert list(ours.model_fields) == list(theirs.model_fields)
    for field, info in theirs.model_fields.items():
        mine = ours.model_fields[field]
        assert repr(mine.annotation).replace("shrimpy_tpu_torch", "shrimpy_tpu") == repr(
            info.annotation), field
        assert mine.is_required() == info.is_required(), field
        if not info.is_required():
            a, b = mine.get_default(call_default_factory=True), info.get_default(
                call_default_factory=True)
            a, b = (v.model_dump() if isinstance(v, BaseModel) else v for v in (a, b))
            assert a == b, field
    assert _schema(ours) == _schema(theirs)
    assert ours.model_config == theirs.model_config


def test_lazy_names_of_the_config_package():
    for name in tconfig._SCHEMA_NAMES:
        assert getattr(tconfig, name) is getattr(tschemas, name)
    with pytest.raises(AttributeError, match="no attribute"):
        tconfig.NoSuchSettings
    # Importing the package (what the compute path does) loads neither
    # pydantic nor yaml, nor the schemas.
    code = ("import sys, shrimpy_tpu_torch.config as c; c.deskew_settings(); "
            "bad = [m for m in ('pydantic', 'yaml', 'shrimpy_tpu_torch.config.schemas') "
            "if m in sys.modules]; assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(REPO)}, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("yml,model", [
    ("configs/reconstruct_demo.yml", "ReconstructSettings"),
    ("configs/dynatrack_demo.yml", "DynaTrackConfig"),
])
def test_yaml_loads_to_equal_dumps(yml, model):
    path = REPO / yml
    ours = tschemas.load_yaml_config(path, getattr(tschemas, model))
    theirs = jschemas.load_yaml_config(path, getattr(jschemas, model))
    assert type(ours).__module__ != type(theirs).__module__
    assert ours.model_dump() == theirs.model_dump()
    assert ours.model_dump_json() == theirs.model_dump_json()


@pytest.mark.parametrize("kw", [
    {"pixel_size_um": 0.116, "z_step_um": 0.3},
    {"pixel_size_um": 0.2, "z_step_um": 0.5},
])
def test_inject_derived_parameters_agree(kw):
    def build(mod):
        s = mod.ReconstructSettings(deskew=mod.DeskewSettings(),
                                    phase=mod.PhaseSettings(),
                                    deconvolve=mod.DeconvolveSettings(iterations=3))
        mod.inject_derived_parameters(s, **kw)
        return s

    ours, theirs = build(tschemas), build(jschemas)
    assert ours.model_dump() == theirs.model_dump()
    assert ours.deskew.px_to_scan_ratio == pytest.approx(kw["pixel_size_um"] / kw["z_step_um"],
                                                         abs=1e-3)
    # A settings object of the JAX package, passed in by a caller, is read
    # by attribute all the same.
    tschemas.inject_derived_parameters(theirs, **kw)
    assert theirs.model_dump() == ours.model_dump()


@pytest.mark.parametrize("model,bad", [
    ("DeskewSettings", {"angle": 30}),
    ("DeskewSettings", {"ls_angle_deg": 95.0}),
    ("DeskewSettings", {"average_n_slices": 0}),
    ("DeconvolveSettings", {"iterations": 0}),
    ("DeconvolveSettings", {"separable_backend": "fused_twice"}),
    ("DeconvolveSettings", {"fused_low_precision_iters": -1}),
    ("ReconstructSettings", {"output_dtype": "int8"}),
    ("PhaseTransferFunctionSettings", {"numerical_aperture_detection": 1.6}),
])
def test_validators_reject_alike(model, bad):
    for mod in (tschemas, jschemas):
        with pytest.raises(ValidationError):
            getattr(mod, model)(**bad)


def test_reconstruct_arms_and_sidecar_agree():
    arms = {"arms": {"a": {"deskew": {"ls_angle_deg": 30.0}},
                     "b": {"deconvolve": {"iterations": 5, "acceleration": "biggs"}}}}
    assert tschemas.ReconstructArms(**arms).model_dump() == jschemas.ReconstructArms(
        **arms).model_dump()
    assert tsidecar.CKPT_SIDECAR == jsidecar.CKPT_SIDECAR
    assert tsidecar.DEFAULT_OUT_CHANNELS == jsidecar.DEFAULT_OUT_CHANNELS
    assert tsidecar.read_vs_sidecar("/nonexistent") is None


@pytest.mark.parametrize("name", ["mantis", "isim", "nikon"])
def test_get_microscope_agrees(name):
    assert tmicro.available_microscopes() == jmicro.available_microscopes()
    if name not in jmicro.available_microscopes():
        for mod in (tmicro, jmicro):
            with pytest.raises(KeyError, match=name):
                mod.get_microscope(name)
        return
    assert tmicro.get_microscope(name).model_dump() == jmicro.get_microscope(name).model_dump()


@pytest.mark.parametrize("writer,reader", [(tngff, jngff), (jngff, tngff)],
                         ids=["port-writes", "jax-writes"])
@pytest.mark.parametrize("version", ["0.4", "0.5"])
def test_fov_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader, version):
    rng = np.random.default_rng(3)
    data = (rng.random((2, 2, 5, 12, 10)) * 1000).astype(np.float32)
    pos = writer.create_fov(tmp_path / "f.zarr", shape=data.shape, dtype="float32",
                            channel_names=["a", "b"], zyx_scale=(0.5, 0.11, 0.12),
                            version=version)
    for t in range(2):
        for c in range(2):
            pos.write((t, c), data[t, c])
    store = reader.open_ngff(tmp_path / "f.zarr")
    got = store.position()
    assert not store.is_plate and store.version == version
    assert tuple(got.shape) == data.shape and got.channel_names == ["a", "b"]
    np.testing.assert_allclose(got.zyx_scale, (0.5, 0.11, 0.12), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(got.volume(1, 0)), data[1, 0])
    np.testing.assert_array_equal(np.asarray(got.read_async((0, 1)).result()), data[0, 1])


@pytest.mark.parametrize("writer,reader", [(tsynth, jngff), (jsynth, tngff)],
                         ids=["port-writes", "jax-writes"])
def test_plate_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    writer.coordinate_encoded_plate(tmp_path / "p.zarr", shape_tczyx=(2, 2, 3, 8, 8))
    store = reader.open_ngff(tmp_path / "p.zarr")
    assert store.is_plate
    keys = sorted(store.positions())
    assert keys == sorted(tngff.open_ngff(tmp_path / "p.zarr").positions())
    for p, key in enumerate(keys):
        pos = store.positions()[key]
        assert np.asarray(pos.volume(1, 1))[2, 0, 0] == tsynth.coordinate_encoded_value(p, 1, 1, 2)
    assert tsynth.coordinate_encoded_value(1, 1, 1, 3) == jsynth.coordinate_encoded_value(1, 1, 1, 3)


def test_synthetic_fixtures_equal_originals(tmp_path):
    raw_t, beads_t = tsynth.synthetic_ls_stack(tmp_path / "t.zarr", raw_shape_szx=(40, 24, 32))
    raw_j, beads_j = jsynth.synthetic_ls_stack(tmp_path / "j.zarr", raw_shape_szx=(40, 24, 32))
    np.testing.assert_array_equal(raw_t, raw_j)
    np.testing.assert_array_equal(np.asarray(beads_t), np.asarray(beads_j))
    a, b = jngff.open_ngff(tmp_path / "t.zarr").position(), tngff.open_ngff(
        tmp_path / "j.zarr").position()
    np.testing.assert_array_equal(np.asarray(a.volume(0, 0)), np.asarray(b.volume(0, 0)))
    np.testing.assert_allclose(a.zyx_scale, b.zyx_scale, rtol=1e-12)
    args = ((6, 20, 22), (3.0, 10.0, 11.0), (1.5, 3.0, 4.0))
    np.testing.assert_array_equal(tsynth.gaussian_blob(*args, amplitude=7.0),
                                  jsynth.gaussian_blob(*args, amplitude=7.0))
    # The pyramid writer of the copy, read through the original.
    pos = tngff.open_ngff(tmp_path / "t.zarr").position()
    tngff.add_pyramid_levels(pos, 1)
    levels = jngff.open_ngff(tmp_path / "t.zarr").position().attrs["multiscales"][0]["datasets"]
    assert len(levels) == 2


def test_atomic_write_text_publishes_whole_files(tmp_path):
    target = tmp_path / "state.json"
    atomic_write_text(target, "one")
    atomic_write_text(target, "two")
    assert target.read_text() == "two"
    assert [p.name for p in tmp_path.iterdir()] == ["state.json"]


def test_cli_reconstruct_fused_iter_donate_on_cpu(tmp_path):
    """A YAML that sets ``separable_backend: fused_iter`` and
    ``donate_input: true`` runs through ``shrimpy-tpu-torch reconstruct
    --device cpu`` on a store the port's own fixture wrote; the output,
    read back through the JAX package's store code, equals the port's
    reconstruct_batch and its ``fused`` run."""
    raw, _ = tsynth.synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(40, 24, 32))
    cfg = tmp_path / "fused_iter.yml"
    cfg.write_text(textwrap.dedent("""
        deskew:
          ls_angle_deg: 30.0
        deconvolve:
          iterations: 3
          separable_backend: fused_iter
          donate_input: true
    """))
    out = tmp_path / "out.zarr"
    result = CliRunner().invoke(cli, ["reconstruct", str(tmp_path / "ls.zarr"), "-o", str(out),
                                      "-c", str(cfg), "--device", "cpu"])
    assert result.exit_code == 0, result.output
    got = np.asarray(jngff.open_ngff(out).position().volume(0, 0))
    settings = tschemas.load_yaml_config(cfg, tschemas.ReconstructSettings)
    sz, sy, _ = tngff.open_ngff(tmp_path / "ls.zarr").position().zyx_scale
    tschemas.inject_derived_parameters(settings, pixel_size_um=sy, z_step_um=sz)
    assert settings.deconvolve.separable_backend == "fused_iter"
    psf = tstream._load_psf(settings)
    want = reconstruct_batch(raw[None], settings, psf=psf, device="cpu")[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    settings.deconvolve.separable_backend = "fused"
    fused = reconstruct_batch(raw[None], settings, psf=psf, device="cpu")[0].numpy()
    assert np.abs(got - fused).max() <= 1e-5 * np.abs(fused).max()


@pytest.mark.parametrize("layout", ["fov", "plate", None])
def test_info_and_microscopes_verbs_print_jax_s_json(tmp_path, layout):
    """``info`` on a single-FOV store and on a plate, and ``microscopes``:
    the port's CLI prints the JAX CLI's JSON."""
    from shrimpy_tpu.cli.main import cli as jax_cli

    if layout == "fov":
        jsynth.synthetic_ls_stack(tmp_path / "s.zarr", raw_shape_szx=(20, 12, 16))
        args = ["info", str(tmp_path / "s.zarr")]
    elif layout == "plate":
        jsynth.coordinate_encoded_plate(tmp_path / "s.zarr", shape_tczyx=(2, 3, 4, 8, 8))
        args = ["info", str(tmp_path / "s.zarr")]
    else:
        args = ["microscopes"]
    runner = CliRunner()
    want, got = runner.invoke(jax_cli, args), runner.invoke(cli, args)
    assert want.exit_code == 0, want.output
    assert got.exit_code == 0, got.output
    assert json.loads(got.output) == json.loads(want.output)
    if layout == "plate":
        assert json.loads(got.output)["layout"] == "hcs-plate"

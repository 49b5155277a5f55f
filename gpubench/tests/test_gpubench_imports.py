"""No run loads JAX or the JAX package; the reference's files import
nothing of the program."""

import ast
import subprocess
import sys

import pytest

from gpubench import cell, spec


@pytest.mark.parametrize("names, bad", [
    (["shrimpy_tpu_torch", "shrimpy_tpu_torch.ops.deconv", "torch"], []),
    (["shrimpy_tpu.ops", "numpy"], ["shrimpy_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen", "jaxtyping"], ["flax", "jax", "jaxlib"]),
])
def test_names_compare_whole(names, bad):
    assert cell.forbidden_modules(names) == bad


def test_harness_and_reference_load_no_jax():
    code = ("import runpy, sys; sys.argv = ['run.py', '--help']\n"
            "try:\n    runpy.run_path('gpubench/run.py', run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "import gpubench.reference, gpubench.cell, gpubench.inputs\n"
            "from gpubench import cell; cell.port_step; print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.HERE.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_program_step_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from gpubench import cell, spec, inputs\n"
            "c = spec.load_named('configs', 'mantis-ls-sep')\n"
            "cell.port_step(c, inputs.make_psf(c['psf']), 'cpu')\n"
            "print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.HERE.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["reference.py", "geometry.py", "inputs.py"])
def test_reference_files_import_nothing_of_the_program(name):
    tree = ast.parse((spec.HERE / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"__future__", "hashlib", "math", "numpy", "torch", "gpubench"}, roots

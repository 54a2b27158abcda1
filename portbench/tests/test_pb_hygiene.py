"""Nothing under portbench/ imports JAX or the JAX package, the reference
imports nothing of the port, and the run's check of loaded modules
compares whole top-level names."""

import ast
import pathlib

import pytest

from portbench import run

HERE = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not _imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert "ray_tpu_torch" not in _imports(path)
    # nor by a module name handed to importlib
    assert not [n.value for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value.split(".")[0] == "ray_tpu_torch"]


def test_forbidden_modules_by_whole_top_level_name():
    assert run.forbidden_modules(["ray_tpu_torch", "ray_tpu_torch.serve",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["ray_tpu.serve", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "ray_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole run's modules, in a fresh process: the tiny training cell
    on the CPU imports neither JAX nor the JAX package."""
    import subprocess
    import sys
    code = ("import sys, torch; torch.set_num_threads(2);"
            "from portbench.tests import tiny; from portbench import run;"
            "r = run.Run(tiny.cell('mistral7b.train.s4096'), 3, 0.5, False,"
            " 'cpu'); run.execute(r); print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

"""What a run and the plain reference load: never ``jax``, ``jaxlib``,
``flax`` or the JAX package ``wisecondorx_tpu`` (top-level names compared
whole: the port's own name begins with the JAX package's), and the
reference nothing of the port either."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
JAX_SIDE = {"jax", "jaxlib", "flax", "wisecondorx_tpu"}


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        if os.sep + "tests" in dirpath[len(HERE):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_source_imports_the_jax_side(path):
    assert not set(_top_imports(path)) & JAX_SIDE


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_the_reference_imports_nothing_of_the_port(path):
    assert "wisecondorx_tpu_torch" not in set(_top_imports(path))


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_reference_loads_neither_the_port_nor_jax():
    mods = _loaded("import wcxbench.reference.predict, wcxbench.reference.compare,"
                   " wcxbench.reference.newref, wcxbench.reference.cbs")
    assert not mods & (JAX_SIDE | {"wisecondorx_tpu_torch"})


def test_a_run_of_every_stage_loads_no_jax():
    mods = _loaded("import wcxbench.run, wcxbench.control\n"
                   "import wcxbench.stages.predict, wcxbench.stages.predict_batch,"
                   " wcxbench.stages.newref\n"
                   "import wisecondorx_tpu_torch.cli\n"
                   "from wisecondorx_tpu_torch.models import reference, predictor, ref_loader\n"
                   "from wisecondorx_tpu_torch.parallel import batch")
    assert "wisecondorx_tpu_torch" in mods
    assert not mods & JAX_SIDE


def test_the_runner_refuses_a_run_that_holds_jax(monkeypatch):
    from wcxbench import run

    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib")
    monkeypatch.setitem(sys.modules, "wisecondorx_tpu.ops", object())
    assert run.forbidden_modules() == ["wisecondorx_tpu"]

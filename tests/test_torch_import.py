"""The PyTorch port imports with jax, scikit-learn, matplotlib, PIL and the
JAX package itself absent (the machine with the GPU has none of the first
four, and the port keeps its own copies of the host modules it needs and
draws its figures itself).

* a subprocess imports every module of the port with those packages
  blocked (tests/conftest.py has already imported jax into this process);
* an AST scan finds no ``import`` of ``wisecondorx_tpu``, ``matplotlib``
  or ``PIL`` anywhere in the port or in chip_smoke.py, including imports
  inside functions, which the subprocess only reaches when they run.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

PORT_MODULES = [
    "wisecondorx_tpu_torch",
    "wisecondorx_tpu_torch.device",
    "wisecondorx_tpu_torch.cli",
    "wisecondorx_tpu_torch.errors",
    "wisecondorx_tpu_torch.genome",
    "wisecondorx_tpu_torch.ref_qc",
    "wisecondorx_tpu_torch.io",
    "wisecondorx_tpu_torch.io.npz",
    "wisecondorx_tpu_torch.io.bam",
    "wisecondorx_tpu_torch.output",
    "wisecondorx_tpu_torch.output.tables",
    "wisecondorx_tpu_torch.output._glyphs",
    "wisecondorx_tpu_torch.output.layout",
    "wisecondorx_tpu_torch.output.plots",
    "wisecondorx_tpu_torch.output.png",
    "wisecondorx_tpu_torch.output.raster",
    "wisecondorx_tpu_torch.output.text",
    "wisecondorx_tpu_torch.ops._build",
    "wisecondorx_tpu_torch.ops.common",
    "wisecondorx_tpu_torch.ops.knn",
    "wisecondorx_tpu_torch.ops.knn_cuda",
    "wisecondorx_tpu_torch.ops.mask",
    "wisecondorx_tpu_torch.ops.stats",
    "wisecondorx_tpu_torch.ops.pca",
    "wisecondorx_tpu_torch.ops.gmm",
    "wisecondorx_tpu_torch.ops.normalize",
    "wisecondorx_tpu_torch.ops.cbs",
    "wisecondorx_tpu_torch.models.reference",
    "wisecondorx_tpu_torch.models.ref_loader",
    "wisecondorx_tpu_torch.models.predictor",
    "wisecondorx_tpu_torch.parallel",
    "wisecondorx_tpu_torch.parallel.batch",
    "wisecondorx_tpu_torch.parallel.multihost",
    "wisecondorx_tpu_torch.parallel.sharded_knn",
    "wisecondorx_tpu_torch.utils.checkpoint",
    "wisecondorx_tpu_torch.utils.log",
    "wisecondorx_tpu_torch.utils.threads",
    "wisecondorx_tpu_torch.utils.warmup",
]

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "sklearn", "matplotlib", "PIL", "wisecondorx_tpu")
#: Top-level packages no port file may import.
FORBIDDEN = ("wisecondorx_tpu", "matplotlib", "PIL")


def test_port_imports_without_jax_sklearn_matplotlib():
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from wisecondorx_tpu_torch.cli import build_parser\n"
        "build_parser()\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_modules(tree):
    """Every module name an import statement (at any depth) or a literal
    ``importlib.import_module`` / ``__import__`` call of ``tree`` names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "wisecondorx_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_the_jax_package(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_scan_sees_nested_imports():
    tree = ast.parse(
        "def f():\n"
        "    from wisecondorx_tpu.io import npz\n"
        "    import wisecondorx_tpu.genome as g\n"
        "    importlib.import_module('wisecondorx_tpu.ref_qc')\n"
        "from wisecondorx_tpu_torch import genome\n"
        "import matplotlib.pyplot as plt\n"
        "from PIL import Image\n"
    )
    assert sorted(_imported_modules(tree)) == [
        "PIL", "matplotlib.pyplot", "wisecondorx_tpu.genome",
        "wisecondorx_tpu.io", "wisecondorx_tpu.ref_qc", "wisecondorx_tpu_torch",
    ]
    assert [m for m in sorted(_imported_modules(tree))
            if m.split(".")[0] in FORBIDDEN] == [
        "PIL", "matplotlib.pyplot", "wisecondorx_tpu.genome",
        "wisecondorx_tpu.io", "wisecondorx_tpu.ref_qc"]

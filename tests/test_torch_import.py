"""The PyTorch port imports with jax, scikit-learn and matplotlib absent
(the machine with the GPU has none of them).  Runs in a subprocess:
tests/conftest.py has already imported jax into this one."""

import os
import subprocess
import sys

PORT_MODULES = [
    "wisecondorx_tpu_torch",
    "wisecondorx_tpu_torch.device",
    "wisecondorx_tpu_torch.cli",
    "wisecondorx_tpu_torch.ops._build",
    "wisecondorx_tpu_torch.ops.common",
    "wisecondorx_tpu_torch.ops.knn",
    "wisecondorx_tpu_torch.ops.knn_cuda",
    "wisecondorx_tpu_torch.ops.pca",
    "wisecondorx_tpu_torch.ops.gmm",
    "wisecondorx_tpu_torch.ops.normalize",
    "wisecondorx_tpu_torch.ops.cbs",
    "wisecondorx_tpu_torch.models.reference",
    "wisecondorx_tpu_torch.models.ref_loader",
    "wisecondorx_tpu_torch.models.predictor",
    "wisecondorx_tpu_torch.parallel",
    "wisecondorx_tpu_torch.parallel.batch",
    "wisecondorx_tpu_torch.utils.log",
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax_sklearn_matplotlib():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'sklearn', 'matplotlib'):\n"
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

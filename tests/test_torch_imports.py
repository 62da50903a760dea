"""The port imports nothing of JAX and nothing of the JAX package: an AST
scan of every module of ``src/repro_torch`` and of ``chip_smoke.py``, and
an import of the serving entry point with ``jax`` and ``repro`` blocked."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.JoinedStr | ast.Constant)):
            text = ast.unparse(node.args[0]).strip("f'\"")
            roots.add(text.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_serve_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.models.convert\n"
            "import repro_torch.kernels.mma_gemm\n"
            "import repro_torch.kernels.mma_attention\n"
            "import repro_torch.kernels.mma_conv\n"
            "import repro_torch.models.mamba2\n"
            "import repro_torch.models.moe\n"
            "import repro_torch.data.pipeline\n"
            "import repro_torch.core.quant\n"
            "import repro_torch.core.packing\n"
            "import repro_torch.kernels.blas3\n"
            "import repro_torch.kernels.ops\n"
            "import repro_torch.runtime.elastic\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.launch.mesh\n"
            "import repro_torch.parallel.api\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

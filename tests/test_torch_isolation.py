"""The port stands alone: no module of savont_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package savont_tpu (read from each
file's syntax tree), and none reaches into savont_tpu at run time
(rebinding its functions, or steering it through SAVONT_ALIGN_BACKEND).
test_torch_routes.test_port_imports_no_jax checks the same in a live
process."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "savont_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "savont_tpu"}


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"chip_smoke.py", "savont_tpu_torch/cli.py", "savont_tpu_torch/ops/align_batch.py",
            "savont_tpu_torch/pipeline/asv.py", "savont_tpu_torch/probes/roofline.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_imports_neither_jax_nor_savont_tpu(path):
    text = path.read_text()
    assert not _imported_roots(ast.parse(text)) & FORBIDDEN
    for word in ("device_routes", "SAVONT_ALIGN_BACKEND"):
        assert word not in text

"""The port stands alone: no file of ``src/repro_torch/``, not
``chip_smoke.py`` and not the port's examples (``examples/*_torch.py``)
imports ``jax``, ``jaxlib``, ``ml_dtypes`` or anything of the JAX package
``repro`` (the port keeps its own copies of what it needs).  Only the
tests import both."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/runtime/serve.py" in names
    assert "src/repro_torch/kernels/paged_attention/kernel.py" in names
    assert {"examples/quickstart_torch.py",
            "examples/train_minicpm_torch.py",
            "examples/serve_fenghuang_torch.py",
            "examples/paper_figures_torch.py"} <= names
    assert {f"src/repro_torch/core/{m}.py" for m in (
        "__init__", "hw", "latency", "analysis", "graphs", "simulator")
    } <= names
    assert len(names) > 15
    # tensor-parallel serving: the mesh, the transports, the TAB, sharding
    assert {"src/repro_torch/launch/__init__.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/runtime/transport.py",
            "src/repro_torch/runtime/sharding.py",
            "src/repro_torch/core/tab.py"} <= names


def test_chip_smoke_rank_entry_point_is_scanned():
    """The tp phase's ranks run ``chip_smoke.tp_rank`` (started by
    ``repro_torch.launch.mesh.spawn``): a function of ``chip_smoke.py``
    itself, so the scan above covers what the ranks import."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"tp_rank", "check_tp"} <= names
    assert ROOT / "chip_smoke.py" in FILES


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scanner_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.models import base\n"
                     "import importlib\nimportlib.import_module('jaxlib')\n"
                     "import repro_torch\nimport ml_dtypes\n")
    assert _imported_roots(probe) & FORBIDDEN == {"jax", "repro", "jaxlib",
                                                  "ml_dtypes"}

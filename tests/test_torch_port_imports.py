"""The port stands alone: no file of diffsep_tpu_torch/, chip_smoke.py nor
the port's scripts (scripts/torch_port_*.py) imports jax, flax or the JAX
package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "diffsep_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "scripts").glob("torch_port_*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "diffsep_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_package():
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py").exists()
    assert {p.name for p in FILES} >= {"torch_port_profile.py", "torch_port_conv_plans.py",
                                       "torch_port_fir_plans.py", "train.py", "loop.py"}

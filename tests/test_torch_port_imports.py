"""The port stands alone: no file of diffsep_tpu_torch/, chip_smoke.py, the
port's scripts (scripts/torch_port_*.py) nor the worker scripts that the
port's tests spawn (tests/_torch_port_*_worker.py) imports jax, flax or the
JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "diffsep_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "scripts").glob("torch_port_*.py")) + sorted((ROOT / "tests").glob("_torch_port_*_worker.py"))
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
                                       "torch_port_fir_plans.py", "train.py", "loop.py", "serve.py",
                                       "serve_http.py", "loading.py", "eval_common.py", "streaming.py",
                                       "separate.py", "pc.py", "predictors.py", "correctors.py",
                                       "evaluate.py", "ouve.py", "mixsde.py", "vctk_demand.py",
                                       "pesq_native.py", "metrics.py", "datamodule.py", "synthetic.py",
                                       "distill.py", "export.py", "export_model.py", "cdiffuse.py",
                                       "score_model_diffuse.py", "tcn.py", "dptnet.py", "model_utils.py",
                                       "legacy_layers.py", "normalization.py", "score_utils.py", "fused_act.py",
                                       "native_io.py", "figures.py", "registry.py", "import_module.py",
                                       "split_dir.py", "stats.py", "linalg.py", "params.py", "bn_update.py",
                                       "torch_port_train_demo.py", "torch_port_distill_demo.py"}
    names = [str(p.relative_to(ROOT)) for p in FILES]
    assert {"diffsep_tpu_torch/train/distill.py", "diffsep_tpu_torch/cli/distill.py",
            "diffsep_tpu_torch/cli/evaluate_mp.py", "diffsep_tpu_torch/parallel/mesh.py",
            "diffsep_tpu_torch/parallel/shard_eval.py", "diffsep_tpu_torch/utils/distributed.py"} <= set(names)

"""The port's console entry points (``pyproject.toml [project.scripts]``):
every ``diffsep-torch-*`` name targets a module of ``diffsep_tpu_torch.cli``
that imports and has a callable ``main``; one name per port CLI, beside the
JAX package's names, which are unchanged."""
import importlib
import tomllib
from pathlib import Path

import pytest

SCRIPTS = tomllib.loads((Path(__file__).resolve().parents[1] / "pyproject.toml").read_text())["project"]["scripts"]
PORT = {k: v for k, v in SCRIPTS.items() if k.startswith("diffsep-torch-")}
CLIS = ["train", "separate", "serve", "evaluate", "evaluate_mp", "evaluate_covl", "merge_dnsmos", "distill",
        "export_model", "figures"]


@pytest.mark.parametrize("name", sorted(PORT))
def test_entry_point_imports_and_has_main(name):
    module, _, attr = PORT[name].partition(":")
    assert module.startswith("diffsep_tpu_torch.cli.") and attr == "main"
    assert callable(getattr(importlib.import_module(module), attr))


def test_every_port_cli_has_a_name_and_the_jax_names_stay():
    assert sorted(v.partition(":")[0].rsplit(".", 1)[1] for v in PORT.values()) == sorted(CLIS)
    jax = {k: v for k, v in SCRIPTS.items() if not k.startswith("diffsep-torch-")}
    assert all(v.startswith("diffsep_tpu.cli.") for v in jax.values()) and len(jax) == 9

"""The CLI flag helpers of diffsep_tpu_torch/cli/eval_common.py against
diffsep_tpu/cli/eval_common.py: the same answers, the same errors."""
import argparse

import pytest

from diffsep_tpu.cli import eval_common as jax_ec
from diffsep_tpu_torch.cli import eval_common as ec


@pytest.mark.parametrize("value", ["1", "true", "T", "Yes", "y", "0", "False", "f", "NO", "n", True, False])
def test_str2bool_matches(value):
    assert ec.str2bool(value) is jax_ec.str2bool(value)


def test_str2bool_rejects_what_the_jax_package_rejects():
    for f in (ec.str2bool, jax_ec.str2bool):
        with pytest.raises(ValueError, match="expected a boolean"):
            f("maybe")


@pytest.mark.parametrize("attrs", [
    {},
    {"N": 6, "snr": None, "corrector_steps": None, "predictor": "ddim", "corrector": None},
    {"N": None, "schedule": "log", "denoise": False, "seed": 3, "batch": 4},
], ids=["none", "serve-like", "separate-like"])
def test_sampler_flag_map_and_reject_baked_flags_match(attrs):
    args = argparse.Namespace(**attrs)
    got, want = ec.sampler_flag_map(args), jax_ec.sampler_flag_map(args)
    assert got == want
    errors = []
    for f in (ec.reject_baked_flags, jax_ec.reject_baked_flags):
        try:
            f(got, "the sampler is baked into the artifact")
            errors.append(None)
        except SystemExit as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == all(v is None for v in got.values())

"""Training through the NCSN++ options, on the CPU in float32: parameter
gradients against jax.grad (option set C of chip_smoke.py, and remat),
remat against no remat in the port, and the entry points (cli.train, then
cli.separate on its run dir) with set C's overrides.

Tolerances: parameter gradients within 1e-4 of the gradient norm, as
tests/test_torch_port_losses.py holds them; remat equal to no remat within
1e-6 of the norm (the same operations run again).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.models import NCSNpp as JaxNCSNpp
from diffsep_tpu_torch.cli import separate as separate_cli
from diffsep_tpu_torch.cli import train as train_cli
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.models import NCSNpp, state_dict_from_jax
from test_torch_port_ncsnpp_options import SET_C, SMALL, fill

GRADS = {"C": SET_C, "remat": dict(remat=True)}


def _grads(model, x, t, cot):
    model.zero_grad(set_to_none=True)
    (model(x, t) * cot).sum().backward()
    return {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in model.named_parameters()}


def _rel(got, want):
    norm = torch.sqrt(sum((w.double() ** 2).sum() for w in want.values())).item()
    return max((got[k] - want[k]).abs().max().item() for k in want) / norm


@pytest.mark.parametrize("name", sorted(GRADS))
def test_parameter_gradients_match_jax(name, rng):
    overrides = GRADS[name]
    jm = JaxNCSNpp(**{**SMALL, **overrides})
    x = rng.uniform(-1, 1, (2, 32, 16, 6)).astype(np.float32)
    t = np.asarray([0.4, 0.9], np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    params = fill(shapes, rng)
    cot = rng.standard_normal((2, 32, 16, 4)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t)) * cot)

    want = jax.jit(jax.grad(loss))(params)
    want = {k[len("backbone."):]: v for k, v in state_dict_from_jax({"backbone": want}).items()}
    port = NCSNpp(**{**SMALL, **overrides})
    port.load_state_dict({k[len("backbone."):]: v for k, v in state_dict_from_jax({"backbone": params}).items()})
    got = _grads(port, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cot))
    assert got.keys() == want.keys()
    assert _rel(got, want) <= 1e-4
    if overrides.get("remat"):
        # the same gradients without the recomputation
        port.remat = False
        assert _rel(got, _grads(port, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cot))) <= 1e-6


SET_C_OVERRIDES = [
    "model.score_model.backbone_args.resblock_type=ddpm", "model.score_model.backbone_args.progressive=residual",
    "model.score_model.backbone_args.progressive_input=input_skip",
    "model.score_model.backbone_args.progressive_combine=cat", "model.score_model.backbone_args.centered=true",
    "model.score_model.transform=none", "model.score_model.stft_args.center=false",
]
TINY = [
    "trainer.accelerator=cpu", "model.score_model.backbone_args.nf=8",
    "model.score_model.backbone_args.ch_mult=[1,2,2]", "model.score_model.backbone_args.num_res_blocks=1",
    "model.score_model.backbone_args.attn_resolutions=[16]", "model.score_model.backbone_args.image_size=64",
    "model.score_model.backbone_args.dtype=float32",
    "model.score_model.stft_args.n_fft=126", "model.score_model.stft_args.hop_length=32",
    "model.sampler.N=2", "model.sde.N=2", "model.valid_max_sep_batches=1",
    "datamodule.train.dl_opts.batch_size=2", "datamodule.val.dl_opts.batch_size=2",
]


def test_set_c_trains_and_separates_through_the_entry_points(tmp_path):
    """cli.train with set C's overrides takes 2 micro-steps, validates and
    checkpoints; cli.separate then separates a folder with its run dir, the
    options read back from its hparams."""
    data = write_wsj0_mix(tmp_path / "wsj0_mix", {"train": 4, "val": 2}, seconds=0.5, seed=0)
    state = train_cli.main(["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}",
                            f"path.exp_root={tmp_path / 'exp'}", "trainer.max_steps=2", *TINY, *SET_C_OVERRIDES])
    assert state.step == 2
    (run,) = [p for p in (tmp_path / "exp" / "default").iterdir() if p.is_dir()]
    rows = [json.loads(line) for line in (run / "train_log.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["train/score_loss"]) for r in rows if "step" in r)
    assert any(".Conv2d_0.weight" in n for n in state.names) and any(".NIN_0.W" in n for n in state.names)

    src = tmp_path / "in"
    src.mkdir()
    wavfile.write(str(src / "a.wav"), 8000, (np.random.default_rng(1).standard_normal(3000) * 3000).astype(np.int16))
    separate_cli.main([str(src), str(tmp_path / "out"), "--model", str(run), "--device", "cpu", "-N", "2"])
    for s in (0, 1):
        fs, y = wavfile.read(str(tmp_path / "out" / f"s{s}" / "a.wav"))
        assert fs == 8000 and y.shape == (3000,)
    assert Path(run / "hparams.yaml").read_text().count("resblock_type: ddpm") == 1


def test_reference_checkpoint_with_options_loads_the_same_in_both_packages(tmp_path):
    """A reference-layout checkpoint (the JAX package's writer, an EMA
    shadow list added) of a model with DDPM blocks, the fused FIR resample
    convs (``Conv2d_0``, OIHW) and the learnable transform constants loads
    into the same backbone parameters in both packages, EMA weights
    included."""
    from diffsep_tpu.cli.loading import load_model as jax_load_model
    from diffsep_tpu.config import compose
    from diffsep_tpu.config.compose import to_dict
    from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
    from diffsep_tpu.models.convert import save_reference_checkpoint
    from diffsep_tpu_torch.cli.loading import load_model

    from _torch_port_util import JAX_TINY_OVERRIDES, random_params

    cfg = compose(JAX_TINY_OVERRIDES + ["model.score_model.backbone_args.resblock_type=ddpm",
                                        "model.score_model.backbone_args.progressive_input=residual",
                                        "model.score_model.spec_trans_learnable=true"])
    params = random_params(JaxDiffSepModel(cfg).score_model, np.random.default_rng(22))
    path = tmp_path / "checkpoint.ckpt"
    save_reference_checkpoint(path, params, config=to_dict(cfg))
    ckpt = torch.load(path, weights_only=False)
    sd = ckpt["state_dict"]
    trainable = [k for k in sd if ".stft" not in k and not k.endswith("all_modules.0.W")]
    ckpt["ema"] = {"shadow_params": [sd[k] + 1.0 for k in trainable]}
    torch.save(ckpt, path)
    _, jparams = jax_load_model(path)
    want = state_dict_from_jax(jax.device_get(jparams))
    got = load_model(path, device="cpu").score_model.state_dict()
    # the JAX package's loader converts the backbone only and leaves the
    # learnable constants out; the port takes them, EMA'd, from the list
    scalars = {"spec_abs_exponent", "spec_factor"}
    assert set(got) - set(want) == scalars and set(want) <= set(got)
    assert any(".Conv2d_0.weight" in k for k in got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    for k in scalars:
        torch.testing.assert_close(got[k], torch.tensor(float(params[k]) + 1.0), atol=1e-6, rtol=0)

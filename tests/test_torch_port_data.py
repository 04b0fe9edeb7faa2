"""The port's data layer, config composition and SI-SDR metrics against the
JAX package's, on the CPU.

Batches must be identical (the same numpy arrays): the same files, the
same rng draws for crops and shuffles, the same collator. The composed
recipe must be the JAX tree but for the port's ``_target_`` prefixes and
its one-GPU trainer. SI-SDR is held to 1e-4 dB (float32, the same
formulas).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.data import DataLoader as JaxDataLoader
from diffsep_tpu.data import WSJ0_mix as JaxWSJ0_mix
from diffsep_tpu.data import WSJ0_mix_Module as JaxModule
from diffsep_tpu.data import load_wav as jax_load_wav
from diffsep_tpu.data import max_collator as jax_max_collator
from diffsep_tpu.models import losses as jax_metrics
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.data import DataLoader, WSJ0_mix, WSJ0_mix_Module, load_wav, max_collator
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.models import losses as metrics
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsj0")
    write_wsj0_mix(root / "long", {"train": 7, "val": 3}, seconds=0.7, seed=1)
    write_wsj0_mix(root / "short", {"train": 5, "val": 3}, seconds=0.3, seed=2)
    return root


def _batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y) == 2
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v)


def test_wav_reader_matches_jax(corpus):
    path = next((corpus / "long").rglob("*.wav"))
    (a, fa), (b, fb) = load_wav(path), jax_load_wav(path)
    assert fa == fb == 8000 and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataset_and_loader_batches_match_jax(corpus, shuffle):
    kw = dict(n_spkr=2, fs=8000, split="train", max_len_s=0.5)
    port = WSJ0_mix(corpus / "long", rng=np.random.default_rng(4), **kw)
    ref = JaxWSJ0_mix(corpus / "long", rng=np.random.default_rng(4), **kw)
    assert port.file_list == ref.file_list and len(port) == 7
    dl_kw = dict(batch_size=3, shuffle=shuffle, seed=5, pad_to_multiple=800)
    _batches_equal(DataLoader(port, **dl_kw), JaxDataLoader(ref, num_shards=1, shard_index=0, **dl_kw))


def test_collator_matches_jax():
    rng = np.random.default_rng(0)
    rows = [(rng.standard_normal((1, n)).astype(np.float32), rng.standard_normal((2, n)).astype(np.float32))
            for n in (5, 9, 2)]
    for mult in (None, 4):
        _batches_equal([max_collator(rows, mult)], [jax_max_collator(rows, mult)])


def _normalized(node):
    """The JAX tree's form of a port config: _target_ prefixes renamed."""
    if isinstance(node, dict):
        return {k: _normalized(v) for k, v in node.items()}
    if isinstance(node, str) and node.startswith("diffsep_tpu_torch."):
        return "diffsep_tpu." + node[len("diffsep_tpu_torch."):]
    return node


@pytest.mark.parametrize("overrides", [[], ["experiment=icassp-separation", "model.sde.sigma_min=0.1"]])
def test_compose_matches_jax_tree(overrides):
    got, want = _normalized(dict(compose(overrides))), dict(jax_compose(overrides))
    assert got["trainer"].pop("accelerator") == "gpu" and want["trainer"].pop("accelerator") == "tpu"
    if overrides:  # allgpus: every device, data-parallel (the dp mesh there, DDP here)
        assert got["trainer"].pop("strategy") == "ddp" and want["trainer"].pop("strategy") == "dp_mesh"
        assert got["trainer"]["devices"] == want["trainer"]["devices"] == -1
    else:
        assert got["trainer"]["devices"] == want["trainer"]["devices"] == 1
    assert got == want


def test_datamodule_batches_match_jax(corpus):
    overrides = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={corpus / 'short'}",
                 "datamodule.train.dl_opts.batch_size=2", "datamodule.val.dl_opts.batch_size=2"]
    port, ref = WSJ0_mix_Module(compose(overrides), 800), JaxModule(jax_compose(overrides), 800)
    _batches_equal(port.train_dataloader(), ref.train_dataloader())
    _batches_equal(port.val_dataloader(), ref.val_dataloader())


@pytest.mark.parametrize("n_src", [2, 3])
def test_si_sdr_metrics_match_jax(n_src):
    rng = np.random.default_rng(n_src)
    ref = rng.standard_normal((4, n_src, 300)).astype(np.float32)
    est = (ref[:, ::-1] + 0.3 * rng.standard_normal(ref.shape)).astype(np.float32)
    est[0] = ref[0] * 2.0  # a scaled copy: no error left, clamped at 30 dB
    e, r = torch.from_numpy(est), torch.from_numpy(ref)
    je, jr = jnp.asarray(est), jnp.asarray(ref)
    # unclamped only where an error is left: for the copy both read rounding noise
    assert np.allclose(metrics.si_sdr(e[1:], r[1:]).numpy(), np.asarray(jax_metrics.si_sdr(je[1:], jr[1:])),
                       atol=1e-4)
    assert np.allclose(metrics.si_sdr(e, r, clamp_db=30).numpy(), np.asarray(jax_metrics.si_sdr(je, jr, clamp_db=30)),
                       atol=1e-4)
    vals, perm = metrics.si_sdr_pit(e, r, zero_mean=True, clamp_db=30, return_perm=True)
    jvals, jperm = jax_metrics.si_sdr_pit(je, jr, zero_mean=True, clamp_db=30, return_perm=True)
    assert np.allclose(vals.numpy(), np.asarray(jvals), atol=1e-4)
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    for reduction in ("mean", "sum", "none"):
        kw = dict(zero_mean=True, clamp_db=30, reduction=reduction, sign_flip=True)
        assert np.allclose(metrics.SISDRLoss(**kw)(e, r).numpy(), np.asarray(jax_metrics.SISDRLoss(**kw)(je, jr)),
                           atol=1e-4)

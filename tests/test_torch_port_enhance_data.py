"""The enhancement recipe's data: diffsep_tpu_torch's NoisyDataset,
split_train_val and Valentini_Module against diffsep_tpu's on one seeded
synthetic VCTK-DEMAND folder (``data.synthetic.write_vctk_demand``). The
same files, crops, tiling and noise permutations from the same seeds give
the same items, bit for bit."""
import numpy as np
import pytest

from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.data import NoisyDataset as JaxNoisyDataset
from diffsep_tpu.data import Valentini_Module as JaxValentini
from diffsep_tpu.data import split_train_val as jax_split
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.data import NoisyDataset, Subset, Valentini_Module, load_wav, split_train_val
from diffsep_tpu_torch.data.synthetic import write_vctk_demand

FS = 16000


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_vctk_demand(tmp_path_factory.mktemp("vctk"), n_train=12, n_test=3, fs=FS, seed=1)


def _same(a, b):
    assert len(a) == len(b)
    for (xa, ta), (xb, tb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ta, tb)


def test_synthetic_folder(folder):
    lengths = []
    for split, n in (("train", 12), ("test", 3)):
        names = sorted(p.name for p in (folder / split / "noisy").iterdir())
        assert names == sorted(p.name for p in (folder / split / "clean").iterdir()) and len(names) == n
        for name in names:
            noisy, fs = load_wav(folder / split / "noisy" / name)
            clean, _ = load_wav(folder / split / "clean" / name)
            assert fs == FS and noisy.shape == clean.shape and noisy.shape[0] == 1
            assert 0 < np.abs(noisy - clean).max() and np.abs(noisy).max() <= 0.9 + 1e-4
            lengths.append(noisy.shape[-1] / FS)
    assert 1.0 <= min(lengths) < 3.0 < max(lengths) <= 4.0  # some files are tiled up to the 3 s crop


@pytest.mark.parametrize("split,augmentation", [("train", False), ("train", True), ("test", False)])
def test_noisy_dataset_items_match(folder, split, augmentation):
    kw = dict(audio_len=3, fs=FS, augmentation=augmentation, split=split)
    want = JaxNoisyDataset(folder, rng=np.random.default_rng(5), **kw)
    got = NoisyDataset(folder, rng=np.random.default_rng(5), **kw)
    assert got.file_list == want.file_list
    items = [got[i] for i in range(len(got))]
    _same(items, [want[i] for i in range(len(want))])
    for noisy, tgt in items:
        np.testing.assert_allclose(tgt.sum(axis=0), noisy[0], atol=1e-6)  # [clean, noisy - clean]
        if split == "train":
            assert noisy.shape == (1, 3 * FS)
    with pytest.raises(ValueError, match="split"):
        NoisyDataset(folder, split="val")


def test_split_train_val_matches(folder):
    ds = NoisyDataset(folder, split="test")
    for seed in (0, 3):
        got = split_train_val(ds, val_frac=0.1, seed=seed)
        want = jax_split(JaxNoisyDataset(folder, split="test"), val_frac=0.1, seed=seed)
        assert [g.indices for g in got] == [w.indices for w in want]
    assert len(Subset(ds, [2, 0])) == 2
    _same([Subset(ds, [2, 0])[i] for i in range(2)], [ds[2], ds[0]])


def test_valentini_module_matches(folder):
    overrides = ["experiment=noise-reduction", f"path.datasets.valentini={folder}", "seed=7"]
    got, want = Valentini_Module(compose(overrides)), JaxValentini(jax_compose(overrides))
    got.setup()
    want.setup()
    assert {k: len(v) for k, v in got.datasets.items()} == {"train": 10, "val": 2, "test": 3}
    for split in ("train", "val"):
        assert got.datasets[split].indices == want.datasets[split].indices
    # the train set draws its crops and noise permutations from its rng
    for dm in (got, want):
        dm.datasets["train"].dataset.rng = np.random.default_rng(11)
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        _same(list(getattr(got, loader)()), list(getattr(want, loader)()))

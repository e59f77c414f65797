"""The port's host data layer against the JAX package's, exactly.

Sampler order, loader batches (``drop_last``, ``pad_to_batch``,
``_n_valid``, two shards), dataset samples (reads, flips, train and eval
crops, clinical vector) and fold membership are pure numpy and pandas on
both sides, so every comparison here is an exact equality, dtypes
included. The data is the ``tests/synth_oai.py`` tree with X-ray, DESS and
clinical values (12 patients, 24 knees).
"""

import numpy as np
import pytest
import torch

from oaprogressionmmf_tpu.data import pipeline as jax_pipeline
from oaprogressionmmf_tpu.data.provider import \
    prepare_datasets as jax_prepare_datasets
from oaprogressionmmf_torch.data import pipeline
from oaprogressionmmf_torch.data.provider import prepare_datasets
from oaprogressionmmf_torch.utils.seeding import PRNGChain
from synth_oai import build_synth_tree, make_synth_config

MODALS = ("xr_pa", "sag_3d_dess", "clin")


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (7, 0), (7, 13),
                                        (1000, 2)])
def test_weighted_sampler_order_equals_jax(seed, epoch):
    targets = np.random.RandomState(seed).randint(0, 2, 57)
    got = pipeline.WeightedSampler(targets, seed=seed).epoch_indices(epoch)
    want = jax_pipeline.WeightedSampler(targets,
                                        seed=seed).epoch_indices(epoch)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


class ToyDataset:
    """Samples that depend on (idx, epoch): an image, a target, a name."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, idx, epoch=0):
        img = np.full((1, 3, 2), idx * 100 + epoch, np.uint8)
        return {"image__xr_pa": img,
                "target": np.asarray([idx % 2], np.int32),
                "exam_knee_id": f"knee{idx}"}


LOADER_CASES = {
    "keep_last": {},
    "drop_last": {"drop_last": True},
    "pad_to_batch": {"pad_to_batch": True},
    "shard_0_of_2": {"shard_index": 0, "shard_count": 2},
    "shard_1_of_2": {"shard_index": 1, "shard_count": 2, "drop_last": True},
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_batch_loader_equals_jax(case):
    kw = LOADER_CASES[case]
    ds = ToyDataset(11)
    sampler = pipeline.WeightedSampler(np.arange(11) % 3, seed=4)
    got_loader = pipeline.BatchLoader(ds, sampler, 3, num_workers=2, **kw)
    want_loader = jax_pipeline.BatchLoader(ds, sampler, 3, mesh=None,
                                           num_workers=2, **kw)
    assert len(got_loader) == len(want_loader)
    for epoch in (0, 1):
        got = list(got_loader.epoch(epoch))
        want = list(want_loader.epoch(epoch))
        assert len(got) == len(want) == len(want_loader)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["_n_valid"] == w["_n_valid"]
            assert g["exam_knee_id"] == w["exam_knee_id"]
            for k in ("image__xr_pa", "target"):
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_array_equal(g[k].numpy(), w[k])
                assert g[k].numpy().dtype == w[k].dtype


def test_loader_raises_a_read_error_in_the_consumer():
    """A sample that cannot be read stops the epoch with its error (the
    reading thread hands it over instead of leaving the loop waiting)."""
    class Broken(ToyDataset):
        def get(self, idx, epoch=0):
            if idx == 4:
                raise OSError("unreadable sample 4")
            return super().get(idx, epoch)

    loader = pipeline.BatchLoader(Broken(8), pipeline.SequentialSampler(8),
                                  2, num_workers=2)
    with pytest.raises(OSError, match="unreadable sample 4"):
        list(loader.epoch(0))


def test_grain_backend_is_refused():
    ds = ToyDataset(4)
    with pytest.raises(NotImplementedError, match="grain"):
        pipeline.make_batch_loader("grain", ds,
                                   pipeline.SequentialSampler(4), 2)
    assert isinstance(pipeline.make_batch_loader(
        "threads", ds, pipeline.SequentialSampler(4), 2),
        pipeline.BatchLoader)


def test_prng_chain_is_a_pure_function_of_its_coordinates():
    chain = PRNGChain(1000)
    assert chain.seed(3, 1, 0) == PRNGChain(1000).seed(3, 1, 0)
    seeds = {chain.seed(e, s, k) for e in range(3) for s in range(3)
             for k in range(2)}
    assert len(seeds) == 18 and all(0 <= s < 2 ** 63 for s in seeds)
    a = torch.rand(4, generator=chain.generator(1, 2, 0))
    b = torch.rand(4, generator=chain.generator(1, 2, 0))
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """The provider's datasets of folds 0 and 1 in both packages, each
    building the index itself (ignore_cache)."""
    tmp = tmp_path_factory.mktemp("oai")
    build_synth_tree(tmp / "data", n_patients=12,
                     modals=("xr_pa", "sag_3d_dess"))
    config = make_synth_config(tmp, model_name="XR1MR2C1CnnTrf",
                               modals=MODALS)
    config["data"]["ignore_cache"] = True
    out = {}
    for fold in (0, 1):
        got = prepare_datasets(config.to_dict(), fold)["oai"]
        want = jax_prepare_datasets(config, fold)["oai"]
        out[fold] = (got, want)
    return out


@pytest.mark.parametrize("fold", [0, 1])
def test_fold_membership_equals_jax(folds, fold):
    got, want = folds[fold]
    for part in ("sel_df", "trainval_df", "train_df", "val_df", "test_df"):
        g = got[part][("-", "exam_knee_id")].tolist()
        assert g == want[part][("-", "exam_knee_id")].tolist(), part
        assert len(g) > 0, part
    np.testing.assert_array_equal(got["train"].targets(),
                                  want["train_df"][("-", "target")].values)


@pytest.mark.parametrize("subset,epoch", [("train", 0), ("train", 3),
                                          ("val", 0), ("test", 1)])
def test_dataset_samples_equal_jax(folds, subset, epoch):
    """Every sample of the subset: X-ray and DESS crops (random for train,
    centre otherwise; RIGHT knees flipped), clinical vector, target, id."""
    got_ds, want_ds = folds[0][0][subset], folds[0][1][subset]
    assert len(got_ds) == len(want_ds) > 0
    sides = set()
    for idx in range(len(got_ds)):
        got, want = got_ds.get(idx, epoch), want_ds.get(idx, epoch)
        assert set(got) == set(want)
        assert got["exam_knee_id"] == want["exam_knee_id"]
        sides.add(got["exam_knee_id"].rsplit("__", 1)[1])
        for k, w in want.items():
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(got[k], w, err_msg=k)
                assert got[k].dtype == w.dtype, k
        assert got["image__xr_pa"].shape == (1, 64, 64)
        assert got["image__sag_3d_dess"].shape == (1, 64, 64, 4)
    assert sides == {"LEFT", "RIGHT"}


def test_train_crops_move_with_the_epoch(folds):
    ds = folds[0][0]["train"]
    a, b = ds.get(0, 0), ds.get(0, 1)
    assert not np.array_equal(a["image__sag_3d_dess"],
                              b["image__sag_3d_dess"])
    np.testing.assert_array_equal(a["clin_vec"], b["clin_vec"])

"""The port's host data layer against the JAX package's, exactly.

Sampler order, loader batches (``drop_last``, ``pad_to_batch``,
``_n_valid``, two shards), dataset samples (reads, flips, train and eval
crops, clinical vector) and fold membership are pure numpy and pandas on
both sides, so every comparison here is an exact equality, dtypes
included. The data is the ``tests/synth_oai.py`` tree with X-ray, DESS and
clinical values (12 patients, 24 knees).
"""

import pickle

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
from torch_port_toy_data import ToyDataset

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


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["_n_valid"] == w["_n_valid"]
        assert g["exam_knee_id"] == w["exam_knee_id"]
        for k in ("image__xr_pa", "target"):
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


WORKER_CASES = {
    "plain": (lambda: pipeline.SequentialSampler(11),
              {"pad_to_batch": True}),
    "shard_1_of_2": (lambda: pipeline.SequentialSampler(11),
                     {"shard_index": 1, "shard_count": 2}),
    "weighted": (lambda: pipeline.WeightedSampler(np.arange(11) % 3, seed=4),
                 {"drop_last": True}),
}


@pytest.mark.parametrize("case", sorted(WORKER_CASES))
def test_worker_loader_equals_jax_grain(case):
    """``loader_backend: grain``: two worker processes of
    torch.utils.data yield the batches of JAX's GrainBatchLoader (grain's
    index pipeline, read in process) and of the threads backend, in
    order; the weighted case in an epoch other than 0."""
    make_sampler, kw = WORKER_CASES[case]
    epoch = 2 if case == "weighted" else 0
    ds = ToyDataset(11)
    loader = pipeline.make_batch_loader("grain", ds, make_sampler(), 3,
                                        num_workers=2, **kw)
    assert isinstance(loader, pipeline.WorkerBatchLoader)
    got = list(loader.epoch(epoch))
    assert len(got) == len(loader)
    want = list(jax_pipeline.make_batch_loader(
        "grain", ds, make_sampler(), 3, mesh=None, num_workers=0,
        **kw).epoch(epoch))
    _assert_batches_equal(got, want)
    threads = list(pipeline.BatchLoader(ds, make_sampler(), 3,
                                        num_workers=2, **kw).epoch(epoch))
    _assert_batches_equal(got, [{k: (v.numpy() if isinstance(
        v, torch.Tensor) else v) for k, v in b.items()} for b in threads])


def test_grain_backend_is_refused():
    """What the worker backend refuses: a dataset that does not pickle
    (its workers are spawned, as grain's are) stops the epoch with the
    pickling error; an unknown backend raises. The threads backend takes
    both datasets."""
    class Unpicklable(ToyDataset):
        pass

    ds = Unpicklable(4)
    loader = pipeline.make_batch_loader("grain", ds,
                                        pipeline.SequentialSampler(4), 2,
                                        num_workers=1)
    with pytest.raises((AttributeError, TypeError, pickle.PicklingError),
                       match="local object"), \
            pytest.warns(UserWarning, match="pickle"):
        next(loader.epoch(0))
    assert isinstance(pipeline.make_batch_loader(
        "threads", ds, pipeline.SequentialSampler(4), 2),
        pipeline.BatchLoader)
    with pytest.raises(ValueError, match="Unknown loader backend"):
        pipeline.make_batch_loader("dali", ds,
                                   pipeline.SequentialSampler(4), 2)


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


def test_all_readable_finds_the_failures_jax_finds(tmp_path):
    """The read sweep (``DatasetOAI3d.test_all_readable``) over a tree
    with one X-ray overwritten by bytes that are no PNG: the same failing
    index in both packages, in index order, every other sample read."""
    from oaprogressionmmf_tpu.data.dataset import \
        DatasetOAI3d as JaxDataset
    from oaprogressionmmf_torch.data.dataset import DatasetOAI3d
    from oaprogressionmmf_torch.data.index import index_from_path_oai

    build_synth_tree(tmp_path, n_patients=3, modals=("xr_pa",))
    df = index_from_path_oai(tmp_path, ["clin", "xr_pa"], ignore_cache=True)
    df[("-", "target")] = df[("-", "prog_kl_48")]
    broken = 3
    path = df.iloc[broken][("xr_pa", "path_image")]
    with open(path, "wb") as f:
        f.write(b"not a png")
    got = DatasetOAI3d(df, ["xr_pa"], crop_sizes=[[64, 64]]) \
        .test_all_readable(n_jobs=2)
    want = JaxDataset(df, ["xr_pa"], crop_sizes=[[64, 64]]) \
        .test_all_readable(n_jobs=2)
    assert got == want == [broken]

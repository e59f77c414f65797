"""The plain reference against the program at test size on the CPU, and
the benchmark's operation and byte counts."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import flops, k5
from benchmark.reference import nets, preprocess, train as ref_train
from benchmark.tests import tiny
from benchmark.traffic.knees import Cohort

FLAGSHIP_MODALS = tiny.modals("xr1mr2c1_cnntrf")


def _cohort(cfg, modals, n=4, seed=5):
    return Cohort(cfg, modals, {"knees": n}, seed, "cpu")


@pytest.mark.parametrize("config", tiny.configs())
def test_eval_forward_matches_program(config):
    from oaprogressionmmf_torch.serving import make_predictor
    cfg, modals = tiny.size(config), tiny.modals(config)
    sd = nets.make_weights(cfg, 7, "cpu")
    xs = _cohort(cfg, modals).batch(range(4))
    pred = make_predictor(cfg, {k: v.clone() for k, v in sd.items()}, modals,
                          cfg["downscale"], device="cpu",
                          dtype=torch.float32)
    got = pred.logits(xs)
    with torch.no_grad():
        want = nets.forward(cfg, sd, preprocess.eval_inputs(
            modals, cfg["downscale"], [torch.from_numpy(x) for x in xs]))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_resnext_matches_program():
    from oaprogressionmmf_torch.models.resnet import resnext50_32x4d
    fe = resnext50_32x4d(with_gap=True).eval()
    spec = nets.resnet_spec("", "resnext50_32x4d")
    gen = torch.Generator().manual_seed(0)
    sd = {n: (torch.randn(s, generator=gen) * 0.05 if k == "w" else
              torch.ones(s) if k == "one" else
              torch.zeros(s, dtype=torch.int64 if k == "count" else None))
          for n, s, k in spec}
    fe.load_state_dict(sd, strict=True)
    x = torch.randn(2, 1, 64, 64, generator=gen)
    with torch.no_grad():
        torch.testing.assert_close(
            fe(x), nets.resnet(x, sd, "", "resnext50_32x4d"),
            rtol=1e-4, atol=1e-5)


def test_draws_and_order_match_program():
    from oaprogressionmmf_torch.data.pipeline import WeightedSampler
    from oaprogressionmmf_torch.ops.preproc import sample_augment_draws
    from oaprogressionmmf_torch.utils.seeding import PRNGChain
    seed, targets = 2 ** 31 + 17, np.array([0, 1, 1, 0, 1, 1, 1, 0])
    np.testing.assert_array_equal(
        WeightedSampler(targets, seed=seed).epoch_indices(3),
        preprocess.epoch_order(targets, seed, 3))
    gen = PRNGChain(seed + 1000).generator(3, 5, 0)
    mine = preprocess.step_draws(seed, 3, 5, FLAGSHIP_MODALS, 4, "cpu")
    for m in FLAGSHIP_MODALS[:3]:
        theirs = sample_augment_draws(gen, 4)
        for a, b in zip(theirs, mine[m]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_steps_match_program():
    """Two float32 training steps of the flagship (augmentation, forward in
    train mode with dropout, focal loss, backward, Adam) against the
    program's ``TrainRuntime`` on the same draws and dropout masks."""
    from oaprogressionmmf_torch.ops.preproc import AugmentDraws
    from oaprogressionmmf_torch.train.trainer import TrainRuntime
    from benchmark.drivers.train_epoch import given_masks
    cfg, modals = tiny.FLAGSHIP, FLAGSHIP_MODALS
    train_cfg = tiny.harness.cell("xr1mr2c1.train-b16")["config_file"][
        "training"]
    cohort = _cohort(cfg, modals, n=8)
    sd = nets.make_weights(cfg, 11, "cpu")
    rt = TrainRuntime({"model": cfg, "training": train_cfg}, modals,
                      cfg["downscale"], steps_per_epoch=2,
                      state_dict={k: v.clone() for k, v in sd.items()},
                      dtype=torch.float32, device="cpu")
    batches, losses = [], []
    for step in range(2):
        idx = list(range(step * 4, step * 4 + 4))
        xs = cohort.batch(idx)
        ys = torch.from_numpy(cohort.targets()[idx])
        draws = preprocess.step_draws(9, 0, step, modals, 4, "cpu")
        with given_masks(nets.Masks(9, step)):
            loss, _ = rt.train_step(xs, ys, draws=[
                None if m == "clin" else AugmentDraws(*draws[m])
                for m in modals])
        losses.append(float(loss))
        batches.append((preprocess.train_inputs(
            modals, cfg["downscale"], [torch.from_numpy(x) for x in xs],
            draws), ys))
    ref = ref_train.train_steps(cfg, train_cfg, sd, batches, 2, seed=9)
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-5)
    # Adam's first update is about lr·sign(g): round-off in a gradient
    # near 0 flips a sign, and the second step's loss moves by ~1e-4
    np.testing.assert_allclose(losses[1], ref["losses"][1], rtol=1e-3)
    # the parameters within the two steps' learning rate, where such a
    # sign may flip
    got = dict(rt.model.named_parameters())
    lr = ref_train.lr_at(train_cfg, 0, 2)
    for k in ref_train.trainable(sd):
        torch.testing.assert_close(got[k].detach(), sd[k], rtol=1e-3,
                                   atol=2 * 2 * lr + 1e-7)


@pytest.mark.parametrize("config", tiny.configs())
def test_flop_count_matches_flop_counter(config):
    cfg, modals = tiny.size(config), tiny.modals(config)
    sd = nets.make_weights(cfg, 1, "cpu")
    xs = _cohort(cfg, modals, n=2).batch(range(2))
    inputs = preprocess.eval_inputs(modals, cfg["downscale"],
                                    [torch.from_numpy(x) for x in xs])
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        nets.forward(cfg, sd, inputs)
    want = sum(flops.forward_flops(cfg).values()) * 2
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-9)


def test_k5_bound_of_a_flagship_request():
    """The int8 flagship's convolutions at batch 4 take at least 2.358 ms
    at the memory rate and the int8 peak, as chip_smoke.py counts them."""
    cfg = tiny.harness.cell("xr1mr2c1.score-int8-b16")["model"]
    assert k5.request_bound_s(cfg, 4) * 1e3 == pytest.approx(2.358, abs=5e-4)
    assert len(flops.resnet_convs("resnet50", 160)) == 53

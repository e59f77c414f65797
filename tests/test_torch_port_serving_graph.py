"""``serving.Predictor``'s CUDA graphs: when a call runs eagerly, captures
or replays (:func:`serving.engagement`), what the predictor observes to
decide, and, on the card, that replayed answers equal the eager ones and
stay as they were after later calls.

This file imports no JAX, so the card test runs where JAX is absent:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_serving_graph.py``."""

import re

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from oaprogressionmmf_torch import serving
from oaprogressionmmf_torch.models import dict_models
from oaprogressionmmf_torch.ops.flash_attention import flash_attention
from oaprogressionmmf_torch.train.trainer import eval_step

MR1 = {"name": "MR1CnnTrf", "input_size": [[32, 32, 8]],
       "downscale": [[0.5, 0.5, 0.5]], "input_channels": 1,
       "output_channels": 2, "output_type": "dict", "debug": False,
       "restore_weights": False,
       "fe": {"arch": "resnet18", "pretrained": False, "with_gap": True,
              "dropout": 0.0, "dims_view": "rc"},
       "agg": {"depth": 1, "heads": 2, "emb_dropout": 0.1, "mlp_dim": 64,
               "mlp_dropout": 0.1, "num_slices": None}}
MODALS = ["sag_3d_dess"]


def _predictor(device, dtype=torch.float32, cfg=MR1):
    torch.manual_seed(0)
    sd = dict_models["MR1CnnTrf"](MR1).state_dict()
    return serving.make_predictor(cfg, sd, MODALS, cfg["downscale"],
                                  device=device, dtype=dtype)


def _knees(n: int, batch: int = 1) -> list:
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, (batch, 1, *MR1["input_size"][0]),
                          dtype=np.uint8),) for _ in range(n)]


# (case, arguments of engagement beside the defaults, the path)
POLICY = [
    ("cpu", dict(cuda=False, seen=True), "eager"),
    ("cpu_captured", dict(cuda=False, seen=True, captured=True), "eager"),
    ("first_call", dict(seen=False), "eager"),
    ("second_call", dict(seen=True), "capture"),
    ("captured", dict(seen=True, captured=True), "replay"),
    ("calibration", dict(seen=True, calibrating=True), "eager"),
    ("dispatch_mode", dict(seen=True, captured=True, intercepted=True),
     "eager"),
    ("past_the_cap", dict(seen=True, graphs=serving.MAX_GRAPHS), "eager"),
    ("at_the_cap_replays", dict(seen=True, captured=True,
                                graphs=serving.MAX_GRAPHS), "replay"),
]


@pytest.mark.parametrize("case,kw,want", POLICY, ids=[c[0] for c in POLICY])
def test_engagement(case, kw, want):
    args = dict(cuda=True, seen=False, captured=False, graphs=0)
    args.update(kw)
    assert serving.engagement(**args) == want


def test_cpu_calls_run_eager_with_eval_steps_answers():
    predictor = _predictor("cpu")
    knees = _knees(3) + _knees(1, batch=2)
    for xs in knees + knees[:1]:
        want = eval_step(predictor.model, predictor.preprocess,
                         tuple(torch.as_tensor(x) for x in xs))
        assert torch.equal(predictor(xs), want[1])
        assert torch.equal(predictor.logits(xs), want[0])
    assert predictor.counts == {"eager": 10, "captured": 0, "replayed": 0}


def test_the_predictor_sees_calibration_hooks_and_dispatch_modes():
    assert not _predictor("cpu")._calibrating
    calib = _predictor("cpu", cfg=serving.quantized_model_config(
        MR1, "calib", include_agg=True))
    assert calib._calibrating

    predictor = _predictor("cpu")
    assert not predictor._intercepted()
    handle = predictor.model._fe.register_forward_hook(
        lambda *args: None)
    assert predictor._intercepted()
    handle.remove()
    assert not predictor._intercepted()
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda *args: None)
    assert predictor._intercepted()
    handle.remove()
    with FlopCounterMode(display=False):
        assert predictor._intercepted()
    assert not predictor._intercepted()


def _k1_on_the_device(fn) -> int:
    """K1's launches in ``fn``, counted by kernel name in a profiler trace
    of the card (a replay runs no Python, so its wrapper does not count)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if re.search(r"\(anonymous namespace\)::(?:\w+::)*flash_fwd_",
                            e.key))


@pytest.mark.card
def test_replays_equal_the_eager_answers_and_stay_held():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    predictor = _predictor(None, dtype=torch.bfloat16)
    knees = _knees(5)
    wants = []
    for xs in knees:
        before = flash_attention.launches
        logits, probs = eval_step(predictor.model, predictor.preprocess,
                                  predictor.to_device(xs))
        per_call = flash_attention.launches - before
        wants.append(probs.cpu())
    assert per_call > 0                             # K1 ran in every call
    held, counted = [], []
    for i, xs in enumerate(knees):
        before = flash_attention.launches
        held.append(predictor(xs))
        counted.append(flash_attention.launches - before)
        for got, want in zip(held, wants):       # earlier answers unchanged
            assert torch.equal(got.cpu(), want), i
    # the wrapper counts the eager call, the capturing call's eager run and
    # its capture, and no replay
    assert counted == [per_call, 2 * per_call, 0, 0, 0]
    assert _k1_on_the_device(lambda: predictor(knees[0]).cpu()) == per_call
    assert predictor.counts == {"eager": 1, "captured": 1, "replayed": 4}

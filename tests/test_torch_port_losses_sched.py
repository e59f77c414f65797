"""Port of the losses, LR schedules and optimizers against the JAX package.

Each bar is stated with its reason where it is defined.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from oaprogressionmmf_tpu.ops import losses as jax_losses
from oaprogressionmmf_tpu.ops import schedules as jax_sched
from oaprogressionmmf_tpu.train import state as jax_state
from oaprogressionmmf_torch.ops import losses, schedules
from oaprogressionmmf_torch.train import state

# float32 log-softmax in both
LOSS_RTOL = 1e-6
# the JAX factors are float32: a power such as gamma ** epoch loses about
# one ulp (6e-8) per epoch, 7e-6 by epoch 120; the port's are float64
SCHED_RTOL = 1e-5
# optax takes Adam's bias correction 1 − b2^t in float32, where at t = 2
# cancellation leaves ~3e-5 of it (torch takes it in float64): ~1.5e-5 of
# an update of at most 0.2 here, 3e-6; float32 rounding elsewhere is 1e-8
OPT_ATOL = 1e-5


@pytest.mark.parametrize("weights", [None, [0.3, 1.7]],
                         ids=["plain", "class_weight"])
@pytest.mark.parametrize("name,params", [
    ("FocalLoss", {"gamma": 2.0, "reduction": "mean"}),
    ("FocalLoss", {"gamma": 1.5, "reduction": "sum"}),
    ("CrossEntropyLoss", {"reduction": "mean"}),
    ("CrossEntropyLoss", {"reduction": "sum"}),
], ids=["focal_mean", "focal_sum", "ce_mean", "ce_sum"])
def test_classification_losses_match_jax(name, params, weights):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(16, 2)).astype(np.float32)
    target = rng.randint(0, 2, 16)
    kw = dict(params, class_weight=weights, batch_avg=True)
    want = jax_losses.dict_losses[name](num_classes=2, **kw)(
        jnp.asarray(logits), jnp.asarray(target))
    got = losses.dict_losses[name](num_classes=2, **kw)(
        torch.from_numpy(logits), torch.from_numpy(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_bce_with_logits_matches_jax():
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(8, 3)).astype(np.float32)
    target = rng.randint(0, 2, (8, 3))
    want = jax_losses.dict_losses["bce_wlogits_loss"]()(
        jnp.asarray(logits), jnp.asarray(target))
    got = losses.dict_losses["bce_wlogits_loss"]()(
        torch.from_numpy(logits), torch.from_numpy(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_focal_loss_is_differentiable():
    logits = torch.randn(4, 2, requires_grad=True)
    losses.make_focal()(logits, torch.tensor([0, 1, 1, 0])).backward()
    assert torch.isfinite(logits.grad).all() and logits.grad.abs().sum() > 0


SCHEDULES = {
    "CustomWarmupStaticDecayLR": dict(epochs_warmup=5, epochs_static=100,
                                      epochs_decay=1),
    "CustomWarmupMultiStepLR": dict(epochs_warmup=5,
                                    mstep_milestones=[10, 40, 90]),
    "StepLR": dict(step_size=30, gamma=0.5),
    "MultiStepLR": dict(milestones=[20, 50, 110], gamma=0.3),
    "ExponentialLR": dict(gamma=0.97),
    "CosineAnnealingLR": dict(T_max=50, eta_min_factor=0.05),
    "ConstantLR": dict(),
    "LambdaLR": dict(lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeLR": dict(lr_lambda=lambda e: 0.98),
    "CosineAnnealingWarmRestarts": dict(T_0=7, T_mult=2,
                                        eta_min_factor=0.1),
    "CyclicLR": dict(base_lr=1e-4, max_lr=1e-2, step_size_up=9,
                     step_size_down=13, mode="triangular2"),
    "OneCycleLR": dict(max_lr=1e-2, total_steps=100, three_phase=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_120_epochs(name):
    jax_fn = jax_sched.dict_schedulers[name](**SCHEDULES[name])
    fn = schedules.dict_schedulers[name](**SCHEDULES[name])
    assert getattr(fn, "absolute", False) == getattr(jax_fn, "absolute",
                                                     False)
    for epoch in range(121):
        want = float(jax_fn(jnp.asarray(epoch)))
        np.testing.assert_allclose(fn(epoch), want, rtol=SCHED_RTOL,
                                   atol=1e-12, err_msg=f"epoch {epoch}")


@pytest.mark.parametrize("name", ["CustomWarmupStaticDecayLR", "CyclicLR"])
def test_make_lr_schedule_quantizes_steps_to_epochs(name):
    kw = dict(params=SCHEDULES[name], lr_init=1e-3, steps_per_epoch=7)
    want = jax_sched.make_lr_schedule(name, **kw)
    got = schedules.make_lr_schedule(name, **kw)
    for step in range(0, 300, 5):
        np.testing.assert_allclose(got(step), float(want(step)),
                                   rtol=SCHED_RTOL)
    with pytest.raises(ValueError, match="metric-driven"):
        schedules.make_lr_schedule("ReduceLROnPlateau", {}, 1e-3, 7)


@pytest.mark.parametrize("mode,threshold_mode,cooldown", [
    ("min", "rel", 0), ("max", "abs", 2)])
def test_reduce_lr_on_plateau_matches_jax(mode, threshold_mode, cooldown):
    kw = dict(lr_init=0.1, mode=mode, factor=0.5, patience=2,
              threshold=1e-2, threshold_mode=threshold_mode,
              cooldown=cooldown, min_lr=0.01)
    ours, theirs = schedules.ReduceLROnPlateau(**kw), \
        jax_sched.ReduceLROnPlateau(**kw)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.89, 0.89, 0.9, 0.91, 0.5,
               0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]
    for m in metrics:
        assert ours.step(m) == theirs.step(m)
        assert ours.state_dict() == theirs.state_dict()
    other = schedules.ReduceLROnPlateau(lr_init=1.0)
    other.load_state_dict(ours.state_dict())
    assert other.state_dict() == ours.state_dict()


OPTIMIZERS = [
    ("Adam", {}), ("Adam", {"weight_decay": 1e-2}),
    ("AdamW", {"weight_decay": 0.1}),
    ("SGD", {"weight_decay": 1e-2, "momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True}),
    ("RMSprop", {"weight_decay": 1e-2}), ("RMSprop", {"momentum": 0.5}),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{'-'.join(k) or 'plain'}"
                              for n, k in OPTIMIZERS])
def test_two_optimizer_steps_match_optax(name, kw):
    """Two steps on a small parameter dict under a schedule whose value
    changes between the steps; the port sets the LR before each step."""
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]

    def lr(step):
        return 0.1 * (1 + step)

    tx = jax_state.dict_optimizers[name](lr, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in
                                        g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = state.dict_optimizers[name](list(tp.values()), **kw)
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        state.set_lr(opt, lr(step))
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=OPT_ATOL, err_msg=k)


def test_rmsprop_eps_sits_inside_the_square_root():
    """optax's scale_by_rms divides by sqrt(nu + eps); with a large eps the
    torch form sqrt(nu) + eps would be far off."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = state.dict_optimizers["RMSprop"]([p], eps=1.0, decay=0.0)
    p.grad = torch.tensor([1.0])
    state.set_lr(opt, 1.0)
    opt.step()
    assert math.isclose(p.item(), -1.0 / math.sqrt(2.0), rel_tol=1e-6)

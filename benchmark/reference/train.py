"""Plain float32 reference of the training step.

Focal loss −(1 − p_t)^γ · log p_t averaged over the batch; Adam with
coupled (L2) weight decay, the decay added to the gradient before the
moments, bias-corrected moments and ε outside the square root; the
learning rate of a linear warm-up from a tenth, a plateau and an
exponential decay, constant within an epoch. BatchNorm takes the batch's
statistics. Dropout takes each step's masks from the seed
(:class:`nets.Masks`). The per-slice feature extractors recompute their
blocks in the backward pass (the same numbers in less memory).
"""

from __future__ import annotations

import torch

from . import nets

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def focal_loss(logits, targets, gamma: float):
    logpt = torch.log_softmax(logits, dim=-1).gather(
        -1, targets.long()[:, None])[:, 0]
    return (-((1.0 - torch.exp(logpt)) ** gamma) * logpt).mean()


def lr_at(train_cfg: dict, step: int, steps_per_epoch: int) -> float:
    sched = train_cfg["sched"]
    if sched["name"] != "CustomWarmupStaticDecayLR":
        raise ValueError(f"no reference for the schedule {sched['name']}")
    prm = sched["params"]
    warmup, static = prm["epochs_warmup"], prm["epochs_static"]
    epoch = step // steps_per_epoch
    if epoch <= warmup:
        factor = 0.1 + 0.9 * epoch / float(warmup)
    elif epoch <= warmup + static:
        factor = 1.0
    else:
        factor = 0.9 ** (epoch - warmup - static)
    return float(train_cfg["optim"]["lr_init"]) * factor


class Adam:
    """Adam over a dict of float32 tensors, as the configuration states
    it: L2 weight decay added to the gradient."""

    def __init__(self, params: dict, weight_decay: float):
        self.wd = weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        b1, b2 = BETAS
        for k, p in params.items():
            g = grads[k] + self.wd * p
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))


def trainable(sd: dict) -> list:
    """Names of the parameters that training updates: every tensor but
    BatchNorm's running statistics and counters."""
    return [k for k in sd if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]


def train_steps(cfg: dict, train_cfg: dict, sd: dict, batches,
                steps_per_epoch: int, seed: int, prec=nets.FLOAT32) -> dict:
    """Run the steps of ``batches`` (each (model inputs, targets), the
    inputs already augmented) from the weights ``sd``, which are updated in
    place, step ``i``'s dropout masks ``nets.Masks(seed, i)``. Returns the
    losses, and the logits and loss gradients (by name) of the first step,
    float32."""
    names = trainable(sd)
    params = {k: sd[k] for k in names}
    gamma = float(train_cfg["loss"]["params"].get("gamma", 2.0))
    opt = Adam(params, float(train_cfg["optim"].get("weight_decay") or 0.0))
    out = {"losses": []}
    for step, (xs, ys) in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  params.items()}
        p = dict(sd, **leaves)
        logits = nets.forward(cfg, p, xs, train=True, prec=prec, remat=True,
                              drop=nets.Masks(seed, step))
        loss = focal_loss(logits, ys, gamma)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(leaves, got)}
        out["losses"].append(float(loss.detach()))
        if step == 0:
            out["grads"] = {k: g.clone() for k, g in grads.items()}
            out["logits"] = logits.detach().float()
        del leaves, p, logits, loss, got
        opt.step(params, grads, lr_at(train_cfg, step, steps_per_epoch))
        del grads
    return out

"""Optimizer registry with the JAX package's update semantics.

Port of ``dict_optimizers`` of ``oaprogressionmmf_tpu/train/state.py``:
Adam, SGD and RMSprop take ``weight_decay`` as L2 added to the gradient
before the moments (coupled), AdamW decays the weights apart from them.
Each entry builds an optimizer over ``params`` with learning rate 0; the
caller sets every group's ``lr`` to ``lr_schedule(step)`` before each
``step()`` (:func:`set_lr`), so the first update uses the schedule's
value at step 0, as optax does.
"""

from __future__ import annotations

import torch


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def _adam(params, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8):
    # optax chain(add_decayed_weights, scale_by_adam, scale_by_lr) is
    # torch's Adam with L2 weight decay: the same moments, bias
    # corrections and eps outside the square root
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def _adamw(params, weight_decay=0.01, b1=0.9, b2=0.999, eps=1e-8):
    # optax.adamw adds lr·wd·p to the Adam step; torch's AdamW multiplies
    # p by (1 − lr·wd) before it: the same update
    return torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, weight_decay=0.0, momentum=0.0, nesterov=False):
    # optax.trace starts from zero, so its first trace is the gradient, as
    # torch's momentum buffer is; nesterov adds momentum·trace the same way
    return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                           nesterov=nesterov, weight_decay=weight_decay)


class RMSprop(torch.optim.Optimizer):
    """optax's RMSprop chain: ν ← decay·ν + (1 − decay)·g², update
    g / sqrt(ν + eps), then an optional momentum trace. Written by hand
    because optax.scale_by_rms takes eps inside the square root and
    torch.optim.RMSprop outside it (g / (sqrt(ν) + eps))."""

    def __init__(self, params, lr=0.0, weight_decay=0.0, decay=0.99,
                 eps=1e-8, momentum=0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      decay=decay, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.zeros_like(p)
                    if group["momentum"]:
                        state["momentum_buffer"] = torch.zeros_like(p)
                nu = state["square_avg"]
                nu.mul_(group["decay"]).addcmul_(g, g,
                                                 value=1 - group["decay"])
                update = g / (nu + group["eps"]).sqrt()
                if group["momentum"]:
                    buf = state["momentum_buffer"]
                    update = buf.mul_(group["momentum"]).add_(update)
                p.add_(update, alpha=-group["lr"])


def _rmsprop(params, weight_decay=0.0, decay=0.99, eps=1e-8, momentum=0.0):
    return RMSprop(params, weight_decay=weight_decay, decay=decay, eps=eps,
                   momentum=momentum)


dict_optimizers = {
    "SGD": _sgd,
    "Adam": _adam,
    "AdamW": _adamw,
    "RMSprop": _rmsprop,
}

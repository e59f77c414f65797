"""Learning-rate schedules: epoch → factor, lifted to step → lr.

Port of ``oaprogressionmmf_tpu/ops/schedules.py``. Each schedule is a
plain function of the epoch index; :func:`make_lr_schedule` turns it into
step → lr with ``epoch = step // steps_per_epoch``, the torch schedulers'
once-per-epoch stepping. CyclicLR and OneCycleLR give absolute rates.
``ReduceLROnPlateau`` is metric-driven and host-side, as in torch.
"""

from __future__ import annotations

import bisect
import math


def custom_warmup_static_decay(epochs_warmup, epochs_static, epochs_decay,
                               warmup_factor=0.1, decay_factor=0.9,
                               **kwargs):
    """Linear warmup → plateau at 1 → exponential decay."""
    end_s = epochs_warmup + epochs_static

    def fn(epoch):
        if epoch <= epochs_warmup:
            return (warmup_factor
                    + (1. - warmup_factor) * epoch / float(epochs_warmup))
        if epoch <= end_s:
            return 1.0
        return decay_factor ** (epoch - end_s)

    return fn


def custom_warmup_multistep(epochs_warmup, mstep_milestones,
                            warmup_factor=0.1, mstep_factor=0.1, **kwargs):
    """Linear warmup → multiplicative drops at warmup-shifted milestones."""
    milestones = sorted(epochs_warmup + e for e in mstep_milestones)

    def fn(epoch):
        if epoch <= epochs_warmup:
            return (warmup_factor
                    + (1. - warmup_factor) * epoch / float(epochs_warmup))
        return mstep_factor ** bisect.bisect_right(milestones, epoch)

    return fn


def step_lr(step_size, gamma=0.1, **kwargs):
    return lambda epoch: gamma ** math.floor(epoch / step_size)


def multi_step_lr(milestones, gamma=0.1, **kwargs):
    ms = sorted(milestones)
    return lambda epoch: gamma ** bisect.bisect_right(ms, epoch)


def exponential_lr(gamma, **kwargs):
    return lambda epoch: gamma ** epoch


def cosine_annealing_lr(T_max, eta_min_factor=0.0, **kwargs):
    return lambda epoch: (eta_min_factor + (1 - eta_min_factor)
                          * (1 + math.cos(math.pi * epoch / T_max)) / 2)


def constant_lr(**kwargs):
    return lambda epoch: 1.0


def lambda_lr(lr_lambda, **kwargs):
    """torch LambdaLR: factor = lr_lambda(epoch)."""
    return lambda epoch: float(lr_lambda(epoch))


def multiplicative_lr(lr_lambda, **kwargs):
    """torch MultiplicativeLR: factor(E) = prod_{e=1..E} lr_lambda(e)."""
    return lambda epoch: math.prod(float(lr_lambda(e))
                                   for e in range(1, epoch + 1))


def cosine_annealing_warm_restarts(T_0, T_mult=1, eta_min_factor=0.0,
                                   **kwargs):
    """torch CosineAnnealingWarmRestarts; eta_min as a factor of
    lr_init."""
    T_0, T_mult = float(T_0), int(T_mult)

    def fn(epoch):
        if T_mult == 1:
            t_cur, t_i = epoch % T_0, T_0
        else:
            n = math.floor(math.log(epoch / T_0 * (T_mult - 1) + 1)
                           / math.log(T_mult))
            t_cur = epoch - T_0 * (T_mult ** n - 1) / (T_mult - 1)
            t_i = T_0 * T_mult ** n
        return (eta_min_factor + (1 - eta_min_factor)
                * (1 + math.cos(math.pi * t_cur / t_i)) / 2)

    return fn


def cyclic_lr(base_lr, max_lr, step_size_up=2000, step_size_down=None,
              mode="triangular", gamma=1.0, **kwargs):
    """torch CyclicLR (absolute rates: base_lr and max_lr set the cycle)."""
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"Unknown CyclicLR mode: {mode}")
    up = float(step_size_up)
    down = float(step_size_down if step_size_down is not None
                 else step_size_up)
    total = up + down
    step_ratio = up / total

    def fn(epoch):
        cycle = math.floor(1 + epoch / total)
        x = 1.0 + epoch / total - cycle
        scale_factor = (x / step_ratio if x <= step_ratio
                        else (x - 1) / (step_ratio - 1))
        height = (max_lr - base_lr) * scale_factor
        if mode == "triangular":
            scale = 1.0
        elif mode == "triangular2":
            scale = 1.0 / (2.0 ** (cycle - 1))
        else:
            scale = gamma ** epoch          # scale_mode='iterations'
        return base_lr + height * scale

    fn.absolute = True
    return fn


def one_cycle_lr(max_lr, total_steps, pct_start=0.3, anneal_strategy="cos",
                 div_factor=25.0, final_div_factor=1e4, three_phase=False,
                 **kwargs):
    """torch OneCycleLR (absolute rates), annealed once per epoch."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    if anneal_strategy == "cos":
        def anneal(start, end, pct):
            return end + (start - end) / 2.0 * (1 + math.cos(math.pi * pct))
    elif anneal_strategy == "linear":
        def anneal(start, end, pct):
            return (end - start) * pct + start
    else:
        raise ValueError(f"Unknown anneal_strategy: {anneal_strategy}")
    if three_phase:
        ends = [float(pct_start * total_steps) - 1,
                float(2 * pct_start * total_steps) - 2, total_steps - 1]
        lrs = [(initial_lr, max_lr), (max_lr, initial_lr),
               (initial_lr, min_lr)]
    else:
        ends = [float(pct_start * total_steps) - 1, total_steps - 1]
        lrs = [(initial_lr, max_lr), (max_lr, min_lr)]

    def fn(epoch):
        start_step = 0.0
        for end_step, (start_lr, end_lr) in zip(ends, lrs):
            if epoch <= end_step:
                span = max(end_step - start_step, 1e-12)
                pct = min(max((epoch - start_step) / span, 0.0), 1.0)
                return anneal(start_lr, end_lr, pct)
            start_step = end_step
        return lrs[-1][1]                   # past the end: min_lr

    fn.absolute = True
    return fn


class ReduceLROnPlateau:
    """Metric-driven LR controller with torch semantics: call
    ``step(metric)`` once per epoch with the validation criterion; it
    returns the LR to use next."""

    def __init__(self, lr_init, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0,
                 min_lr=0.0, eps=1e-8, **kwargs):
        if factor >= 1.0:
            raise ValueError("factor should be < 1.0")
        self.current_lr = float(lr_init)
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.eps = float(eps)
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, a, best):
        rel = self.threshold_mode == "rel"
        if self.mode == "min":
            return a < (best * (1.0 - self.threshold) if rel
                        else best - self.threshold)
        return a > (best * (1.0 + self.threshold) if rel
                    else best + self.threshold)

    def state_dict(self) -> dict:
        return {"current_lr": self.current_lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, state: dict) -> None:
        self.current_lr = float(state["current_lr"])
        self.best = float(state["best"])
        self.num_bad_epochs = int(state["num_bad_epochs"])
        self.cooldown_counter = int(state["cooldown_counter"])

    def step(self, metric) -> float:
        current = float(metric)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.current_lr * self.factor, self.min_lr)
            if self.current_lr - new_lr > self.eps:
                self.current_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.current_lr


dict_schedulers = {
    "LambdaLR": lambda_lr,
    "MultiplicativeLR": multiplicative_lr,
    "StepLR": step_lr,
    "MultiStepLR": multi_step_lr,
    "ExponentialLR": exponential_lr,
    "CosineAnnealingLR": cosine_annealing_lr,
    "ReduceLROnPlateau": ReduceLROnPlateau,
    "CyclicLR": cyclic_lr,
    "OneCycleLR": one_cycle_lr,
    "CosineAnnealingWarmRestarts": cosine_annealing_warm_restarts,
    "ConstantLR": constant_lr,
    "CustomWarmupStaticDecayLR": custom_warmup_static_decay,
    "CustomWarmupMultiStepLR": custom_warmup_multistep,
}


def make_lr_schedule(name: str, params: dict, lr_init: float,
                     steps_per_epoch: int):
    """step → lr, epoch-quantized like torch. ReduceLROnPlateau is
    metric-driven and has no step schedule: the training loop drives it."""
    if name == "ReduceLROnPlateau":
        raise ValueError("ReduceLROnPlateau is metric-driven and has no step "
                         "schedule: train.trainer.ProgressionTrainer drives "
                         "it with ops.schedules.ReduceLROnPlateau after each "
                         "validation epoch")
    factor_fn = dict_schedulers[name](**dict(params))
    absolute = getattr(factor_fn, "absolute", False)

    def schedule(step):
        value = factor_fn(int(step) // max(int(steps_per_epoch), 1))
        return value if absolute else lr_init * value

    return schedule

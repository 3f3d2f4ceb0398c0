"""optax's optimizers, written on tensors.

`Optimizer` applies, in place and without gradient, the update equations
and defaults of `optax.adam`, `optax.rmsprop` and `optax.sgd` (each scaled by
a learning-rate schedule), optionally behind `optax.clip_by_global_norm`
and inside `optax.MultiSteps`, as `hyperpose_tpu/train/trainer.py`
`make_optimizer` chains them, or behind `optax.add_decayed_weights` with a
learning rate that `optax.inject_hyperparams` keeps in the optimizer's
state, as `hyperpose_tpu/train/pretrain.py` chains them. The ways they
differ from `torch.optim`:

- Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the update
  mu_hat / (sqrt(nu_hat) + eps) with both moments bias-corrected by
  1 - b^t (b1 0.9, b2 0.999, eps 1e-8).
- RMSprop: decay 0.9 (torch's alpha is 0.99), nu starts at 0, and eps (1e-8)
  sits inside the square root: g * rsqrt(nu + eps).
- SGD: no momentum.
- The schedule reads the update count before it is incremented: the first
  update uses schedule(0). A constant learning rate instead lives in the
  state, rounded to float32 (inject_hyperparams' array; float64 parameters
  keep it in float64, as optax under `jax.enable_x64` does), where a caller
  may change it (`set_learning_rate`: pretraining's lr / 5) and a
  checkpoint keeps it.
- add_decayed_weights(wd): wd x p is added to every parameter's gradient
  (BatchNorm scales and biases too) before the update.
- clip_by_global_norm: g unchanged when its global norm is below the
  limit, else (g / norm) * limit.
- MultiSteps(k): the gradients of k calls are averaged (Welford's running
  mean); the inner update runs on the k-th call only, and the other calls
  leave the parameters and the inner state as they are.

Every state is float32 tensors beside the parameters (on their device) and
Python integers; `state_dict` / `load_state_dict` carry it through a
checkpoint.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

KINDS = ("adam", "rmsprop", "sgd")
ADAM_B1, ADAM_B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's and optax.rmsprop's eps
RMS_DECAY = 0.9                             # optax.rmsprop


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax `clip_by_global_norm`: the gradients as they are when their
    global norm (the square root of the sum of every element's square) is
    below `max_norm`, else each (g / norm) * max_norm. Decided on the
    device, with no host sync."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def _bias_correction(decay: float, count: int, dtype: torch.dtype) -> float:
    """1 - decay^count as optax forms it: in float32, or in float64 for
    float64 moments (optax under `jax.enable_x64`)."""
    if dtype == torch.float64:
        return 1.0 - decay ** count
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))


class Optimizer:
    """One of `KINDS` over `params` with the learning rate `schedule(count)`
    (or a constant held in the state when `schedule` is a number), the
    decayed-weights term when `weight_decay` > 0, global-norm clipping when
    `clip_norm` > 0 and `accum_steps`-step gradient averaging when it is
    above 1 (see the module docstring)."""

    def __init__(self, params: Sequence[torch.Tensor], kind: str,
                 schedule: Callable[[int], float] | float, clip_norm: float = 0.0,
                 accum_steps: int = 1, weight_decay: float = 0.0):
        if kind not in KINDS:
            raise ValueError(f"unknown optimizer {kind!r}; one of {KINDS}")
        self.params = list(params)
        self.kind = kind
        self.schedule = schedule if callable(schedule) else None
        self._lr_x64 = bool(self.params) and self.params[0].dtype == torch.float64
        self.lr = None if callable(schedule) else self._round_lr(schedule)
        self.weight_decay = float(weight_decay)
        self.clip_norm, self.accum_steps = float(clip_norm or 0.0), int(accum_steps)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.count = 0          # inner updates made: the schedule's step
        self.mu = zeros() if kind == "adam" else []
        self.nu = zeros() if kind in ("adam", "rmsprop") else []
        self.mini_step = 0      # MultiSteps
        self.acc = zeros() if self.accum_steps > 1 else []

    @property
    def learning_rate(self) -> float:
        """The learning rate of the next update."""
        return float(self.schedule(self.count)) if self.schedule else self.lr

    def _round_lr(self, lr: float) -> float:
        return float(lr) if self._lr_x64 else float(np.float32(lr))

    def set_learning_rate(self, lr: float) -> None:
        """Replace the constant learning rate (rounded to float32 but for
        float64 parameters)."""
        if self.schedule is not None:
            raise ValueError("the learning rate follows a schedule")
        self.lr = self._round_lr(lr)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Apply one call's gradients (one per parameter, in order). Returns
        whether the parameters were updated (always, unless MultiSteps is
        still accumulating)."""
        grads = list(grads)
        if self.accum_steps > 1:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.accum_steps - 1:
                self.mini_step = n + 1
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm)
        updates = self._direction(grads)
        lr = -self.learning_rate
        torch._foreach_mul_(updates, lr)
        torch._foreach_add_(self.params, updates)
        self.count += 1
        return True

    def _direction(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The update before the learning rate, with the moments advanced."""
        if self.kind == "sgd":
            return [g.clone() for g in grads]
        sq = torch._foreach_mul(grads, grads)
        if self.kind == "rmsprop":
            torch._foreach_mul_(self.nu, RMS_DECAY)
            torch._foreach_add_(self.nu, torch._foreach_mul(sq, 1 - RMS_DECAY))
            return [torch.rsqrt(n + EPS) * g for n, g in zip(self.nu, grads)]
        b1, b2 = ADAM_B1, ADAM_B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(sq, 1 - b2))
        t = self.count + 1
        dt = self.mu[0].dtype if self.mu else torch.float32
        mu_hat = torch._foreach_div(self.mu, _bias_correction(b1, t, dt))
        nu_hat = torch._foreach_div(self.nu, _bias_correction(b2, t, dt))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        return torch._foreach_div(mu_hat, denom)

    def state_dict(self) -> dict:
        return {"kind": self.kind, "count": self.count, "mini_step": self.mini_step,
                "lr": self.lr, "mu": list(self.mu), "nu": list(self.nu), "acc": list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if state["kind"] != self.kind:
            raise ValueError(f"optimizer state of {state['kind']!r}, not {self.kind!r}")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        if self.schedule is None and state.get("lr") is not None:
            self.lr = float(state["lr"])
        for name in ("mu", "nu", "acc"):
            own, saved = getattr(self, name), state[name]
            if len(own) != len(saved):
                raise ValueError(f"optimizer state {name}: {len(saved)} tensors, "
                                 f"expected {len(own)}")
            for t, s in zip(own, saved):
                t.copy_(s)

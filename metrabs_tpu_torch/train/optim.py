"""Optimizer and LR schedules (`metrabs_tpu/train/optim.py`, which builds them
with optax), as plain tensor functions that match optax step for step:

 - `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay
   weight_decay / sqrt(training_steps) / base_learning_rate on every
   parameter: p += -lr(count) * (m_hat / (sqrt(v_hat) + eps) + wd * p), the
   schedule read at the count before its increment; with
   `optimizer_mu_dtype` the first moment is stored in that dtype (the
   update uses it unrounded, and decays it by b1 rounded to that dtype, as
   optax does); the moment updates round as XLA's fused multiply-add
   (`_moment_update`);
 - dual-LR fine-tuning (`optax.multi_transform`): parameters under
   `backbone` get the low schedule, the others the high one, each group with
   its own Adam state;
 - `optax.MultiSteps` accumulation: a running mean of the gradients, and a
   real update every `grad_accum_steps`-th micro-step;
 - the EMA of the parameters and the max-norm projection of the backbone's
   conv kernels (`ema_update`, `project_kernel_norms`);
 - `optax.adam` with a constant LR or `optax.cosine_decay_schedule`
   (`Adam`, `cosine_decay_schedule`), the detector trainer's optimizer.

Schedules compute in float32, as the JAX ones do under `jnp`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from metrabs_tpu_torch.config import TrainConfig

B1, B2, EPS = 0.9, 0.999, 1e-8
BACKBONE = 'backbone'


def _two_phase_schedule(tcfg: TrainConfig, phase1_fraction: float) -> Callable[[int], float]:
    """Exponential decay to base/3 over the first `phase1_fraction` of
    training, then from base/30 with rate 0.3 over the rest."""
    n1 = phase1_fraction * tcfg.training_steps
    n2 = tcfg.training_steps - n1
    b = tcfg.base_learning_rate
    f32 = np.float32

    def schedule(count: int) -> float:
        step = f32(count)
        if step < f32(n1):
            return float(f32(b) * f32(1 / 3) ** (step / f32(n1)))
        return float(f32(b / 30) * f32(0.3) ** ((step - f32(n1)) / f32(n2)))

    return schedule


def lr_schedule(tcfg: TrainConfig) -> Callable[[int], float]:
    """The training LR: phase switch at 92% of training."""
    return _two_phase_schedule(tcfg, 0.92)


def lr_schedule_finetune_high(tcfg: TrainConfig) -> Callable[[int], float]:
    """The head's LR in dual-LR fine-tuning: phase switch at 50%."""
    return _two_phase_schedule(tcfg, 0.5)


def lr_schedule_finetune_low(tcfg: TrainConfig) -> Callable[[int], float]:
    """The backbone's LR in dual-LR fine-tuning."""
    b, total = tcfg.base_learning_rate, tcfg.training_steps
    return lambda count: float(np.float32(b / 30) * np.float32(0.3) ** (
        np.float32(count) / np.float32(total)))


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState of one parameter group (its schedule's count
    is always equal)."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class OptState:
    """Adam state per group ('all', or 'backbone' and 'heads'), and
    MultiSteps' counters and accumulated gradients (None without
    accumulation)."""
    groups: Dict[str, AdamState]
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self) -> dict:
        return dict(groups={k: dataclasses.asdict(g) for k, g in self.groups.items()},
                    mini_step=self.mini_step, gradient_step=self.gradient_step,
                    acc_grads=self.acc_grads)

    @classmethod
    def from_state_dict(cls, d: dict) -> 'OptState':
        return cls(groups={k: AdamState(**g) for k, g in d['groups'].items()},
                   mini_step=d['mini_step'], gradient_step=d['gradient_step'],
                   acc_grads=d['acc_grads'])


class Optimizer:
    """`build_optimizer(tcfg)` of the JAX package over a dict of named
    parameters, updating them in place."""

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg
        # max(1) guards training_steps=0 (export only), as in JAX.
        self.weight_decay = (tcfg.weight_decay / math.sqrt(max(tcfg.training_steps, 1))
                             / tcfg.base_learning_rate)
        self.mu_dtype = getattr(torch, tcfg.optimizer_mu_dtype) if tcfg.optimizer_mu_dtype \
            else None
        if tcfg.dual_finetune_lr:
            self.schedules = {BACKBONE: lr_schedule_finetune_low(tcfg),
                              'heads': lr_schedule_finetune_high(tcfg)}
        else:
            self.schedules = {'all': lr_schedule(tcfg)}

    def group_of(self, name: str) -> str:
        if 'all' in self.schedules:
            return 'all'
        return BACKBONE if BACKBONE in name.split('.') else 'heads'

    def _names(self, params: Dict[str, torch.Tensor]) -> Dict[str, List[str]]:
        groups = {g: [] for g in self.schedules}
        for name in params:
            groups[self.group_of(name)].append(name)
        return groups

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = lambda names, dtype=None: {
            n: torch.zeros_like(params[n], dtype=dtype) for n in names}
        groups = {g: AdamState(0, zeros(names, self.mu_dtype), zeros(names))
                  for g, names in self._names(params).items()}
        acc = ({n: torch.zeros_like(p) for n, p in params.items()}
               if self.tcfg.grad_accum_steps > 1 else None)
        return OptState(groups, acc_grads=acc)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: OptState) -> bool:
        """One micro-step; updates `params` and `state` in place. Returns
        whether an update was applied (every micro-step without
        accumulation)."""
        k = self.tcfg.grad_accum_steps
        if k > 1:
            n = state.mini_step
            for name, acc in state.acc_grads.items():
                acc.add_((grads[name] - acc) / (n + 1))
            state.mini_step = (n + 1) % k
            if n != k - 1:
                return False
            grads = state.acc_grads
            state.gradient_step += 1
        for group, names in self._names(params).items():
            self._adamw(names, params, grads, state.groups[group], self.schedules[group])
        if k > 1:
            for acc in state.acc_grads.values():
                acc.zero_()
        return True

    def _adamw(self, names: List[str], params, grads, adam: AdamState, schedule) -> None:
        _adam_update(names, params, grads, adam, schedule, self.weight_decay)


def _adam_update(names: List[str], params, grads, adam: AdamState, schedule,
                 weight_decay: float = 0.0) -> None:
    """One optax Adam update of `names` in place, with decoupled weight
    decay if `weight_decay` (optax.adamw), at the LR `schedule(count)`."""
    if not names:
        return
    lr = schedule(adam.count)
    adam.count += 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(B1) ** f32(adam.count))
    bc2 = float(f32(1) - f32(B2) ** f32(adam.count))
    p = [params[n] for n in names]
    g = [grads[n] for n in names]
    mu = _moment_update(g, [adam.mu[n] for n in names], B1)
    nu = _moment_update(torch._foreach_mul(g, g), [adam.nu[n] for n in names], B2)
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), EPS)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    if weight_decay:
        u = torch._foreach_add(u, torch._foreach_mul(p, weight_decay))
    torch._foreach_add_(p, torch._foreach_mul(u, -lr))
    for name, m, v in zip(names, mu, nu):
        adam.mu[name] = m.to(adam.mu[name].dtype)
        adam.nu[name] = v


class Adam:
    """`optax.adam(learning_rate)` (b1 0.9, b2 0.999, eps 1e-8, no weight
    decay) over a dict of named float32 parameters, updated in place:
    p -= lr(count) * m_hat / (sqrt(v_hat) + eps), the schedule read at the
    count before its increment. `learning_rate` is a number or a schedule
    of the count (`cosine_decay_schedule`). The detector trainer's
    optimizer; the crop-model trainer's is `Optimizer`."""

    def __init__(self, learning_rate):
        self.schedule = (learning_rate if callable(learning_rate)
                         else lambda count: float(np.float32(learning_rate)))

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                         {n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: AdamState) -> None:
        _adam_update(list(params), params, grads, state, self.schedule)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """`optax.cosine_decay_schedule` in float32: init_value * ((1 - alpha) *
    0.5 * (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)."""
    if not decay_steps > 0:
        raise ValueError(f'The cosine_decay_schedule requires positive decay_steps, got '
                         f'decay_steps={decay_steps}.')
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(init_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def _moment_update(values: List[torch.Tensor], moments: List[torch.Tensor],
                   decay: float) -> List[torch.Tensor]:
    """optax's (1 - decay) * values + decay * moments in float32, rounded
    once as XLA's fused multiply-add rounds it: the product of two float32
    numbers is exact in float64. (A first moment that nearly cancels over
    the steps keeps only the bits that this rounding decides.) A bfloat16
    moment is decayed as jnp's weak typing has it: by `decay` rounded to
    bfloat16 (0.8984375 for 0.9), the product kept in float32."""
    dtype = moments[0].dtype if moments else torch.float32
    decay_as_typed = torch.tensor(decay, dtype=dtype).item()
    decayed = torch._foreach_mul([m.float() for m in moments], decay_as_typed)
    out = torch._foreach_add(torch._foreach_mul([v.double() for v in values],
                                                float(np.float32(1 - decay))),
                             [d.double() for d in decayed])
    return [o.float() for o in out]


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               momentum: float) -> None:
    """Polyak averaging in place: ema = momentum * ema + (1 - momentum) *
    params; momentum >= 1 copies the parameters."""
    names = list(ema_params)
    ema = [ema_params[n] for n in names]
    new = [params[n].detach() for n in names]
    if momentum >= 1.0:
        torch._foreach_copy_(ema, new)
        return
    torch._foreach_copy_(ema, torch._foreach_add(torch._foreach_mul(ema, momentum),
                                                 torch._foreach_mul(new, 1.0 - momentum)))


@torch.no_grad()
def project_kernel_norms(params: Dict[str, torch.Tensor], max_norm: float) -> None:
    """Max-norm projection in place of the conv kernels [O, I, kh, kw]
    (depthwise [E, 1, kh, kw] too) under `backbone` (all of them if none is):
    each output channel's norm over dims 1-3 is clipped to `max_norm`."""
    names = [n for n in params if n.split('.')[0] == BACKBONE] or list(params)
    for name in names:
        x = params[name]
        if x.ndim != 4:
            continue
        xf = x.float()
        norms = torch.sqrt(torch.sum(xf * xf, dim=(1, 2, 3), keepdim=True))
        scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
        x.copy_((xf * scale).to(x.dtype))

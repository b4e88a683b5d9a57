"""Cosine annealing with warm restarts, stepped per epoch (port of
``nbody_gnn_hpc_tpu/train/schedule.py``).

Parity target: torch ``CosineAnnealingWarmRestarts(T_0=20, T_mult=2,
eta_min=1e-6)`` stepped once per epoch (reference ``train.py:368-370,503``):

    lr(epoch) = eta_min + (base - eta_min) * (1 + cos(pi * T_cur / T_i)) / 2

with restarts at epochs 20, 60, 140, ...
"""

import math


def cosine_warm_restarts(epoch: int, base_lr: float, t_0: int = 20,
                         t_mult: int = 2, eta_min: float = 1e-6) -> float:
    """LR at integer ``epoch`` (0-indexed: epoch 0 uses lr=base)."""
    if t_mult == 1:
        t_cur, t_i = epoch % t_0, t_0
    else:
        # Cycle c: the largest with t_0*(t_mult^c - 1)/(t_mult - 1) <= epoch;
        # the epsilon keeps an exact power of t_mult from rounding below.
        ratio = epoch * (t_mult - 1) / t_0 + 1
        c = int(math.floor(math.log(ratio, t_mult) + 1e-9))
        cum = t_0 * (t_mult ** c - 1) // (t_mult - 1)
        t_cur, t_i = epoch - cum, t_0 * t_mult ** c
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur
                                                         / t_i)) / 2


def make_step_schedule(base_lr: float, steps_per_epoch: int, t_0: int = 20,
                       t_mult: int = 2, eta_min: float = 1e-6):
    """Optimizer step count -> LR, constant within each epoch; the first
    step (count 0) runs at the base LR, as optax counts."""
    spe = max(1, int(steps_per_epoch))

    def schedule(count: int) -> float:
        return cosine_warm_restarts(int(count) // spe, base_lr, t_0, t_mult,
                                    eta_min)

    return schedule

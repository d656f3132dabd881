"""Learning-rate schedules (JAX counterpart: ``deepfluoro_tpu/train/
schedules.py``, copied: it is pure Python).

- WarmRestartLR: SGDR cosine annealing with warm restarts (arXiv 1608.03983),
  including the two features the reference added over stock schedulers
  (warm_restarts_lr.py:1-3): a period growth factor applied at each restart
  and *intra-epoch* fractional stepping driven from the train loop
  (warm_restarts_lr.py:32-36, called at train.py:427-428).
- ReduceLROnPlateau: min-mode plateau decay with patience + cooldown,
  matching the construction at train.py:339 (factor=0.1).

These are small host-side state machines (the LR is set on the optimizer
before each step); their ``state_dict``/``load_state_dict`` payloads
serialize into checkpoints like the reference's scheduler state
(train.py:479,:358).
"""

from __future__ import annotations

import math


class WarmRestartLR:
    def __init__(
        self,
        base_lr: float,
        init_run_period_epochs: int = 10,
        lr_min: float = 0.0,
        last_epoch: int = -1,
        growth_factor: int = 2,
    ):
        self.base_lr = base_lr
        self.lr_min = lr_min
        self.cur_run_period_epochs = init_run_period_epochs
        self.next_restart_epoch = init_run_period_epochs
        self.last_restart_epoch = last_epoch if last_epoch >= 0 else 0
        self.period_growth_factor = growth_factor
        self.cur_epoch_ratio = 0.0
        self.just_restarted = False
        self.last_epoch = last_epoch if last_epoch >= 0 else 0

    def get_lr(self) -> float:
        """Cosine LR at (last_epoch + cur_epoch_ratio) within the current
        period (warm_restarts_lr.py:56-63)."""
        assert -1.0e-12 < self.cur_epoch_ratio < 1 + 1.0e-12
        shift_cos = 1 + math.cos(
            math.pi
            * (self.last_epoch - self.last_restart_epoch + self.cur_epoch_ratio)
            / self.cur_run_period_epochs
        )
        return self.lr_min + ((self.base_lr - self.lr_min) / 2) * shift_cos

    def intra_epoch_step(self, epoch_ratio: float) -> float:
        """Fractional step inside an epoch; returns the new LR
        (warm_restarts_lr.py:32-36)."""
        self.cur_epoch_ratio = epoch_ratio
        return self.get_lr()

    def step(self) -> None:
        """End-of-epoch step; sets just_restarted when a restart boundary is
        crossed (warm_restarts_lr.py:38-54)."""
        self.cur_epoch_ratio = 0.0
        self.last_epoch += 1
        if self.last_epoch >= self.next_restart_epoch:
            print(
                "WARM RESTART AFTER PERIOD OF {} EPOCHS".format(self.cur_run_period_epochs)
            )
            self.last_restart_epoch = self.next_restart_epoch
            self.cur_run_period_epochs *= self.period_growth_factor
            self.next_restart_epoch += self.cur_run_period_epochs
            self.just_restarted = True
        else:
            self.just_restarted = False

    def state_dict(self) -> dict:
        return {
            "base_lr": self.base_lr,
            "lr_min": self.lr_min,
            "cur_run_period_epochs": self.cur_run_period_epochs,
            "next_restart_epoch": self.next_restart_epoch,
            "last_restart_epoch": self.last_restart_epoch,
            "period_growth_factor": self.period_growth_factor,
            "cur_epoch_ratio": self.cur_epoch_ratio,
            "just_restarted": self.just_restarted,
            "last_epoch": self.last_epoch,
        }

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


class ReduceLROnPlateau:
    """Min-mode plateau LR decay (torch semantics; train.py:339:
    factor=0.1, configurable patience/cooldown, no threshold subtleties —
    torch default threshold 1e-4 rel is replicated)."""

    def __init__(
        self,
        base_lr: float,
        factor: float = 0.1,
        patience: int = 20,
        cooldown: int = 20,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.cooldown = cooldown
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def get_lr(self) -> float:
        return self.lr

    def step(self, metric: float) -> float:
        # torch 'rel' threshold mode for mode='min'
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if new_lr < self.lr:
                print("Reducing learning rate to {:.4e}".format(new_lr))
            self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "factor": self.factor,
            "patience": self.patience,
            "cooldown": self.cooldown,
            "threshold": self.threshold,
            "min_lr": self.min_lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)

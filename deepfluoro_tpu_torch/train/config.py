"""Training configuration (JAX counterpart: ``deepfluoro_tpu/train/
config.py``): one dataclass that is the CLI surface, the architecture spec
and the checkpoint metadata, under the reference's key names
(train.py:475-513) so the JAX package and the reference read this port's
checkpoints.
"""

from __future__ import annotations

import dataclasses

import torch

from deepfluoro_tpu_torch.models.unet import UNet


@dataclasses.dataclass
class TrainConfig:
    num_classes: int = 7
    batch_size: int = 1
    proj_unet_dim: int = 364  # --unet-img-dim; reflect-pad target
    optim_type: str = "sgd"
    init_lr: float = 1.0e-2
    nesterov: bool = False
    momentum: float = 0.9
    wgt_decay: float = 0.0
    lr_sched_meth: str = "cos"  # 'cos' | 'plateau' | 'none'
    lr_patience: int = 20
    lr_cooldown: int = 20
    lrs_num_epochs: int = 10  # --cos-anneal-epochs
    lrs_growth_factor: int = 2  # --cos-growth
    max_num_restarts: int = -1
    save_after_n_restarts: int = 0
    save_restart_net_prefix: str | None = None  # pre-warm-restart snapshots <prefix>_RR.pt
    max_num_epochs: int = 200
    max_hours: float = -1.0  # wall-clock budget; <= 0 disables
    depth: int = 5  # --unet-num-lvls
    init_feats_exp: int = 4  # --unet-init-feats-exp (wf)
    batch_norm: bool = False
    padding: bool = False
    no_max_pool: bool = False
    block_depth: int = 2
    use_res: bool = True
    data_aug: bool = False
    num_lands: int = 0
    heat_coeff: float = 0.5
    use_dice_valid: bool = False
    train_valid_split: float = -1.0
    checkpoint_freq: int = 1
    save_best_valid: bool = True
    # best-valid and pre-restart files hold meta, weights and BatchNorm
    # statistics only (no optimizer or scheduler state)
    light_best_nets: bool = False
    seed: int = 0
    # 'float32' | 'bfloat16': convolutions and BatchNorm in bfloat16 under
    # autocast; weights, statistics, softmax, heatmaps and losses float32
    compute_dtype: str = "float32"
    # recompute each U-Net block's activations in backward
    # (models/unet.py::UNet.remat): less activation memory for about one
    # extra forward; results equal up to float reassociation
    remat: bool = False
    # append a left/right mirror of every training sample, after the split
    # (data/hdf5.py::lr_flip_duplicate)
    dup_lr_flip: bool = False

    _META_KEYS = {
        "num-classes": "num_classes",
        "optim-type": "optim_type",
        "depth": "depth",
        "init-feats-exp": "init_feats_exp",
        "batch-norm": "batch_norm",
        "padding": "padding",
        "no-max-pool": "no_max_pool",
        "pad-img-size": "proj_unet_dim",
        "batch-size": "batch_size",
        "data-aug": "data_aug",
        "opt-nesterov": "nesterov",
        "opt-momentum": "momentum",
        "opt-wgt-decay": "wgt_decay",
        "num-lands": "num_lands",
        "heat-coeff": "heat_coeff",
        "use-dice-valid": "use_dice_valid",
        "unet-use-res": "use_res",
        "unet-block-depth": "block_depth",
        "lrs-meth": "lr_sched_meth",
        "lrs-num-epochs": "lrs_num_epochs",
        "lrs-growth-factor": "lrs_growth_factor",
        "lrs-max-num-restarts": "max_num_restarts",
        "lrs-save-restart-net-prefix": "save_restart_net_prefix",
        "lrs-save-after-n-restarts": "save_after_n_restarts",
        "lrs-patience": "lr_patience",
        "lrs-cooldown": "lr_cooldown",
        "checkpoint-freq": "checkpoint_freq",
        "save-best-valid": "save_best_valid",
        "light-best-nets": "light_best_nets",
        "init-lr": "init_lr",
        "compute-dtype": "compute_dtype",
        "remat": "remat",
        "dup-lr-flip": "dup_lr_flip",
    }

    def to_checkpoint_meta(self) -> dict:
        return {k: getattr(self, attr) for k, attr in self._META_KEYS.items()}

    @classmethod
    def from_checkpoint_meta(cls, meta: dict, base: "TrainConfig | None" = None) -> "TrainConfig":
        """Stored keys override; absent ones keep ``base``'s values."""
        cfg = dataclasses.replace(base) if base is not None else cls()
        for k, attr in cls._META_KEYS.items():
            if k in meta:
                setattr(cfg, attr, meta[k])
        return cfg

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be 'float32' or 'bfloat16', got {!r}".format(self.compute_dtype))
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def build_model(cfg: TrainConfig, lands_block_depth: int = 0, lands_num_1x1: int = 2) -> UNet:
    """The U-Net train.py:313 builds from these flags. The landmark head's
    shape is not among them (train.py leaves it at its defaults); a loader
    passes the shape a checkpoint's keys show."""
    return UNet(
        n_classes=cfg.num_classes,
        depth=cfg.depth,
        wf=cfg.init_feats_exp,
        padding=cfg.padding,
        batch_norm=cfg.batch_norm,
        max_pool=not cfg.no_max_pool,
        num_lands=cfg.num_lands,
        do_res=cfg.use_res,
        block_depth=cfg.block_depth,
        lands_block_depth=lands_block_depth,
        lands_num_1x1=lands_num_1x1,
        dtype=cfg.dtype,
        remat=cfg.remat,
    )

"""Training configuration (JAX counterpart: ``deepfluoro_tpu/train/
config.py``): one dataclass that is the CLI surface, the architecture spec
and the checkpoint metadata, under the reference's key names
(train.py:475-513) so the JAX package and the reference read this port's
checkpoints.

``arch`` picks the network: ``'unet'`` (the recipe's U-Net, the default),
``'transunet'`` (``models/transunet.py``, TransUNet R50-ViT; its sizes
default to R50-ViT-B/16 and its grid is ``proj_unet_dim / 16``),
``'swinunetr'`` (``models/swinunetr.py``, Swin UNETR in 2D; its sizes
default to the published feature size 48) or ``'samed'``
(``models/samed.py``, SAMed: SAM's ViT-B with LoRA, prompt-free, one mask
token per class; its sizes default to ``build_sam_vit_b``'s and its grid
is ``proj_unet_dim / 16``; the ViT-B sizes are TransUNet's fields). None
of the three has a JAX counterpart. A U-Net's checkpoint meta holds the
JAX package's keys and no others; another network's adds ``arch`` and its
own sizes, and a meta without ``arch`` is a U-Net's.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from deepfluoro_tpu_torch.models.samed import SAMed
from deepfluoro_tpu_torch.models.swinunetr import SwinUNETR
from deepfluoro_tpu_torch.models.transunet import TransUNet
from deepfluoro_tpu_torch.models.unet import UNet

ARCHS = ("unet", "transunet", "swinunetr", "samed")
ARCH_NAMES = {"transunet": "TransUNet", "swinunetr": "Swin UNETR", "samed": "SAMed"}


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
    # the network: 'unet', 'transunet', 'swinunetr' or 'samed'; the sizes
    # below are TransUNet's (the first four also SAMed's ViT-B encoder's),
    # then Swin UNETR's, then SAMed's
    arch: str = "unet"
    hidden_size: int = 768
    num_heads: int = 12
    mlp_dim: int = 3072
    num_layers: int = 12
    resnet_units: tuple = (3, 4, 9)
    resnet_width: int = 64
    gn_groups: int = 32
    decoder_channels: tuple = (256, 128, 64, 16)
    feature_size: int = 48
    swin_depths: tuple = (2, 2, 2, 2)
    swin_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    sam_window_size: int = 14
    sam_global_attn_indexes: tuple = (2, 5, 8, 11)
    sam_prompt_dim: int = 256
    sam_decoder_heads: int = 8
    sam_decoder_mlp_dim: int = 2048

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
    # written only for the network they name
    _ARCH_META_KEYS = {
        "transunet": {
            "arch": "arch",
            "vit-hidden-size": "hidden_size",
            "vit-num-heads": "num_heads",
            "vit-mlp-dim": "mlp_dim",
            "vit-num-layers": "num_layers",
            "resnet-units": "resnet_units",
            "resnet-width": "resnet_width",
            "gn-groups": "gn_groups",
            "decoder-channels": "decoder_channels",
        },
        "swinunetr": {
            "arch": "arch",
            "swin-feature-size": "feature_size",
            "swin-depths": "swin_depths",
            "swin-num-heads": "swin_heads",
            "swin-window-size": "window_size",
        },
        "samed": {
            "arch": "arch",
            "vit-hidden-size": "hidden_size",
            "vit-num-heads": "num_heads",
            "vit-mlp-dim": "mlp_dim",
            "vit-num-layers": "num_layers",
            "sam-window-size": "sam_window_size",
            "sam-global-attn-indexes": "sam_global_attn_indexes",
            "sam-prompt-embed-dim": "sam_prompt_dim",
            "sam-decoder-num-heads": "sam_decoder_heads",
            "sam-decoder-mlp-dim": "sam_decoder_mlp_dim",
        },
    }

    def to_checkpoint_meta(self) -> dict:
        keys = dict(self._META_KEYS, **self._ARCH_META_KEYS.get(self.arch, {}))
        meta = {k: getattr(self, attr) for k, attr in keys.items()}
        return {k: list(v) if isinstance(v, tuple) else v for k, v in meta.items()}

    @classmethod
    def from_checkpoint_meta(cls, meta: dict, base: "TrainConfig | None" = None) -> "TrainConfig":
        """Stored keys override; absent ones keep ``base``'s values, but a
        meta without ``arch`` is a U-Net's."""
        cfg = dataclasses.replace(base) if base is not None else cls()
        cfg.arch = "unet"
        keys = dict(cls._META_KEYS)
        for arch_keys in cls._ARCH_META_KEYS.values():
            keys.update(arch_keys)
        for k, attr in keys.items():
            if k in meta:
                setattr(cfg, attr, tuple(meta[k]) if isinstance(meta[k], list) else meta[k])
        return cfg

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be 'float32' or 'bfloat16', got {!r}".format(self.compute_dtype))
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def build_model(cfg: TrainConfig, lands_block_depth: int = 0, lands_num_1x1: int = 2) -> nn.Module:
    """The U-Net train.py:313 builds from these flags, or with ``arch``
    'transunet' a TransUNet, with 'swinunetr' a Swin UNETR and with
    'samed' a SAMed for ``proj_unet_dim``-square inputs (float32, no
    remat). The landmark
    head's shape is not among the flags (train.py leaves it at its
    defaults); a loader passes the shape a checkpoint's keys show."""
    if cfg.arch not in ARCHS:
        raise ValueError("arch must be one of {}, got {!r}".format(", ".join(ARCHS), cfg.arch))
    if cfg.arch != "unet" and (cfg.dtype != torch.float32 or cfg.remat or lands_block_depth):
        raise ValueError("{} runs in float32 without remat and with a 1x1 landmark head".format(ARCH_NAMES[cfg.arch]))
    if cfg.arch == "transunet":
        return TransUNet(
            n_classes=cfg.num_classes, size=cfg.proj_unet_dim, num_lands=cfg.num_lands, hidden=cfg.hidden_size,
            heads=cfg.num_heads, mlp_dim=cfg.mlp_dim, layers=cfg.num_layers, units=tuple(cfg.resnet_units),
            width=cfg.resnet_width, groups=cfg.gn_groups, decoder_channels=tuple(cfg.decoder_channels),
            lands_num_1x1=lands_num_1x1,
        )
    if cfg.arch == "swinunetr":
        return SwinUNETR(
            n_classes=cfg.num_classes, size=cfg.proj_unet_dim, num_lands=cfg.num_lands, feature_size=cfg.feature_size,
            depths=tuple(cfg.swin_depths), heads=tuple(cfg.swin_heads), window=cfg.window_size,
            lands_num_1x1=lands_num_1x1,
        )
    if cfg.arch == "samed":
        return SAMed(
            n_classes=cfg.num_classes, size=cfg.proj_unet_dim, num_lands=cfg.num_lands, embed_dim=cfg.hidden_size,
            depth=cfg.num_layers, heads=cfg.num_heads, mlp_dim=cfg.mlp_dim, window=cfg.sam_window_size,
            global_attn_indexes=tuple(cfg.sam_global_attn_indexes), prompt_dim=cfg.sam_prompt_dim,
            decoder_heads=cfg.sam_decoder_heads, decoder_mlp_dim=cfg.sam_decoder_mlp_dim,
            lands_num_1x1=lands_num_1x1,
        )
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

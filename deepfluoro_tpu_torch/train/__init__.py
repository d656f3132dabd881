from deepfluoro_tpu_torch.train.config import TrainConfig, build_model
from deepfluoro_tpu_torch.train.schedules import ReduceLROnPlateau, WarmRestartLR
from deepfluoro_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from deepfluoro_tpu_torch.train.step import eval_losses, make_optimizer, train_step
from deepfluoro_tpu_torch.train.loop import fit
from deepfluoro_tpu_torch.train.multifold import fit_multifold
from deepfluoro_tpu_torch.train.sharded_checkpoint import load_sharded_checkpoint, save_sharded_checkpoint

__all__ = [
    "TrainConfig", "build_model", "ReduceLROnPlateau", "WarmRestartLR", "load_checkpoint",
    "save_checkpoint", "eval_losses", "make_optimizer", "train_step", "fit", "fit_multifold",
    "load_sharded_checkpoint", "save_sharded_checkpoint",
]

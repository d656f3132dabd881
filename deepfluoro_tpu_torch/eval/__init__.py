from deepfluoro_tpu_torch.eval.dice import hard_dice, write_dice_csv
from deepfluoro_tpu_torch.eval.landmarks import (
    SEG_LABELS_TO_USE_FOR_LANDS,
    detect_landmarks,
    detect_landmarks_timed,
    write_landmarks_csv,
)

__all__ = [
    "SEG_LABELS_TO_USE_FOR_LANDS",
    "detect_landmarks",
    "detect_landmarks_timed",
    "hard_dice",
    "write_dice_csv",
    "write_landmarks_csv",
]

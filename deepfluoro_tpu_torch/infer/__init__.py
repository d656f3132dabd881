from deepfluoro_tpu_torch.infer.ensemble import (
    ensemble_batches,
    ensemble_forward,
    load_net_from_checkpoint,
    seg_dataset,
    seg_dataset_ensemble,
    test_dataset_ensemble,
    write_ensemble_outputs,
)

__all__ = [
    "ensemble_batches",
    "ensemble_forward",
    "load_net_from_checkpoint",
    "seg_dataset",
    "seg_dataset_ensemble",
    "test_dataset_ensemble",
    "write_ensemble_outputs",
]

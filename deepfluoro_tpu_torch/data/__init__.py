from deepfluoro_tpu_torch.data.hdf5 import FluoroData, load_dataset, split_train_valid
from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.data.pipeline import BatchIterator, PrefetchIterator

__all__ = ["FluoroData", "load_dataset", "split_train_valid", "AugmentConfig", "prepare_batch", "BatchIterator", "PrefetchIterator"]

from deepfluoro_tpu_torch.utils.io import RunningFloatWriter, read_floats_from_txt, write_floats_to_txt
from deepfluoro_tpu_torch.utils.platform import get_device

__all__ = ["RunningFloatWriter", "get_device", "read_floats_from_txt", "write_floats_to_txt"]

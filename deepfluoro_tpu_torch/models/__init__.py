from deepfluoro_tpu_torch.models.unet import UNet, UNetConvBlock, UNetUpBlock

__all__ = ["UNet", "UNetConvBlock", "UNetUpBlock"]

from stroke_prediction_tpu_torch.models.unet3d import (  # noqa: F401
    LargeUnet3D, Unet3D)

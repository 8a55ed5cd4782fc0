from stroke_prediction_tpu_torch.models.unet3d import Unet3D  # noqa: F401

"""stroke_prediction_tpu_torch — the PyTorch / CUDA port of stroke_prediction_tpu.

The JAX package beside it stays the reference; this package re-implements
its modules in PyTorch, module for module (same names, same public
channels-last ``(B, D, H, W, C)`` layout, conv kernels ``(3, 3, 3, C_in,
C_out)``), and replaces each Pallas TPU kernel by a CUDA C++ kernel written
for Hopper (``ops/csrc``), bound through ``ctypes``.

Ported so far: U-Net training (``cli.train_unet_segmentation``),
full-volume U-Net testing (``cli.test_unet_segmentation``) and the CAE
shape testers (``cli.test_shape_reconstruction`` and its
``_CurveAnalysis`` twin), with the fused 3x3x3 conv forward and backward
(``ops.conv3x3``) and the separable EDT (``ops.edt``) as hand-written
kernels.  Entry points run on ``cuda`` unless
the caller asks for ``cpu``; on CPU tensors every kernel wrapper runs its
plain PyTorch version.

The package imports neither JAX nor anything of ``stroke_prediction_tpu``.
"""

__version__ = "0.1.0"

"""Device ops over channels-last volumes.

Hand-written CUDA kernels (``csrc/``, built by ``_build``) sit behind
wrappers that run their plain PyTorch version on CPU tensors:

* :mod:`.conv3x3` — K1, the fused 3x3x3 conv + bias + activation forward,
  and K2-K4, its backward (fused dx + dW, dx alone, dW alone);
* :mod:`.edt` — K5, the exact separable EDT (two kernels: the nearest-site
  scan along D with the parabola pass along H, then the pass along W with
  the sqrt).

:mod:`.resize` and :mod:`.pooling` are plain PyTorch.
"""

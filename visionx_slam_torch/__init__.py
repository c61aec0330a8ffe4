"""VisionX-SLAM in PyTorch: the port of ``visionx_slam_tpu`` to CUDA.

Mirrors the JAX package's layout and names (ops/, models/, tracking/, data/,
eval/, utils/) so each function has an obvious counterpart; the JAX package
is the reference every module here is tested against. This package imports
neither jax nor cv2 nor ``visionx_slam_tpu``.

Functions take tensors with explicit batch dimensions; the device is the
device of the tensors (entry points take a ``device`` argument). The
hand-written kernels, K1 and its score-only form K1b
(``csrc/fast_harris_blur.cu``), are built with nvcc at first use.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (Procrustes, Gauss-Newton normal equations, Schur solves) is
# float32 and precision-critical: TF32 keeps ~3 decimal digits and corrupts
# it. Pin full-precision float32 for matmuls and cuDNN alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

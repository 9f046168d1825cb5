"""MultiMotionFusion in PyTorch + CUDA for one NVIDIA H100.

The port of ``multimotionfusion_tpu`` (the JAX reference package, which it
never imports). It covers the static (ElasticFusion-style) frame step with
every pose initialisation (``odom_init`` "kp", the default, "tf" and ""):
``engine.MultiMotionFusionTorch(cfg, device="cuda")``. Hand-written CUDA
kernels under ``csrc/`` carry its per-pixel, per-surfel and per-keypoint work
(K1-K10 and the sparse keypoint pipeline K19-K21); the rest is PyTorch glue
on 4x4 poses and 0-dim scalars.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and the normal equations must not round through TF32 (about three
# decimal digits): f32 matmuls and convolutions stay full precision, the
# counterpart of the reference package pinning its matmuls to "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig, OdometryConfig  # noqa: E402,F401

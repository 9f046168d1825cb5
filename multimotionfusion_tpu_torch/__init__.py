"""MultiMotionFusion in PyTorch + CUDA for one NVIDIA H100.

The port of ``multimotionfusion_tpu`` (the JAX reference package, which it
never imports). This slice covers the static (ElasticFusion-style) frame step:
``engine.MultiMotionFusionTorch(cfg, device="cuda")``. Four hand-written CUDA
kernels under ``csrc/`` carry its per-pixel and per-surfel work (GN reduction,
z-buffer, fusion, splat resolve); the rest is plain PyTorch.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and the normal equations must not round through TF32 (about three
# decimal digits): f32 matmuls and convolutions stay full precision, the
# counterpart of the reference package pinning its matmuls to "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from multimotionfusion_tpu_torch.config import CameraModel, EngineConfig, OdometryConfig  # noqa: E402,F401

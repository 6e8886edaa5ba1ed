"""Stereo point+line visual odometry in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``gfplslam_tpu`` (the reference, kept beside it).
Module layout and names mirror the reference file for file, so
``gfplslam_torch/models/frame.py::process_stereo_pair`` does what
``gfplslam_tpu/models/frame.py::process_stereo_pair`` does. Plain tensor code
is PyTorch; the reference's two Pallas kernels (FAST-9 score map, Hamming
distance matrix) are hand-written CUDA C++ under ``csrc/``, built at first use
(``ops/kernels.py``). On a CPU tensor every op takes its plain PyTorch path.

The caller names the device at the entry points
(``run_vo_scan(..., device=...)``, ``VisualOdometry(cfg, device=...)``);
nothing here picks one.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and the 6x6 solvers need true fp32 products (the reference sets
# jax_default_matmul_precision="highest" for the same reason): TF32 keeps
# about three decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from gfplslam_torch.config import Config, default_config  # noqa: F401,E402

"""tc2li_slam_torch — the PyTorch/CUDA port of tc2li_slam_tpu.

The STEREO_LIDAR mode of the JAX package (ORB stereo tracking,
camera-pose-driven LiDAR voxel map, keyframe landmarks, triangulated new
map points, local BA with the BALM plane eigen-factor, keyframe culling,
tracking recovery by PnP RANSAC, bag-of-words relocalization and the
multi-map atlas), written as plain functions on torch tensors for one
NVIDIA H100. The TPU-shaped kernels of that path, the FAST-9/16 detection,
the masked best-two descriptor match and the Hamming distance matrix, are
hand-written CUDA (``csrc/``) built at first use; each keeps a plain
PyTorch version that runs for CPU tensors only.

Subpackages mirror the JAX layout: ``geom``, ``ops`` (+ ``ops/kernels``),
``solver``, ``slam``, ``io``. The package never imports jax or
``tc2li_slam_tpu``; ``interop`` converts the JAX package's state containers
(as numpy arrays) into this package's.

The solver paths are float32 like the reference: TF32 is switched off for
matrix products and convolutions when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

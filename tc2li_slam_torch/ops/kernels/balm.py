"""The BALM eigen-factor's quadratic: one hand-written CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/solver/balm.py:quadratic`` (line 303), which the
TPU runs as one jit-compiled ``jax.hessian`` of the closed-form cost
``sum_v valid_v N_v lambda_min(cov_v)`` over the window's LiDAR pose
tangents. Written as eager PyTorch (``quadratic_plain``, through
``torch.func.hessian``) one call issues ~2,100 small ops; the window BA
takes two a pass.

Bound on the H100: latency. At V = 512 voxels and W = 6 poses a call reads
160 KB and does ~2.5 M float operations; the kernel (``csrc/balm.cu``)
writes the derivatives in closed form, takes the eigenvalue's gradient and
Hessian by second-order forward-mode arithmetic on one thread a voxel, and
sums the voxels' terms in a fixed order, so the same inputs give the same
bits. Against ``jax.hessian`` the chain agrees to ~1e-5 of the largest entry in
float32 (the chain emulated in numpy in ``tests/test_torch_local_ba.py``).

``balm_quadratic`` launches the kernel (CUDA tensors only);
``solver.balm.quadratic`` sends CUDA tensors there and CPU tensors to
``quadratic_plain``; there is no other route.
"""

from __future__ import annotations

import torch
from torch.func import grad_and_value, hessian

from ...solver import balm as balm_mod
from . import build

launches = 0   # kernel launches by balm_quadratic (plain-version calls excluded)
MAX_WINDOW = 16   # csrc/balm.cu kMaxW
_counters: dict[torch.device, torch.Tensor] = {}   # the kernel's block counter, left at 0


def quadratic_plain(c, T_wl):
    """Exact gradient + Hessian of the eigen cost at the current poses
    (right perturbation per pose)."""
    W = T_wl.shape[0]
    xi0 = torch.zeros(W * 6, dtype=T_wl.dtype, device=T_wl.device)
    g, cost = grad_and_value(balm_mod._cost_of_tangent)(xi0, c, T_wl)
    H = hessian(balm_mod._cost_of_tangent)(xi0, c, T_wl)
    return balm_mod.BalmQuad(H, g, cost)


def balm_quadratic(c, T_wl):
    """Launch ``csrc/balm.cu`` on the current stream: what ``quadratic_plain``
    computes, in one launch."""
    global launches
    V, W = c.N.shape
    dev = T_wl.device
    for x in (c.N, c.mean, c.Pc, c.center, c.valid, T_wl):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"balm_quadratic: every tensor must lie on one CUDA device, got "
                             f"{x.device} beside {dev}")
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"balm_quadratic: window of {W} poses, the kernel takes 1 to "
                         f"{MAX_WINDOW}")
    for name, x, shape in (("N", c.N, (V, W)), ("mean", c.mean, (V, W, 3)),
                           ("Pc", c.Pc, (V, W, 3, 3)), ("center", c.center, (V, 3)),
                           ("T_wl", T_wl, (W, 4, 4))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"balm_quadratic: {name} must be float32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if tuple(c.valid.shape) != (V,) or c.valid.dtype != torch.bool:
        raise ValueError(f"balm_quadratic: valid must be bool [{V}], got {c.valid.dtype} "
                         f"{tuple(c.valid.shape)}")
    lib = build.library()
    N, mean, Pc, center, T = (x.contiguous() for x in (c.N, c.mean, c.Pc, c.center, T_wl))
    valid = c.valid.contiguous().view(torch.uint8)
    D = 6 * W
    partial = torch.empty((lib.tc2li_balm_blocks(V), D * D + D + 1), dtype=torch.float32,
                          device=dev)
    counter = _counters.get(dev)
    if counter is None:
        counter = _counters[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    H = torch.empty((D, D), dtype=torch.float32, device=dev)
    g = torch.empty(D, dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_balm_quadratic(
        N.data_ptr(), mean.data_ptr(), Pc.data_ptr(), center.data_ptr(), valid.data_ptr(),
        T.data_ptr(), V, W, partial.data_ptr(), counter.data_ptr(), H.data_ptr(), g.data_ptr(),
        cost.data_ptr(), stream), "balm_quadratic")
    launches += 1
    return balm_mod.BalmQuad(H, g, cost)

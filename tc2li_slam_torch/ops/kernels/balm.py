"""The BALM eigen-factor's quadratic: one hand-written CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/solver/balm.py:quadratic`` (line 303), which the
TPU runs as one jit-compiled ``jax.hessian`` of the closed-form cost
``sum_v valid_v N_v lambda_min(cov_v)`` over the window's LiDAR pose
tangents. Written as eager PyTorch (``quadratic_plain``, through
``torch.func.hessian``) one call issues ~2,100 small ops; the window BA
takes two a pass.

Bound on the H100: latency. At V = 512 voxels and W = 6 poses a call reads
160 KB and does ~2.5 M float operations; the kernel (``csrc/balm.cu``)
writes the derivatives in closed form and takes the eigenvalue's gradient
and Hessian by second-order forward-mode arithmetic, in two launches: a
block a chunk of ``CHUNK`` voxel slots (all at once) computes its valid
voxels' factors and the chunk's partial sums of (H, g, cost), then each
block adds 32 entries' partial sums over ``GROUPS`` runs of chunks, the runs
in order, so the same inputs give the same bits.
Against ``jax.hessian`` the chain agrees to ~1e-5 of the largest entry in
float32 (the chain emulated in numpy in ``tests/test_torch_local_ba.py``,
its order of sums in ``tests/test_torch_balm_emulation.py``).

``balm_quadratic`` launches the kernel (CUDA tensors only);
``solver.balm.quadratic`` sends CUDA tensors there and CPU tensors to
``quadratic_plain``; there is no other route.
"""

from __future__ import annotations

import torch
from torch.func import grad_and_value, hessian

from ...solver import balm as balm_mod
from . import build

launches = 0   # balm_quadratic calls, two device launches each (plain-version calls excluded)
MAX_WINDOW = 16   # csrc/balm.cu kMaxW
CHUNK = 4         # csrc/balm.cu kChunk: the voxel slots a partial sum adds, in slot order
GROUPS = 32       # ... kGroups: the runs of chunks an entry's sum adds, each in order


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
    computes, in two launches."""
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
    contig = lambda x: x if x.is_contiguous() else x.contiguous()
    N, mean, Pc, center, T = (contig(x) for x in (c.N, c.mean, c.Pc, c.center, T_wl))
    D = 6 * W
    # one allocation: the chunks' partial sums, then H, g and the cost
    S = scratch_floats(V, W)
    partial, H, g, cost = torch.empty(S + D * D + D + 1, dtype=torch.float32,
                                      device=dev).split([S, D * D, D, 1])
    build.check(build.library().tc2li_balm_quadratic(
        N.data_ptr(), mean.data_ptr(), Pc.data_ptr(), center.data_ptr(),
        contig(c.valid).view(torch.uint8).data_ptr(), T.data_ptr(), V, W, partial.data_ptr(),
        H.data_ptr(), g.data_ptr(), cost.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "balm_quadratic")
    launches += 1
    return balm_mod.BalmQuad(H.view(D, D), g, cost.view(()))


def scratch_floats(V: int, W: int) -> int:
    """Floats of ``csrc/balm.cu``'s scratch: the partial sums of (H, g, cost)
    of each chunk of ``CHUNK`` voxel slots."""
    D = 6 * W
    return -(-V // CHUNK) * (D * D + D + 1)

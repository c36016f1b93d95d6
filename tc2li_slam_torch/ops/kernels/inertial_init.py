"""The visual-inertial initialization's Gauss-Newton: one hand-written CUDA
kernel + its plain version.

Replaces ``tc2li_slam_tpu/solver/inertial_init.py:inertial_optimization``
(line 85, its ``lax.scan`` :184), one jit-compiled program on the TPU: the
EdgeInertialGS bundle over fixed keyframe poses (gravity direction,
log-scale, one shared gyro and accel bias, K velocities; 9 + 3K unknowns,
K - 1 preintegration factors and two bias priors). Written as eager PyTorch
(``inertial_init_plain``) a call is ``torch.func.jacfwd`` of the whitened
residual vector and a dense solve in a Python loop of ``iters`` steps, at the
visual-inertial initialization and at each VIBA rung (K 20: ``System``
pads its window to 20 keyframes).

Bound on the H100: latency. At K 20, 20 iterations a call reads ~13 KB and
does ~7 M float64 operations; its steps are serial. ``csrc/inertial_init.cu``
runs the whole call in one launch of one block on the current stream, no
host sync and no atomics in a float sum (the same bits on every call): the
Cholesky whitening of each factor, the entry cost, then an iteration's
Jacobian by forward-mode dual numbers (a thread a factor and local column:
jacfwd's derivative of the residual as written), H and g an entry a thread
summed over the 15x15 blocks in factor order, the priors, the frozen rows,
the damping, the Jacobi scaling, Gauss-Jordan with partial pivoting, the
candidate's cost and the accept test. Everything after the float32 inputs is
float64, so the kernel is nearer the float64 run of the plain version than
the float32 run is. The system and the factors live in one block's shared
memory: K above ``MAX_KF`` is refused.

``inertial_init_gn`` launches the kernel (CUDA tensors only);
``solver.inertial_init.inertial_optimization`` sends CUDA tensors there and
CPU tensors to ``inertial_init_plain``; there is no other route.
"""

from __future__ import annotations

import torch

from ...geom import lie
from ...solver import inertial_init as ii
from ...solver.lm import precond_solve
from ...tensors import axis_vector, matvec
from . import build

launches = 0          # kernel launches by inertial_init_gn (plain-version calls excluded)
SMEM_LIMIT = 232448   # shared memory a block can use on the H100
FACTOR_DOUBLES = 170  # a factor's row in shared memory (kQ)
# what inertial_init_gn reads, in the kernel's argument order: (name, shape
# after the leading K or K - 1)
FIELDS = (("T_wb", (4, 4)), ("dR", (3, 3)), ("dV", (3,)), ("dP", (3,)), ("JRg", (3, 3)),
          ("JVg", (3, 3)), ("JVa", (3, 3)), ("JPg", (3, 3)), ("JPa", (3, 3)), ("dt", ()),
          ("C_inv", (9, 9)), ("bg_lin", (3,)), ("ba_lin", (3,)), ("valid", ()))


def smem_bytes(K: int) -> int:
    """Dynamic shared memory of a call with K keyframes (csrc/inertial_init.cu
    smem_of): the system [n, n + 1] (n = 9 + 3K), x, the candidate and the
    scaling [n] each, a factor's row, whitened block [9, 15], residual and
    cost a factor, R_wg0, the row permutation (two int arrays [n])."""
    n, F = 9 + 3 * K, K - 1
    return 8 * (n * (n + 1) + 3 * n + F * (FACTOR_DOUBLES + 135 + 9 + 1) + 9) + 4 * 2 * n


# the largest K whose call fits a block's shared memory (with the kernel's
# few static scalars): csrc/inertial_init.cu kMaxKF
MAX_KF = max(K for K in range(1, 64) if smem_bytes(K) + 64 <= SMEM_LIMIT)


def inertial_init_plain(T_wb, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dt, C_inv, bg_lin, ba_lin,
                        valid, R_wg0, vel0, prior_g: float = 1e2, prior_a: float = 1e6,
                        fix_scale: bool = True, fix_gravity: bool = False,
                        iters: int = 20):
    """The EdgeInertialGS bundle (``solver.inertial_init.inertial_optimization``'s
    arguments) as eager tensor ops: damped Gauss-Newton on the Jacobian of
    the whitened residual vector by ``torch.func.jacfwd``."""
    K = T_wb.shape[0]
    R_wb, p_wb = T_wb[:, :3, :3], T_wb[:, :3, 3]
    dtype, dev = T_wb.dtype, T_wb.device
    n_x = 9 + 3 * K
    # layout: x[0:2] gravity tangent, x[2] log-scale, x[3:6] bg, x[6:9] ba,
    # x[9:] velocities
    x = torch.cat([torch.zeros(9, dtype=dtype, device=dev), vel0.reshape(-1)])
    sqrt_pg, sqrt_pa = float(prior_g) ** 0.5, float(prior_a) ** 0.5
    g_I = axis_vector(2, -ii.G_MAG, dev, dtype)
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    eyeN = torch.eye(n_x, dtype=dtype, device=dev)
    # whitening by the Cholesky factor of the preintegration information
    Lt = torch.linalg.cholesky_ex(C_inv + 1e-6 * eye9, check_errors=False)[0].transpose(-1, -2)
    vw = valid.to(dtype)[:, None]
    R1t = R_wb[:-1].transpose(-1, -2)
    dp12 = p_wb[1:] - p_wb[:-1]
    dt1 = dt[:, None]
    # coordinates held fixed: their rows and columns of H become the identity
    frozen = ([2] if fix_scale else []) + ([0, 1] if fix_gravity else [])
    keep = torch.ones(n_x, dtype=dtype, device=dev)
    for c in frozen:
        keep[c:c + 1].fill_(0.0)   # (a scalar assigned to one slot is a host copy)

    def residuals(x):
        # (leading axes of one keep 0-d tensors out of the differentiated
        # code: under torch.func they take a Python scalar's float64)
        phi = torch.cat([x[0:2], torch.zeros(1, dtype=dtype, device=dev)])[None]
        g_w = (R_wg0 @ lie.so3_exp(phi)[0]) @ g_I        # VertexGDir 2-dof update
        s = 1.0 if fix_scale else torch.exp(x[2:3])
        bg, ba = x[3:6], x[6:9]
        vel = x[9:].reshape(K, 3)
        v1, v2 = vel[:-1], vel[1:]
        # exact bias re-correction of the preintegrated deltas
        dbg, dba = bg - bg_lin, ba - ba_lin
        dR_c = dR @ lie.so3_exp(matvec(JRg, dbg))
        dV_c = dV + matvec(JVg, dbg) + matvec(JVa, dba)
        dP_c = dP + matvec(JPg, dbg) + matvec(JPa, dba)
        er = lie.so3_log(dR_c.transpose(-1, -2) @ R1t @ R_wb[1:])
        ev = matvec(R1t, s * (v2 - v1) - g_w * dt1) - dV_c
        ep = matvec(R1t, s * (dp12 - v1 * dt1) - 0.5 * g_w * dt1 * dt1) - dP_c
        r_fac = matvec(Lt, torch.cat([er, ev, ep], dim=-1)) * vw
        return torch.cat([r_fac.reshape(-1), sqrt_pg * bg, sqrt_pa * ba])

    def cost_of(x):
        return torch.sum(residuals(x) ** 2)

    jac = torch.func.jacfwd(residuals)
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    cost = cost_of(x)
    for _ in range(iters):
        r = residuals(x)
        J = jac(x)
        H = J.T @ J
        g = J.T @ r
        if frozen:
            H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
            g = g * keep
        Haug = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eyeN
        # Jacobi-preconditioned: whitened IMU residual Jacobians are 1e3 and
        # more while the gravity-tangent columns are O(1)
        x_new = x - precond_solve(Haug, g)
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, cost_new, cost)

    phi = torch.cat([x[0:2], torch.zeros(1, dtype=dtype, device=dev)])
    return ii.InertialInitResult(
        R_wg=R_wg0 @ lie.so3_exp(phi),
        scale=torch.ones((), dtype=dtype, device=dev) if fix_scale else torch.exp(x[2]),
        bg=x[3:6], ba=x[6:9], vel=x[9:].reshape(K, 3), cost=cost)


def inertial_init_gn(T_wb, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dt, C_inv, bg_lin, ba_lin,
                     valid, R_wg0, vel0, prior_g: float = 1e2, prior_a: float = 1e6,
                     fix_scale: bool = True, fix_gravity: bool = False,
                     iters: int = 20):
    """Launch ``csrc/inertial_init.cu`` on the current stream: what
    ``inertial_init_plain`` computes, in one launch (the inputs read where
    they lie; the outputs are views of one float32 buffer)."""
    global launches
    K = T_wb.shape[0]
    if not 1 <= K <= MAX_KF or iters < 0:
        raise ValueError(f"inertial_init_gn: K {K} (1 to {MAX_KF}: the kernel's shared "
                         f"memory), iters {iters}")
    F = K - 1
    dev = T_wb.device
    args = dict(zip([name for name, _ in FIELDS], (T_wb, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
                                                    dt, C_inv, bg_lin, ba_lin, valid)))
    for name, x, shape, dtypes in (
            [(name, args[name], ((K,) if name == "T_wb" else (F,)) + tail,
              (torch.bool, torch.uint8) if name == "valid" else (torch.float32,))
             for name, tail in FIELDS]
            + [("R_wg0", R_wg0, (3, 3), (torch.float32,)),
               ("vel0", vel0, (K, 3), (torch.float32,))]):
        if tuple(x.shape) != tuple(shape) or x.dtype not in dtypes:
            raise ValueError(f"inertial_init_gn: {name} must be {dtypes[0]} {tuple(shape)}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"inertial_init_gn: every tensor must lie on one CUDA device, got "
                             f"{x.device} beside {dev}")
    ins = [args[name].contiguous() for name, _ in FIELDS[:-1]]
    val = valid.contiguous()
    val = val.view(torch.uint8) if val.dtype == torch.bool else val
    Rg, v0 = R_wg0.contiguous(), vel0.contiguous()
    out = torch.empty(17 + 3 * K, dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_inertial_init_gn(
        *(x.data_ptr() for x in ins), val.data_ptr(), Rg.data_ptr(), v0.data_ptr(), K,
        float(prior_g), float(prior_a), int(bool(fix_scale)), int(bool(fix_gravity)), int(iters),
        out.data_ptr(), stream), "inertial_init_gn")
    launches += 1
    return ii.InertialInitResult(R_wg=out[:9].view(3, 3), scale=out[9], bg=out[10:13],
                                 ba=out[13:16], vel=out[16:16 + 3 * K].view(K, 3),
                                 cost=out[16 + 3 * K])

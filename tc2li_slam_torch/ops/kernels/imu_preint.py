"""IMU preintegration: one hand-written CUDA kernel + its plain version.

Replaces ``tc2li_slam_tpu/estimation/imu.py:integrate`` (line 83), which the
TPU runs as one jit-compiled ``lax.scan`` over the window's samples (:169).
Written as eager PyTorch (``integrate_plain``) a sample costs ~40 small ops,
each a launch: ~670 device events a preintegration on the IMU mode's frames.

Bound on the H100: latency. A sample reads 28 bytes and costs ~1,100 float
operations (a fused multiply-add counted as one; A C9 A^T on A's block
structure); the plain version's chain over samples is serial.
``csrc/imu_preint.cu`` runs a window in one launch of a cluster of up to 8
blocks: the live samples compacted, cut into chunks of ``max(8, ceil(n /
64))``, each chunk integrated from the identity by one warp in its own
frame, the chunks joined in a fixed tree (the chunk's transition has a
sample's block form; the later chunk moved into the earlier one's frame;
the reference's JPa, which lacks ORB-SLAM3's ``+ JVa dt``, kept). Its
float32 sums run in another order than the plain version's, so it agrees
with it to float32 rounding, not to the bit; it is judged against the
plain version run in float64. A padded sample (``dts <= 0``) is left out
before the chunks are cut, so padding changes no bit of the result; any N.

``estimation/imu.integrate`` sends CUDA tensors to ``imu_preintegrate`` and
CPU tensors to ``integrate_plain``; any other device raises. There is no
other route.
"""

from __future__ import annotations

import torch

from ...estimation import imu as imu_est
from ...geom import lie
from . import build

launches = 0   # kernel launches by imu_preintegrate (plain-version calls excluded)
OUT_FLOATS = 286   # dR, dV, dP, JRg, JVg, JVa, JPg, JPa, C [15, 15], dt


def integrate_plain(calib, gyro, acc, dts, bg, ba):
    """Integrate an IMU window (``IntegrateNewMeasurement``): gyro [N, 3]
    body rates, acc [N, 3] specific force, dts [N] (<= 0 for padding), at
    the linearization biases bg, ba [3].

    Covariance propagation is the discrete A/B form of Forster et al. on
    (dR, dV, dP); the bias random-walk block accumulates on its own."""
    dtype, dev = gyro.dtype, gyro.device
    Ng2, Na2 = calib.sigma_g ** 2, calib.sigma_a ** 2
    Ngw2, Naw2 = calib.sigma_gw ** 2, calib.sigma_aw ** 2
    active = dts > 0
    dts = torch.where(active, dts, 0.0)
    # a padded sample integrates at the bias itself: w_ub = a_ub = 0
    w_ub_all = torch.where(active[:, None], gyro - bg, 0.0)
    a_ub_all = torch.where(active[:, None], acc - ba, 0.0)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    walk = torch.cat([torch.full((3,), Ngw2, dtype=dtype, device=dev),
                      torch.full((3,), Naw2, dtype=dtype, device=dev)])
    noise = torch.cat([torch.full((3,), Ng2, dtype=dtype, device=dev),
                       torch.full((3,), Na2, dtype=dtype, device=dev)])
    Nga_all = noise[None, :] / torch.clamp(dts, min=1e-9)[:, None]     # [N, 6]
    dRi_all = lie.so3_exp(w_ub_all * dts[:, None])                     # [N, 3, 3]
    Jr_all = lie.so3_right_jacobian(w_ub_all * dts[:, None])
    a_hat_all = lie.hat(a_ub_all)

    p = imu_est.identity_preintegrated(dtype, dev)
    dR, dV, dP = p.dR, p.dV, p.dP
    JRg, JVg, JVa, JPg, JPa = p.JRg, p.JVg, p.JVa, p.JPg, p.JPa
    C9 = torch.zeros((9, 9), dtype=dtype, device=dev)
    for i in range(gyro.shape[0]):
        dt = dts[i]
        dt2 = dt * dt
        a_ub, dRi, Jr = a_ub_all[i], dRi_all[i], Jr_all[i]
        Ra = dR @ a_ub
        Rah = dR @ a_hat_all[i]
        # position and velocity first, with the current dR; then the bias
        # Jacobians, all before the rotation update (the reference's order)
        dP = dP + dV * dt + 0.5 * Ra * dt2
        dV = dV + Ra * dt
        JPa = JPa - 0.5 * dR * dt2
        JPg = JPg + JVg * dt - 0.5 * Rah @ JRg * dt2
        JVa = JVa - dR * dt
        JVg = JVg - Rah @ JRg * dt

        # covariance: x = (dR, dV, dP); A [9, 9], B [9, 6] with noise (g, a)
        A = torch.zeros((9, 9), dtype=dtype, device=dev)
        A[0:3, 0:3] = dRi.T
        A[3:6, 0:3] = -Rah * dt
        A[3:6, 3:6] = eye3
        A[6:9, 0:3] = -0.5 * Rah * dt2
        A[6:9, 3:6] = eye3 * dt
        A[6:9, 6:9] = eye3
        B = torch.zeros((9, 6), dtype=dtype, device=dev)
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt2
        C9 = A @ C9 @ A.T + (B * Nga_all[i][None, :]) @ B.T

        JRg = dRi.T @ JRg - Jr * dt
        dR = dR @ dRi

    t_total = torch.sum(dts)
    C = torch.zeros((15, 15), dtype=dtype, device=dev)
    C[:9, :9] = C9
    C[9:15, 9:15] = torch.diag(walk * t_total)
    return imu_est.Preintegrated(dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa, t_total, bg, ba)


def imu_preintegrate(calib, gyro, acc, dts, bg, ba):
    """Launch ``csrc/imu_preint.cu`` on the current stream: what
    ``integrate_plain`` computes, in one launch and without a host sync."""
    global launches
    N = gyro.shape[0]
    dev = gyro.device
    for name, x, shape in (("gyro", gyro, (N, 3)), ("acc", acc, (N, 3)), ("dts", dts, (N,)),
                           ("bg", bg, (3,)), ("ba", ba, (3,))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"imu_preintegrate: {name} must be float32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"imu_preintegrate: every tensor must lie on one CUDA device, got "
                             f"{x.device} beside {dev}")
    g, a, d, b_g, b_a = (x.contiguous() for x in (gyro, acc, dts, bg, ba))
    out = torch.empty(OUT_FLOATS, dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tc2li_imu_preintegrate(
        g.data_ptr(), a.data_ptr(), d.data_ptr(), b_g.data_ptr(), b_a.data_ptr(), N,
        calib.sigma_g ** 2, calib.sigma_a ** 2, calib.sigma_gw ** 2, calib.sigma_aw ** 2,
        out.data_ptr(), stream), "imu_preintegrate")
    launches += 1
    m3 = [out[k:k + 9].view(3, 3) for k in (0, 15, 24, 33, 42, 51)]
    return imu_est.Preintegrated(
        dR=m3[0], dV=out[9:12], dP=out[12:15], C=out[60:285].view(15, 15), JRg=m3[1],
        JVg=m3[2], JVa=m3[3], JPg=m3[4], JPa=m3[5], dt=out[285], bg=bg, ba=ba)

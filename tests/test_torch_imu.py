"""Parity: the port's SO3/SE3 logs, IMU preintegration, the IMU factor and
the per-keyframe inertial store against the JAX package, on the same numpy
inputs made from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.estimation import imu as jimu
from tc2li_slam_tpu.geom import lie as jlie
from tc2li_slam_tpu.slam import imu_mode as jmode
from tc2li_slam_tpu.solver import factors as jfac
from tc2li_slam_torch import interop
from tc2li_slam_torch.estimation import imu as timu
from tc2li_slam_torch.geom import lie as tlie
from tc2li_slam_torch.io.synthetic import so3_exp_np
from tc2li_slam_torch.slam import imu_mode as tmode
from tc2li_slam_torch.solver import factors as tfac
from torch_parity import n, random_poses, t

# float32 closed forms evaluated by two libraries
TOL = dict(rtol=1e-5, atol=3e-6)
CALIB = (1e-4, 1e-3, 1e-6, 1e-5)


def j(a):
    return jnp.asarray(a)


def imu_window(rng, n_live=10, n_slots=32, rate=100.0):
    """A padded IMU window: ``n_live`` samples of a turning, accelerating
    body, then zero padding (dt = 0)."""
    gyro = np.zeros((n_slots, 3), np.float32)
    acc = np.zeros((n_slots, 3), np.float32)
    dts = np.zeros(n_slots, np.float32)
    gyro[:n_live] = rng.normal(0, 0.3, (n_live, 3))
    acc[:n_live] = rng.normal(0, 1.0, (n_live, 3)) + [0.0, 0.0, 9.81]
    dts[:n_live] = 1.0 / rate
    return gyro, acc, dts


# --- geom/lie: the SO3/SE3 log half ---------------------------------------------

@pytest.mark.parametrize("angle", [0.0, 1e-7, 1e-4, 4e-3, 6e-3, 0.5, 2.0, 3.0,
                                   np.pi - 5e-4, np.pi - 1e-5, np.pi])
def test_so3_log_near_zero_and_pi(rng, angle):
    axes = rng.normal(0, 1, (32, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    R = np.stack([so3_exp_np(a * angle) for a in axes]).astype(np.float32)
    got, ref = n(tlie.so3_log(t(R))), n(jlie.so3_log(j(R)))
    # near pi the axis comes from square roots of the diagonal: both
    # libraries lose the same digits there, but not bit for bit
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5 if angle < 3.1 else 2e-3)
    assert np.all(np.isfinite(got))
    # unbatched input
    np.testing.assert_allclose(n(tlie.so3_log(t(R[0]))), ref[0], rtol=1e-4,
                               atol=2e-5 if angle < 3.1 else 2e-3)


def test_vee_and_so3_jacobians(rng):
    w = np.concatenate([rng.normal(0, 1, (32, 3)), rng.normal(0, 1e-3, (16, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_array_equal(n(tlie.vee(tlie.hat(t(w)))), w)
    for name in ("so3_right_jacobian", "so3_left_jacobian_inv", "so3_right_jacobian_inv"):
        np.testing.assert_allclose(n(getattr(tlie, name)(t(w))), n(getattr(jlie, name)(j(w))),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_se3_log_identity_interpolate(rng):
    T0, T1 = random_poses(rng, 24, rot=0.8), random_poses(rng, 24, rot=0.8)
    np.testing.assert_allclose(n(tlie.se3_log(t(T0))), n(jlie.se3_log(j(T0))),
                               rtol=1e-5, atol=1e-5)
    assert n(tlie.se3_identity((3,))).shape == (3, 4, 4)
    np.testing.assert_array_equal(n(tlie.se3_identity((3,))), n(jlie.se3_identity((3,))))
    alpha = rng.uniform(0, 1, 24).astype(np.float32)
    alpha[:2] = [0.0, 1.0]
    got = n(tlie.se3_interpolate(t(T0), t(T1), t(alpha)))
    np.testing.assert_allclose(got, n(jlie.se3_interpolate(j(T0), j(T1), j(alpha))),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got[0], T0[0], atol=1e-5)
    np.testing.assert_allclose(got[1], T1[1], atol=2e-5)


# --- estimation/imu -------------------------------------------------------------

def assert_preintegrated_close(got, ref):
    for name in timu.Preintegrated._fields:
        g, r = n(getattr(got, name)), n(getattr(ref, name))
        assert g.dtype == r.dtype and g.shape == r.shape, name
        # 10 float32 steps of products of O(1) terms; the covariance spans
        # 1e-12 .. 1e-6, hence the relative part
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-7, err_msg=name)


@pytest.mark.parametrize("n_live", [0, 1, 10, 32])
def test_integrate_padded_window(rng, n_live):
    gyro, acc, dts = imu_window(rng, n_live)
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    ba = rng.normal(0, 0.1, 3).astype(np.float32)
    ref = jimu.integrate(jimu.ImuCalib.create(*CALIB), j(gyro), j(acc), j(dts), j(bg), j(ba))
    got = timu.integrate(timu.ImuCalib.create(*CALIB), t(gyro), t(acc), t(dts), t(bg), t(ba))
    assert_preintegrated_close(got, ref)


def test_integrate_skips_padding_exactly(rng):
    """A padded sample (dt = 0, whatever its values) is an exact no-op: the
    window trimmed to its live samples integrates to the same bits, also
    with padding in the middle and non-finite values in padded slots."""
    gyro, acc, dts = imu_window(rng, 10)
    cal = timu.ImuCalib.create(*CALIB)
    z = torch.zeros(3)
    full = timu.integrate(cal, t(gyro), t(acc), t(dts), z, z)
    trimmed = timu.integrate(cal, t(gyro[:10]), t(acc[:10]), t(dts[:10]), z, z)
    gyro2 = np.insert(gyro[:10], 4, np.nan, axis=0)
    acc2 = np.insert(acc[:10], 4, np.inf, axis=0)
    dts2 = np.insert(dts[:10], 4, 0.0)
    holed = timu.integrate(cal, t(gyro2), t(acc2), t(dts2), z, z)
    for name in timu.Preintegrated._fields:
        assert torch.equal(getattr(full, name), getattr(trimmed, name)), name
        assert torch.equal(getattr(full, name), getattr(holed, name)), name


def test_bias_getters_and_predict_state(rng):
    gyro, acc, dts = imu_window(rng, 12)
    z = np.zeros(3, np.float32)
    ref = jimu.integrate(jimu.ImuCalib.create(*CALIB), j(gyro), j(acc), j(dts), j(z), j(z))
    pre = interop.preintegrated_from_numpy({k: np.asarray(v) for k, v in ref._asdict().items()})
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    ba = rng.normal(0, 0.1, 3).astype(np.float32)
    np.testing.assert_allclose(n(timu.delta_rotation(pre, t(bg))),
                               n(jimu.delta_rotation(ref, j(bg))), **TOL)
    np.testing.assert_allclose(n(timu.delta_velocity(pre, t(bg), t(ba))),
                               n(jimu.delta_velocity(ref, j(bg), j(ba))), **TOL)
    np.testing.assert_allclose(n(timu.delta_position(pre, t(bg), t(ba))),
                               n(jimu.delta_position(ref, j(bg), j(ba))), **TOL)
    R = so3_exp_np(rng.normal(0, 0.5, 3)).astype(np.float32)
    p, v = rng.normal(0, 3, 3).astype(np.float32), rng.normal(0, 2, 3).astype(np.float32)
    for grav in (None, np.array([0.3, 9.7, -0.5], np.float32)):
        got = timu.predict_state(pre, t(R), t(p), t(v), t(bg), t(ba),
                                 None if grav is None else t(grav))
        want = jimu.predict_state(ref, j(R), j(p), j(v), j(bg), j(ba),
                                  None if grav is None else j(grav))
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(n(g_), n(w_), rtol=1e-5, atol=1e-5)


# --- solver/factors: the IMU factor -----------------------------------------------

def factor_inputs(rng, batch=()):
    def rot(scale):
        flat = [so3_exp_np(rng.normal(0, scale, 3)) for _ in range(int(np.prod(batch, dtype=int)))]
        return np.stack(flat).reshape(batch + (3, 3)).astype(np.float32)

    def vec(scale, shape=(3,)):
        return rng.normal(0, scale, batch + shape).astype(np.float32)

    A = rng.normal(0, 1, batch + (9, 9))
    return dict(
        R1=rot(0.5), p1=vec(2), v1=vec(1), R2=rot(0.5), p2=vec(2), v2=vec(1),
        bg=vec(0.01), ba=vec(0.1), dR_c=rot(0.3), dV_c=vec(1), dP_c=vec(0.5),
        JRg=vec(0.1, (3, 3)), JVg=vec(0.1, (3, 3)), JVa=vec(0.1, (3, 3)),
        JPg=vec(0.1, (3, 3)), JPa=vec(0.1, (3, 3)),
        dt=np.abs(rng.normal(0.3, 0.1, batch)).astype(np.float32),
        C9_inv=(A @ np.swapaxes(A, -1, -2)).astype(np.float32))


def test_imu_residual_and_jacobians(rng):
    grav = np.array([0.1, 9.8, -0.2], np.float32)
    one = factor_inputs(rng)
    ref = jfac.imu_residual(**{k: j(v) for k, v in one.items()}, gravity=j(grav))
    got = tfac.imu_residual(**{k: t(v) for k, v in one.items()}, gravity=t(grav))
    for name in tfac.ImuFactorResult._fields:
        np.testing.assert_allclose(n(getattr(got, name)), n(getattr(ref, name)),
                                   rtol=1e-5, atol=2e-5, err_msg=name)
    # a batch of factors in one call equals the factors one by one
    many = factor_inputs(rng, (5,))
    got = tfac.imu_residual(**{k: t(v) for k, v in many.items()}, gravity=t(grav))
    for i in range(5):
        ref = jfac.imu_residual(**{k: j(v[i]) for k, v in many.items()}, gravity=j(grav))
        for name in tfac.ImuFactorResult._fields:
            np.testing.assert_allclose(n(getattr(got, name)[i]), n(getattr(ref, name)),
                                       rtol=1e-5, atol=2e-5, err_msg=name)
    rg, ra, ig, ia = tfac.bias_rw_residual(t(one["bg"]), t(one["ba"]), t(one["v1"]),
                                           t(one["v2"]), 1e5, 1e4)
    np.testing.assert_array_equal(n(rg), one["v1"] - one["bg"])
    np.testing.assert_array_equal(n(ra), one["v2"] - one["ba"])
    assert (ig, ia) == (1e5, 1e4)


# --- slam/imu_mode ------------------------------------------------------------------

def filled_stores(rng, n_kf=6, max_kf=8):
    """The same keyframe records written into both packages' stores."""
    js, ts = jmode.ImuKfStore.create(max_kf), tmode.ImuKfStore.create(max_kf, "cpu")
    jcal, tcal = jimu.ImuCalib.create(*CALIB), timu.ImuCalib.create(*CALIB)
    for kf in range(n_kf):
        vel = rng.normal(0, 1, 3).astype(np.float32)
        bg = rng.normal(0, 0.01, 3).astype(np.float32)
        ba = rng.normal(0, 0.1, 3).astype(np.float32)
        jpre = tpre = None
        if kf > 0:
            gyro, acc, dts = imu_window(rng, 20)
            jpre = jimu.integrate(jcal, j(gyro), j(acc), j(dts), j(bg), j(ba))
            tpre = timu.integrate(tcal, t(gyro), t(acc), t(dts), t(bg), t(ba))
        js = js.set_kf(kf, jpre, j(vel), bg=j(bg), ba=j(ba))
        ts = ts.set_kf(kf, tpre, t(vel), bg=t(bg), ba=t(ba))
    return js, ts


def assert_store_close(ts, js):
    got = interop.imustore_to_numpy(ts)
    for name, g in got.items():
        r = np.asarray(getattr(js, name))
        assert g.dtype == r.dtype and g.shape == r.shape, name
        # C_inv is the inverse of a floored covariance: entries up to 4e4
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-6, err_msg=name)


def test_imu_kf_store_set_kf_and_interop(rng):
    js, ts = filled_stores(rng)
    assert_store_close(ts, js)
    # the covariance floor caps the information at 1 / floor^2
    C_inv = n(ts.C_inv[1])
    assert C_inv[0, 0] <= 1.0 / tmode.SIGMA_ROT_FLOOR ** 2 * (1 + 1e-4)
    assert C_inv[3, 3] <= 1.0 / tmode.SIGMA_VEL_FLOOR ** 2 * (1 + 1e-4)
    assert n(ts.has_factor).tolist() == [False] + [True] * 5 + [False] * 2
    # the store travels through numpy without loss
    back = interop.imustore_from_numpy(js)
    assert_store_close(back, js)
    # no bias given: only the velocity row changes
    ts2 = ts.set_kf(7, None, torch.ones(3))
    assert torch.equal(ts2.vel[7], torch.ones(3)) and torch.equal(ts2.bg, ts.bg)


@pytest.mark.parametrize("window", [[1, 2, 3, 4, 5], [0, 1, 2, 4, 5, 5, 5], [3, 4]])
def test_window_factors(rng, window):
    js, ts = filled_stores(rng)
    host = [False] + [True] * 5 + [False] * 2
    ref = jmode.window_factors(js, window, has_factor=host)
    for got in (tmode.window_factors(ts, window, has_factor=host),
                tmode.window_factors(ts, window)):       # flags read from the store
        for name in ref._fields:
            g, r = n(getattr(got, name)), np.asarray(getattr(ref, name))
            assert g.shape == r.shape and g.dtype == r.dtype, name
            np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-6, err_msg=name)
    # a gap in the window or a repeated keyframe invalidates that factor
    want = [b == a + 1 and host[b] for a, b in zip(window[:-1], window[1:])]
    assert n(got.valid).tolist() == want

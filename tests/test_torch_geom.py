"""Parity: tc2li_slam_torch.geom (lie, camera) vs tc2li_slam_tpu.geom."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.geom import camera as jcam, lie as jlie
from tc2li_slam_torch.geom import camera as tcam, lie as tlie
from torch_parity import n, random_poses, t

# float32 closed forms evaluated by two libraries: agreement to a few ulp of
# O(1) values
TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("scale", [1.0, 1e-2, 1e-4, 0.0])
def test_se3_exp_taylor_and_closed_form(rng, scale):
    xi = (rng.normal(0, 1, (64, 6)) * [1, 1, 1, scale, scale, scale]).astype(np.float32)
    # just above the 5e-3 switchover, (1 - cos x)/x^2 loses ~1e-3 relative in
    # f32 in either library; times |phi| |rho| that is ~2e-5 on translations
    np.testing.assert_allclose(n(tlie.se3_exp(t(xi))), n(jlie.se3_exp(jnp.asarray(xi))),
                               rtol=1e-5, atol=5e-5)


def test_se3_inverse_apply_adjoint(rng):
    T = random_poses(rng, 16)
    p = rng.normal(0, 5, (16, 3)).astype(np.float32)
    P = rng.normal(0, 5, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tlie.se3_inverse(t(T))), n(jlie.se3_inverse(jnp.asarray(T))), **TOL)
    np.testing.assert_allclose(n(tlie.se3_apply(t(T), t(p))),
                               n(jlie.se3_apply(jnp.asarray(T), jnp.asarray(p))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tlie.se3_apply(t(T[0]), t(P))),
                               n(jlie.se3_apply(jnp.asarray(T[0]), jnp.asarray(P))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tlie.se3_adjoint(t(T))), n(jlie.se3_adjoint(jnp.asarray(T))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tlie.hat(t(p))), n(jlie.hat(jnp.asarray(p))), **TOL)


def test_se3_orthonormalize_matches_svd_projection(rng):
    """Newton-Schulz polar steps vs the reference's SVD projection on
    drifted rotations (|R^T R - I| ~ 1e-3): same rotation to f32 precision."""
    T = random_poses(rng, 8)
    T[:, :3, :3] += rng.normal(0, 1e-3, (8, 3, 3)).astype(np.float32)
    got = n(tlie.se3_orthonormalize(t(T)))
    ref = n(jlie.se3_orthonormalize(jnp.asarray(T)))
    np.testing.assert_allclose(got, ref, atol=2e-6)
    RtR = np.einsum("kji,kjl->kil", got[:, :3, :3], got[:, :3, :3])
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=2e-6)


def test_se3_pack_and_parts(rng):
    T = random_poses(rng, 5)
    R, tr = T[:, :3, :3], T[:, :3, 3]
    assert np.array_equal(n(tlie.se3(t(R), t(tr))), n(jlie.se3(jnp.asarray(R), jnp.asarray(tr))))
    assert np.array_equal(n(tlie.rotation(t(T))), R)
    assert np.array_equal(n(tlie.translation(t(T))), tr)


def _cams():
    args = (718.856, 718.856, 607.19, 185.2)
    kw = dict(bf=718.856 * 0.537, width=1241, height=376)
    return tcam.Pinhole.create(*args, **kw), jcam.Pinhole.create(*args, **kw)


def test_pinhole_project_unproject_jac(rng):
    tc, jc = _cams()
    X = np.concatenate([rng.normal(0, 5, (200, 2)), rng.uniform(0.5, 60, (200, 1))], 1).astype(np.float32)
    X[0, 2] = 0.0  # degenerate depth stays finite on both
    np.testing.assert_allclose(n(tcam.project(tc, t(X))), n(jcam.project(jc, jnp.asarray(X))),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(n(tcam.project_stereo(tc, t(X))),
                               n(jcam.project_stereo(jc, jnp.asarray(X))), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(n(tcam.project_stereo_jac(tc, t(X))),
                               n(jcam.project_stereo_jac(jc, jnp.asarray(X))), rtol=1e-6, atol=1e-3)
    uv = rng.uniform(-50, 1300, (200, 2)).astype(np.float32)
    d = rng.uniform(0.5, 50, 200).astype(np.float32)
    np.testing.assert_allclose(n(tcam.unproject(tc, t(uv), t(d))),
                               n(jcam.unproject(jc, jnp.asarray(uv), jnp.asarray(d))), **TOL)
    assert np.array_equal(n(tcam.in_image(tc, t(uv))), n(jcam.in_image(jc, jnp.asarray(uv))))
    assert tc.baseline == float(jc.baseline)
    assert torch.all(torch.isfinite(tcam.project(tc, t(X))))

"""The BALM voxel clusters of the port (``solver/balm.build_clusters``, whose
CUDA route is ``ops/kernels/clusters.balm_clusters``) against the JAX
package's ``build_clusters``.

On the CPU the route is ``build_clusters_plain``, the version the kernel is
held to bit for bit on the card (the kernel adds each cell's run in the
plain version's order, so no other order needs emulating). Tolerances as
``test_torch_mapping.test_balm_clusters_cost_quadratic``: flags and counts
exact, the float32 moment sums to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tc2li_slam_tpu.solver import balm as jbalm
from tc2li_slam_torch.ops.kernels import clusters as kcl
from tc2li_slam_torch.solver import balm as tbalm
from torch_parity import n, t

KW = dict(voxel_size=1.0, max_voxels=512, min_points=15)


def _agree(ct, cj):
    np.testing.assert_array_equal(n(ct.valid), np.asarray(cj.valid))
    np.testing.assert_array_equal(n(ct.N), np.asarray(cj.N))
    for k in ("mean", "Pc", "center"):   # float32 moment sums, same order
        np.testing.assert_allclose(n(getattr(ct, k)), np.asarray(getattr(cj, k)),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", chip_smoke.CLUSTER_CASES)
def test_build_clusters_matches_jax(case):
    pl, valid, T_wl = chip_smoke.cluster_case(np.random.default_rng(3), case)
    before = kcl.launches
    ct = tbalm.build_clusters(t(pl), t(valid), t(T_wl), **KW)
    assert kcl.launches == before                     # CPU tensors: the plain version
    cj = jbalm.build_clusters(jnp.asarray(pl), jnp.asarray(valid), jnp.asarray(T_wl), **KW)
    _agree(ct, cj)
    n_valid, n_pts = int(np.asarray(cj.valid).sum()), int(np.asarray(cj.N).sum())
    if case == "full_width":
        assert n_valid > 20
    if case == "overflow":   # every slot taken, points left over
        assert n_pts < valid.sum() and int((np.asarray(cj.N).sum(1) > 0).sum()) == 512
    if case == "no_valid_point":
        assert n_valid == 0 and n_pts == 0
    if case == "no_kf_pads":
        assert not np.asarray(cj.N)[:, 4:].any() and n_valid > 20


@pytest.mark.parametrize("W,M,V", [(1, 1, 1), (2, 300, 8), (6, 2048, 16)])
def test_build_clusters_small_shapes_match_jax(W, M, V):
    pl, valid, T_wl = chip_smoke.cluster_case(np.random.default_rng(4), "full_width", W, M)
    kw = dict(KW, max_voxels=V)
    ct = tbalm.build_clusters(t(pl), t(valid), t(T_wl), **kw)
    cj = jbalm.build_clusters(jnp.asarray(pl), jnp.asarray(valid), jnp.asarray(T_wl), **kw)
    _agree(ct, cj)


def test_build_clusters_dispatch():
    """CPU tensors run the plain version, CUDA tensors the kernel (card
    tests), any other device raises."""
    pl, valid, T_wl = chip_smoke.cluster_case(np.random.default_rng(5), "full_width", 2, 64)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        tbalm.build_clusters(t(pl).to(meta), t(valid).to(meta), t(T_wl).to(meta), **KW)

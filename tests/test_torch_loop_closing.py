"""Parity: loop detection, Sim3 verification and the pose-graph closure of
tc2li_slam_torch vs tc2li_slam_tpu.

Two maps, built with the JAX package and carried across with ``interop``:
the hand-built drifted loop of ``tests/test_loop_closing.py`` (keyframe K-1
revisits keyframe 0), and a denser one whose keyframes share landmarks, so
that covisibility groups, the covisibility exclusion, strong covisibility
edges and a culled keyframe all take part. Candidate lists and edge sets
are compared for equality, poses and landmarks to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.geom import lie as jlie
from tc2li_slam_tpu.slam import loop_closing as jlc, mapstate as jms
from tc2li_slam_tpu.solver import sim3 as jsim3
from tc2li_slam_torch import interop
from tc2li_slam_torch.ops import matching as tmatch
from tc2li_slam_torch.slam import loop_closing as tlc, mapstate as tms
from test_loop_closing import build_loop_map
from test_torch_pnp import jax_sample_idx
from torch_parity import n, random_words, t

POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def loop_map():
    rng = np.random.default_rng(0)
    m, T_gt, T_est = build_loop_map(rng)
    return m, interop.mapstate_from_numpy(m), T_gt, T_est


def build_dense_map(rng, K=14, F=160, n_lm=150):
    """A chain of K keyframes on a loop. Keyframes 0..3 and K-1 observe the
    same ``n_lm`` landmarks (weights >= 100 among them: strong edges 0-2,
    0-3, 1-3 and the loop pairs), keyframes 5..8 share 40 others (weights
    15..99: groups, but no strong edge), keyframe 2 is culled."""
    m = jms.create(max_kf=16, max_feats=F, max_lm=512, max_obs=8)
    step = np.asarray(jlie.se3_exp(jnp.asarray([0.8, 0, 0, 0, 0, 2 * np.pi / K], jnp.float32)))
    T = [np.eye(4, dtype=np.float32)]
    for _ in range(K - 1):
        noise = np.asarray(jlie.se3_exp(jnp.asarray(
            (rng.normal(0, 0.03, 6) * [1, 1, 1, 0.3, 0.3, 0.3]).astype(np.float32))))
        T.append((noise @ step @ T[-1]).astype(np.float32))
    X = (rng.uniform(-5, 5, (F, 3)) + [0, 0, 8]).astype(np.float32)
    descs = random_words(rng, (F, 8))
    feat = jnp.arange(F, dtype=jnp.int32)
    for k in range(K):
        desc = random_words(rng, (F, 8))
        if k in (0, 1, 2, 3, K - 1):
            desc[:n_lm] = descs[:n_lm]
        m, _ = jms.add_keyframe(
            m, jnp.asarray(T[k]), jnp.float32(k), jnp.zeros((F, 2)),
            jnp.zeros((F, 3)).at[:, 2].set(-1.0), jnp.zeros(F, jnp.int32), jnp.zeros(F),
            jnp.asarray(desc), jnp.ones(F, bool), jnp.full(F, jms.NO_LM, jnp.int32))
    first = jnp.arange(F) < n_lm
    m, ids0 = jms.add_landmarks(m, jnp.int32(0), feat, jnp.asarray(X), jnp.asarray(descs),
                                jnp.zeros((F, 3)), jnp.ones((F, 2)), first)
    for k in (1, 2, 3, K - 1):
        m = jms.link_observations(m, jnp.int32(k), feat, ids0, first)
    some = jnp.arange(F) < 40
    m, ids5 = jms.add_landmarks(m, jnp.int32(5), feat, jnp.asarray(X + 1.0),
                                jnp.asarray(random_words(rng, (F, 8))), jnp.zeros((F, 3)),
                                jnp.ones((F, 2)), some)
    for k in (6, 7, 8):
        m = jms.link_observations(m, jnp.int32(k), feat, ids5, some)
    return m._replace(kf_valid=m.kf_valid.at[2].set(False)), np.stack(T)


@pytest.fixture(scope="module")
def dense_map():
    m, T = build_dense_map(np.random.default_rng(3))
    return m, interop.mapstate_from_numpy(m), T


def test_covisibility_tables_match_rows(dense_map):
    """The batched covisibility matrix and neighbour table, row by row
    against the single-keyframe functions of both packages."""
    mj, mt, _ = dense_map
    W = tms.covisibility_matrix(mt, 14, block=5)
    assert W.dtype == torch.int32 and W.shape == (14, 16)
    nb, vals = tms.top_covisible_table(mt, 14, 8, min_weight=100)
    assert nb.dtype == torch.int32
    for k in range(14):
        np.testing.assert_array_equal(n(W[k]), n(tms.covisibility_weights(mt, k)))
        np.testing.assert_array_equal(n(W[k]),
                                      np.asarray(jms.covisibility_weights(mj, jnp.int32(k))))
        nj, vj = jms.top_covisible(mj, jnp.int32(k), 8, min_weight=100)
        np.testing.assert_array_equal(n(nb[k]), np.asarray(nj))
        np.testing.assert_array_equal(n(vals[k]), np.asarray(vj))
    assert int(W.max()) >= 100 and n(W)[:, 2].max() == 0      # the culled keyframe counts nowhere
    np.testing.assert_array_equal(n(tms.covisibility_matrix(mt)[:14]), n(W))
    assert tms.covisibility_matrix(mt, 0).shape == (0, 16)


def _word_rows(rng, K_all, F, shared_rows, n_words, partial=None):
    """[K_all, F] sorted word rows: ``shared_rows`` hold one word list,
    ``partial`` = (row, count) holds its first ``count`` words, the others
    are random over ``n_words``."""
    kw = np.full((K_all, F), -1, np.int32)
    shared = np.sort(rng.integers(0, 1000, F))
    for k in range(14):
        kw[k] = shared if k in shared_rows else np.sort(rng.integers(0, n_words, F))
    if partial is not None:
        row, cnt = partial
        kw[row, :cnt] = shared[:cnt]
        kw[row] = np.sort(kw[row])
    return kw


CASES = [
    # (map, query, min_gap, shared rows, vocabulary size, partial row)
    ("loop", 9, 3, (0, 9), 1000, None),
    ("loop", 9, 3, (0, 1, 9), 1000, (2, 40)),
    ("loop", 9, 3, (0, 9), 80, None),            # a saturated vocabulary
    ("loop", 9, 12, (0, 9), 1000, None),         # everything inside the gap: none
    ("dense", 10, 3, (0, 1, 3, 10), 1000, None),  # 0, 1, 3 one covisibility group
    ("dense", 10, 3, (1, 6, 7, 10), 1000, (5, 120)),
    ("dense", 13, 3, (0, 5, 13), 1000, None),    # 0 is covisible with 13: excluded
    ("dense", 11, 4, (5, 6, 7, 8, 11), 60, (3, 130)),
]


@pytest.mark.parametrize("idf", [False, True], ids=["counts", "idf"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_detect_candidates_list_equal(loop_map, dense_map, case, idf):
    """The candidate list equals the reference's, in order, with and without
    idf weights, with and without the host's keyframe count."""
    which, query, gap, shared_rows, n_words, partial = CASES[case]
    mj, mt = (loop_map if which == "loop" else dense_map)[:2]
    rng = np.random.default_rng(10 + case)
    kw = _word_rows(rng, mj.K, mj.F, shared_rows, n_words, partial)
    ww = rng.uniform(0.1, 3.0, 1000).astype(np.float32) if idf else None
    cj = jlc.detect_candidates(mj, query, jnp.asarray(kw), min_gap=gap, n_best=3,
                               word_weights=None if ww is None else jnp.asarray(ww))
    wt = None if ww is None else t(ww)
    ct = tlc.detect_candidates(mt, query, t(kw), min_gap=gap, n_best=3, word_weights=wt)
    assert ct == [int(c) for c in cj]
    assert tlc.detect_candidates(mt, query, t(kw), min_gap=gap, n_best=3, word_weights=wt,
                                 n_kf=14 if which == "dense" else 10) == ct
    dev = tlc.detect_candidates_device(mt, query, t(kw), min_gap=gap, n_best=3, word_weights=wt)
    assert dev.dtype == torch.int32 and dev.shape == (3,)
    assert dev.tolist() == ct + [-1] * (3 - len(ct))
    if case == 3:
        assert ct == []
    if case == 0:
        assert ct == [0]


def _pair_valid(mt, kf, cand):
    """The valid mask that ``verify_candidate`` hands to the RANSAC."""
    la, lb = mt.kf_feat_lm[kf], mt.kf_feat_lm[cand]
    va = mt.kf_feat_valid[kf] & (la != -1)
    vb = mt.kf_feat_valid[cand] & (lb != -1)
    idx, _, okm = tmatch.match_descriptors(mt.kf_desc[kf], mt.kf_desc[cand], va, vb,
                                           max_dist=tmatch.TH_LOW, ratio=0.75, mutual=True)
    lm_a = torch.clamp(la, 0, mt.L - 1).long()
    lm_b = torch.clamp(lb[idx], 0, mt.L - 1).long()
    return okm & mt.lm_valid[lm_a] & mt.lm_valid[lm_b]


def test_verify_candidate_matches_jax(loop_map):
    """On the triples the JAX key draws: the same verdict, inlier count,
    inlier mask and landmark pairs, S to 1e-4. A keyframe that shares
    nothing fails in both."""
    mj, mt, T_gt, _ = loop_map
    K = len(T_gt)
    key = jax.random.PRNGKey(0)
    okj, Sj, nj, (laj, lbj, inlj) = jlc.verify_candidate(mj, K - 1, 0, key, with_scale=False,
                                                         min_inliers=15)
    idx = jax_sample_idx(key, n(_pair_valid(mt, K - 1, 0)), 128, 3)
    okt, St, nt, (lat, lbt, inlt) = tlc.verify_candidate(mt, K - 1, 0, with_scale=False,
                                                         min_inliers=15, sample_idx=t(idx))
    assert okt is True and okj and isinstance(nt, int) and nt == nj >= 40
    np.testing.assert_array_equal(n(inlt), np.asarray(inlj))
    np.testing.assert_array_equal(n(lat), np.asarray(laj))
    np.testing.assert_array_equal(n(lbt)[n(inlt)], np.asarray(lbj)[n(inlt)])
    np.testing.assert_allclose(n(St), np.asarray(Sj), atol=POSE_ATOL)
    rel_gt = T_gt[K - 1] @ np.linalg.inv(T_gt[0])
    assert np.abs(np.asarray(jlie.se3_log(jnp.asarray(np.linalg.inv(rel_gt) @ n(St))))).max() < 0.2
    okj2, _, nj2, _ = jlc.verify_candidate(mj, K - 1, 4, key, with_scale=False)
    okt2, S2, nt2, _ = tlc.verify_candidate(mt, K - 1, 4, torch.Generator().manual_seed(0))
    assert okt2 is False and not okj2 and nt2 == nj2 == 0 and np.isfinite(n(S2)).all()


def _jax_close_loop(mj, kf, cand, S, iters):
    """The reference's ``close_loop`` and the edges it handed its optimizer."""
    seen = {}
    orig = jsim3.pose_graph_optimize

    def spy(S_w, edges, fixed, iters=20):
        seen["edges"], seen["fixed"] = edges, fixed
        return orig(S_w, edges, fixed, iters=iters)

    jlc.sim3_mod.pose_graph_optimize = spy
    try:
        out = jlc.close_loop(mj, kf, cand, jnp.asarray(S), iters=iters)
    finally:
        jlc.sim3_mod.pose_graph_optimize = orig
    return out, seen["edges"], np.asarray(seen["fixed"])


@pytest.mark.parametrize("which", ["loop", "dense"])
def test_close_loop_matches_jax(loop_map, dense_map, which):
    """The edge list equals the reference's (same pairs, same order, same
    weights; relative transforms to 1e-5), poses and landmarks to 1e-4, and
    the loop edge's residual falls below 0.3 of what it was."""
    if which == "loop":
        mj, mt, T_gt, _ = loop_map
        kf, n_kf = len(T_gt) - 1, len(T_gt)
        _, S, _, _ = jlc.verify_candidate(mj, kf, 0, jax.random.PRNGKey(0), min_inliers=15)
        S = np.asarray(S)
    else:
        mj, mt, T = dense_map
        kf, n_kf = 13, 14
        drift = np.asarray(jlie.se3_exp(jnp.asarray([0.3, -0.1, 0.2, 0.02, 0.05, -0.03], jnp.float32)))
        S = (drift @ T[13] @ np.linalg.inv(T[0])).astype(np.float32)
    out_j, edges_j, fixed_j = _jax_close_loop(mj, kf, 0, S, iters=12)
    edges_t = tlc.loop_edges(mt, kf, 0, t(S), n_kf)
    np.testing.assert_array_equal(n(edges_t.i), np.asarray(edges_j.i))
    np.testing.assert_array_equal(n(edges_t.j), np.asarray(edges_j.j))
    np.testing.assert_array_equal(n(edges_t.weight), np.asarray(edges_j.weight))
    assert edges_t.i.dtype == torch.int32 and bool(edges_t.valid.all())
    np.testing.assert_allclose(n(edges_t.S_ij), np.asarray(edges_j.S_ij), atol=1e-5)
    pairs = set(zip(n(edges_t.i).tolist(), n(edges_t.j).tolist()))
    if which == "dense":
        # strong covisibility edges among alive keyframes; none touches the
        # culled keyframe 2, the chain runs through it
        assert {(0, 3), (1, 3), (0, 13), (1, 13), (3, 13)} <= pairs
        assert not any(2 in p and abs(p[0] - p[1]) > 1 for p in pairs)
        assert {(1, 2), (2, 3)} <= pairs and (5, 7) not in pairs
    else:
        assert len(pairs) == n_kf
    out_t = tlc.close_loop(mt, kf, 0, t(S), iters=12, n_kf=n_kf)
    assert out_t.kf_T_cw.dtype == torch.float32 and out_t.lm_pos.dtype == torch.float32
    np.testing.assert_allclose(n(out_t.kf_T_cw), np.asarray(out_j.kf_T_cw), atol=POSE_ATOL)
    np.testing.assert_allclose(n(out_t.lm_pos), np.asarray(out_j.lm_pos), atol=POSE_ATOL)
    assert fixed_j[0] and fixed_j[n_kf:].all() and not fixed_j[1:n_kf].any()
    # the candidate and a culled keyframe keep their pose; n_kf read from the map agrees
    np.testing.assert_array_equal(n(out_t.kf_T_cw[0]), n(mt.kf_T_cw[0]))
    if which == "dense":
        np.testing.assert_array_equal(n(out_t.kf_T_cw[2]), n(mt.kf_T_cw[2]))
    np.testing.assert_array_equal(n(tlc.close_loop(mt, kf, 0, t(S), iters=12).kf_T_cw),
                                  n(out_t.kf_T_cw))

    def residual(T):
        rel = T[kf] @ np.linalg.inv(T[0])
        return np.linalg.norm(np.asarray(jlie.se3_log(jnp.asarray(np.linalg.inv(S) @ rel))))

    assert residual(n(out_t.kf_T_cw)) < 0.3 * residual(n(mt.kf_T_cw)) + 1e-3
    assert np.isfinite(n(out_t.lm_pos)).all()

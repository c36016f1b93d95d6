"""Parity: the bag-of-words vocabulary, quantization, shared-word scoring
and relocalization candidates of tc2li_slam_torch vs tc2li_slam_tpu. The
vocabulary is trained by the JAX package and carried over with
``tc2li_slam_torch.interop``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tc2li_slam_tpu.ops import bow as jbow
from tc2li_slam_torch import interop
from tc2li_slam_torch.ops import bow as tbow
from torch_parity import n, random_words, t


def _near(rng, base, flips):
    """Copies of descriptors [N, 8] uint32 with `flips` random bits flipped."""
    out = base.copy()
    for r in range(len(out)):
        for b in rng.integers(0, 256, flips):
            out[r, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


@pytest.fixture(scope="module")
def vocs():
    rng = np.random.default_rng(0)
    centers = random_words(rng, (40, 8))
    train = _near(rng, centers[rng.integers(0, 40, 1500)], 12)
    vj = jbow.train_vocabulary(train, k=5, depth=3, seed=0)
    return vj, interop.vocabulary_from_numpy(vj), centers, train


def test_vocabulary_interop_and_training(vocs):
    """Carried over field by field; the port's own training gives the same
    tree for the same seed; the round trip restores uint32 words."""
    vj, vt, _, train = vocs
    back = interop.vocabulary_to_numpy(vt)
    own = interop.vocabulary_to_numpy(tbow.train_vocabulary(train, k=5, depth=3, seed=0))
    for k, v in vj._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(own[k], np.asarray(v), err_msg=k)
        assert np.asarray(back[k]).dtype == np.asarray(v).dtype, k
    assert vt.node_desc.dtype == torch.int32 and vt.n_words == vj.n_words > 20
    np.testing.assert_allclose(n(tbow.word_idf(vt)), np.asarray(jbow.word_idf(vj)), atol=1e-7)


@pytest.mark.parametrize("depth", [3, 1])
def test_quantize(vocs, rng, depth):
    """Words equal, weights to 1e-6; invalid features give -1 and 0."""
    vj, vt, centers, _ = vocs
    desc = np.concatenate([_near(rng, centers[rng.integers(0, 40, 300)], 20),
                           random_words(rng, (100, 8))])
    valid = rng.random(400) > 0.2
    wj, gj = jbow.quantize(vj, jnp.asarray(desc), jnp.asarray(valid), depth)
    wt, gt = tbow.quantize(vt, t(desc), t(valid), depth)
    assert wt.dtype == torch.int32 and gt.dtype == torch.float32
    np.testing.assert_array_equal(n(wt), np.asarray(wj))
    np.testing.assert_allclose(n(gt), np.asarray(gj), atol=1e-6)
    assert (n(wt)[~valid] == -1).all() and (depth < 3 or (n(wt)[valid] >= 0).all())


def _kf_words(vj, vt, frames, valid):
    wj = jnp.stack([jnp.sort(jbow.quantize(vj, jnp.asarray(f), jnp.asarray(v), vj.depth)[0])
                    for f, v in zip(frames, valid)])
    wt = torch.stack([torch.sort(tbow.quantize(vt, t(f), t(v), vt.depth)[0]).values
                      for f, v in zip(frames, valid)])
    np.testing.assert_array_equal(n(wt), np.asarray(wj))
    return wj, wt


def test_shared_word_scores_and_candidates(vocs, rng):
    """Counts equal, scores to 1e-5, candidates equal. The query carries -1
    pads and repeated words; keyframes 1 and 4 hold the same words, so their
    scores tie and the lower id must come first."""
    vj, vt, centers, _ = vocs
    F = 120
    frames = [_near(rng, centers[rng.integers(0, 40, F)], 10) for _ in range(5)]
    frames[4] = frames[1].copy()
    frames.append(random_words(rng, (F, 8)))
    valid = [rng.random(F) > 0.15 for _ in frames]
    valid[4] = valid[1].copy()
    wj, wt = _kf_words(vj, vt, frames, valid)
    kf_valid = np.array([True, True, True, False, True, True])
    query = _near(rng, frames[1], 3)
    qv = rng.random(F) > 0.1
    qwj, qgj = jbow.quantize(vj, jnp.asarray(query), jnp.asarray(qv), vj.depth)
    qwt, qgt = tbow.quantize(vt, t(query), t(qv), vt.depth)
    cj, sj = jbow.shared_word_scores(qwj, qgj, wj, jnp.asarray(kf_valid))
    ct, st = tbow.shared_word_scores(qwt, qgt, wt, t(kf_valid))
    assert ct.dtype == torch.int32 and st.dtype == torch.float32
    np.testing.assert_array_equal(n(ct), np.asarray(cj))
    np.testing.assert_allclose(n(st), np.asarray(sj), atol=1e-5)
    assert n(ct)[3] == 0 and n(ct)[1] == n(ct)[4] == n(ct).max() > 20
    for k in (1, 3, 6):
        idj, vj_ = jbow.reloc_candidates(cj, sj, k)
        idt, vt_ = tbow.reloc_candidates(ct, st, k)
        np.testing.assert_array_equal(n(idt), np.asarray(idj))
        np.testing.assert_allclose(n(vt_), np.asarray(vj_), atol=1e-5)
    assert n(tbow.reloc_candidates(ct, st, 2)[0]).tolist() == [1, 4]
    # tied scores by construction, and nothing shared at all
    counts = np.array([5, 9, 9, 9, 2], np.int32)
    scores = np.array([3.0, 7.5, 7.5, 7.5, 1.0], np.float32)
    for c, s in ((counts, scores), (np.zeros(5, np.int32), np.zeros(5, np.float32))):
        idj, _ = jbow.reloc_candidates(jnp.asarray(c), jnp.asarray(s), 4)
        idt, _ = tbow.reloc_candidates(t(c), t(s), 4)
        np.testing.assert_array_equal(n(idt), np.asarray(idj))


def test_orbvoc_txt_loader(tmp_path, rng):
    """The text loader builds the tree the JAX package's builds."""
    k, L = 2, 2
    descs = random_words(rng, (6, 8))
    parent_of, is_leaf = [0, 0, 1, 1, 2, 2], [0, 0, 1, 1, 1, 1]
    lines = [f"{k} {L} 0 0"] + [
        f"{parent_of[i]} {is_leaf[i]} " + " ".join(str(b) for b in descs[i].view(np.uint8))
        + f" {0.25 * (i + 1)}" for i in range(6)]
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    vj, vt = jbow.load_orbvoc_txt(str(path)), tbow.load_orbvoc_txt(str(path))
    got = interop.vocabulary_to_numpy(vt)
    for key, v in vj._asdict().items():
        np.testing.assert_array_equal(got[key], np.asarray(v), err_msg=key)
    wj, _ = jbow.quantize(vj, jnp.asarray(descs), jnp.ones(6, bool), L)
    wt, _ = tbow.quantize(vt, t(descs), torch.ones(6, dtype=torch.bool), L)
    np.testing.assert_array_equal(n(wt), np.asarray(wj))

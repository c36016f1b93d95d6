"""Binary bag-of-words: the vocabulary tree as tensors, batched
quantization, shared-word place-recognition scoring (port of
``tc2li_slam_tpu/ops/bow.py``, which replaces DBoW2).

- The vocabulary is two tables: node descriptors [n_nodes, 8] (int32 bit
  patterns of the uint32 words) and children [n_nodes, k]; quantization
  descends all features in lock-step (gather children, popcount, argmin),
  ``depth`` levels deep. The per-level [F, k] distances are plain tensor
  code on the byte-table popcount of ``ops.kernels.hamming``.
- Each keyframe keeps its sorted word ids [F]; the shared-word counts of a
  query against all keyframes are one ``searchsorted``.
- ``train_vocabulary`` (hierarchical binary k-medians) and
  ``load_orbvoc_txt`` (ORB-SLAM's text format) are host code in numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kernels.hamming import popcount_table
from .orb import topk_stable


class Vocabulary(NamedTuple):
    node_desc: torch.Tensor   # [n_nodes, 8] int32 (uint32 words)
    children: torch.Tensor    # [n_nodes, k] int32 (-1 = none)
    is_leaf: torch.Tensor     # [n_nodes] bool
    word_id: torch.Tensor     # [n_nodes] int32 (leaf enumeration, -1 internal)
    weight: torch.Tensor      # [n_nodes] float32 idf weight of leaves
    k: int
    depth: int
    n_words: int

    def to(self, device) -> "Vocabulary":
        return self._replace(**{f: getattr(self, f).to(device) for f in
                                ("node_desc", "children", "is_leaf", "word_id", "weight")})


def vocabulary_from_arrays(node_desc, children, is_leaf, word_id, weight, k, depth, n_words,
                           device="cpu") -> Vocabulary:
    """Numpy tables (descriptor words uint32) -> ``Vocabulary`` on ``device``."""
    nd = np.ascontiguousarray(np.asarray(node_desc).astype(np.uint32)).view(np.int32)
    return Vocabulary(
        node_desc=torch.as_tensor(nd.copy()),
        children=torch.as_tensor(np.asarray(children).astype(np.int32)),
        is_leaf=torch.as_tensor(np.asarray(is_leaf).astype(bool)),
        word_id=torch.as_tensor(np.asarray(word_id).astype(np.int32)),
        weight=torch.as_tensor(np.asarray(weight).astype(np.float32)),
        k=int(k), depth=int(depth), n_words=int(n_words)).to(device)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distances of broadcast int32 [..., 8] descriptor words: int32 [...]."""
    x = torch.bitwise_xor(a, b).contiguous().view(torch.uint8)
    return popcount_table(x.device)[x.long()].sum(dim=-1, dtype=torch.int32)


def quantize(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor, depth: int):
    """Descriptors [F, 8] -> (word ids [F] int32, weights [F]); invalid -> -1, 0."""
    node = torch.zeros(desc.shape[0], dtype=torch.long, device=desc.device)
    for _ in range(depth):
        ch = voc.children[node]                               # [F, k]
        ch_ok = ch >= 0
        ch_desc = voc.node_desc[torch.clamp(ch, min=0).long()]  # [F, k, 8]
        d = torch.where(ch_ok, _hamming(ch_desc, desc[:, None, :]), 1 << 20)
        best = torch.argmin(d, dim=-1)                        # first on ties
        nxt = torch.gather(ch, 1, best[:, None])[:, 0].long()
        node = torch.where(torch.any(ch_ok, dim=-1), nxt, node)   # leaves stay put
    words = torch.where(valid, voc.word_id[node], -1)
    weights = torch.where(valid, voc.weight[node], 0.0)
    return words, weights


# ---------------------------------------------------------------------------
# Place-recognition scoring
# ---------------------------------------------------------------------------

def word_idf(voc: Vocabulary) -> torch.Tensor:
    """[n_words] idf weight per word id (the leaves' weights re-indexed)."""
    last = max(voc.n_words - 1, 0)
    wid = torch.clamp(voc.word_id, 0, last).long()
    out = torch.zeros(max(voc.n_words, 1), dtype=torch.float32, device=voc.weight.device)
    idx = torch.where(voc.is_leaf, wid, last)
    return out.scatter_reduce(0, idx, torch.where(voc.is_leaf, voc.weight, 0.0), reduce="amax")


def shared_word_scores(query_words, query_weights, kf_words, kf_valid):
    """(shared word counts [K] int32, idf-weighted scores [K]).

    ``query_words`` [F] (any order, -1 pads), ``kf_words`` [K, F] sorted per
    keyframe. The batched form of the inverted-index accumulation of
    ``KeyFrameDatabase::DetectRelocalizationCandidates``."""
    qw, order = torch.sort(query_words, stable=True)
    qweights = query_weights[order]
    pos = torch.searchsorted(qw, kf_words.contiguous())       # left insertion points
    pos = torch.clamp(pos, 0, qw.shape[0] - 1)
    hit = (qw[pos] == kf_words) & (kf_words >= 0)
    counts = torch.sum(hit, dim=-1, dtype=torch.int32)
    scores = torch.sum(torch.where(hit, qweights[pos], 0.0), dim=-1)
    return torch.where(kf_valid, counts, 0), torch.where(kf_valid, scores, 0.0)


def reloc_candidates(counts, scores, n: int, min_common_ratio: float = 0.8):
    """Top-n candidate keyframes: those sharing >= 0.8 of the best count,
    ranked by score, ties to the lower id. Returns (ids [n], -1 none; scores)."""
    max_c = torch.max(counts)
    ok = counts >= (min_common_ratio * max_c).to(counts.dtype)
    ranked = torch.where(ok, scores, -1.0)
    vals, idx = topk_stable(ranked, n)
    return torch.where(vals > 0, idx, -1), vals


# ---------------------------------------------------------------------------
# Vocabulary training (hierarchical binary k-medians), host code
# ---------------------------------------------------------------------------

def _np_hamming(a, b):
    return np.unpackbits(
        np.bitwise_xor(a[:, None, :], b[None, :, :]).view(np.uint8), axis=-1).sum(-1)


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Bit-majority of binary descriptors [N, 8] uint32 -> [8] uint32."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)        # [N, 256]
    maj = (bits.sum(0) * 2 >= len(bits)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train_vocabulary(descs: np.ndarray, k: int = 8, depth: int = 4, seed: int = 0,
                     iters: int = 6, device="cpu") -> Vocabulary:
    """Hierarchical binary k-medians over descriptors [N, 8] uint32
    (TemplatedVocabulary::create's HKmeansStep)."""
    descs = np.ascontiguousarray(descs, dtype=np.uint32)
    rng = np.random.default_rng(seed)
    nodes_desc = [np.zeros(8, np.uint32)]
    children = [[]]
    levels = [[0]]
    assignments = {0: np.arange(len(descs))}

    for _ in range(depth):
        next_level = []
        for nid in levels[-1]:
            idx = assignments.pop(nid)
            if len(idx) == 0:
                continue
            kk = min(k, len(idx))
            centers = descs[rng.choice(idx, kk, replace=False)]
            for _ in range(iters):
                lab = _np_hamming(descs[idx], centers).argmin(1)
                centers = np.stack([
                    _bit_majority(descs[idx[lab == j]]) if np.any(lab == j) else centers[j]
                    for j in range(kk)])
            lab = _np_hamming(descs[idx], centers).argmin(1)
            ch_ids = []
            for j in range(kk):
                cid = len(nodes_desc)
                nodes_desc.append(centers[j])
                children.append([])
                ch_ids.append(cid)
                assignments[cid] = idx[lab == j]
            children[nid] = ch_ids
            next_level.extend(ch_ids)
        levels.append(next_level)

    n_nodes = len(nodes_desc)
    child_tab = np.full((n_nodes, k), -1, np.int32)
    for nid, ch in enumerate(children):
        child_tab[nid, : len(ch)] = ch
    is_leaf = np.array([len(c) == 0 for c in children])
    word_id = np.full(n_nodes, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    word_id[leaves] = np.arange(len(leaves))

    # idf weights from the training distribution
    weight = np.zeros(n_nodes, np.float32)
    n_total = max(len(descs), 1)
    for nid in leaves:
        weight[nid] = np.log(n_total / max(len(assignments.get(nid, [])), 1))

    return vocabulary_from_arrays(np.stack(nodes_desc), child_tab, is_leaf, word_id, weight,
                                  k, depth, len(leaves), device)


# ---------------------------------------------------------------------------
# ORBvoc.txt loader (DBoW2 text format)
# ---------------------------------------------------------------------------

def load_orbvoc_txt(path: str, device="cpu") -> Vocabulary:
    """Load ORB-SLAM's vocabulary: header 'k L scoring weighting', then one
    line per node, 'parent_id is_leaf d0 ... d31 weight'."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaf_flags, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(int(parts[1]) != 0)
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))
    n = len(parents) + 1  # + the root
    node_desc = np.zeros((n, 8), np.uint32)
    node_desc[1:] = np.stack(descs).view(np.uint32)
    child_tab = np.full((n, k), -1, np.int32)
    counts = np.zeros(n, np.int32)
    for i, p in enumerate(parents):
        if counts[p] < k:
            child_tab[p, counts[p]] = i + 1
            counts[p] += 1
    is_leaf = np.zeros(n, bool)
    is_leaf[1:] = np.array(leaf_flags)
    word_id = np.full(n, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    word_id[leaves] = np.arange(len(leaves))
    weight = np.zeros(n, np.float32)
    weight[1:] = np.array(weights, np.float32)
    return vocabulary_from_arrays(node_desc, child_tab, is_leaf, word_id, weight, k, L,
                                  len(leaves), device)

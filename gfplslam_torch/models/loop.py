"""Loop closure: bag-of-words scorer, candidate gating, geometric
verification, SE(3) pose-graph optimization, rigid map correction.

Port of ``gfplslam_tpu/models/loop.py`` (mapHandler.cpp): dual point+line
BoW scoring (``insertKFBowVectorPL``, :2925-3000), candidate search
(``lookForLoopCandidates``, :3002-3076), KF<->KF geometric verification
(``isLoopClosure`` + ``computeRelativePoseGN``, :3078-3545) and pose-graph
optimization with landmark correction (:3950-4185).

The vocabulary is the reference's flat anchor vocabulary: word(desc) =
nearest of V 256-bit anchors by Hamming distance, one [N, V] distance
matrix per KF and family (the Hamming kernel on the card). The trained
codebooks are byte-identical copies of the reference's, kept in
``gfplslam_torch/data/`` and read at first use. The pose graph is a dense
GN on [6K] twists whose edge Jacobians come from forward-mode AD
(``jax.jacfwd`` under ``vmap`` in the reference).
"""

from __future__ import annotations

import glob
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from gfplslam_torch.config import Config
from gfplslam_torch.models import pose_opt
from gfplslam_torch.models.frame import StereoFrame
from gfplslam_torch.models.map import set_rows
from gfplslam_torch.ops import matching as match_ops
from gfplslam_torch.ops.hamming import hamming_matrix
from gfplslam_torch.utils import se3, trace

CUDA = torch.device("cuda")
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data")
# stereo features snapshotted per KF for LC verification
N_KF_PT = 512
N_KF_LN = 256


def make_vocab(v: int = 1024, seed: int = 31) -> np.ndarray:
    """[V, 8] uint32 anchor descriptors (deterministic)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(v, 8), dtype=np.uint32)


class _Vocabularies:
    """The reference's vocabulary registry (module state there as here):
    seeded random anchor pools, and trained codebooks by word count
    {k: dict(vp, vl, df_p, df_l, n_docs)} read from ``DATA_DIR`` at first
    use; device copies are cached per (word count, device)."""

    def __init__(self):
        self.loaded = False
        self.source = "random-anchors"
        self.trained: dict = {}
        self.device_cache: dict = {}
        self.p_full = self.l_full = None

    def ensure(self) -> None:
        if self.loaded:
            return
        self.loaded = True
        self.p_full = make_vocab(4096, seed=31)
        self.l_full = make_vocab(4096, seed=67)
        for path in sorted(glob.glob(os.path.join(DATA_DIR, "vocab_synth*.npz"))):
            with np.load(path) as data:
                vp = np.asarray(data["vocab_p"], np.uint32)
                self.trained[vp.shape[0]] = dict(
                    vp=vp, vl=np.asarray(data["vocab_l"], np.uint32),
                    df_p=(np.asarray(data["df_p"], np.float32)
                          if "df_p" in data else None),
                    df_l=(np.asarray(data["df_l"], np.float32)
                          if "df_l" in data else None),
                    n_docs=float(data["n_docs"]) if "n_docs" in data else None)
            if path.endswith("vocab_synth.npz") or self.source == "random-anchors":
                self.source = path


_VOCAB = _Vocabularies()


def vocab_source() -> str:
    """Where the active codebooks came from (a file, or random anchors)."""
    _VOCAB.ensure()
    return _VOCAB.source


def __getattr__(name: str):
    # ``VOCAB_SOURCE``: the reference's module global ("random-anchors", the
    # path of the loaded file, or "set_vocab()"), read from the registry
    if name == "VOCAB_SOURCE":
        return vocab_source()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def trained_sizes() -> list[int]:
    _VOCAB.ensure()
    return sorted(_VOCAB.trained)


def active_vocab(vocab_k: int) -> tuple[np.ndarray, np.ndarray]:
    """The vocabulary used at size ``vocab_k``: the trained words when a
    codebook of that exact size is installed, random anchors otherwise."""
    _VOCAB.ensure()
    t = _VOCAB.trained.get(vocab_k)
    if t is not None:
        vl = t["vl"]
        return t["vp"], (vl if vl.shape[0] == vocab_k else _VOCAB.l_full[:vocab_k])
    return _VOCAB.p_full[:vocab_k], _VOCAB.l_full[:vocab_k]


def active_idf(vocab_k: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Frozen training-corpus idf vectors [(V,), (V,)], or None when no
    trained document frequencies exist for this vocabulary size (DBoW2
    fixes word weights from its training corpus, TemplatedVocabulary.h:
    1066-1127)."""
    _VOCAB.ensure()
    t = _VOCAB.trained.get(vocab_k)
    if t is not None and t["df_p"] is not None:
        idf_p = np.log((t["n_docs"] + 1.0) / (t["df_p"] + 1.0))
        idf_l = np.log((t["n_docs"] + 1.0) / (t["df_l"] + 1.0))
        return idf_p.astype(np.float32), idf_l.astype(np.float32)
    return None


def set_vocab(vocab_p: np.ndarray, vocab_l: np.ndarray,
              df_p: np.ndarray = None, df_l: np.ndarray = None,
              n_docs: float = None) -> None:
    """Install a trained vocabulary for its word count (the analog of
    loading the reference's pre-trained .yml files, config.cpp:59-60)."""
    _VOCAB.ensure()
    vp = np.asarray(vocab_p, np.uint32)
    _VOCAB.trained[vp.shape[0]] = dict(
        vp=vp, vl=np.asarray(vocab_l, np.uint32),
        df_p=np.asarray(df_p, np.float32) if df_p is not None else None,
        df_l=np.asarray(df_l, np.float32) if df_l is not None else None,
        n_docs=float(n_docs) if n_docs is not None else None)
    _VOCAB.source = "set_vocab()"
    _VOCAB.device_cache.clear()


def load_vocab(path: str) -> None:
    with np.load(path) as data:
        set_vocab(data["vocab_p"], data["vocab_l"], df_p=data.get("df_p"),
                  df_l=data.get("df_l"), n_docs=data.get("n_docs"))


def _device_vocab(vocab_k: int, device: torch.device):
    """(vocab_p, vocab_l) as int32 bit views and the frozen idf (or None),
    on ``device``, uploaded once."""
    key = (vocab_k, str(device))
    if key not in _VOCAB.device_cache:
        vp, vl = active_vocab(vocab_k)
        idf = active_idf(vocab_k)

        def up(a):
            return torch.from_numpy(np.array(a)).to(device)
        _VOCAB.device_cache[key] = (
            up(np.ascontiguousarray(vp).view(np.int32)),
            up(np.ascontiguousarray(vl).view(np.int32)),
            None if idf is None else (up(idf[0]), up(idf[1])))
    return _VOCAB.device_cache[key]


class LoopState(NamedTuple):
    """Per-KF BoW vectors + feature snapshots + confusion matrix."""
    bow_p: torch.Tensor      # [K, V] raw tf histograms (points)
    bow_l: torch.Tensor      # [K, V] (lines)
    df_p: torch.Tensor       # [V] int32 document frequencies
    df_l: torch.Tensor       # [V]
    n_docs: torch.Tensor     # int32
    n_pt: torch.Tensor       # [K] int32 feature counts
    n_ln: torch.Tensor
    std_pt: torch.Tensor     # [K] spatial dispersion (vector_stdv x + y)
    std_ln: torch.Tensor
    conf: torch.Tensor       # [K, K] combined scores (conf_matrix)
    # feature snapshots for geometric verification
    pt_p3d: torch.Tensor     # [K, N_KF_PT, 3] camera-frame 3D points
    pt_uv: torch.Tensor      # [K, N_KF_PT, 2]
    pt_desc: torch.Tensor    # [K, N_KF_PT, 8] int32
    pt_sigma2: torch.Tensor  # [K, N_KF_PT]
    pt_valid: torch.Tensor   # [K, N_KF_PT] bool
    ln_sp3d: torch.Tensor    # [K, N_KF_LN, 3]
    ln_ep3d: torch.Tensor    # [K, N_KF_LN, 3]
    ln_le: torch.Tensor      # [K, N_KF_LN, 3]
    ln_desc: torch.Tensor    # [K, N_KF_LN, 8] int32
    ln_sigma2: torch.Tensor  # [K, N_KF_LN]
    ln_valid: torch.Tensor   # [K, N_KF_LN] bool
    # features beyond the per-KF snapshot capacity (no silent caps)
    n_snapshot_dropped: torch.Tensor  # int32


def empty_loop_state(cfg: Config, device: torch.device = CUDA) -> LoopState:
    k, v = cfg.cap.n_kf_max, cfg.cap.vocab_k
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return LoopState(
        bow_p=torch.zeros((k, v), **f32), bow_l=torch.zeros((k, v), **f32),
        df_p=torch.zeros(v, **i32), df_l=torch.zeros(v, **i32),
        n_docs=torch.zeros((), **i32),
        n_pt=torch.zeros(k, **i32), n_ln=torch.zeros(k, **i32),
        std_pt=torch.zeros(k, **f32), std_ln=torch.zeros(k, **f32),
        conf=torch.zeros((k, k), **f32),
        pt_p3d=torch.zeros((k, N_KF_PT, 3), **f32),
        pt_uv=torch.zeros((k, N_KF_PT, 2), **f32),
        pt_desc=torch.zeros((k, N_KF_PT, 8), **i32),
        pt_sigma2=torch.ones((k, N_KF_PT), **f32),
        pt_valid=torch.zeros((k, N_KF_PT), **b),
        ln_sp3d=torch.zeros((k, N_KF_LN, 3), **f32),
        ln_ep3d=torch.zeros((k, N_KF_LN, 3), **f32),
        ln_le=torch.zeros((k, N_KF_LN, 3), **f32),
        ln_desc=torch.zeros((k, N_KF_LN, 8), **i32),
        ln_sigma2=torch.ones((k, N_KF_LN), **f32),
        ln_valid=torch.zeros((k, N_KF_LN), **b),
        n_snapshot_dropped=torch.zeros((), **i32))


def bow_vector(desc: torch.Tensor, valid: torch.Tensor, vocab: torch.Tensor
               ) -> torch.Tensor:
    """Raw tf histogram over nearest-anchor words
    (TemplatedVocabulary::transform on a flat vocabulary)."""
    word = torch.argmin(hamming_matrix(desc, vocab, valid_a=valid), 1)
    return torch.zeros(vocab.shape[0], device=desc.device).index_add(
        0, word, valid.to(torch.float32))


def _weighted_normalize(tf: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """Apply idf word weights + L1 normalize ([K?, V] tf)."""
    v = tf * idf
    return v / torch.clamp(torch.abs(v).sum(-1, keepdim=True), min=1e-9)


def _idf_normalize(tf: torch.Tensor, df: torch.Tensor, n_docs: torch.Tensor
                   ) -> torch.Tensor:
    """tf-idf weight + L1 normalize ([K?, V] tf against shared df)."""
    idf = torch.log((n_docs + 1.0) / (df.to(torch.float32) + 1.0))
    return _weighted_normalize(tf, idf)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score: 1 - 0.5 |v1 - v2|_1 in [0, 1]."""
    return 1.0 - 0.5 * torch.abs(v1 - v2).sum(-1)


def _masked_stdv(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(mask.sum(), min=1)
    mu = torch.where(mask, x, 0.0).sum() / n
    return torch.sqrt(torch.where(mask, (x - mu) ** 2, 0.0).sum() / n)


def _topk_snapshot(valid, score, n_out, *arrays):
    """Select up to n_out valid rows, best score first (stable sort, as
    ``jnp.argsort``), from padded arrays; zero-pads when the frame holds
    fewer slots than the snapshot."""
    n = valid.shape[0]
    key = torch.where(valid, -score, math.inf)
    order = torch.argsort(key, stable=True)[:min(n_out, n)]
    ok = valid[order]
    outs = tuple(a[order] for a in arrays)
    if n < n_out:
        pad = n_out - n
        ok = torch.cat([ok, ok.new_zeros(pad)])
        outs = tuple(torch.cat([a, a.new_zeros((pad, *a.shape[1:]))]) for a in outs)
    return (ok,) + outs


def insert_kf_bow(cfg: Config, ls: LoopState, kf_idx: torch.Tensor,
                  frame: StereoFrame) -> LoopState:
    """Compute this KF's dual BoW + dispersion stats, snapshot its features,
    and fill its conf-matrix row against all earlier KFs (:2976-2999):
    score = (sp*n_pt + sl*n_ln)/n_pl + (sp*std_pt + sl*std_ln)/std_pl."""
    f = frame.points
    fl = frame.lines
    dev = f.desc.device
    vocab_p, vocab_l, idf = _device_vocab(cfg.cap.vocab_k, dev)
    bow_p = bow_vector(f.desc, f.valid, vocab_p)
    bow_l = bow_vector(fl.desc, fl.valid, vocab_l)
    n_pt = f.valid.sum(dtype=torch.int32)
    n_ln = fl.valid.sum(dtype=torch.int32)
    std_pt = _masked_stdv(f.xy[:, 0], f.valid) + _masked_stdv(f.xy[:, 1], f.valid)
    mid = 0.5 * (fl.sp + fl.ep)
    std_ln = _masked_stdv(mid[:, 0], fl.valid) + _masked_stdv(mid[:, 1], fl.valid)

    df_p = ls.df_p + (bow_p > 0)
    df_l = ls.df_l + (bow_l > 0)
    n_docs = ls.n_docs + 1
    if idf is not None:
        # frozen training-corpus idf: scores are epoch-consistent
        sp = l1_score(_weighted_normalize(bow_p[None], idf[0]),
                      _weighted_normalize(ls.bow_p, idf[0]))
        sl = l1_score(_weighted_normalize(bow_l[None], idf[1]),
                      _weighted_normalize(ls.bow_l, idf[1]))
    else:
        # online-df fallback (untrained/random-anchor vocabularies)
        sp = l1_score(_idf_normalize(bow_p[None], df_p, n_docs),
                      _idf_normalize(ls.bow_p, df_p, n_docs))
        sl = l1_score(_idf_normalize(bow_l[None], df_l, n_docs),
                      _idf_normalize(ls.bow_l, df_l, n_docs))
    n_pl = torch.clamp(n_pt + n_ln, min=1)
    std_pl = torch.clamp(std_pt + std_ln, min=1e-9)
    score = (sp * n_pt + sl * n_ln) / n_pl + (sp * std_pt + sl * std_ln) / std_pl
    prior = torch.arange(ls.conf.shape[0], device=dev) < kf_idx
    row = torch.where(prior, score, 0.0)
    conf = set_rows(ls.conf, kf_idx, row)
    conf = set_rows(conf.T, kf_idx, row).T.contiguous()

    # quality keys: FAST corner response for points (frame.points rows are
    # left-feature-aligned), length for lines
    ln_d = fl.ep - fl.sp
    ln_len = torch.sqrt(ln_d[:, 0] * ln_d[:, 0] + ln_d[:, 1] * ln_d[:, 1])
    ok_p, p3, uv, dp, s2p = _topk_snapshot(f.valid, frame.feat_l.pt_score,
                                           N_KF_PT, f.p3d, f.xy, f.desc, f.sigma2)
    ok_l, s3, e3, le, dl, s2l = _topk_snapshot(fl.valid, ln_len, N_KF_LN,
                                               fl.sp3d, fl.ep3d, fl.le,
                                               fl.desc, fl.sigma2)

    def put(x, v):
        return set_rows(x, kf_idx, v)
    return ls._replace(
        bow_p=put(ls.bow_p, bow_p), bow_l=put(ls.bow_l, bow_l),
        df_p=df_p.to(torch.int32), df_l=df_l.to(torch.int32), n_docs=n_docs,
        n_pt=put(ls.n_pt, n_pt), n_ln=put(ls.n_ln, n_ln),
        std_pt=put(ls.std_pt, std_pt), std_ln=put(ls.std_ln, std_ln),
        conf=conf,
        pt_p3d=put(ls.pt_p3d, p3), pt_uv=put(ls.pt_uv, uv),
        pt_desc=put(ls.pt_desc, dp), pt_sigma2=put(ls.pt_sigma2, s2p),
        pt_valid=put(ls.pt_valid, ok_p),
        ln_sp3d=put(ls.ln_sp3d, s3), ln_ep3d=put(ls.ln_ep3d, e3),
        ln_le=put(ls.ln_le, le), ln_desc=put(ls.ln_desc, dl),
        ln_sigma2=put(ls.ln_sigma2, s2l), ln_valid=put(ls.ln_valid, ok_l),
        n_snapshot_dropped=(ls.n_snapshot_dropped
                            + torch.clamp(n_pt - N_KF_PT, min=0)
                            + torch.clamp(n_ln - N_KF_LN, min=0)))


def look_for_loop_candidates(cfg: Config, ls: LoopState,
                             full_graph: torch.Tensor,
                             kf_curr: torch.Tensor) -> torch.Tensor:
    """Candidate KF index or -1 (lookForLoopCandidates, :3002-3076)."""
    s = cfg.slam
    k = ls.conf.shape[0]
    kf_curr = torch.as_tensor(kf_curr, device=ls.conf.device).long()
    ids = torch.arange(k, device=ls.conf.device)
    row = ls.conf[kf_curr]
    far = ids < kf_curr - s.lc_kf_dist
    # min score among covisible/recent KFs (the adaptive threshold)
    connected = ((full_graph[:, kf_curr] + full_graph[kf_curr, :]
                  >= s.min_lm_cov_graph)
                 | ((kf_curr - ids <= s.min_kf_local_map + 3) & (ids < kf_curr)))
    cscores = torch.where(connected & (row > 0.001), row, math.inf)
    lc_min_score = torch.clamp(cscores.min(), max=1.0)
    cand_scores = torch.where(far, row, -math.inf)
    idx_max = torch.argmax(cand_scores)
    best = cand_scores[idx_max]
    # temporal consistency: enough KFs near idx_max also scoring high
    near = (torch.abs(ids - idx_max) <= s.lc_kf_max_dist) & far & (ids != idx_max)
    n_closest = (near & (row >= lc_min_score * 0.8)).sum()
    ok = ((far.sum() > s.lc_kf_max_dist) & (best >= lc_min_score)
          & (n_closest >= s.lc_nkf_closest))
    return torch.where(ok, idx_max, -1).to(torch.int32)


class LoopVerification(NamedTuple):
    accepted: torch.Tensor   # bool
    t_rel: torch.Tensor      # [4,4] T_curr<-prev relative pose estimate
    n_inliers: torch.Tensor
    err: torch.Tensor


def verify_loop(cfg: Config, ls: LoopState, kf_prev: torch.Tensor,
                kf_curr: torch.Tensor) -> LoopVerification:
    """KF<->KF mutual-best matching + robust GN from identity + acceptance
    gates (isLoopClosure/computeRelativePoseGN, :3078-3545): residual <
    lc_res, cov eig < lc_unc, inlier ratio > lc_inl, |t| < lc_trs,
    rot < lc_rot degrees."""
    s = cfg.slam
    kp = torch.as_tensor(kf_prev, device=ls.conf.device).long()
    kc = torch.as_tensor(kf_curr, device=ls.conf.device).long()
    mp = match_ops.mutual_best(hamming_matrix(
        ls.pt_desc[kp], ls.pt_desc[kc], ls.pt_valid[kp], ls.pt_valid[kc]))
    pts = pose_opt.PointMatches(
        p3d=ls.pt_p3d[kp], obs=ls.pt_uv[kc][mp.idx],
        sigma2=ls.pt_sigma2[kp], valid=mp.valid)
    ml = match_ops.mutual_best(hamming_matrix(
        ls.ln_desc[kp], ls.ln_desc[kc], ls.ln_valid[kp], ls.ln_valid[kc]))
    lns = pose_opt.LineMatches(
        sp3d=ls.ln_sp3d[kp], ep3d=ls.ln_ep3d[kp], le_obs=ls.ln_le[kc][ml.idx],
        sigma2=ls.ln_sigma2[kp], valid=ml.valid)

    eye = torch.eye(4, device=ls.conf.device)
    res = pose_opt.optimize_pose(cfg.camera, eye, pts, lns, cfg.optimizer,
                                 delta_t=1e9)
    n_match = mp.valid.sum() + ml.valid.sum()
    n_inl = res.pt_inlier.sum() + res.ln_inlier.sum()
    inl_ratio = n_inl / torch.clamp(n_match, min=1)
    tw = se3.logmap_se3(res.dt)
    trans = torch.sqrt((tw[:3] * tw[:3]).sum())
    rot_deg = torch.sqrt((tw[3:] * tw[3:]).sum()) * 180.0 / math.pi
    max_cov_eig = torch.linalg.eigvalsh(
        res.dt_cov + 1e-12 * torch.eye(6, device=eye.device)).max()
    accepted = (res.accepted & (res.err < s.lc_res) & (res.err >= 0)
                & (max_cov_eig < s.lc_unc) & (inl_ratio > s.lc_inl)
                & (trans < s.lc_trs) & (rot_deg < s.lc_rot))
    return LoopVerification(accepted=accepted, t_rel=res.dt,
                            n_inliers=n_inl.to(torch.int32), err=res.err)


# ---------------------------------------------------------------------------
# Pose-graph optimization (g2o replacement)
# ---------------------------------------------------------------------------

class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] int64
    j: torch.Tensor       # [E] int64
    t_ij: torch.Tensor    # [E, 4, 4] measured T_i^-1 T_j
    valid: torch.Tensor   # [E] bool


def build_edges(kf_pose: torch.Tensor, kf_valid: torch.Tensor,
                full_graph: torch.Tensor, min_covis: int,
                lc_i, lc_j, lc_t: torch.Tensor, max_edges: int,
                lc_valid=None) -> PoseGraphEdges:
    """Sequential + covisibility + loop edges (:4029-4066). Sequential and
    covisibility measurements come from the current estimates; ``lc_i/lc_j``
    [C] and ``lc_t`` [C, 4, 4] carry the verified loop constraints, and
    ``lc_valid`` pads them to a fixed count."""
    dev = kf_pose.device
    k = kf_pose.shape[0]
    ids = torch.arange(k, device=dev)
    lc_i = torch.as_tensor(lc_i, device=dev).long().reshape(-1)
    lc_j = torch.as_tensor(lc_j, device=dev).long().reshape(-1)
    lc_t = torch.as_tensor(lc_t, device=dev).reshape(-1, 4, 4)
    n_lc = lc_i.shape[0]
    # sequential edges: each valid KF to the PREVIOUS valid KF (chains
    # across holes left by remove_redundant_kfs)
    cm = torch.cummax(torch.where(kf_valid, ids, -1), 0).values
    prev = torch.cat([cm.new_full((1,), -1), cm[:-1]])
    seq_ok = kf_valid & (prev >= 0)
    seq_i = torch.where(seq_ok, prev, 0)[1:]
    seq_j = ids[1:]
    seq_ok = seq_ok[1:]
    # covisibility edges above threshold (upper triangle), strongest first
    counts = full_graph + full_graph.T
    iu, ju = torch.triu_indices(k, k, 1, device=dev)
    c = counts[iu, ju]
    cov_ok = (c >= min_covis) & kf_valid[iu] & kf_valid[ju] & (ju != iu + 1)
    budget = max_edges - (k - 1) - n_lc
    top = torch.sort(torch.where(cov_ok, c, -1), descending=True, stable=True)
    sel_ok = top.values[:budget] >= min_covis
    sel_pos = top.indices[:budget]

    e_i = torch.cat([seq_i, iu[sel_pos], lc_i])
    e_j = torch.cat([seq_j, ju[sel_pos], lc_j])
    lc_ok = (torch.ones(n_lc, dtype=torch.bool, device=dev) if lc_valid is None
             else torch.as_tensor(lc_valid, dtype=torch.bool, device=dev))
    e_ok = torch.cat([seq_ok, sel_ok, lc_ok])
    t_ij = se3.inverse_se3(kf_pose)[e_i] @ kf_pose[e_j]
    # overwrite the LC edges with the verified measurements
    t_ij = torch.cat([t_ij[:-n_lc], lc_t.to(t_ij.dtype)])
    return PoseGraphEdges(i=e_i, j=e_j, t_ij=t_ij, valid=e_ok)


def _edge_residual(pose_i, pose_j, xi, xj, tij):
    """r = log(T_ij^-1 T_i^-1 T_j) with T <- T exp(x) at both ends."""
    ti = pose_i @ se3.expmap_se3(xi)
    tj = pose_j @ se3.expmap_se3(xj)
    return se3.logmap_se3(se3.inverse_se3(tij) @ se3.inverse_se3(ti) @ tj)


def _edge_terms(pose_i, pose_j, xi, xj, tij, same):
    """Residuals [E, 6] and their Jacobians [E, 6, 6] in the twist of KF i
    and of KF j, by forward-mode AD over the 12 basis directions of each
    edge in one batch (``jax.jacfwd`` in the reference; ``torch.func.jacfwd``
    turns float32 tangents into float64 ones here, so it is not used).
    ``same`` [E, 1] (1.0 when i == j) moves both ends together, as
    ``x.at[i].add(d)`` does in the reference."""
    e = xi.shape[0]
    basis = torch.eye(6, dtype=xi.dtype, device=xi.device).expand(e, 6, 6)
    s = same[:, :, None]
    tan_i = torch.cat([basis, s * basis], 1).reshape(e * 12, 6)
    tan_j = torch.cat([s * basis, basis], 1).reshape(e * 12, 6)

    def rep(t):
        return t[:, None].expand(e, 12, *t.shape[1:]).reshape(e * 12, *t.shape[1:])
    with fwAD.dual_level():
        r = _edge_residual(rep(pose_i), rep(pose_j),
                           fwAD.make_dual(rep(xi), tan_i),
                           fwAD.make_dual(rep(xj), tan_j), rep(tij))
        primal, tangent = fwAD.unpack_dual(r)
    jac = tangent.reshape(e, 12, 6).transpose(1, 2)      # [E, out, dir]
    return primal.reshape(e, 12, 6)[:, 0], jac[:, :, :6], jac[:, :, 6:]


def optimize_pose_graph(kf_pose: torch.Tensor, kf_valid: torch.Tensor,
                        edges: PoseGraphEdges, fixed: torch.Tensor,
                        iters: int = 50) -> torch.Tensor:
    """Dense GN on an SE(3) pose graph: residual r = log(T_ij^-1 T_i^-1 T_j),
    identity information (:4052-4072; replaces g2o LM + Cholmod). Runs at
    most ``iters`` steps and stops after the first whose largest twist
    change is <= 1e-7, where the reference's loop stops: a later step
    would change nothing. Each step ends with one host read of that change."""
    k = kf_pose.shape[0]
    ei, ej = edges.i, edges.j
    w = edges.valid.to(kf_pose.dtype)
    same = (ei == ej).to(kf_pose.dtype)[:, None]
    free = kf_valid & ~fixed
    mask = free.repeat_interleave(6)
    mask2 = mask[:, None] & mask[None, :]
    reg = torch.diag(torch.where(mask, 1e-8, 1.0))
    pose_i, pose_j = kf_pose[ei], kf_pose[ej]
    # edge -> KF one-hots: the sums over edges are matrix products, whose
    # order is fixed; a duplicate-index index_add_ on the card sums in no
    # fixed order, and the closure's poses would differ from run to run
    idx = torch.arange(k, device=ei.device)
    oh_i = (ei[:, None] == idx).to(kf_pose.dtype)
    oh_j = (ej[:, None] == idx).to(kf_pose.dtype)

    def pair_blocks(oh_a, oh_b, ja, jb):
        """sum_e [a_e = a][b_e = b] ja_e^T jb_e as [K, 6, K, 6]."""
        m = torch.einsum("eri,erj->eij", ja, jb)
        t = (oh_a[:, :, None, None] * m[:, None]).reshape(m.shape[0], -1)
        return (t.T @ oh_b).reshape(k, 6, 6, k).permute(0, 1, 3, 2)

    def gn_step(x):
        r, ji, jj = _edge_terms(pose_i, pose_j, x[ei], x[ej], edges.t_ij, same)
        r = r * w[:, None]
        ji = ji * w[:, None, None]
        jj = jj * w[:, None, None]
        h = (pair_blocks(oh_i, oh_i, ji, ji) + pair_blocks(oh_j, oh_j, jj, jj)
             + pair_blocks(oh_i, oh_j, ji, jj) + pair_blocks(oh_j, oh_i, jj, ji))
        b = (oh_i.T @ torch.einsum("eri,er->ei", ji, r)
             + oh_j.T @ torch.einsum("eri,er->ei", jj, r))
        hf = torch.where(mask2, h.reshape(6 * k, 6 * k), 0.0) + reg
        bf = torch.where(mask, b.reshape(-1), 0.0)
        dx = torch.linalg.solve_ex(hf, bf)[0].reshape(k, 6)
        return x - torch.where(free[:, None], dx, 0.0)

    x = kf_pose.new_zeros((k, 6))
    for _ in range(iters):
        trace.count("pgo.steps_dispatched", 1)
        trace.count("pgo.steps_active", 1)
        x_new = gn_step(x)
        delta = torch.abs(x_new - x).max()
        x = x_new
        with trace.wait("wait.pgo_step"):
            if not bool(delta > 1e-7):
                break
    return kf_pose @ se3.expmap_se3(x)


def rigid_correct_landmarks(kf_old: torch.Tensor, kf_new: torch.Tensor,
                            lm_pos: torch.Tensor, lm_kf: torch.Tensor,
                            lm_valid: torch.Tensor) -> torch.Tensor:
    """Apply each landmark's owner-KF correction T_new T_old^-1
    (:4074-4127). An owner index past the end reads the last KF, as the
    reference's clamped gather does."""
    t = (kf_new @ se3.inverse_se3(kf_old))[torch.clamp(lm_kf.long(), 0,
                                                       kf_old.shape[0] - 1)]
    moved = (t[:, :3, :3] @ lm_pos[:, :, None])[:, :, 0] + t[:, :3, 3]
    return torch.where(lm_valid[:, None], moved, lm_pos)

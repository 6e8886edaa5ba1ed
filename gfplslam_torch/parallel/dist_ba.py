"""Landmark-sharded bundle adjustment over a process group.

Port of ``gfplslam_tpu/parallel/dist_ba.py``. Landmarks and all their
observations are split into contiguous blocks, one per rank; keyframe
poses are replicated. Each rank assembles its landmarks' blocks and their
Schur reductions of the camera system, the reduced [6K, 6K] system and its
right-hand side are summed over the ranks, every rank solves the same
small camera system, and each back-substitutes its own landmarks.

The reference runs this under ``shard_map`` on one controller's mesh and
sums with ``psum``. PyTorch runs one process per rank, so here a rank is a
member of a ``torch.distributed`` group and the sum is ``dist.all_reduce``
(SUM); the landmark-sharded outputs are gathered with ``all_gather`` so
every rank returns the full result, as the reference's ``out_specs`` do.
Where the reference asks ``len(jax.devices()) > 1``, the port asks for an
initialized default group with ``world_size > 1`` (``multihost.py``).

The LM loop is ``models/ba.py::solve_ba``'s fixed ``max_iters`` loop with
an ``active`` mask: the all-reduced error keeps every rank's lambda
schedule identical, with no host read per iteration.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gfplslam_torch.config import CameraParams
from gfplslam_torch.models import ba as ba_ops
from gfplslam_torch.models import ba_core
from gfplslam_torch.models.ba import BAProblem, BAResult
from gfplslam_torch.parallel.multihost import all_gather_cat


def make_mesh(n_ranks: int | None = None):
    """The group of the first ``n_ranks`` ranks of the default group (all
    of them by default). Every rank of the default group must call it;
    ranks outside the group take no part in its collectives."""
    n = n_ranks or dist.get_world_size()
    return dist.new_group(ranks=list(range(n)))


def shard_problem_by_landmark(prob: BAProblem, n_shards: int,
                              return_perm: bool = False):
    """Reorder + pad the problem so landmark blocks and their observations
    partition evenly into ``n_shards`` contiguous blocks (host-side, once
    per window). Observations of landmark slot i go to shard i % n_shards
    after a stable re-binning of landmark slots.

    With ``return_perm``, also returns (po_perm, lo_perm): for each sharded
    observation slot, the ORIGINAL problem index it came from (-1 = padding)
    — needed to map the sharded solve's outlier marks back onto the
    original problem's observation order."""
    dev = prob.kf_pose.device

    def pad_to(x, n):
        x = x.cpu().numpy()
        pad = n - x.shape[0]
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    def as_t(x):
        return torch.as_tensor(x, device=dev)

    p = prob.pt_pos.shape[0]
    l = prob.ln_sp.shape[0]
    p_pad = -(-p // n_shards) * n_shards
    l_pad = -(-l // n_shards) * n_shards
    op = prob.po_kf.shape[0]
    ol = prob.lo_kf.shape[0]
    op_pad = -(-op // n_shards) * n_shards
    ol_pad = -(-ol // n_shards) * n_shards

    # landmark slots keep their ids (block partition: slot // (p_pad/n))
    new = prob._replace(
        pt_pos=as_t(pad_to(prob.pt_pos, p_pad)),
        pt_valid=as_t(pad_to(prob.pt_valid, p_pad)),
        ln_sp=as_t(pad_to(prob.ln_sp, l_pad)),
        ln_ep=as_t(pad_to(prob.ln_ep, l_pad)),
        ln_valid=as_t(pad_to(prob.ln_valid, l_pad)),
    )

    # re-bin observations so each obs lands in its landmark's shard
    def rebin(kf, lm, payload, sigma2, valid, n_lm_pad, n_obs_pad):
        kf = kf.cpu().numpy()
        lm = lm.cpu().numpy()
        valid = valid.cpu().numpy()
        payload = payload.cpu().numpy()
        sigma2 = sigma2.cpu().numpy()
        block = n_lm_pad // n_shards
        shard_of = np.where(valid, lm // block, n_shards)  # invalid -> tail
        # per-shard capacity sized to the LARGEST shard's load (rounded up
        # for shape stability): a uniform n_obs_pad/n_shards split would
        # drop observations whenever landmark popularity is skewed
        load = np.bincount(shard_of[shard_of < n_shards],
                           minlength=n_shards)
        per = max(-(-int(load.max(initial=1)) // 64) * 64,
                  n_obs_pad // n_shards)
        n_obs_pad = per * n_shards
        order = np.argsort(shard_of * n_obs_pad + np.arange(len(lm)),
                           kind="stable")
        out_idx = np.full(n_obs_pad, -1, np.int64)
        counts = np.zeros(n_shards, np.int64)
        for oi in order:
            s = shard_of[oi]
            if s >= n_shards:
                continue
            out_idx[s * per + counts[s]] = oi
            counts[s] += 1
        ok = out_idx >= 0
        safe = np.where(ok, out_idx, 0)
        return (as_t(np.where(ok, kf[safe], 0).astype(np.int32)),
                as_t(np.where(ok, lm[safe], 0).astype(np.int32)),
                as_t(np.where(ok[:, None], payload[safe], 0)
                     .astype(np.float32)),
                as_t(np.where(ok, sigma2[safe], 1).astype(np.float32)),
                as_t(ok & np.where(ok, valid[safe], False)),
                as_t(np.where(ok, out_idx, -1).astype(np.int32)))

    po = rebin(prob.po_kf, prob.po_lm, prob.po_uv, prob.po_sigma2,
               prob.po_valid, p_pad, op_pad)
    lo = rebin(prob.lo_kf, prob.lo_lm, prob.lo_le, prob.lo_sigma2,
               prob.lo_valid, l_pad, ol_pad)
    sharded = new._replace(po_kf=po[0], po_lm=po[1], po_uv=po[2],
                           po_sigma2=po[3], po_valid=po[4],
                           lo_kf=lo[0], lo_lm=lo[1], lo_le=lo[2],
                           lo_sigma2=lo[3], lo_valid=lo[4])
    if return_perm:
        return sharded, po[5], lo[5]
    return sharded


def _gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Index as an XLA gather reads it: negatives count from the end, then
    clamp into [0, n). Only padded (invalid) observations fall outside."""
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def solve_ba_sharded(cam: CameraParams, prob: BAProblem, group=None,
                     lambda0: float = 1e-3, lambda_k: float = 10.0,
                     max_iters: int = 20, tol: float = 1e-5) -> BAResult:
    """Landmark-sharded LM solve over ``group`` (the default group when
    None). ``prob`` must be pre-partitioned with
    :func:`shard_problem_by_landmark` for the group's size, and every
    member rank calls this with the same problem; each returns the full
    result."""
    n = dist.get_world_size(group)
    shard = dist.get_rank(group)
    p_block = prob.pt_pos.shape[0] // n
    l_block = prob.ln_sp.shape[0] // n
    po_block = prob.po_kf.shape[0] // n
    lo_block = prob.lo_kf.shape[0] // n

    def block(x, size):
        return x[shard * size:(shard + 1) * size]

    lm_fields = {f: block(getattr(prob, f), p_block)
                 for f in ("pt_pos", "pt_valid")}
    lm_fields.update({f: block(getattr(prob, f), l_block)
                      for f in ("ln_sp", "ln_ep", "ln_valid")})
    lm_fields.update({f: block(getattr(prob, f), po_block)
                      for f in ("po_kf", "po_lm", "po_uv", "po_sigma2",
                                "po_valid")})
    lm_fields.update({f: block(getattr(prob, f), lo_block)
                      for f in ("lo_kf", "lo_lm", "lo_le", "lo_sigma2",
                                "lo_valid")})
    # observation landmark ids are global; make them shard-local
    raw = prob._replace(**lm_fields)
    raw = raw._replace(po_lm=raw.po_lm - shard * p_block,
                       lo_lm=raw.lo_lm - shard * l_block)
    # the selectors take the raw ids (an id outside the block is a zero
    # row, as in the reference's one-hot); the residual gathers read them
    # as the reference's gathers do
    lp = raw._replace(po_lm=_gather_index(raw.po_lm, p_block),
                      lo_lm=_gather_index(raw.lo_lm, l_block))

    def psum(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)  # in place
        return x

    res = ba_ops.solve_ba(cam, lp, lambda0=lambda0, lambda_k=lambda_k,
                          max_iters=max_iters, tol=tol,
                          sel=ba_core.make_selectors(raw), psum=psum)
    return res._replace(
        pt_pos=all_gather_cat(res.pt_pos, group),
        ln_sp=all_gather_cat(res.ln_sp, group),
        ln_ep=all_gather_cat(res.ln_ep, group),
        po_inlier=all_gather_cat(res.po_inlier, group),
        lo_inlier=all_gather_cat(res.lo_inlier, group))

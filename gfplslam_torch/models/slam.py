"""Full SLAM system: tracking front-end + mapping back-end + loop closure.

Port of ``gfplslam_tpu/models/slam.py`` (``plslam_mod``'s main loop +
``MapHandler`` orchestration, app/plslam_mod.cpp:318-513,
mapHandler.cpp:113-187, 2801-2868): per frame, run VO; on a keyframe, insert
it into the map, run local BA, cull landmarks, score loop candidates, and on
a verified loop run pose-graph optimization with rigid landmark correction
and landmark fusion. The loop-closure state machine (LC_IDLE -> LC_ACTIVE
-> LC_READY, mapHandler.h:123-156) runs on the host; the numeric work is
queued on ``device`` (the CUDA card unless the caller passes another).

Host reads sit where the reference has them: one packed read per chunk of
the streaming driver, one packed loop-closure row per keyframe (read one
keyframe, or one chunk, late: the async-mapping semantics), the corrected
keyframe pose at each tracker rebase, and the map sizes at a loop closure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from gfplslam_torch.config import Config
from gfplslam_torch.models import ba as ba_ops
from gfplslam_torch.models import loop as loop_ops
from gfplslam_torch.models import map as map_ops
from gfplslam_torch.models import mapping
from gfplslam_torch.models import vo as vo_mod
from gfplslam_torch.models.vo import VisualOdometry

CUDA = torch.device("cuda")
LC_IDLE, LC_ACTIVE, LC_READY = 0, 1, 2


def _pack_lc(cand, accepted, err, t_rel) -> torch.Tensor:
    """One [19] float32 tensor for the LC decision's host read: cand,
    accepted, err, 4x4 t_rel."""
    return torch.cat([
        torch.stack([cand.to(torch.float32), accepted.to(torch.float32),
                     err.to(torch.float32)]),
        t_rel.reshape(-1).to(torch.float32)])


@dataclass
class SLAMSystem:
    cfg: Config
    device: torch.device = CUDA
    run_local_ba: bool = True
    run_loop_closure: bool = True
    # working version of the reference's declared-but-disabled
    # removeRedundantKFs (mapHandler.cpp:2632-2795); opt-in
    cull_redundant_kfs: bool = False
    # asynchronous mapping (addKeyFrame_multiThread, mapHandler.h:86-88):
    # a KF's loop-closure decision and the tracker rebase are harvested at
    # the NEXT KF, so tracking never waits on mapping. On by default, as in
    # the reference; async_mapping=False gives the blocking driver.
    async_mapping: bool = True
    vo: VisualOdometry = None
    map: map_ops.MapState = None
    loop_state: loop_ops.LoopState = None
    lc_status: int = LC_IDLE
    # verified constraints accumulated while LC_ACTIVE: [(kf_prev, kf_curr,
    # t_rel, err), ...] — flushed as pose-graph edges when the revisit ends
    # (lc_idx_list/lc_pose_list, mapHandler.cpp:2820-2834)
    lc_pending: list = field(default_factory=list)
    n_loop_closures: int = 0
    n_fused_landmarks: int = 0
    kf_frame_ids: list = field(default_factory=list)
    kf_timestamps: list = field(default_factory=list)
    # observability counters (capped-work events that must not be silent)
    counters: dict = field(default_factory=dict)
    # async-mapping deferred results: (kf_idx, cand, verification)
    _deferred: tuple = None
    # streaming driver: chunk LC rows awaiting their read, and the scan state
    _lc_deferred: tuple = None
    _ts_base: float = None
    _scan_carry: tuple = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.vo is None:
            self.vo = VisualOdometry(self.cfg, device=self.device)
        if self.map is None:
            self.map = map_ops.empty_map(self.cfg, self.device)
        if self.loop_state is None:
            self.loop_state = loop_ops.empty_loop_state(self.cfg, self.device)
        # host mirror of map.n_kf so queuing never reads the map back
        self._n_kf_host = int(self.map.n_kf)

    def _scalar(self, v, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def process(self, img_l: np.ndarray, img_r: np.ndarray, timestamp: float):
        """One stereo frame through the full system."""
        rec = self.vo.process(img_l, img_r, timestamp)
        frame = self.vo.prev_frame  # the frame just processed

        if rec.is_kf and not self.vo.lost:
            kf_idx = self._n_kf_host
            if self.async_mapping:
                # harvest the PREVIOUS KF's mapping results
                self._harvest_deferred()
            if kf_idx == 0:
                self.map = map_ops.initialize_map(self.cfg, self.map, frame)
                self.loop_state = loop_ops.insert_kf_bow(
                    self.cfg, self.loop_state, self._scalar(kf_idx), frame)
            else:
                # VO relative motion KF_{k-1} -> KF_k only; the map composes
                # it onto the *optimized* previous KF pose (T_kf_w = T_prev_w
                # * T_rel, mapHandler.cpp:126-128)
                t_rel = torch.as_tensor(self.vo.last_kf_rel.astype(np.float32),
                                        device=self.device)
                res = mapping.mapping_step(
                    self.cfg, self.map, self.loop_state, frame, t_rel,
                    run_ba=self.run_local_ba, run_lc=self.run_loop_closure,
                    cull_redundant=self.cull_redundant_kfs)
                self.map = res.map
                self.loop_state = res.loop_state
                if self.run_loop_closure:
                    if self.async_mapping:
                        self._deferred = (kf_idx, res.cand, res.verification)
                    else:
                        self._lc_decide(res.cand, res.verification, kf_idx)
            self.kf_frame_ids.append(self.vo.frame_idx - 1)
            self.kf_timestamps.append(timestamp)
            self._n_kf_host = kf_idx + 1
            if not self.async_mapping:
                # subsequent frames ride the optimized map
                self.vo.rebase(self.kf_pose_world(kf_idx))
        return rec

    # ------------------------------------------------------------------
    def process_chunk(self, imgs_l, imgs_r, timestamps) -> None:
        """Streaming chunk driver: the chunk's tracking runs as one queued
        scan (models/vo.py run_vo_scan_chunk), its host-visible scalars come
        back as ONE packed read, and keyframe mapping slices the scan's
        stacked per-frame features on the device. Map corrections (BA/PGO)
        land between keyframes exactly as in the per-frame driver."""
        self._process_scanned(self._scan_chunk(imgs_l, imgs_r, timestamps))

    def _scan_chunk(self, imgs_l, imgs_r, timestamps):
        """Queue one chunk's tracking scan with NO host read. Returns the
        pending state _process_scanned consumes (None if the chunk held
        only the bootstrap frame)."""
        if not torch.is_tensor(imgs_l):
            imgs_l = np.asarray(imgs_l)
        if not torch.is_tensor(imgs_r):
            imgs_r = np.asarray(imgs_r)
        timestamps = np.asarray(timestamps, np.float64)
        # Normalize timestamps on the host in float64 BEFORE the float32
        # device cast: at EuRoC epoch scale (~1.4e9 s) float32 resolution is
        # 128 s, which would round every frame's dt to 0 (slam.py:181-189 of
        # the reference).
        if self._ts_base is None:
            self._ts_base = float(timestamps[0])
        ts_norm = timestamps - self._ts_base
        start = 0
        if self._scan_carry is None:
            carry, frame0 = vo_mod.init_scan_carry(
                self.cfg, imgs_l[0], imgs_r[0], float(ts_norm[0]),
                device=self.device)
            self._scan_carry = carry
            self._abs_prev_kf = np.eye(4)     # absolute VO pose, last KF
            # device-resident mirror of _abs_prev_kf (mapping_step_chunk
            # computes t_rel on the device)
            self._abs_prev_kf_dev = torch.eye(4, device=self.device)
            # frame 0 initializes the map (first keyframe)
            self.map = map_ops.initialize_map(self.cfg, self.map, frame0)
            self.loop_state = loop_ops.insert_kf_bow(
                self.cfg, self.loop_state, self._scalar(0), frame0)
            self.kf_frame_ids.append(0)
            self.kf_timestamps.append(float(timestamps[0]))
            self._n_kf_host = 1
            self.vo.records.append(vo_mod.FrameRecord(
                float(timestamps[0]), np.eye(4), True, 0, 0, True,
                base_kf=0, t_rel_base=np.eye(4)))
            self.vo.frame_idx += 1
            self.vo.kf_count = 1
            start = 1
        if start >= len(imgs_l):
            return None
        carry, poses, aux, frames = vo_mod.run_vo_scan_chunk(
            self.cfg, self._scan_carry, imgs_l[start:], imgs_r[start:],
            ts_norm[start:].astype(np.float32), device=self.device)
        self._scan_carry = carry
        return (vo_mod.pack_chunk_aux(self.cfg, poses, aux), frames, poses,
                timestamps[start:])

    def _process_scanned(self, scanned) -> None:
        """Harvest one queued chunk: read the packed per-frame scalars (the
        chunk's ONE device->host transfer), queue keyframe mapping on the
        device-resident stacked features, and stack the LC rows for the
        next chunk boundary."""
        if scanned is None:
            return
        # decisions for the PREVIOUS chunk's LC verifications first
        self._drain_lc()
        packed_dev, frames, poses, ts_abs = scanned
        packed = packed_dev.cpu().numpy()
        lc_queue = []   # (kf_idx, cand, verification), decided one chunk late
        for j in range(packed.shape[0]):
            is_kf = packed[j, 0] > 0.5
            accepted = packed[j, 1] > 0.5
            t_abs = packed[j, 5:21].reshape(4, 4).astype(np.float64)
            # the tracker's cumulative loss verdict persists across chunks
            if packed[j, 2] > 0.5:
                self.vo.lost = True
            ts_j = float(ts_abs[j])
            if is_kf and not self.vo.lost:
                kf_idx = self._n_kf_host
                res, self._abs_prev_kf_dev = mapping.mapping_step_chunk(
                    self.cfg, self.map, self.loop_state, frames, j, poses,
                    self._abs_prev_kf_dev, run_ba=self.run_local_ba,
                    run_lc=self.run_loop_closure,
                    cull_redundant=self.cull_redundant_kfs)
                self.map = res.map
                self.loop_state = res.loop_state
                if self.run_loop_closure:
                    lc_queue.append((kf_idx, res.cand, res.verification))
                self.kf_frame_ids.append(self.vo.frame_idx)
                self.kf_timestamps.append(ts_j)
                self._n_kf_host = kf_idx + 1
                self.vo.kf_count += 1
                self._abs_prev_kf = t_abs.copy()
                base_kf = kf_idx
                t_rel_base = np.eye(4)
            else:
                base_kf = self._n_kf_host - 1
                t_rel_base = np.linalg.inv(self._abs_prev_kf) @ t_abs
            self.vo.records.append(vo_mod.FrameRecord(
                ts_j, t_abs, bool(is_kf), int(packed[j, 3]), int(packed[j, 4]),
                bool(accepted), base_kf=base_kf, t_rel_base=t_rel_base))
            self.vo.frame_idx += 1
        if lc_queue:
            # ONE device tensor for the chunk's LC decisions, read at the next
            # chunk boundary (reading now would wait on this chunk's mapping)
            self._lc_deferred = (
                [kf for kf, _, _ in lc_queue],
                torch.stack([_pack_lc(c, v.accepted, v.err, v.t_rel)
                             for _, c, v in lc_queue]))

    def _drain_lc(self) -> None:
        """Read + apply a deferred chunk's LC decisions (one transfer)."""
        if self._lc_deferred is None:
            return
        kf_ids, rows_dev = self._lc_deferred
        self._lc_deferred = None
        for kf_idx, row in zip(kf_ids, rows_dev.cpu().numpy()):
            self._lc_decide_row(row, kf_idx)

    def run_sequence(self, imgs_l, imgs_r, timestamps, chunk: int = 24) -> None:
        """Drive a whole sequence through the streaming chunk driver with
        double-buffered image upload: chunk k+1 is staged host->device
        before chunk k's scan is queued. Chunk boundaries make every scan
        exactly ``chunk`` frames long (frame 0 is consumed by map init)."""
        n = len(imgs_l)
        if n == 0:
            return
        bounds = [0, min(chunk + 1, n)]
        while bounds[-1] < n:
            bounds.append(min(bounds[-1] + chunk, n))
        pin = self.device.type == "cuda"

        def stage(s, e):
            a, b = imgs_l[s:e], imgs_r[s:e]
            if not torch.is_tensor(a):
                a, b = (torch.from_numpy(np.ascontiguousarray(x)) for x in (a, b))
                if pin:
                    a, b = a.pin_memory(), b.pin_memory()
            return (a.to(self.device, non_blocking=True),
                    b.to(self.device, non_blocking=True))

        nxt = stage(bounds[0], bounds[1])
        pending = None
        for k in range(len(bounds) - 1):
            s, e = bounds[k], bounds[k + 1]
            cur = nxt
            if k + 2 < len(bounds):
                nxt = stage(bounds[k + 1], bounds[k + 2])
            # queue chunk k's scan BEFORE harvesting chunk k-1's mapping
            scanned = self._scan_chunk(cur[0], cur[1], timestamps[s:e])
            self._process_scanned(pending)
            pending = scanned
        self._process_scanned(pending)

    def _harvest_deferred(self):
        """Apply the previous KF's deferred mapping decisions (async mode):
        LC state machine, then tracker rebase onto the corrected map pose."""
        if self._deferred is not None:
            kf_idx, cand, ver = self._deferred
            self._deferred = None
            self._lc_decide(cand, ver, kf_idx)
        if self._n_kf_host > 0:
            self.vo.rebase(self.kf_pose_world(self._n_kf_host - 1))

    # ------------------------------------------------------------------
    def kf_pose_world(self, kf_idx: int) -> np.ndarray:
        return self.map.kf_pose[kf_idx].cpu().numpy()

    def _lc_decide(self, cand, ver, kf_curr: int):
        """The host-side LC state machine on one keyframe's candidate and
        verification: one packed read."""
        self._lc_decide_row(
            _pack_lc(cand, ver.accepted, ver.err, ver.t_rel).cpu().numpy(),
            kf_curr)

    def _lc_decide_row(self, packed: np.ndarray, kf_curr: int):
        """LC state machine on an already-read [19] _pack_lc row."""
        cand = int(packed[0])
        verified = cand >= 0 and packed[1] > 0.5
        if verified:
            self.lc_pending.append(
                (cand, kf_curr, packed[3:19].reshape(4, 4).astype(np.float64),
                 float(packed[2])))
            self.lc_status = LC_ACTIVE
        elif self.lc_status == LC_ACTIVE:
            # the revisit has ended: close now (LC_ACTIVE -> LC_READY ->
            # optimize, mapHandler.cpp:2840-2861)
            self.lc_status = LC_READY
            self._close_loop()

    def _bump(self, name: str, by: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def _close_loop(self):
        if not self.lc_pending:
            return
        # constraints much worse than the best verified one are dropped
        # before they enter the pose graph as identity-weighted edges
        best_err = min(p[3] for p in self.lc_pending)
        keep = [p for p in self.lc_pending
                if p[3] <= max(2.0 * best_err, best_err + 0.1)]
        self._bump("lc_constraints_dropped", len(self.lc_pending) - len(keep))
        self.lc_pending = keep
        m = self.map
        dev = self.device
        # the constraint set is padded to a fixed length, best verification
        # error first
        n_lc_max = 8
        pend = sorted(self.lc_pending, key=lambda p: p[3])[:n_lc_max]
        self._bump("lc_constraints_over_cap",
                   max(0, len(self.lc_pending) - n_lc_max))
        n_pad = n_lc_max - len(pend)
        lc_i = torch.tensor([p[0] for p in pend] + [0] * n_pad, device=dev)
        lc_j = torch.tensor([p[1] for p in pend] + [0] * n_pad, device=dev)
        lc_t = torch.as_tensor(np.stack(
            [np.linalg.inv(p[2]).astype(np.float32) for p in pend]
            + [np.eye(4, dtype=np.float32)] * n_pad), device=dev)
        lc_valid = torch.tensor([True] * len(pend) + [False] * n_pad, device=dev)
        kf_prev, kf_curr = pend[0][0], pend[0][1]
        # pose-graph size: power-of-two buckets over the occupied KF count
        # (a [6K x 6K] solve per GN step at full capacity is ~100x the work)
        k_cap = m.kf_pose.shape[0]
        n_kf = int(m.n_kf)
        k_b = 32
        while k_b < min(n_kf, k_cap):
            k_b *= 2
        k_b = min(k_b, k_cap)
        edges = loop_ops.build_edges(
            m.kf_pose[:k_b], m.kf_valid[:k_b], m.full_graph[:k_b, :k_b],
            self.cfg.slam.min_lm_ess_graph, lc_i, lc_j, lc_t,
            max_edges=int(k_b * 4), lc_valid=lc_valid)
        # every constraint's current KF is seeded at the constraint-implied
        # pose (mapHandler.cpp:4005-4025); only the best-error constraint's
        # KF is fixed, the rest stay soft edges
        kf_pose = m.kf_pose[:k_b].cpu().numpy()
        fixed = np.zeros(k_b, bool)
        fixed[0] = True
        best_err = min(p[3] for p in pend)
        for p_i, c_i, t_rel_i, v_err in pend:
            kf_pose[c_i] = (kf_pose[p_i] @ np.linalg.inv(t_rel_i)).astype(np.float32)
            fixed[p_i] = True
            if v_err <= best_err:
                fixed[c_i] = True
        new_b = loop_ops.optimize_pose_graph(
            torch.as_tensor(kf_pose, device=dev), m.kf_valid[:k_b], edges,
            torch.as_tensor(fixed, device=dev),
            iters=min(self.cfg.slam.max_iters_pgo, 50))
        old_b = m.kf_pose[:k_b]
        self.map = m._replace(
            kf_pose=torch.cat([new_b, m.kf_pose[k_b:]]),
            pt_pos=loop_ops.rigid_correct_landmarks(
                old_b, new_b, m.pt_pos, m.pt_last_kf, m.pt_valid),
            ln_sp=loop_ops.rigid_correct_landmarks(
                old_b, new_b, m.ln_sp, m.ln_last_kf, m.ln_valid),
            ln_ep=loop_ops.rigid_correct_landmarks(
                old_b, new_b, m.ln_ep, m.ln_last_kf, m.ln_valid))
        # merge duplicate landmarks across the junction
        # (loopClosureFuseLandmarks, mapHandler.cpp:4425-4714)
        self.map, n_fused, n_over = map_ops.fuse_loop_landmarks(
            self.cfg, self.map, self._scalar(kf_prev), self._scalar(kf_curr))
        n_fused, n_over = (int(v) for v in torch.stack([n_fused, n_over]).tolist())
        self.n_fused_landmarks += n_fused
        # no silent caps: surface candidates the N_FUSE compaction dropped
        self._bump("fuse_candidates_over_cap", n_over)
        self.n_loop_closures += 1
        self.lc_pending = []
        self.lc_status = LC_IDLE
        # the tracker rides the corrected trajectory from here on
        self.vo.rebase(self.kf_pose_world(n_kf - 1))

    # ------------------------------------------------------------------
    def finish(self, run_global_ba: bool = False):
        """Flush deferred mapping results and any pending loop closure
        (finishSLAM, mapHandler.cpp:96-111); optionally refine everything
        with one dense global BA on this device (globalBundleAdjustment,
        mapHandler.cpp:1844-1948)."""
        if self.async_mapping:
            self._harvest_deferred()
        self._drain_lc()
        if self.lc_pending:
            self._close_loop()
        self.counters["snapshot_features_over_cap"] = int(
            self.loop_state.n_snapshot_dropped)
        if run_global_ba and int(self.map.n_kf) >= 2:
            (prob, win_ids, p_ids, l_ids, po_src,
             lo_src) = map_ops.build_local_ba_problem(self.cfg, self.map,
                                                      global_ba=True)
            res = ba_ops.solve_ba(self.cfg.camera, prob,
                                  lambda0=self.cfg.slam.lambda_lba_lm,
                                  lambda_k=self.cfg.slam.lambda_lba_k,
                                  max_iters=self.cfg.slam.max_iters_lba)
            self.map = map_ops.apply_ba_result(self.cfg, self.map, res,
                                               win_ids, p_ids, l_ids)
            # post-BA outlier-observation deletion (mapHandler.cpp:1714-1836)
            self.map = map_ops.apply_ba_outliers(self.cfg, self.map, res,
                                                 po_src, lo_src)

    @property
    def keyframe_trajectory(self) -> np.ndarray:
        """Optimized map KF poses (plslam_mod.cpp:538-566)."""
        return self.map.kf_pose[:int(self.map.n_kf)].cpu().numpy()

    @property
    def all_frame_trajectory(self) -> np.ndarray:
        """Every frame re-based onto its base KF's *optimized* pose:
        T_frame = T_kf(map) @ T_rel(vo)."""
        kf_pose = self.map.kf_pose.cpu().numpy()
        n_kf = int(self.map.n_kf)
        out = []
        for r in self.vo.records:
            if r.t_rel_base is None or n_kf == 0:
                out.append(r.t_cam_w)
            else:
                out.append(kf_pose[min(r.base_kf, n_kf - 1)] @ r.t_rel_base)
        return np.stack(out)

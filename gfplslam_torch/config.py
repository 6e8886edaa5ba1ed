"""Configuration tree for the TPU PL-SLAM engine.

Provides every tunable the reference exposes through its ``Config`` singleton
(reference: config.h:28-255, config.cpp:26-154) as one frozen dataclass tree,
plus the TPU-specific capacity parameters (padded array sizes) that replace the
reference's dynamic containers. Defaults mirror config.cpp:29-153 exactly so the
operating points in BASELINE.md hold.

Unlike the reference (whose only "loader" is editing config.cpp), configs here
are plain dataclasses: construct, ``replace()``, or load overrides from a YAML
mapping via :func:`load_config`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class SlamParams:
    """Back-end / keyframe / loop-closure decision parameters.

    Mirrors the "SLAM parameters" block, config.cpp:29-96.
    """

    # track loss definition (config.cpp:32)
    max_num_frame_loss: int = 10
    # keyframe decision (config.cpp:34-38)
    min_entropy_ratio: float = 0.90
    max_kf_num_frames: int = 50
    min_kf_n_feats: int = 30
    max_kf_t_dist: float = 2.0
    max_kf_r_dist: float = 5.0
    # landmark numbers and errors (config.cpp:40-48)
    min_lm_obs: int = 2
    max_common_fts_kf: float = 0.8
    max_kf_epip_p: float = 1.0
    max_kf_epip_l: float = 1.0
    max_lm_3d_err: float = 1.0
    max_lm_dir_err: float = 0.5
    max_point_point_error: float = 0.1
    max_point_line_error: float = 0.1
    max_dir_line_error: float = 0.1
    # covisibility graph thresholds (config.cpp:50-53)
    min_lm_ess_graph: int = 100
    min_lm_cov_graph: int = 30
    min_kf_local_map: int = 3
    # local bundle adjustment (config.cpp:55-57)
    lambda_lba_lm: float = 0.001
    lambda_lba_k: float = 10.0
    max_iters_lba: int = 20
    # loop closure (config.cpp:59-72)
    lc_mat: float = 0.50
    lc_res: float = 1.5
    lc_unc: float = 0.01
    lc_inl: float = 0.3
    lc_trs: float = 1.5
    lc_rot: float = 35.0
    max_iters_pgo: int = 100
    lc_kf_dist: int = 100
    lc_kf_max_dist: int = 20
    lc_nkf_closest: int = 4
    lc_inlier_ratio: float = 35.0


@dataclass(frozen=True)
class StvoParams:
    """Visual-odometry pipeline switches (config.cpp:76-97)."""

    has_points: bool = True
    has_lines: bool = True
    # lr_in_parallel / pl_in_parallel are thread switches in the reference
    # (stereoFrame.cpp:419-450, 1021-1051); here detection of both cameras and
    # both feature families is always issued as one batched device program, so
    # the switches are kept only for config-surface parity and ignored.
    lr_in_parallel: bool = True
    pl_in_parallel: bool = True
    best_lr_matches: bool = True
    adaptative_fast: bool = True
    # good-line-cutting switches (config.cpp:83-86)
    use_line_conf_cut: bool = True
    ratio_disp_std: float = 0.15
    ratio_disp_std_hor: float = 0.9
    max_vol_line_cut: bool = True
    # cross-frame match budgets (config.cpp:94-95)
    max_line_match_num: int = 300
    max_point_match_num: int = 500


@dataclass(frozen=True)
class TrackingParams:
    """Matching thresholds + adaptive-FAST loop (config.cpp:100-119)."""

    # point features
    max_dist_epip: float = 2.0
    min_disp: float = 1.0
    max_ratio_12_p: float = 0.9
    point_match_radius: float = 50.0
    # line segment features
    stereo_overlap_th: float = 0.5
    min_line_length: float = 0.025
    line_horiz_th: float = 0.1
    desc_th_l: float = 0.1
    line_cov_th: float = 10.0
    line_match_radius: float = 80.0
    # adaptive FAST (config.cpp:114-118)
    fast_min_th: int = 10
    fast_max_th: int = 50
    fast_inc_th: int = 5
    fast_feat_th: int = 50
    fast_err_th: float = 0.5


@dataclass(frozen=True)
class OptimizerParams:
    """Pose-only robust Gauss-Newton budgets (config.cpp:122-131)."""

    homog_th: float = 1e-7
    min_features: int = 10
    max_iters: int = 5
    max_iters_ref: int = 10
    min_error: float = 1e-7
    min_error_change: float = 1e-7
    inlier_k: float = 2.0
    motion_step_th: float = 10.0


@dataclass(frozen=True)
class OrbParams:
    """ORB detector operating point (config.cpp:135-142)."""

    nfeatures: int = 1000
    scale_factor: float = 1.2
    nlevels: int = 4
    edge_th: int = 19
    wta_k: int = 2
    score: int = 1  # 0 HARRIS | 1 FAST
    patch_size: int = 31
    fast_th: int = 20
    # TPU-specific: FAST candidates kept per pyramid level before top-K
    # distribution (replaces the quadtree, ORBextractor.cc:539).
    grid_cell: int = 32  # cell size in px for per-cell top-k distribution
    # sub-pixel stereo refinement window / search half-widths. The reference
    # uses 5/5 (subPixelStereoRefine_ORBSLAM, stereoFrame.cpp:340-404); the
    # 4/4 default trades ~35% of the gather volume for sub-noise ATE impact.
    subpix_win: int = 4
    subpix_search: int = 4


@dataclass(frozen=True)
class LsdParams:
    """LSD line detector operating point (config.cpp:144-153)."""

    nfeatures: int = 300
    refine: int = 1
    scale: float = 1.0
    octave_num: int = 1
    sigma_scale: float = 0.75
    quant: float = 2.0
    ang_th: float = 22.5
    log_eps: float = 1.0
    density_th: float = 0.6
    n_bins: int = 1024


@dataclass(frozen=True)
class CapacityParams:
    """Fixed-capacity padded-shape parameters (TPU-specific, no reference
    analog: replaces std::vector growth with masked static shapes).

    Capacities are sized from the reference budgets: 1000 ORB + margins,
    300 lines, <=500/<=300 cross matches (config.cpp:94-95,134,143).
    """

    n_pt: int = 1024        # per-frame point feature slots (per camera)
    n_ln: int = 512         # per-frame line feature slots (per camera)
    n_pt_match: int = 512   # cross-frame point match slots
    n_ln_match: int = 512   # cross-frame line match slots
    n_kf_window: int = 8    # local-BA keyframe window slots
    n_kf_frozen: int = 8    # out-of-window constant-KF slots in local BA
    n_kf_max: int = 512     # total keyframe capacity (map)
    n_map_pt: int = 16384   # landmark pool: points
    n_map_ln: int = 8192    # landmark pool: lines
    n_obs_pt: int = 4096    # local-BA point observation slots
    n_obs_ln: int = 2048    # local-BA line observation slots
    # bag-of-words vocabulary leaves per family. 4096 trained words ship in
    # data/vocab_synth4096.npz; retrieval AP on a 241-frame 3-lap aliased
    # circuit: 0.73 vs 0.39 at 256 words (VOCAB_PR.json) — small flat
    # codebooks cannot discriminate revisits at map scale (the reference
    # relies on ~1e5-leaf DBoW2 trees, TemplatedVocabulary.h:1066-1127)
    vocab_k: int = 4096
    fast_cand_per_level: int = 4096  # FAST candidate cap per pyramid level


@dataclass(frozen=True)
class CameraParams:
    """Rectified pinhole stereo intrinsics (pinholeStereoCamera.h:53-70)."""

    width: int = 752
    height: int = 480
    fx: float = 435.2046959714599
    fy: float = 435.2046959714599
    cx: float = 367.4517211914062
    cy: float = 252.2008514404297
    baseline: float = 0.110073808127187


@dataclass(frozen=True)
class Config:
    """Root configuration (reference Config singleton, config.h:28-255)."""

    slam: SlamParams = field(default_factory=SlamParams)
    stvo: StvoParams = field(default_factory=StvoParams)
    tracking: TrackingParams = field(default_factory=TrackingParams)
    optimizer: OptimizerParams = field(default_factory=OptimizerParams)
    orb: OrbParams = field(default_factory=OrbParams)
    lsd: LsdParams = field(default_factory=LsdParams)
    cap: CapacityParams = field(default_factory=CapacityParams)
    camera: CameraParams = field(default_factory=CameraParams)

    def replace(self, **groups: Any) -> "Config":
        return dataclasses.replace(self, **groups)


def default_config() -> Config:
    """The reference's compiled-in operating point (config.cpp:29-153)."""
    return Config()


def _apply_overrides(obj: Any, overrides: Mapping[str, Any]) -> Any:
    kwargs = {}
    for f in dataclasses.fields(obj):
        if f.name in overrides:
            val = overrides[f.name]
            if dataclasses.is_dataclass(getattr(obj, f.name)):
                val = _apply_overrides(getattr(obj, f.name), val)
            kwargs[f.name] = val
    return dataclasses.replace(obj, **kwargs) if kwargs else obj


def load_config(overrides: Mapping[str, Any] | None = None) -> Config:
    """Build a config from nested mapping overrides, e.g. parsed YAML.

    Example: ``load_config({"orb": {"nfeatures": 1200}, "camera": {...}})``.
    """
    cfg = default_config()
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    return cfg


# Per-dataset camera operating points (config/euroc_params.yaml:8-11,
# config/kitti/kitti00-02.yaml:9-12 — rectified values).
EUROC_CAMERA = CameraParams()
KITTI_00_CAMERA = CameraParams(
    width=1241, height=376,
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
    baseline=0.5371657188644179,
)

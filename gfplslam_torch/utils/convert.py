"""Converters between the reference's per-frame / tracker state and the
port's NamedTuples, for tests that run a port stage on the reference's own
upstream outputs.

The reference side is given as NamedTuples whose leaves are numpy arrays
(or anything ``np.asarray`` accepts); this module imports no JAX. Classes
are matched by name and fields by position, which both packages share.
Descriptor words map uint32 <-> int32 by bit view, never by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gfplslam_torch import config as cfg_mod
from gfplslam_torch.models.ba import BAProblem, BAResult
from gfplslam_torch.models.frame import (CameraFeatures, StereoFrame,
                                         StereoLines, StereoPoints)
from gfplslam_torch.models.loop import LoopState, LoopVerification, PoseGraphEdges
from gfplslam_torch.models.map import KFMatchResult, MapState
from gfplslam_torch.models.mapping import MappingResult
from gfplslam_torch.models.pose_opt import LineMatches, PointMatches, PoseResult
from gfplslam_torch.models.tracker import CrossMatches, TrackerState

PORT_TYPES = {cls.__name__: cls for cls in (
    CameraFeatures, StereoPoints, StereoLines, StereoFrame, TrackerState,
    PointMatches, LineMatches, PoseResult, CrossMatches, MapState, LoopState,
    BAProblem, BAResult, LoopVerification, PoseGraphEdges, KFMatchResult,
    MappingResult)}
DESC_FIELDS = frozenset({"desc", "pt_desc", "ln_desc", "pt_desc_hist",
                         "ln_desc_hist"})
INDEX_FIELDS = frozenset({"pt_curr_idx", "ln_curr_idx", "i", "j"})


def _leaf_to_torch(name: str, leaf, device: torch.device) -> torch.Tensor:
    a = np.asarray(leaf)
    if name in DESC_FIELDS:
        a = np.ascontiguousarray(a, np.uint32).view(np.int32)
    elif name in INDEX_FIELDS:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def to_torch(ref, device: torch.device):
    """Reference NamedTuple (numpy-convertible leaves) -> the port's
    NamedTuple of the same name, leaves on ``device``."""
    cls = PORT_TYPES[type(ref).__name__]
    vals = []
    for name, v in zip(cls._fields, ref):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            vals.append(to_torch(v, device))
        else:
            vals.append(_leaf_to_torch(name, v, device))
    return cls(*vals)


def to_numpy(port):
    """Port NamedTuple -> the same NamedTuple with numpy leaves, descriptor
    words viewed back as uint32."""
    vals = []
    for name, v in zip(port._fields, port):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            vals.append(to_numpy(v))
            continue
        a = v.detach().cpu().numpy()
        vals.append(a.view(np.uint32) if name in DESC_FIELDS else a)
    return type(port)(*vals)


def config_from_ref(ref_cfg) -> cfg_mod.Config:
    """The port's Config with every value of a reference Config, through
    ``dataclasses.asdict``."""
    groups = dataclasses.asdict(ref_cfg)
    kwargs = {}
    for f in dataclasses.fields(cfg_mod.Config):
        sub = f.default_factory  # each group's dataclass
        kwargs[f.name] = sub(**groups[f.name])
    return cfg_mod.Config(**kwargs)

"""Map / loop / tracker state checkpointing.

Port of ``gfplslam_tpu/utils/checkpoint.py``. The file layout is the
reference's, so a checkpoint written by either package loads in the other:
one compressed npz with a flat key ``<state>.<field>`` per leaf
(``map.pt_pos``, ``loop.conf``, ``tracker.t_cam_w``, ...), each array in
the reference's dtype. The port holds descriptor words as int32 bit
patterns (``utils/convert.py`` ``DESC_FIELDS``); they are written as the
reference's uint32 and read back by bit view, never by value.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from gfplslam_torch.utils.convert import DESC_FIELDS


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(prefix: str, tree: Any, out: dict) -> None:
    if _is_namedtuple(tree):
        for name in tree._fields:
            _flatten(f"{prefix}{name}.", getattr(tree, name), out)
        return
    key = prefix[:-1]
    a = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
    if key.rsplit(".", 1)[-1] in DESC_FIELDS:
        a = np.ascontiguousarray(a).view(np.uint32)
    out[key] = a


def _unflatten(prefix: str, template: Any, data: dict, device) -> Any:
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(f"{prefix}{name}.", getattr(template, name), data, device)
            for name in template._fields))
    key = prefix[:-1]
    arr = data[key]
    if key.rsplit(".", 1)[-1] in DESC_FIELDS:
        arr = np.ascontiguousarray(arr, np.uint32).view(np.int32)
    else:
        want = torch.empty(0, dtype=template.dtype).numpy().dtype
        arr = arr.astype(want, copy=False)
    return torch.from_numpy(np.array(arr)).to(device)


def save_state(path: str, **states: Any) -> None:
    """Save named NamedTuples of tensors (map=..., loop=..., tracker=...)
    to ``path``."""
    flat: dict = {}
    for key, tree in states.items():
        _flatten(f"{key}.", tree, flat)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_state(path: str, device: torch.device, **templates: Any) -> dict:
    """Load the states named like ``templates`` (same names as saved), each
    leaf in its template's dtype, on ``device``."""
    with np.load(path, allow_pickle=False) as npz:
        data = dict(npz)
    return {key: _unflatten(f"{key}.", tmpl, data, device)
            for key, tmpl in templates.items()}

"""Device time, host time and bounds of the hand-written CUDA kernels.

Shared by ``chip_smoke.py`` (this checkout's kernels against their plain
versions, then timed) and ``profile_torch_kernels.py`` (this checkout's
kernels beside another checkout's, in turns). Every function that times
needs a CUDA card; the input builders and the bounds also run on the CPU.

- :func:`graph_ms`: device time of one launch, from 100+ launches captured
  in a CUDA graph over rotating buffers that move twice the L2 cache per
  pass, replayed between two events.
- :func:`host_ms`: host time of one wrapper call.
- :func:`fast_bound`, :func:`hamming_bound`: the least time the card could
  take for one full-width frame's work, the larger of the bytes over the
  HBM rate and the operations these inputs need over the issue rate of
  their type (H100 SXM, NVIDIA's data sheet).
- :data:`HAMMING_LIBRARY`: single PyTorch calls that compute the Hamming
  kernel's function from the descriptors unpacked to bits (``torch.cdist``
  with p=0, and a +-1 bf16 matrix product), timed beside the kernel as its
  yardstick; the port never calls them.
"""

from __future__ import annotations

import functools
import math
import statistics
import time

import numpy as np
import torch

from gfplslam_torch.ops import kernels

MAIN_THRESHOLD = 20.0        # OrbParams.fast_th; the adaptive loop keeps 10..50
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12        # f32, or bf16x2 counted per half, outside the tensor cores
L2_BYTES = 50e6
# FAST-9 work per pixel in the cheapest form known here (the kernel's). Every
# pixel takes the exact compass test: 4 differences, 8 threshold compares
# and 7 to combine them. A pixel that passes takes the other 12 differences,
# 47 min/max per side for the best 9-arc (each pair of neighbouring windows
# shares its 8 middle taps), and 8 for the threshold tests, the margins and
# the final max.
FAST_COMPASS_OPS_PER_PX = 4 + 8 + 7
FAST_SCORE_OPS_PER_PX = 12 + 2 * 47 + 8
HAMMING_SHAPES = (1024, 512)  # stereo points, stereo lines; then the same
                              # two again for cross-frame matching
# what one keyframe of the SLAM back-end asks of the Hamming kernel at the
# default Config (label, rows, columns, masks the caller passes): the
# frame's points and lines against the whole landmark pools
# (models/map.py), against the two vocabularies (models/loop.py
# bow_vector, rows only), and one snapshot against another (verify_loop)
HAMMING_KEYFRAME = (("map points", 1024, 16384, "both"),
                    ("map lines", 512, 8192, "both"),
                    ("BoW points", 1024, 4096, "rows"),
                    ("BoW lines", 512, 4096, "rows"),
                    ("verify points", 512, 512, "both"),
                    ("verify lines", 256, 256, "both"))


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 descriptor words -> [N, 256] bits (0/1, int32), bit j of
    word w at column 32 w + j."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    return ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256)


def _mask(d: torch.Tensor, va, vb) -> torch.Tensor:
    """The kernel's masking in one ``torch.where``: BIG where a row or a
    column is invalid."""
    from gfplslam_torch.ops.hamming import BIG
    if va is None and vb is None:
        return d
    ok = (torch.ones_like(d, dtype=torch.bool) if va is None else va[:, None]) & (
        True if vb is None else vb[None, :])
    return torch.where(ok, d, BIG)


def hamming_by_cdist(a, b, va=None, vb=None) -> torch.Tensor:
    """``torch.cdist(p=0)`` on the float bits counts the differing bits."""
    d = torch.cdist(unpack_bits(a).float(), unpack_bits(b).float(), p=0)
    return _mask(d.to(torch.int32), va, vb)


def hamming_by_matmul(a, b, va=None, vb=None) -> torch.Tensor:
    """(256 - A.B^T) / 2 for the +-1 bit matrices: bf16 inputs, fp32
    accumulation. Every partial sum is an integer of magnitude <= 256, so
    even a bf16 accumulator would hold it exactly."""
    sa = (1 - 2 * unpack_bits(a)).to(torch.bfloat16)
    sb = (1 - 2 * unpack_bits(b)).to(torch.bfloat16)
    dot = torch.matmul(sa, sb.T)
    return _mask(((256 - dot.float()) * 0.5).to(torch.int32), va, vb)


HAMMING_LIBRARY = {"torch.cdist(p=0)": hamming_by_cdist,
                   "bf16 +-1 torch.matmul": hamming_by_matmul}


def library_ms(fn, inputs: dict) -> float:
    """Device time of one ``fn`` call per entry of ``inputs``, unpack and
    mask included, under the kernel's memory conditions
    (``hamming_launch_list``): the same inputs, and the outputs kept in as
    many rotating slots as the kernel has output buffers, so that they
    leave the L2 cache as the kernel's do."""
    total = 0.0
    for args in inputs.values():
        copies, count = rotation(4.0 * args[0].shape[0] * args[1].shape[0])
        slots = [None] * copies

        def call(i):
            slots[i % copies] = fn(*args)
        total += graph_ms([functools.partial(call, i) for i in range(count)])
        slots.clear()
    return total


def u8(imgs):
    """The uint8 camera-byte contract of bench.py."""
    return np.clip(np.round(np.asarray(imgs)), 0, 255).astype(np.uint8)


def graph_ms(launches) -> float:
    """Device time of one launch: the callables of ``launches`` (one kernel
    launch each, on the current stream) are captured in order into one CUDA
    graph, which is replayed 5 times between two events; the median replay
    time over ``len(launches)``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launches[0]()                      # first call outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for launch in launches:
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(launches))
    return statistics.median(times)


def host_ms(call) -> float:
    """Host time of one wrapper call, 200 calls back to back."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * secs / 200


def rotation(bytes_per_launch: float) -> tuple[int, int]:
    """(buffer copies, launches): enough copies that one pass over them moves
    twice the L2 cache, so every launch reads and writes device memory, and
    at least 100 launches."""
    copies = max(2, math.ceil(2 * L2_BYTES / bytes_per_launch))
    return copies, copies * math.ceil(100 / copies)


def fast_launch_list(lib, imgs, thr):
    """Raw ``gfpl_fast_score`` launches of library ``lib`` over rotating
    copies of ``imgs``."""
    b, h, w = imgs.shape
    copies, n = rotation(8.0 * imgs.numel())
    bufs = [(imgs.clone(), torch.empty_like(imgs)) for _ in range(copies)]

    def launch(x, y):
        kernels.check(lib.gfpl_fast_score(x.data_ptr(), y.data_ptr(), b, h, w,
                                          thr.data_ptr(),
                                          kernels.stream_ptr(x.device)),
                      "gfpl_fast_score")
    return [functools.partial(launch, *bufs[i % copies]) for i in range(n)]


def hamming_launch_list(lib, a, b, va, vb):
    """Raw ``gfpl_hamming`` launches of library ``lib`` over rotating
    output buffers; a ``None`` mask is passed as a null pointer."""
    n, m = a.shape[0], b.shape[0]
    copies, count = rotation(4.0 * n * m)
    outs = [torch.empty((n, m), dtype=torch.int32, device=a.device)
            for _ in range(copies)]
    pa, pb = (None if v is None else v.data_ptr() for v in (va, vb))

    def launch(out):
        kernels.check(lib.gfpl_hamming(a.data_ptr(), b.data_ptr(), pa, pb,
                                       out.data_ptr(), n, m,
                                       kernels.stream_ptr(a.device)),
                      "gfpl_hamming")
    return [functools.partial(launch, outs[i % copies]) for i in range(count)]


def fast_pyramid_inputs(pair, cfg, dev) -> dict:
    """What one stereo pair (uint8 [2, H, W]) feeds the FAST kernel under
    ``cfg``: its padded pyramid, level 0 and levels 1-3 as ``frame.py``
    batches them (non-integer intensities from level 1 on), labelled with
    their shapes."""
    from gfplslam_torch.ops.pyramid import build_pyramid_padded, level_shapes
    imgs = torch.as_tensor(np.asarray(pair), device=dev).float()
    nlv, scale = cfg.orb.nlevels, cfg.orb.scale_factor
    pyr = build_pyramid_padded(imgs, nlv, scale)
    h1, w1 = level_shapes(imgs.shape[-2], imgs.shape[-1], nlv, scale)[1]
    level0 = pyr[:, 0].contiguous()
    upper = pyr[:, 1:, :h1, :w1].reshape(-1, h1, w1).contiguous()
    return {f"level 0 {list(level0.shape)}": level0,
            f"levels 1-{nlv - 1} {list(upper.shape)}": upper}


def fast_main_inputs(dev) -> dict:
    """What one full-width EuRoC frame feeds the FAST kernel: the rendered
    pair of the VO world (``fast_pyramid_inputs``)."""
    from gfplslam_torch.config import CameraParams, Config
    from gfplslam_torch.io import synthetic
    cfg = Config(camera=CameraParams())
    world = synthetic.make_world(n_frames=2, n_points=900, n_lines=90, seed=3,
                                 cam=cfg.camera)
    pair = u8(np.stack(synthetic.render_frame(world, 0, noise=1.5)))
    return fast_pyramid_inputs(pair, cfg, dev)


def hamming_main_inputs(dev, rng) -> dict:
    """The shapes one tracked frame gives the Hamming kernel, with masks:
    n -> (a, b, valid_a, valid_b)."""
    out = {}
    for n in HAMMING_SHAPES:
        a, b = (torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)),
                                dtype=torch.int32, device=dev) for _ in range(2))
        va, vb = (torch.as_tensor(rng.random(n) < 0.8, device=dev)
                  for _ in range(2))
        out[n] = (a, b, va, vb)
    return out


def hamming_keyframe_inputs(dev, rng) -> dict:
    """One keyframe's Hamming calls (``HAMMING_KEYFRAME``), random
    descriptors, 80%-valid masks where the caller passes one:
    label -> (a, b, valid_a, valid_b)."""
    out = {}
    for label, n, m, masks in HAMMING_KEYFRAME:
        a, b = (torch.as_tensor(rng.integers(-2**31, 2**31, (k, 8)),
                                dtype=torch.int32, device=dev) for k in (n, m))
        va = torch.as_tensor(rng.random(n) < 0.8, device=dev)
        vb = torch.as_tensor(rng.random(m) < 0.8, device=dev) if masks == "both" else None
        out[label] = (a, b, va, vb)
    return out


def fast_device_ms(lib, inputs: dict, thr) -> float:
    """Device time of one frame's FAST launches with library ``lib``."""
    return sum(graph_ms(fast_launch_list(lib, x, thr)) for x in inputs.values())


def hamming_launches_ms(lib, inputs: dict) -> float:
    """Device time of one Hamming launch per entry of ``inputs`` (one
    keyframe's six for ``hamming_keyframe_inputs``)."""
    return sum(graph_ms(hamming_launch_list(lib, *args)) for args in inputs.values())


def hamming_device_ms(lib, inputs: dict) -> float:
    """Device time of one tracked frame's four Hamming launches."""
    return 2 * hamming_launches_ms(lib, inputs)


def fast_candidates(imgs, threshold: float) -> int:
    """Pixels that pass the exact compass test: two neighbouring compass taps
    (0, 4, 8, 12) both bright (d > t) or both dark (d < -t), on the bf16
    image as the score computes it. Every other pixel scores 0."""
    img16 = imgs.to(torch.bfloat16)
    t = torch.tensor(threshold, device=imgs.device).to(torch.bfloat16)
    d = [torch.roll(img16, (-dy, -dx), (-2, -1)) - img16
         for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
    bright = [x > t for x in d]
    dark = [x < -t for x in d]
    live = torch.zeros_like(bright[0])
    for i in range(4):
        live |= (bright[i] & bright[(i + 1) % 4]) | (dark[i] & dark[(i + 1) % 4])
    return int(live.sum())


def fast_bound(inputs: dict) -> tuple[float, str]:
    """(ms, what bounds it) for one frame's FAST maps at MAIN_THRESHOLD: f32
    in and out, and the operations these inputs need (the compass test
    everywhere, the full score where it passes)."""
    px = sum(x.numel() for x in inputs.values())
    live = sum(fast_candidates(x, MAIN_THRESHOLD) for x in inputs.values())
    byte_ms = 1e3 * (8.0 * px + 4) / HBM_BYTES_PER_S
    ops = FAST_COMPASS_OPS_PER_PX * px + FAST_SCORE_OPS_PER_PX * live
    op_ms = 1e3 * ops / ALU_OPS_PER_S
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def hamming_bytes_ms(inputs: dict) -> float:
    """Least ms of one launch per entry of ``inputs`` at the HBM rate: the
    descriptors and each mask passed read once, the int32 matrix written
    once (one keyframe's bound for ``hamming_keyframe_inputs``)."""
    nbytes = sum(32.0 * (a.shape[0] + b.shape[0]) + 4.0 * a.shape[0] * b.shape[0]
                 + sum(0 if v is None else v.shape[0] for v in (va, vb))
                 for a, b, va, vb in inputs.values())
    return 1e3 * nbytes / HBM_BYTES_PER_S


def hamming_bound(inputs: dict) -> tuple[float, str]:
    """(ms, "bytes") for one tracked frame's four matrices (each shape of
    ``inputs`` twice). The popcounts do not set it: on this card they run
    on the binary tensor cores (``mma.m16n8k256 .b1 .and.popc``, one 256-bit
    descriptor per k step), whose rate the data sheet does not publish, so
    no operation bound is stated; the least time is the one the bytes need."""
    return 2 * hamming_bytes_ms(inputs), "bytes"

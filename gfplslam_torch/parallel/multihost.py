"""Process-group start-up for multi-process runs, and a local rank launcher.

Port of ``gfplslam_tpu/parallel/multihost.py``. JAX spans hosts with one
controller over a global mesh (``jax.distributed.initialize``, after which
``jax.devices()`` lists every host's devices). PyTorch runs one process per
card, joined in a ``torch.distributed`` process group, and the port uses
the group: where the reference asks ``len(jax.devices()) > 1``, the port
asks for an initialized default group with ``world_size > 1``. Under
``jax.distributed`` the device list is global, so in a multi-host job the
two conditions are the same.

Call :func:`ensure_multihost` once at process start (``run_slam`` and
``batch_eval`` do under ``--multihost``). With no coordinator in the
arguments or the environment it is a no-op, so call sites need no guard.
The reference's ``TPU_WORKER_HOSTNAMES`` branch (a Cloud TPU pod resolves
its own coordinator) has no GPU counterpart: a GPU job names its
coordinator, as ``torchrun`` does.

:func:`launch` starts N ranks on this machine, each a spawned process in
one default group over a file store in a temporary directory: the
counterpart of the JAX tests' virtual 8-device mesh, used by the tests,
``apps/bench_dist_ba.py`` and ``chip_smoke.py``. A spawned rank imports
the worker's module and torch, and (as every spawned process does) the
caller's main script without running its ``__main__`` block; never the
caller's other modules, such as a test file.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# how long a rank waits in a collective for the others
TIMEOUT = datetime.timedelta(minutes=10)


def _env(*names: str) -> str | None:
    """The first of ``names`` set in the environment."""
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def ensure_multihost(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | torch.device | None = None) -> bool:
    """Join the default process group once, if a coordinator is known.

    Each argument is resolved in this order: the explicit argument, then
    the variables ``torchrun`` sets (``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), then the reference's names
    (``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES``, ``PROCESS_ID``), so one job script launches either
    package. The group runs over NCCL when ``device`` is a CUDA device
    (default: when a card is visible), each process on the card of its
    ``LOCAL_RANK``, and over gloo otherwise. Returns True when more than
    one rank is active after the call."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        host, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
        coordinator = (f"{host}:{port}" if host and port
                       else _env("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = int(_env("WORLD_SIZE", "NUM_PROCESSES") or 0)
    if process_id is None:
        process_id = int(_env("RANK", "PROCESS_ID") or -1)
    if not (coordinator and num_processes > 1 and process_id >= 0):
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        local = _env("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return dist.get_world_size() > 1


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0, in rank order. gloo
    gathers CUDA tensors too (checked on an H100 with torch 2.11 for
    float32, int64 and bool), so ranks sharing a card need no staging."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.cat(out)


def backend_for(device: str | torch.device, n_ranks: int) -> str:
    """NCCL when each rank has a card of its own; gloo on the CPU, and for
    several ranks sharing a card (NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def _rank_main(rank: int, fn, n_ranks: int, device: str, store: str,
               out_dir: str, args: tuple) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(device, n_ranks),
                            init_method=f"file://{store}", world_size=n_ranks,
                            rank=rank, timeout=TIMEOUT)
    try:
        result = fn(*args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, *args, device: str | torch.device = "cpu") -> list:
    """Run ``fn(*args)`` in ``n_ranks`` spawned processes on this machine,
    joined in one default process group (:func:`backend_for` picks its
    backend; CPU ranks run one thread each), and return each rank's result
    in rank order. ``fn`` must be importable by name, and its results are
    saved with ``torch.save`` (move tensors to the CPU first). A failing
    rank ends the others and raises here."""
    device = str(device)
    with tempfile.TemporaryDirectory(prefix="gfpl_ranks_") as tmp:
        mp.start_processes(_rank_main, nprocs=n_ranks, join=True,
                           start_method="spawn",
                           args=(fn, n_ranks, device, os.path.join(tmp, "store"),
                                 tmp, args))
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n_ranks)]

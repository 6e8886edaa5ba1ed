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

:func:`spawn_peers` makes the caller rank 0 of a default group on this
machine, over a file store in a temporary directory, and spawns the other
ranks, which run a function once per round the caller starts
(``apps/batch_eval.py --ranks``, the benchmark's batch driver).
:func:`launch` runs a function once on N spawned ranks, rank 0 a spawned
process that runs one such round: the counterpart of the JAX tests'
virtual 8-device mesh, used by the tests, ``apps/bench_dist_ba.py`` and
``chip_smoke.py``. A spawned rank imports the worker's module
and torch, and (as every spawned process does) the caller's main script
without running its ``__main__`` block; never the caller's other modules,
such as a test file.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import shutil
import tempfile
import time
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

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
    package. The group runs over NCCL on the card (``device`` None or a
    CUDA device), each process on the card of its ``LOCAL_RANK``, and over
    gloo on the CPU only when ``device`` says so: with no card visible a
    CUDA group raises. Returns True when more than one rank is active after
    the call."""
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
    if torch.device(device or "cuda").type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("ensure_multihost: no CUDA card is visible; "
                               "pass device=\"cpu\" for a gloo group on the CPU")
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


def _bind(rank: int, device: str) -> None:
    """A spawned rank's device: the card of its rank (modulo the cards), or
    one CPU thread."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)


def _needs_card(device: str, who: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA card is visible; pass "
                           "device=\"cpu\" for ranks on the CPU")


def _launch_main(_, fn, n_ranks: int, device: str, out: str, args: tuple) -> None:
    """Rank 0 of a :func:`launch`: the group's peers spawned, one round of
    ``fn(*args)``, every rank's result saved in rank order."""
    _bind(0, device)
    peers = spawn_peers(fn, n_ranks, *args, device=device)
    with peers.round():
        result = fn(*args)
    torch.save([result] + peers.close(), out)


def launch(fn, n_ranks: int, *args, device: str | torch.device = "cuda") -> list:
    """Run ``fn(*args)`` in ``n_ranks`` spawned processes on this machine,
    joined in one default process group (:func:`backend_for` picks its
    backend), and return each rank's result in rank order. The ranks run on
    the card unless ``device`` is ``"cpu"`` (one thread each). ``fn`` must
    be importable by name, and its results are saved with ``torch.save``
    (move tensors to the CPU first). A failing rank ends the others and
    raises here. Rank 0 is a spawned process that runs one round of
    :func:`spawn_peers`, so the caller joins no group."""
    device = str(device)
    _needs_card(device, "launch")
    with tempfile.TemporaryDirectory(prefix="gfpl_ranks_") as tmp:
        out = os.path.join(tmp, "ranks.pt")
        mp.start_processes(_launch_main, nprocs=1, join=True, start_method="spawn",
                           args=(fn, n_ranks, device, out, args))
        return torch.load(out, weights_only=False)


def comm_device(group=None) -> torch.device:
    """Where ``group``'s collectives take their tensors: the current card
    under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def first_rank(group=None) -> int:
    """The global rank of ``group``'s rank 0."""
    return dist.get_global_rank(group or dist.group.WORLD, 0)


def first_rank_value(value: int = 0, group=None) -> int:
    """Rank 0's ``value``, on every rank of ``group`` (the others' is not read)."""
    t = torch.tensor([int(value)], device=comm_device(group))
    dist.broadcast(t, src=first_rank(group), group=group)
    return int(t.item())


def _peer_main(i: int, fn, n_ranks: int, device: str, store: str, out_dir: str,
               args: tuple) -> None:
    """Rank ``i + 1`` of a :func:`spawn_peers` group: ``fn(*args)`` once per
    round rank 0 starts; the last result is saved when rank 0 ends them."""
    rank = i + 1
    _bind(rank, device)
    joined = dist.FileStore(store, n_ranks)
    joined.set(f"peer{rank}", "up")
    dist.init_process_group(backend_for(device, n_ranks), store=joined,
                            world_size=n_ranks, rank=rank, timeout=TIMEOUT)
    try:
        result = None
        while first_rank_value():
            result = fn(*args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _peer_failure(ctx, wait_s: float) -> str | None:
    """The error of a peer that has failed (waiting up to ``wait_s`` for
    one to end), or None."""
    try:
        ctx.join(timeout=wait_s)
    except ProcessException as exc:
        return str(exc)
    return None


def _end(ctx, tmp: str, n_ranks: int, graceful: bool) -> list | None:
    """End a :func:`spawn_peers` group. ``graceful``: tell the peers that no
    round follows, wait for them, and return their last results (rank 1
    first). Either way this process leaves the group, every peer still
    running is killed and the group's files are removed."""
    try:
        if graceful:
            first_rank_value(0)
            while not ctx.join():
                pass
            return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                    for r in range(1, n_ranks)]
        return None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


class Peers:
    """This process as rank 0 of a default group whose other ranks
    :func:`spawn_peers` started. Each :meth:`round` has the peers run their
    function once; :meth:`close` ends them and returns their last results.
    A handle that is dropped, or left open at exit, ends its group as
    :meth:`close` does."""

    def __init__(self, ctx, tmp: str, n_ranks: int):
        self.n_ranks = n_ranks
        self._ctx, self._tmp = ctx, tmp
        self._ended = weakref.finalize(self, _end, ctx, tmp, n_ranks, True)
        # before multiprocessing's own exit hook, which joins children
        atexit.register(self._ended)

    def _raise(self, exc: BaseException):
        failed = _peer_failure(self._ctx, 5.0)
        self._abort()
        if failed:
            raise RuntimeError(f"a peer rank failed, so its group ended:\n{failed}") from exc
        raise exc

    @contextlib.contextmanager
    def round(self):
        """Around this rank's part of one round: every peer runs its
        function once meanwhile. If anything fails on any rank, the group
        ends and the error is raised here (a peer's with its traceback)."""
        try:
            first_rank_value(1)
            yield
        except BaseException as exc:
            self._raise(exc)

    def close(self) -> list:
        """No round follows: wait for the peers to end; their last results,
        rank 1 first. Raises if one failed."""
        if not self._ended.detach():
            raise RuntimeError("the group has ended already")
        try:
            return _end(self._ctx, self._tmp, self.n_ranks, True)
        except BaseException as exc:
            self._raise(exc)

    def _abort(self) -> None:
        """End the group now: leave it and kill every peer."""
        if self._ended.detach():
            _end(self._ctx, self._tmp, self.n_ranks, False)


def spawn_peers(fn, n_ranks: int, *args, device: str | torch.device = "cuda") -> Peers:
    """Make this process rank 0 of a default group of ``n_ranks`` ranks on
    this machine (:func:`backend_for` picks its backend; several ranks on
    one card share it over gloo) and spawn ranks 1 to ``n_ranks - 1``,
    which run ``fn(*args)`` once per :meth:`Peers.round` and nothing else.
    Returns once every rank has joined; a peer that fails before joining
    raises here, at once. ``fn`` must be importable by name; its results
    are saved with ``torch.save``. A group of one rank spawns nothing."""
    device = str(device)
    _needs_card(device, "spawn_peers")
    if n_ranks < 1:
        raise ValueError(f"a group of {n_ranks} ranks")
    if dist.is_initialized():
        raise RuntimeError("spawn_peers: this process is in a process group already")
    tmp = tempfile.mkdtemp(prefix="gfpl_peers_")
    store = os.path.join(tmp, "store")
    ctx = mp.start_processes(_peer_main, nprocs=n_ranks - 1, join=False, daemon=True,
                             start_method="spawn",
                             args=(fn, n_ranks, device, store, tmp, args))
    try:
        joined = dist.FileStore(store, n_ranks)
        keys = [f"peer{r}" for r in range(1, n_ranks)]
        deadline = time.monotonic() + TIMEOUT.total_seconds()
        while keys and not joined.check(keys):
            failed = _peer_failure(ctx, 0.05)
            if failed:
                raise RuntimeError(f"a peer rank failed before joining:\n{failed}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_peers: the peers did not join within {TIMEOUT}")
        dist.init_process_group(backend_for(device, n_ranks), store=joined,
                                world_size=n_ranks, rank=0, timeout=TIMEOUT)
    except BaseException:
        _end(ctx, tmp, n_ranks, False)
        raise
    return Peers(ctx, tmp, n_ranks)

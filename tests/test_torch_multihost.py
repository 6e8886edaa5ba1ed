"""``parallel/multihost.py::ensure_multihost`` and ``batch_eval``'s
``--multihost`` flag (``run_slam``'s: ``tests/test_torch_apps.py``).

With no coordinator in the arguments or the environment the call is a
no-op; two processes given the ``torchrun`` variables (or the reference's
names for the same settings) join one gloo group of two ranks over
``localhost``. Without a card, a group on the card (the default) raises
instead of falling back to the CPU, and so does ``launch``."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

import torch

from gfplslam_torch.apps import batch_eval
from gfplslam_torch.parallel import multihost
from gfplslam_torch.parallel.multihost import ensure_multihost

ROOT = Path(__file__).resolve().parents[1]
VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
        "PROCESS_ID")
# one rank: join, then prove the group works with an all_reduce of its rank
RANK_PROGRAM = (
    "import torch, torch.distributed as dist\n"
    "from gfplslam_torch.parallel.multihost import ensure_multihost\n"
    "ok = ensure_multihost(device='cpu')\n"
    "x = torch.tensor([dist.get_rank() + 1.0])\n"
    "dist.all_reduce(x)\n"
    "print(ok, dist.get_world_size(), int(x))\n"
    "dist.destroy_process_group()\n")


@pytest.fixture
def clean_env(monkeypatch):
    for name in VARS:
        monkeypatch.delenv(name, raising=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_no_coordinator_is_a_noop(clean_env):
    assert ensure_multihost(device="cpu") is False
    assert not dist.is_initialized()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_card_group_without_a_card_raises(clean_env, no_card, device):
    """The default group is on the card: with none visible the call
    raises, naming ``device="cpu"``, and joins nothing."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ensure_multihost(f"127.0.0.1:{_free_port()}", 2, 0, device=device)
    assert not dist.is_initialized()


def test_launch_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        multihost.launch(print, 2)


@pytest.mark.parametrize("names", ["torchrun", "reference"])
def test_two_ranks_join_from_the_environment(names):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in VARS}
        if names == "torchrun":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(rank), LOCAL_RANK=str(rank))
        else:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                       PROCESS_ID=str(rank))
        env["PYTHONPATH"] = str(ROOT)
        procs.append(subprocess.Popen([sys.executable, "-c", RANK_PROGRAM], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["True", "2", "3"], out


def test_batch_eval_multihost_runs(clean_env, tmp_path):
    rows = batch_eval.main(["--synthetic", "--sequences", "1", "--frames", "3",
                            "--multihost", "--device", "cpu", "-o", str(tmp_path)])
    assert len(rows) == 1 and np.isfinite(rows[0]["ate_rmse"])

"""A mesh across processes: scripts/dryrun_multiprocess_torch.py runs two
gloo processes of 4 shards against one process of 8 (frozen-q and
trainable-q MagNet on mxu, SNEA, SGCN on mxu, SDGNN per motif; one Adam
step each) and must report the same losses and parameter norms;
``init_process_mesh`` refuses what it cannot join."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pytorch_geometric_signed_directed_tpu_torch import parallel

from test_torch_worker_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_two_processes_match_one():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    r = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "dryrun_multiprocess_torch.py")],
        env=env, cwd=ROOT, timeout=300, capture_output=True, text=True)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert '"multiprocess_ok": true' in r.stdout.splitlines()[-1]
    assert r.stdout.count(" OK") == 5


@pytest.mark.parametrize("env,match", [
    ({}, "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT"),
    ({"RANK": "2", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
      "MASTER_PORT": "1"}, "outside WORLD_SIZE"),
])
def test_init_process_mesh_refuses(env, match, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises((RuntimeError, ValueError), match=match):
        parallel.init_process_mesh(4, device="cpu")


def test_init_process_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.init_process_mesh(4)

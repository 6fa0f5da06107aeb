"""Spawn one gloo world of ``tests/torch_port_dist_worker.py`` on the CPU
for the PyTorch port's multi-process tests: every rank of the world in
its own process (``file://`` rendezvous in the test's directory, one
thread a rank, a 240 s timeout on each), rank 0's results returned."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_port_dist_worker.py"


def spawn(world: int, job: dict, tmp_path: Path) -> dict:
    """Every rank of one gloo world on ``job``; rank 0's ``out.pt``."""
    job_path, out_path = tmp_path / "job.pt", tmp_path / "out.pt"
    torch.save({"only_lm": True, **job}, job_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(rank), str(world),
         str(tmp_path / "pg"), str(job_path), str(out_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]
    errors = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {rank} of {world} timed out (a hung collective)")
        if proc.returncode:
            errors.append(f"rank {rank}: rc {proc.returncode}\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return torch.load(out_path, weights_only=False)

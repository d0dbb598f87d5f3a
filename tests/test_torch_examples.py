"""The port's twins of ``examples/quickstart.py`` and
``examples/train_100m.py`` (``repro_torch.launch.quickstart`` and
``repro_torch.launch.train_100m``) run to their end on the CPU, each in its
own process, as ``tests/test_system.py`` runs the reference's. The
100M-parameter twin takes one step: on the CPU the port's AdamW, which
flushes subnormals as XLA does, takes about 14 s a step of 124.7 M
parameters."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_module(args, timeout=400):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{args}\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def test_quickstart_twin():
    out = run_module(["repro_torch.launch.quickstart", "--device", "cpu"])
    assert "all algorithms agree with the dense oracle" in out
    assert "bit-identical to the sorted reference" in out
    assert "spkadd_batched: 4 collections in one call match the loop" in out


@pytest.fixture
def ckpt_dir(tmp_path):
    """A checkpoint directory removed after the test: one checkpoint of
    the 124.7 M-parameter state takes 1.5–2 GB of disk."""
    path = tmp_path / "ckpt"
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


def test_train_100m_twin_short(ckpt_dir):
    out = run_module(["repro_torch.launch.train_100m", "--steps", "1",
                      "--batch", "2", "--seq", "32", "--ckpt-dir",
                      ckpt_dir, "--device", "cpu"])
    assert "model: repro-100m, 124.7M params" in out
    assert "done: 1 steps" in out


def test_train_100m_twin_compressed(ckpt_dir):
    out = run_module(["repro_torch.launch.train_100m", "--steps", "1",
                      "--batch", "4", "--seq", "32", "--compress",
                      "--k-fraction", "0.1", "--ckpt-dir", ckpt_dir,
                      "--device", "cpu"])
    assert "done: 1 steps" in out
    assert "[sparse-allreduce/gather_kway]" in out

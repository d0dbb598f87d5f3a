"""The port's launchers on the CPU: ``repro_torch.launch.train`` and
``repro_torch.launch.serve`` (the twins of ``tests/test_system.py``'s
launcher tests), and a trainer's delta spool feeding a serving replica.

The trainer runs as its own process (``--device cpu``; under ``torchrun``
for the 2 × 2 mesh), with ``PYTHONHASHSEED`` fixed so its batches, whose
seed is Python's ``hash``, are the same in every run. The serving launcher
runs in this process (:func:`repro_torch.launch.serve.run`), so its
replica's parameters can be read.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core.engine import spkadd_run
from repro_torch.launch import serve
from repro_torch.runtime import (DirTransport, apply_delta_flat, decode_frame,
                                 frame_to_coo)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--arch", "smollm-135m", "--smoke", "--device", "cpu"]


def run_module(args, timeout=300, launcher=()):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PYTHONHASHSEED="0", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, *launcher, "-m", *args], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, f"{args}\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def train(*flags, **kw):
    return run_module(["repro_torch.launch.train", *SMOKE, *flags], **kw)


def test_train_launcher_smoke(tmp_path):
    out = train("--steps", "12", "--ckpt-every", "6", "--ckpt-dir",
                str(tmp_path))
    assert "finished at step 12; restarts=0" in out
    assert "step     0 loss" in out and "step    10 loss" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                            "step_00000012"]


def test_train_launcher_resume(tmp_path):
    """Stop after 8 steps (checkpoint at 8), relaunch for 12: the second
    run resumes at step 8 and does not restart from 0."""
    ckpt = str(tmp_path)
    first = train("--steps", "8", "--ckpt-every", "4", "--ckpt-dir", ckpt)
    assert "finished at step 8" in first
    out = train("--steps", "12", "--ckpt-every", "4", "--ckpt-dir", ckpt)
    assert "finished at step 12; restarts=0" in out
    assert "step     0 loss" not in out  # resumed, not restarted
    assert "step    10 loss" in out


def test_train_launcher_compressed_smoke(tmp_path):
    out = train("--steps", "4", "--ckpt-every", "4", "--compress",
                "--k-fraction", "0.05", "--ckpt-dir", str(tmp_path))
    assert "finished at step 4" in out
    # the compressed state has the residuals beside (params, opt)
    with open(os.path.join(tmp_path, "step_00000004", "manifest.json")) as f:
        assert "\"n_leaves\": 49" in f.read()  # params, (step, mu, nu), ef


def test_train_launcher_compressed_2d_under_torchrun(tmp_path):
    """--compress on a 2 × 2 ``("data", "model")`` mesh of four gloo ranks
    started by ``torchrun``: the twin of
    ``test_train_launcher_compressed_2d_smoke``."""
    out = run_module(
        ["repro_torch.launch.train", *SMOKE, "--steps", "4",
         "--ckpt-every", "4", "--mesh", "2x2", "--compress",
         "--k-fraction", "0.05", "--ckpt-dir", str(tmp_path)],
        launcher=("-m", "torch.distributed.run", "--standalone",
                  "--nproc-per-node", "4"))
    assert "mesh: {'data': 2, 'model': 2} over 4 ranks (cpu)" in out
    assert "finished at step 4" in out
    assert sorted(os.listdir(tmp_path)) == [f"rank{r}" for r in range(4)]


def test_dense_step_refuses_a_mesh_its_world_does_not_fill(tmp_path):
    """A world of two ranks that the dense step's ``--mesh`` does not fill
    (2 x 2 wants four) is refused before any step; a world that fills its
    mesh trains (``test_torch_sharded_step.py``'s launcher tests)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *SMOKE,
         "--steps", "1", "--mesh", "2x2", "--ckpt-dir", str(tmp_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "mesh 2x2 does not match a world of 2" in proc.stdout + proc.stderr
    assert os.listdir(tmp_path) == []


def test_serve_launcher_smoke():
    out = run_module(["repro_torch.launch.serve", "--arch", "internlm2-1.8b",
                      "--smoke", "--tokens", "6", "--device", "cpu"])
    assert re.search(r"prefill 4x32: [0-9.]+ ms", out)
    assert "ms/token" in out and "sample token ids:" in out


@pytest.mark.parametrize("arch", ["whisper-medium", "mamba2-370m"])
def test_serve_launcher_smoke_new_families(arch):
    """The encoder-decoder (on zero frame embeddings, as the reference's
    launcher) and the SSM serve through the same launcher."""
    out = run_module(["repro_torch.launch.serve", "--arch", arch,
                      "--smoke", "--tokens", "6", "--device", "cpu"])
    assert re.search(r"prefill 4x32: [0-9.]+ ms", out)
    assert "ms/token" in out and "sample token ids:" in out


# ---------------------------------------------------------------------------
# a trainer's delta spool feeding a serving replica
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spool(tmp_path_factory):
    """A spool of 12 published epochs (shadow checkpoints every 4)."""
    root = tmp_path_factory.mktemp("spool")
    out = train("--steps", "12", "--ckpt-every", "12", "--ckpt-dir",
                str(root / "ckpt_train"), "--compress", "--k-fraction",
                "0.05", "--publish-deltas", str(root / "spool"),
                "--sync-ckpt-every", "4")
    assert "delta-sync published 12 epochs" in out
    return str(root / "spool")


def serve_from(spool_dir, *flags):
    return serve.run(serve.parse_args(
        [*SMOKE, "--tokens", "6", "--sync-spool", spool_dir, *flags]))


def leaves_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(TR.leaves(a), TR.leaves(b)))


def frames_by_epoch(spool_dir):
    out = {}
    for buf in DirTransport(spool_dir).poll():
        f = decode_frame(buf)
        out.setdefault(f.epoch, {})[f.shard] = f
    return out


def test_replica_degrades_to_the_shadow_checkpoint(spool):
    """12 epochs behind with a bound of 4: one reload of the newest shadow
    checkpoint (epoch 12), the shadow bit for bit."""
    res = serve_from(spool)
    sub = res["subscriber"]
    assert sub.applied_epoch == 12 and sub.degradations == 1
    shadow = restore_checkpoint(os.path.join(spool, "ckpt"), 12,
                                res["params"])
    assert leaves_equal(res["params"], shadow)


def test_replica_window_fold_ends_equal_to_the_shadow(spool):
    """A bound of 16: one ragged SpKAdd folds all 12 epochs. The replica is
    the initial parameters plus the engine's canonical sum of each leaf's
    frames (bit for bit the ``sorted`` path's), and the shadow bit for bit
    where no index repeats across the window: each such sum is one frame's
    value, added once, as the shadow added it."""
    res = serve_from(spool, "--max-staleness", "16")
    sub = res["subscriber"]
    assert sub.applied_epoch == 12 and sub.degradations == 0
    init = restore_checkpoint(os.path.join(spool, "ckpt"), 0, res["params"])
    frames = frames_by_epoch(spool)
    assert sorted(frames) == list(range(1, 13))
    want, repeats = [], 0
    names = TR.flatten_with_names(init)[1]
    for leaf, name in zip(TR.leaves(init), names):
        coll = [frame_to_coo(frames[e][name], "cpu") for e in range(1, 13)]
        idx = np.concatenate([frames[e][name].idx for e in range(1, 13)])
        repeats += idx.size - np.unique(idx).size
        s = spkadd_run(coll, algorithm="sorted")
        want.append(apply_delta_flat(leaf.reshape(-1), s.keys, s.vals)
                    .reshape(leaf.shape))
    got = TR.leaves(res["params"])
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))
    shadow = restore_checkpoint(os.path.join(spool, "ckpt"), 12,
                                res["params"])
    if repeats == 0:
        assert leaves_equal(res["params"], shadow)
    else:  # one rounding a repeated index where the shadow rounds twice
        for a, b in zip(got, TR.leaves(shadow)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

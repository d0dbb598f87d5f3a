"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

- One full-width cell, ``smollm-135m × train_4k × 16x16``, runs on the fake
  256-rank world through the CLI with ``--out``: ``status: ok``, and its
  ``arg_bytes`` are exactly a rank's f32 parameters and AdamW moments as
  ``launch/shard_memory.py`` reckons them from the specs, AdamW's step and
  the rank's rows of the batch.
- A smoke config of the MoE ``moonshot_v1_16b_a3b`` (the dry-run's
  ``get_config`` swapped for ``get_smoke_config``) runs through ``--out``
  twice: its record is replaced by key, the full cell's kept.
- The dry-run refuses to start its fake world where a process group
  already exists.

``serve_shardings`` and ``model_flops`` are held to the reference's, for
all ten configs, in ``tests/test_torch_sharding.py``, whose 512-device
subprocess computes the reference's.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.compat import fake_tensor_mode
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.shard_memory import (STATE_BYTES, fake_params,
                                             per_rank_elements)
from repro_torch.models.common import SHAPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_TIMEOUT_S = 300


#: The dry-run's CLI in a fresh process with each arch's smoke config in
#: place of its full one.
SMOKE_MAIN = ("import sys\n"
              "from repro_torch.configs import get_smoke_config\n"
              "from repro_torch.launch import dryrun\n"
              "dryrun.get_config = get_smoke_config\n"
              "raise SystemExit(dryrun.main(sys.argv[1:]))\n")


def run_cli(*args, smoke: bool = False) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    how = ["-c", SMOKE_MAIN] if smoke else ["-m", "repro_torch.launch.dryrun"]
    proc = subprocess.run([sys.executable, *how, *args], env=env,
                          capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The full cell, then the MoE smoke cell twice, into one ``--out``
    file: ``(records after the first smoke run, after the second)``."""
    out = str(tmp_path_factory.mktemp("dryrun") / "dryrun.json")
    run_cli("--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
            "single", "--out", out)
    smoke = ("--arch", "moonshot_v1_16b_a3b", "--shape", "train_4k",
             "--out", out)
    run_cli(*smoke, smoke=True)
    with open(out) as f:
        first = json.load(f)
    run_cli(*smoke, "--print-hlo-collectives", smoke=True)
    with open(out) as f:
        return first, json.load(f)


def test_full_width_cell_on_the_fake_world(records):
    full = records[1][0]
    assert (full["arch"], full["shape"], full["mesh"], full["chips"],
            full["status"]) == ("smollm-135m", "train_4k", "16x16", 256, "ok")
    mesh = production_mesh_shape()
    local = per_rank_elements(fake_params("smollm-135m"), mesh)
    shape = SHAPES["train_4k"]
    rows = shape.global_batch // mesh.shape[0]
    batch_bytes = 2 * rows * shape.seq_len * 4      # int32 tokens, labels
    assert full["arg_bytes"] == local * STATE_BYTES + 4 + batch_bytes
    cfg = get_config("smollm-135m")
    assert full["model_flops_per_chip"] == dryrun.model_flops(cfg, shape,
                                                              256)
    assert 0 < full["useful_flops_ratio"] < 1
    assert full["xla_flops_once"] is None and full["sp"] is False
    assert set(full["coll_by_kind"]) == {"all-gather", "reduce-scatter",
                                         "all-reduce"}
    assert full["temp_bytes"] > 0 and full["hbm_bytes"] > full["arg_bytes"]
    assert full["trace_s"] > 0


def test_smoke_record_is_replaced_by_key(records):
    first, second = records
    assert [(r["arch"], r["mesh"]) for r in second] == [
        ("smollm-135m", "16x16"), ("moonshot_v1_16b_a3b", "16x16")]
    assert first[0] == second[0]
    strip = {"trace_s"}
    assert {k: v for k, v in first[1].items() if k not in strip} \
        == {k: v for k, v in second[1].items() if k not in strip}
    assert second[1]["status"] == "ok"


def test_dryrun_refuses_a_live_process_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="default process group"):
            dryrun.main(["--arch", "smollm-135m", "--shape",
                         "decode_32k"])
    finally:
        dist.destroy_process_group()


def test_serve_params_are_bf16_meta_tensors():
    with fake_tensor_mode()():
        params = fake_params("smollm-135m")
        sds = dryrun.serve_param_sds(params)
    leaves = [x for x in sds.values() if isinstance(x, torch.Tensor)]
    assert leaves and all(x.dtype == torch.bfloat16 and x.is_meta
                          for x in leaves)
    assert sds["embed"].shape == params["embed"].shape

"""Import hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the reference package ``repro``, and the
constructors refuse to default to a card that is not there."""
import ast
import glob
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "src", "repro_torch", "**",
                                           "*.py"), recursive=True))
SCANNED = PORT_FILES + [os.path.join(REPO, "chip_smoke.py")]


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_scan_covers_the_port():
    names = {os.path.relpath(p, REPO) for p in SCANNED}
    assert "src/repro_torch/core/engine.py" in names
    assert "src/repro_torch/kernels/partition.py" in names
    for module in ("tree.py", "core/topk.py", "kernels/topk_block.py",
                   "checkpoint/checkpoint.py", "train/step.py",
                   "runtime/faults.py", "runtime/delta_sync.py",
                   "runtime/supervisor.py", "core/streaming.py",
                   "core/stream_service.py", "launch/__init__.py",
                   "launch/stream_serve.py", "kernels/xla_add.py",
                   "core/allreduce.py", "core/spgemm.py", "optim/adamw.py",
                   "optim/__init__.py", "launch/spgemm_demo.py",
                   "launch/world.py", "models/__init__.py",
                   "models/common.py", "models/layers.py",
                   "models/transformer.py", "models/moe.py",
                   "models/ssm.py", "models/hybrid.py", "models/encdec.py",
                   "serve/__init__.py", "serve/kv_quant.py",
                   "configs/__init__.py",
                   "configs/smollm_135m.py", "configs/internlm2_1_8b.py",
                   "configs/stablelm_3b.py", "configs/gemma3_27b.py",
                   "configs/qwen2_vl_72b.py", "configs/whisper_medium.py",
                   "configs/zamba2_2_7b.py", "configs/mamba2_370m.py",
                   "configs/moonshot_v1_16b_a3b.py",
                   "configs/llama4_scout_17b_a16e.py", "data/__init__.py",
                   "data/synthetic.py", "train/__init__.py",
                   "launch/train.py", "launch/serve.py",
                   "launch/train_100m.py", "launch/quickstart.py",
                   "launch/mesh.py", "sharding/__init__.py",
                   "sharding/api.py", "sharding/params.py", "compat.py",
                   "obs/trace.py", "launch/hlo_analysis.py",
                   "launch/dryrun.py", "analysis/__init__.py",
                   "analysis/findings.py", "analysis/ast_rules.py",
                   "analysis/trace_rules.py", "analysis/smem.py",
                   "analysis/cli.py"):
        assert f"src/repro_torch/{module}" in names, module
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", SCANNED,
                         ids=[os.path.relpath(p, REPO) for p in SCANNED])
def test_no_jax_and_no_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
        assert top != "repro", (path, mod)


def test_kernel_sources_stand_alone():
    csrc = os.path.join(REPO, "src", "repro_torch", "kernels", "csrc")
    sources = sorted(os.listdir(csrc))
    assert {"partition.cu", "hash_slide.cu", "segment_fold.cu",
            "spa_accum.cu", "hash_accum.cu", "topk_block.cu",
            "xla_add.cu", "moe_combine.cu"} <= set(sources)
    for name in sources:
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        assert "torch/extension.h" not in text, name


def test_constructors_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    from repro_torch.core import sparse as TS

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.from_coords([1], [0], [2.0], (4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.resolve_device(None)
    assert TS.resolve_device("cpu").type == "cpu"

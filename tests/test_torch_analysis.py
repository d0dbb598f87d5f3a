"""spkaddlint for the port (``repro_torch.analysis``): the green tests of
``tests/test_analysis.py`` replayed on the port's rules, on the CPU.

Every rule must fire on its violating fixture and stay silent on the clean
twin; the source snippets are the reference's, with each jax call
translated to its torch counterpart. The trace rules run the port's entry
points: SPKJ201 and SPKJ202 are held to ``expected_sorts`` and to the
kernels' int32 boundaries here (the reference's jaxpr traces of them are
red on this tree), SPKJ203 to the reference's tables, SPKJ204 to the
runtime's working-set formula. The shipped port tree must scan clean.

The parts the two packages share are also held to the reference itself on
the same inputs: ``expected_sorts``, ``REGIME_FORCES``, the geometry
matrix's labels and counts, ``STEP_MATRIX``, ``partition_steps`` and
``validate_step_tables``, and the language-neutral AST rules
(SPK103-SPK108) on the same snippets.
"""
import ctypes
import json
import os

import numpy as np
import pytest
import torch

from repro.analysis import ast_rules as ref_ast_rules
from repro.analysis import jaxpr_rules as JR
from repro.core.sparse import partition_steps as ref_partition_steps
from repro.kernels.ops import fold_working_set_bytes as ref_working_set
from repro_torch.analysis import ast_rules, findings as F, smem
from repro_torch.analysis import trace_rules as TR
from repro_torch.analysis.cli import main as cli_main
from repro_torch.core import sparse as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(REPO, "src", "repro_torch")

#: The waivers the shipped tree carries, each with its reason beside it
#: in the source: the stream service's host-side retry jitter (the
#: reference's own waiver), the kernel build's nvcc timing, the plain twins
#: of two in-kernel sorts, and the row-split layout's module state.
SHIPPED_WAIVERS = 6


def rules_of(fs):
    return [f.rule for f in fs]


# ---------------------------------------------------------------------------
# AST rules (SPK1xx): violating fixture vs clean twin
# ---------------------------------------------------------------------------

def test_spk101_direct_sort_fires_outside_sort_home():
    src = "import torch\norder = torch.argsort(keys)\n"
    fs = ast_rules.scan_source(src, "kernels/foo.py")
    assert rules_of(fs) == ["SPK101"]
    assert fs[0].line == 2 and "stable_argsort" in fs[0].fixit


def test_spk101_silent_inside_sort_home_and_on_routed_sort():
    direct = "import torch\norder = torch.argsort(keys)\n"
    assert ast_rules.scan_source(direct, "core/sparse.py") == []
    routed = ("from repro_torch.core.sparse import stable_argsort\n"
              "order = stable_argsort(keys)\n")
    assert ast_rules.scan_source(routed, "kernels/foo.py") == []
    top = ("from repro_torch.core.sparse import top_k\n"
           "vals, idx = top_k(probs, 2)\n")
    assert ast_rules.scan_source(top, "models/moe.py") == []


def test_spk101_alias_cannot_dodge_the_rule():
    src = ("from torch import argsort as innocent_name\n"
           "order = innocent_name(keys)\n")
    assert rules_of(ast_rules.scan_source(src, "core/engine.py")) == ["SPK101"]


def test_spk101_tensor_sort_methods_fire_list_and_numpy_sorts_do_not():
    for src in ("order = keys.argsort(stable=True)\n",
                "s = x.abs().sort(descending=True)\n",
                "v, i = torch.sort(x)\n"):
        fs = ast_rules.scan_source(src, "core/engine.py")
        assert rules_of(fs) == ["SPK101"], src
    for src in ("events.sort(key=lambda e: e.t)\n",
                "names.sort(reverse=True)\n",
                "import numpy as np\nk = np.sort(keys, kind='stable')\n",
                "import numpy as np\no = np.argsort(keys)\n"):
        assert ast_rules.scan_source(src, "launch/foo.py") == [], src


def test_spk102_private_import_fires_outside_compat():
    for src in ("from torch._subclasses.fake_tensor import FakeTensorMode\n",
                "import torch.utils._python_dispatch\n",
                "from torch.testing._internal.distributed.fake_pg "
                "import FakeStore\n",
                "from torch import _C\n"):
        fs = ast_rules.scan_source(src, "kernels/foo.py")
        assert rules_of(fs) == ["SPK102"], src
        assert "compat" in fs[0].fixit
        assert ast_rules.scan_source(src, "compat.py") == [], src
    public = ("import torch.distributed as dist\n"
              "from torch.utils.flop_counter import FlopCounterMode\n")
    assert ast_rules.scan_source(public, "launch/foo.py") == []


def test_spk102_jax_and_reference_imports_fire_everywhere():
    for src in ("import jax\n", "import jax.numpy as jnp\n",
                "from jax.experimental import pallas as pl\n",
                "from repro.core import sparse\n", "import repro\n"):
        for rel in ("kernels/foo.py", "compat.py"):
            fs = ast_rules.scan_source(src, rel)
            assert rules_of(fs) == ["SPK102"], (src, rel)
            assert "neither jax nor" in fs[0].message
    assert ast_rules.scan_source("import repro_torch\n", "launch/x.py") == []


def test_spk103_global_counter_fires_outside_obs():
    src = "def bump():\n    global _calls\n    _calls += 1\n"
    fs = ast_rules.scan_source(src, "core/engine.py")
    assert rules_of(fs) == ["SPK103"]
    assert "obs.metrics" in fs[0].message
    assert ast_rules.scan_source(src, "obs/metrics.py") == []


def test_spk104_span_must_be_with_context_at_launch_boundary():
    bare = "from repro_torch import obs\nspan = obs.span('x')\nspan.close()\n"
    fs = ast_rules.scan_source(bare, "core/engine.py")
    assert rules_of(fs) == ["SPK104"]
    assert "with" in fs[0].message

    misplaced = "from repro_torch import obs\nwith obs.span('x'):\n    pass\n"
    fs = ast_rules.scan_source(misplaced, "core/sparse.py")
    assert rules_of(fs) == ["SPK104"]
    assert "not a launch boundary" in fs[0].message

    good = "from repro_torch import obs\nwith obs.span('x'):\n    pass\n"
    assert ast_rules.scan_source(good, "core/engine.py") == []


def test_spk105_host_nondeterminism_fires_in_traced_dirs_only():
    src = "import time\nt0 = time.perf_counter()\n"
    fs = ast_rules.scan_source(src, "kernels/ops_helper.py")
    assert rules_of(fs) == ["SPK105"]
    assert ast_rules.scan_source(src, "launch/bench.py") == []
    rnd = "import random\nx = random.random()\n"
    assert rules_of(ast_rules.scan_source(rnd, "models/foo.py")) == ["SPK105"]


def test_spk106_bare_assert_fires_anywhere_in_src():
    src = "def f(x):\n    assert x > 0, 'bad'\n    return x\n"
    for rel in ("core/engine.py", "kernels/foo.py", "runtime/delta_sync.py"):
        fs = ast_rules.scan_source(src, rel)
        assert rules_of(fs) == ["SPK106"], rel
        assert fs[0].line == 2 and "python -O" in fs[0].message


def test_spk106_silent_on_raise_twin_and_waivable():
    good = ("def f(x):\n"
            "    if not x > 0:\n"
            "        raise ValueError('bad')\n"
            "    return x\n")
    assert ast_rules.scan_source(good, "core/engine.py") == []
    waived = ("def f(x):\n"
              "    assert x > 0  # spkaddlint: disable=SPK106\n")
    fs = ast_rules.scan_source(waived, "core/engine.py")
    assert rules_of(fs) == ["SPK106"] and fs[0].waived
    assert F.active(fs) == []


def test_spk107_inline_doubling_loop_fires_outside_helper():
    src = ("def size_table(bound):\n"
           "    size = 1\n"
           "    while size < 2 * bound:\n"
           "        size *= 2\n"
           "    return size\n")
    fs = ast_rules.scan_source(src, "kernels/hash_slide.py")
    assert rules_of(fs) == ["SPK107"]
    assert "hash_table_size" in fs[0].fixit
    # the SAME loop inside the sanctioned helper is the one legal home
    good = src.replace("def size_table", "def hash_table_size")
    assert ast_rules.scan_source(good, "kernels/hash_accum.py") == []
    # outside the hash-kernel family: out of scope
    assert ast_rules.scan_source(src, "kernels/partition.py") == []


def test_spk107_probe_loop_half_is_not_carried_over():
    """The reference's probe-loop guard reads ``lax.while_loop`` conds; the
    port's probe loops are CUDA C++, so the half is recorded as not carried
    over (in the rule's text) and checks no Python loop."""
    src = ("import jax\n"
           "def probe(h0):\n"
           "    return jax.lax.while_loop(lambda c: True, lambda c: c, h0)\n")
    assert rules_of(ast_rules.scan_source(src, "kernels/hash_slide.py")) \
        == ["SPK102"]
    assert "not carried over" in F.RULES["SPK107"].invariant


def test_spk108_durable_write_without_staging_fires():
    src = ("def save(journal_path, buf):\n"
           "    with open(journal_path, 'wb') as f:\n"
           "        f.write(buf)\n")
    fs = ast_rules.scan_source(src, "runtime/foo.py")
    assert rules_of(fs) == ["SPK108"]
    assert "os.replace" in fs[0].fixit
    kw = "f = open('spool/frame_0001.bin', mode='w')\n"
    assert rules_of(ast_rules.scan_source(kw, "serve/foo.py")) == ["SPK108"]
    ckpt = ("import os\n"
            "def snap(d, buf):\n"
            "    with open(os.path.join(d, 'snapshot.bin'), 'ab') as f:\n"
            "        f.write(buf)\n")
    assert rules_of(ast_rules.scan_source(ckpt, "core/x.py")) == ["SPK108"]


def test_spk108_silent_on_atomic_twin_reads_and_plain_paths():
    atomic = ("import os\n"
              "def save(journal_path, buf):\n"
              "    tmp = journal_path + '.tmp'\n"
              "    with open(tmp, 'wb') as f:\n"
              "        f.write(buf)\n"
              "    os.replace(tmp, journal_path)\n")
    assert ast_rules.scan_source(atomic, "runtime/foo.py") == []
    read = "buf = open(journal_path, 'rb').read()\n"
    assert ast_rules.scan_source(read, "runtime/foo.py") == []
    plain = "open(report_path, 'w').write('x')\n"
    assert ast_rules.scan_source(plain, "launch/foo.py") == []


def test_spk108_waivable_inline():
    src = ("def save(ckpt, buf):\n"
           "    f = open(ckpt, 'wb')  # spkaddlint: disable=SPK108\n")
    fs = ast_rules.scan_source(src, "runtime/foo.py")
    assert rules_of(fs) == ["SPK108"] and fs[0].waived
    assert F.active(fs) == []


def test_syntax_error_is_its_own_finding():
    fs = ast_rules.scan_source("def broken(:\n", "core/foo.py")
    assert rules_of(fs) == ["SPK101"] and "does not parse" in fs[0].message


#: Snippets whose rules read no jax or torch call (SPK103-SPK108), as
#: ``(source, path under the package)``; the reference scans each with
#: ``repro_torch`` read as ``repro``.
SHARED_SNIPPETS = [
    ("def bump():\n    global _calls\n    _calls += 1\n", "core/engine.py"),
    ("def bump():\n    global _calls\n    _calls += 1\n", "obs/metrics.py"),
    ("from repro_torch import obs\nspan = obs.span('x')\nspan.close()\n",
     "core/engine.py"),
    ("from repro_torch import obs\nwith obs.span('x'):\n    pass\n",
     "core/sparse.py"),
    ("from repro_torch import obs\nwith obs.span('x'):\n    pass\n",
     "core/engine.py"),
    ("import time\nt0 = time.perf_counter()\n", "kernels/ops_helper.py"),
    ("import time\nt0 = time.perf_counter()\n", "launch/bench.py"),
    ("import random\nx = random.random()\n", "models/foo.py"),
    ("def f(x):\n    assert x > 0, 'bad'\n    return x\n", "core/engine.py"),
    ("def f(x):\n    assert x > 0, 'bad'\n    return x\n",
     "runtime/delta_sync.py"),
    ("def f(x):\n    if not x > 0:\n        raise ValueError('bad')\n"
     "    return x\n", "core/engine.py"),
    ("def f(x):\n    assert x > 0  # spkaddlint: disable=SPK106\n",
     "core/engine.py"),
    ("def size_table(bound):\n    size = 1\n    while size < 2 * bound:\n"
     "        size *= 2\n    return size\n", "kernels/hash_slide.py"),
    ("def hash_table_size(bound):\n    size = 1\n    while size < 2 * bound:"
     "\n        size *= 2\n    return size\n", "kernels/hash_accum.py"),
    ("def size_table(bound):\n    size = 1\n    while size < 2 * bound:\n"
     "        size *= 2\n    return size\n", "kernels/partition.py"),
    ("def save(journal_path, buf):\n    with open(journal_path, 'wb') as f:\n"
     "        f.write(buf)\n", "runtime/foo.py"),
    ("f = open('spool/frame_0001.bin', mode='w')\n", "serve/foo.py"),
    ("import os\ndef snap(d, buf):\n"
     "    with open(os.path.join(d, 'snapshot.bin'), 'ab') as f:\n"
     "        f.write(buf)\n", "core/x.py"),
    ("import os\ndef save(journal_path, buf):\n"
     "    tmp = journal_path + '.tmp'\n    with open(tmp, 'wb') as f:\n"
     "        f.write(buf)\n    os.replace(tmp, journal_path)\n",
     "runtime/foo.py"),
    ("buf = open(journal_path, 'rb').read()\n", "runtime/foo.py"),
    ("open(report_path, 'w').write('x')\n", "launch/foo.py"),
    ("def save(ckpt, buf):\n"
     "    f = open(ckpt, 'wb')  # spkaddlint: disable=SPK108\n",
     "runtime/foo.py"),
]


@pytest.mark.parametrize("src,rel", SHARED_SNIPPETS)
def test_language_neutral_ast_rules_equal_the_reference(src, rel):
    def key(fs):
        return [(f.rule, f.path, f.line, f.waived) for f in fs]

    ref_src = src.replace("repro_torch", "repro")
    assert key(ast_rules.scan_source(src, rel)) \
        == key(ref_ast_rules.scan_source(ref_src, rel))


# ---------------------------------------------------------------------------
# waivers
# ---------------------------------------------------------------------------

def test_waiver_roundtrip_same_line_and_line_above():
    same = ("import torch\n"
            "o = torch.argsort(k)  # spkaddlint: disable=SPK101\n")
    fs = ast_rules.scan_source(same, "kernels/foo.py")
    assert rules_of(fs) == ["SPK101"] and fs[0].waived
    assert F.active(fs) == []

    above = ("import torch\n"
             "# spkaddlint: disable=SPK101\n"
             "o = torch.argsort(k)\n")
    fs = ast_rules.scan_source(above, "kernels/foo.py")
    assert fs[0].waived


def test_waiver_wrong_rule_does_not_apply():
    src = ("import torch\n"
           "o = torch.argsort(k)  # spkaddlint: disable=SPK102\n")
    fs = ast_rules.scan_source(src, "kernels/foo.py")
    assert rules_of(fs) == ["SPK101"] and not fs[0].waived
    assert F.active(fs) == fs


def test_waiver_parsing_lists_and_all():
    src = "x = 1  # spkaddlint: disable=SPK101, SPK105\ny = 2\n"
    w = F.parse_waivers(src)
    assert w == {1: {"SPK101", "SPK105"}}
    assert F.is_waived({3: {"all"}}, 3, "SPKJ204")
    assert F.is_waived({3: {"all"}}, 4, "SPKJ204")  # line above
    assert not F.is_waived({3: {"all"}}, 5, "SPKJ204")


# ---------------------------------------------------------------------------
# trace rules (SPKJ2xx)
# ---------------------------------------------------------------------------

def test_expected_sorts_table():
    assert TR.expected_sorts("tree", 1) == 1
    assert TR.expected_sorts("tree", 5) == 4
    for regime in ("sorted", "spa", "vec", "blocked_spa", "hash"):
        assert TR.expected_sorts(regime, 5) == 1


def test_expected_sorts_and_regime_forces_equal_the_reference():
    assert TR.REGIME_FORCES == JR.REGIME_FORCES
    for regime in JR.REGIME_FORCES:
        for k in range(1, 7):
            assert TR.expected_sorts(regime, k) == JR.expected_sorts(regime, k)


def test_geometry_matrix_labels_and_counts_equal_the_reference():
    """The cells and what each expects; neither side's thunks run."""
    port = [(label, n) for label, _, n in TR.geometry_matrix("cpu")]
    ref = [(label, n) for label, _, n in JR.geometry_matrix()]
    assert port == ref and len(port) == 40


def test_sort_counts_see_a_bypass_and_skip_top_k_and_plain_twins():
    """The two counts of SPKJ201: a direct sort shows in the dispatch count
    only (the bypass SPK101 guards), ``stable_argsort`` in both, and the
    top-k selection and a kernel's plain twin in neither."""
    from repro_torch.kernels import vec_accum

    x = torch.tensor([3.0, 1.0, 2.0, 0.5])
    assert TR.count_sorts(lambda: torch.sort(x)) == (0, 1)
    assert TR.count_sorts(lambda: S.stable_argsort(x)) == (1, 1)
    assert TR.count_sorts(lambda: S.top_k(x, 2)) == (0, 0)
    assert TR.count_sorts(lambda: S.top_k_abs(x, 2)) == (0, 0)
    tile = torch.zeros((1, 4))
    slot = torch.tensor([[2, 0, 2, 1]], dtype=torch.int32)
    assert TR.count_sorts(lambda: vec_accum.apply_fold(
        "sort", tile, slot, x[None], torch.ones_like(slot, dtype=torch.bool))
    ) == (0, 0)


def test_sort_in_a_kernel_wrapper_outside_a_plain_twin_is_counted():
    """Only the named plain twins are exempt: a sort on a wrapper's host
    side, in ``kernels/`` but outside a twin, shows in the dispatch count
    (and not in ``sort_calls()``: the bypass SPKJ201 reports)."""
    path = os.path.join(PORT_SRC, "kernels", "segment.py")
    ns = {"torch": torch}
    exec(compile("def segment_fold(x):\n"
                 "    return torch.sort(x, stable=True)\n", path, "exec"), ns)
    x = torch.tensor([3.0, 1.0, 2.0])
    assert TR.count_sorts(lambda: ns["segment_fold"](x)) == (0, 1)
    # the same sort under a plain twin is not counted
    from repro_torch.kernels import spa_accum
    keys = torch.tensor([5, 0, 3, 1], dtype=torch.int32)
    assert TR.count_sorts(lambda: spa_accum.spa_bucket_plain(
        keys, torch.ones(4), m=4, n=2, block_rows=2)) == (0, 0)


@pytest.mark.parametrize("regime,k,expected", [
    ("vec", 3, 1), ("tree", 3, 2), ("blocked_spa", 5, 1), ("hash", 5, 1),
])
def test_one_sort_invariant_spot_check(regime, k, expected):
    """One live cell per regime family, both counts."""
    from repro_torch.core import engine as E

    mats = TR._collection(11, k, 16, 4, 8, "cpu")
    force = dict(TR.REGIME_FORCES[regime])
    counted, seen = TR.count_sorts(
        lambda: E.spkadd_auto(mats, cost_model=force))
    assert counted == seen == expected


def test_spkj201_and_spkj202_hold_over_the_geometry_matrix():
    assert TR.check_entry_points("cpu") == []


def test_spkj202_catches_i64_at_a_kernel_wrapper():
    from repro_torch.kernels import segment

    vals = torch.ones(4)
    with TR._WrapperArgs() as rec:
        segment.segment_fold(vals, torch.tensor([0, 0, 1, 2]), 3)
    fs = TR.index_dtype_findings(rec.bad, "fixture")
    assert rules_of(fs) == ["SPKJ202"] and rec.calls == 1
    assert "int64" in fs[0].message and "segment.segment_fold" in fs[0].message
    # clean twin: int32 indices produce no finding
    with TR._WrapperArgs() as rec:
        segment.segment_fold(vals, torch.tensor([0, 0, 1, 2],
                                                dtype=torch.int32), 3)
    assert rec.bad == [] and rec.calls == 1


def test_spkj202_entry_recorder_resolves_pointers(monkeypatch):
    """The card's check: a C entry point's pointer arguments are traced
    back to the tensors whose ``data_ptr`` gave them."""
    from repro_torch.kernels import _build

    seen = []
    monkeypatch.setattr(_build, "entry",
                        lambda lib, sym, argtypes: lambda *a: seen.append(a))
    i64 = torch.arange(4)
    i32 = torch.arange(4, dtype=torch.int32)
    with TR._EntryRecorder() as rec:
        fn = _build.entry("segment_fold", "spk_segment_fold",
                          [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64])
        fn(i32.data_ptr(), i64.data_ptr(), i64.data_ptr())
    assert rec.calls == 1 and len(seen) == 1
    assert rec.bad == ["segment_fold.spk_segment_fold argument 1: "
                       "torch.int64, shape (4,)"]
    assert "data_ptr" not in vars(torch.Tensor)


def test_kernel_wrappers_are_found():
    names = set(TR.kernel_wrappers().values())
    assert {"partition.partitioned_accumulate_raw",
            "hash_slide.hash_slide_raw", "segment.segment_fold",
            "spa_accum.spa_accumulate_raw", "hash_accum.hash_accumulate_raw",
            "hash_accum.hash_symbolic_raw", "topk_block.topk_block_raw",
            "xla_add.xla_add_raw", "moe_combine.moe_combine_raw"} <= names


def _tiny_schedule():
    # sorted padded stream over mn=512, part_elems=128 (4 parts), chunk=2:
    # keys {0,1} -> (chunk 0, part 0); {130,140} -> (chunk 1, part 1)
    keys = np.array([0, 1, 130, 140], np.int32)
    return dict(keys_sorted=keys, mn=512, part_elems=128, parts=4, chunk=2)


def test_spkj203_legal_tables_pass():
    fs = TR.validate_step_tables(np.array([0, 1]), np.array([0, 1]),
                                 **_tiny_schedule())
    assert fs == []


def test_spkj203_non_monotone_part_table():
    fs = TR.validate_step_tables(np.array([0, 1]), np.array([1, 0]),
                                 **_tiny_schedule())
    msgs = " | ".join(f.message for f in fs)
    assert all(f.rule == "SPKJ203" for f in fs)
    assert "not non-decreasing" in msgs


def test_spkj203_duplicate_step_double_counts():
    fs = TR.validate_step_tables(np.array([0, 0, 1]), np.array([0, 0, 1]),
                                 **_tiny_schedule())
    assert rules_of(fs) == ["SPKJ203"]
    assert "more than once" in fs[0].message


def test_spkj203_dropped_payload():
    fs = TR.validate_step_tables(np.array([0]), np.array([0]),
                                 **_tiny_schedule())
    assert rules_of(fs) == ["SPKJ203"]
    assert "never scheduled" in fs[0].message


def test_spkj203_real_partition_steps_are_legal():
    assert TR.check_step_tables() == []


@pytest.mark.parametrize("chunk_id,part_id", [
    ([0, 1], [0, 1]), ([0, 1], [1, 0]), ([0, 0, 1], [0, 0, 1]), ([0], [0]),
    ([1, 0], [0, 1]),
])
def test_spkj203_validate_step_tables_equals_the_reference(chunk_id, part_id):
    def key(fs):
        return [(f.rule, f.path, f.line) for f in fs]

    args = (np.array(chunk_id), np.array(part_id))
    assert key(TR.validate_step_tables(*args, **_tiny_schedule())) \
        == key(JR.validate_step_tables(*args, **_tiny_schedule()))


def test_spkj203_partition_steps_equal_the_reference_over_step_matrix():
    """``STEP_MATRIX`` is the reference's, and on each of its streams both
    packages' ``partition_steps`` give the same tables, which both
    validators pass."""
    import jax.numpy as jnp

    assert TR.STEP_MATRIX == JR.STEP_MATRIX
    rng = np.random.default_rng(0)
    for mn, part_elems, chunk, nnz in TR.STEP_MATRIX:
        parts = max(1, (mn + part_elems - 1) // part_elems)
        keys = np.sort(rng.choice(mn, size=min(nnz, mn), replace=False)) \
            if nnz else np.zeros((0,), np.int64)
        cap_pad = ((max(len(keys), 1) + chunk - 1) // chunk) * chunk
        keys_p = np.full((cap_pad,), mn, np.int32)
        keys_p[:len(keys)] = keys.astype(np.int32)
        geo = dict(mn=mn, part_elems=part_elems, parts=parts, chunk=chunk)
        port = S.partition_steps(torch.from_numpy(keys_p), **geo)
        ref = ref_partition_steps(jnp.asarray(keys_p), **geo)
        tables = []
        for name in ("chunk_id", "part_id"):
            p = getattr(port, name).reshape(-1).numpy()
            r = np.asarray(getattr(ref, name)).reshape(-1)
            np.testing.assert_array_equal(p, r, err_msg=f"{name} {geo}")
            tables.append(p)
        assert TR.validate_step_tables(*tables, keys_sorted=keys_p,
                                       **geo) == []
        assert JR.validate_step_tables(*tables, keys_sorted=keys_p,
                                       **geo) == []


def test_spkj204_overspilled_geometry_is_flagged():
    fs = smem.check_launch(cap=1 << 16, m=4096, n=4096, part_elems=1 << 22,
                           chunk=1024, backend="cpu",
                           label="forced-overspill")
    assert rules_of(fs) == ["SPKJ204"]
    assert "exceeds" in fs[0].message and "cpu cap 16777216" in fs[0].message


def test_spkj204_default_matrix_is_clean():
    assert smem.backend_cap("cpu") == 16 * 1024 * 1024
    assert smem.runtime_budget("cpu") == smem.backend_cap("cpu")
    assert smem.check_all("cpu") == []


def test_working_set_formula_matches_runtime():
    from repro_torch.kernels.ops import fold_working_set_bytes
    assert fold_working_set_bytes("sort", tile_elems=1024, chunk=256) \
        == 1024 * 4 + 2 * 256 * 8
    assert fold_working_set_bytes("onehot", tile_elems=1024, chunk=256) \
        == 1024 * 4 + 2 * 256 * 8 + 256 * 1024 * 8
    for fold in ("sort", "onehot", "serial"):
        assert fold_working_set_bytes(fold, tile_elems=1024, chunk=256) \
            == ref_working_set(fold, tile_elems=1024, chunk=256)
    assert smem.working_set_bytes(part_elems=1024, chunk=256) \
        == fold_working_set_bytes("sort", tile_elems=1024, chunk=256)


# ---------------------------------------------------------------------------
# CLI round-trip
# ---------------------------------------------------------------------------

def _fake_root(tmp_path, source):
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(source)
    return str(tmp_path)


def test_cli_ast_clean_on_shipped_tree(capsys):
    rc = cli_main(["--ast", "--root", REPO])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"0 finding(s) ({SHIPPED_WAIVERS} waived) — OK" in out


def test_cli_all_clean_on_shipped_tree_and_writes_json(tmp_path, capsys):
    report = tmp_path / "lint.json"
    rc = cli_main(["--all", "--root", REPO, "--json", str(report)])
    assert rc == 0, capsys.readouterr().out
    payload = json.loads(report.read_text())
    assert payload["ok"] is True and payload["counts"] == {}
    assert payload["layers"] == {"ast": True, "trace": True}
    assert sum(f["waived"] for f in payload["findings"]) == SHIPPED_WAIVERS


def test_cli_gates_red_and_writes_json(tmp_path, capsys):
    root = _fake_root(tmp_path, "import torch\no = torch.sort(k)\n")
    report = tmp_path / "out" / "findings.json"
    rc = cli_main(["--ast", "--root", root, "--json", str(report)])
    assert rc == 1
    payload = json.loads(report.read_text())
    assert payload["ok"] is False
    assert payload["counts"] == {"SPK101": 1}
    (f,) = payload["findings"]
    assert f["rule"] == "SPK101" and not f["waived"]
    assert f["path"] == "src/repro_torch/core/bad.py" and f["line"] == 2
    assert "FAIL" in capsys.readouterr().out


def test_cli_disable_is_a_global_waiver(tmp_path, capsys):
    root = _fake_root(tmp_path, "import torch\no = torch.sort(k)\n")
    rc = cli_main(["--ast", "--root", root, "--disable", "SPK101"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "(1 waived)" in out and "[waived]" in out


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in F.RULES:
        assert rule in out


def test_shipped_tree_ast_scan_is_clean():
    fs = ast_rules.scan_tree(PORT_SRC)
    assert F.active(fs) == []
    assert len(fs) == SHIPPED_WAIVERS

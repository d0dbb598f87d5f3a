"""The port's distributed SpGEMM (``repro_torch.core.spgemm``) and its demo
(``repro_torch.launch.spgemm_demo``) against ``A @ B`` and the reference
(``repro.core.spgemm``), on the CPU.

The port runs once for this file: the demo's 2 × 2 gloo world
(``spgemm_demo.run``) computes C for every case. The reference's
``spgemm_summa`` runs in a subprocess with four fake CPU devices
(as ``tests/conftest.py`` runs them), jitted as
``examples/distributed_spgemm.py`` runs it, on the same numpy draws. A stage's dense product is
a matrix product in each package, summed in its library's order, so C is
held to the reference's tolerance; given the same partials, the SpKAdd
reduction is held bitwise.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bytes_equal
from repro.core import sparse as RS
from repro.core.engine import spkadd_run as ref_spkadd_run
from repro_torch.core import sparse as S
from repro_torch.core import spgemm as G
from repro_torch.core.engine import spkadd_run
from repro_torch.launch import spgemm_demo as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
CPU = "cpu"
SHAPE = (128, 128, 128)
#: Sparse enough that no stage's partial outgrows Fig. 6's cap (10 % of a
#: C block): the capped cases then equal A @ B too.
DENSITY = 0.03
SEED = 7
#: The algorithms the reference runs on this jax: its ``vec`` and
#: ``blocked_spa`` reach the sort fold, which needs ``pl.store``.
REF_ALGORITHMS = ("incremental", "tree", "sorted", "spa", "auto")
#: ``tests/test_distributed.py``'s tolerance against ``A @ B``: each
#: library sums a stage's products in its own order.
TOL = dict(rtol=1e-4, atol=1e-5)
WORLD_TIMEOUT_S = 150

CASES = D.cases_for(SHAPE[0], SHAPE[2], (2, 2),
                    algorithms=D.ALGORITHMS + ("blocked_spa", "hash"))
LABELS = [label for label, _, _ in CASES]

REF_SNIPPET = r"""
import functools, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.spgemm import spgemm_summa
from repro_torch.launch.spgemm_demo import sprand_pair
shape, density, seed, cases, out = json.loads(sys.argv[1])
a, b = sprand_pair(seed, *shape, density)
mesh = jax.make_mesh((2, 2), ('data', 'model'))
res = {}
for label, alg, cap in cases:
    fn = jax.jit(functools.partial(spgemm_summa, mesh=mesh, algorithm=alg,
                                   partial_cap_per_stage=cap))
    c = fn(jnp.asarray(a), jnp.asarray(b))
    res[label] = np.asarray(c)
np.savez(out, **{k.replace('/', '__'): v for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def world():
    grid, res = D.run(CPU, SHAPE, density=DENSITY, seed=SEED, cases=CASES,
                      reps=1, timeout=WORLD_TIMEOUT_S)
    assert grid == (2, 2)
    return res


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("spgemm") / "ref.npz"
    cases = [c for c in CASES if c[1] in REF_ALGORITHMS]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", REF_SNIPPET,
         json.dumps([SHAPE, DENSITY, SEED, cases, str(out)])],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k.replace("__", "/"): z[k] for k in z.files}


def matmul():
    a, b = D.sprand_pair(SEED, *SHAPE, DENSITY)
    return a @ b


@pytest.mark.parametrize("label", LABELS)
def test_c_equals_the_product(world, label):
    np.testing.assert_allclose(world[label]["c"], matmul(), err_msg=label,
                               **TOL)


@pytest.mark.parametrize("label", [c[0] for c in CASES
                                   if c[1] in REF_ALGORITHMS])
def test_c_equals_the_reference(world, reference, label):
    np.testing.assert_allclose(world[label]["c"], reference[label],
                               err_msg=label, **TOL)


@pytest.mark.parametrize("label", LABELS)
def test_every_algorithm_equals_sorted_bitwise(world, label):
    """Two stages a worker: every member, ``tree`` too, folds each key
    left to right, so every C equals ``sorted``'s bit for bit."""
    assert_bytes_equal(world["sorted"]["c"], world[label]["c"], label)


def stage_products(seed, stages, m, n, nnz):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(stages):
        d = np.zeros((m, n), np.float32)
        d.flat[rng.choice(m * n, nnz, replace=False)] = \
            rng.standard_normal(nnz)
        out.append(d)
    return out


@pytest.mark.parametrize("cap", [None, 40])
@pytest.mark.parametrize("alg", REF_ALGORITHMS)
def test_reduction_bitwise_given_the_same_partials(alg, cap):
    """The worker body after its products: ``from_dense`` at the cap,
    ``spkadd_run`` and ``to_dense``, on the same 6 stage products (a cap
    of 40 truncates each to its heaviest entries)."""
    m, n, nnz = 24, 16, 60
    prods = stage_products(11, 6, m, n, nnz)
    c = min(cap or m * n, m * n)

    @jax.jit
    def ref(ps):
        return ref_spkadd_run([RS.from_dense(p, cap=c) for p in ps],
                              algorithm=alg).to_dense()

    want = ref([jnp.asarray(p) for p in prods])
    got = spkadd_run([S.from_dense(torch.from_numpy(p), cap=c)
                      for p in prods], algorithm=alg).to_dense()
    assert_bytes_equal(np.asarray(want), got, f"{alg} cap {cap}")


def test_summa_block_stages_and_caps():
    """``summa_block`` on a worker's stripes: ``stages`` products, each
    partial at most its cap, C equal to the stripes' product."""
    a, b = D.sprand_pair(3, 32, 64, 16, 0.1)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    parts = G.summa_partials(at, bt, 4, cap=10_000)
    assert len(parts) == 4 and all(p.cap == 32 * 16 for p in parts)
    small = G.summa_partials(at, bt, 4, cap=5)
    assert all(p.cap == 5 and int(p.nnz) <= 5 for p in small)
    c = G.summa_block(at, bt, 4, algorithm="sorted")
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)
    np.testing.assert_allclose(G.spgemm_reference(at, bt).numpy(), a @ b,
                               **TOL)


def test_demo_prints_each_algorithm(world, monkeypatch, capsys):
    monkeypatch.setattr(D, "run", lambda *a, **k: ((2, 2), world))
    for name, value in (("SHAPE", SHAPE), ("DENSITY", DENSITY),
                        ("SEED", SEED)):
        monkeypatch.setattr(D, name, value)
    assert D.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on a 2x2 SUMMA grid (cpu)" in out
    for label in LABELS:
        if label.startswith("fig6/"):
            assert f"fig6/summa_reduction={label[5:]}," in out
        else:
            assert f"reduction={label:12s}" in out
    errs = [float(w.split("=")[1]) for w in out.split() if "max|err|" in w]
    assert len(errs) == len(LABELS) and max(errs) < 1e-4

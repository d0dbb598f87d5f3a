"""The port's delta-sync runtime against the reference, on the CPU.

- ``tree``: leaf order and names against ``jax.tree_util``;
- ``checkpoint``: a checkpoint written by either package restores bitwise
  in the other;
- ``runtime/delta_sync``: the frame codec and ``apply_delta_flat`` bitwise;
  the publisher's frames byte for byte over several epochs (selectors
  ``global`` and ``block``, k = 0.01 and 1.0, a leaf past one 4,096 block
  that is no block multiple); the subscriber's params after a window fold;
  frames crossing between the packages through a spool directory;
- chaos twins of ``benchmarks/delta_sync.py``'s cells (the benchmark itself
  is not imported): ``lossless_chaos`` and ``ef_sparse`` under its ``CHAOS``
  wire (seed 7) and ``degrade_reload``, run in both packages, with the same
  bytes per sync (793.75 at k = 0.01, the ledger's value), windows and
  fault counts;
- ``runtime/faults.backoff_delay`` and the ``Supervisor`` restart path;
- the SmolLM-135M parameter table ``chip_smoke.py`` drives, against
  ``jax.eval_shape`` of the reference's init.

Data is made with numpy from a seed on the benchmark's dyadic grid, so
every f32 sum is exact. Tolerance everywhere: bitwise.
"""
import collections
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as JR
from repro.checkpoint import (latest_step as j_latest_step,
                              restore_checkpoint as j_restore,
                              save_checkpoint as j_save)
from repro.train.step import init_ef_state as j_init_ef_state
import repro_torch.runtime as TR
from repro_torch import interop
from repro_torch import tree as T_tree
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.runtime.delta_sync import CorruptFrameError
from repro_torch.train.step import init_ef_state

from _torch_parity import assert_bytes_equal, np_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
GRID = 2.0 ** -10

#: A model-like tree: the block selector runs on ``embed`` (6,300 elements,
#: two 4,096 blocks, not a multiple) and the nested names are the model's.
SHAPES = {"embed": (70, 90), "final_ln": (24,),
          "layers": {"ln1": (2, 24), "w1": (2, 24, 40)}}


def grid_tree(rng, shapes=SHAPES, lo=-512, hi=512):
    """numpy tree of multiples of 2^-10 (every f32 sum below 2^13 exact)."""
    return {k: (grid_tree(rng, s, lo, hi) if isinstance(s, dict) else
                rng.integers(lo, hi, s).astype(np.float32) * np.float32(GRID))
            for k, s in shapes.items()}


def np_add(a, b):
    return jax.tree.map(np.add, a, b)


def to_ref(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def to_port(np_tree):
    return interop.params_from_numpy(np_tree, device=CPU)


def assert_same_tree(ref_tree, port_tree, msg=""):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    port_leaves = T_tree.leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves), msg
    for r, p in zip(ref_leaves, port_leaves):
        assert_bytes_equal(r, p, msg)


# ---------------------------------------------------------------------------
# the tree helper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", [
    {"b": np.zeros(2), "a": {"z": np.ones(1), "c": [np.zeros(3), 1.5]}},
    [np.zeros(1), (np.ones(2), {"k": np.zeros(1)}), None, 3],
    {1: np.zeros(1), 0: np.ones(1)},
    {"layers": {"w2": np.zeros(1), "w10": np.zeros(2), "W1": np.zeros(3)}},
])
def test_tree_order_and_names_match_jax(tree):
    paths_leaves, jdef = jax.tree_util.tree_flatten_with_path(tree)
    leaves, names, treedef = T_tree.flatten_with_names(tree)
    assert names == [jax.tree_util.keystr(p) for p, _ in paths_leaves]
    assert [id(x) for x in leaves] == [id(x) for _, x in paths_leaves]
    rebuilt = T_tree.unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(rebuilt) == jdef
    assert T_tree.flatten(rebuilt)[1] == treedef


def test_tree_refuses_unknown_nodes():
    Pair = collections.namedtuple("Pair", "a b")
    for bad in (Pair(np.zeros(1), np.zeros(1)), {1, 2}, object(),
                {"x": "text"}):
        with pytest.raises(TypeError, match="not a dict, list, tuple"):
            T_tree.flatten(bad)


def test_params_interop_round_trip():
    tree = grid_tree(np.random.default_rng(0))
    back = interop.params_to_numpy(to_port(tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert_bytes_equal(a, b)


def test_init_ef_state_matches_reference():
    tree = grid_tree(np.random.default_rng(1))
    for workers, shards in ((1, 1), (2, 1), (2, 3)):
        ref = j_init_ef_state(to_ref(tree), workers, shards)
        port = init_ef_state(to_port(tree), workers, shards)
        assert_same_tree(ref, port, f"{workers}x{shards}")


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    tree = grid_tree(rng)
    tree["extra"] = [rng.integers(0, 9, 5).astype(np.int32),
                     np.float32(-0.0) * np.ones(3, np.float32)]
    return tree


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    tree = ckpt_tree(2)
    save_checkpoint(str(tmp_path), 3, to_port(tree))
    assert j_latest_step(str(tmp_path)) == 3
    got = j_restore(str(tmp_path), 3, to_ref(jax.tree.map(np.zeros_like,
                                                          tree)))
    assert_same_tree(got, to_port(tree))


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    tree = ckpt_tree(3)
    j_save(str(tmp_path), 5, to_ref(tree))
    assert latest_step(str(tmp_path)) == 5
    like = to_port(jax.tree.map(np.zeros_like, tree))
    got = restore_checkpoint(str(tmp_path), 5, like)
    assert_same_tree(to_ref(tree), got)
    assert T_tree.flatten(got)[1] == T_tree.flatten(like)[1]


def test_checkpoint_layout_is_the_references(tmp_path):
    tree = ckpt_tree(4)
    save_checkpoint(str(tmp_path / "port"), 7, to_port(tree))
    j_save(str(tmp_path / "ref"), 7, to_ref(tree))
    port_dir, ref_dir = (tmp_path / d / "step_00000007" for d in
                         ("port", "ref"))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    for name in os.listdir(ref_dir):
        if name.endswith(".npy"):
            assert (port_dir / name).read_bytes() == \
                (ref_dir / name).read_bytes(), name
    # a crashed attempt's .tmp dir and foreign entries stay invisible
    os.makedirs(tmp_path / "port" / "step_00000009.tmp")
    os.makedirs(tmp_path / "port" / "step_junk")
    assert latest_step(str(tmp_path / "port")) == 7


def test_async_checkpointer_latest_wins(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    tree = to_port(ckpt_tree(5))
    ck.save(1, tree)
    ck.save(2, tree)
    ck.close()
    assert latest_step(str(tmp_path)) == 2
    assert_same_tree(to_ref(ckpt_tree(5)),
                     restore_checkpoint(str(tmp_path), 2, tree))


# ---------------------------------------------------------------------------
# frames and the shared scatter-add
# ---------------------------------------------------------------------------

def make_frame(pkg, epoch=3, n=5, size=64, shard="['wq']"):
    rng = np.random.default_rng(epoch)
    idx = np.sort(rng.choice(size, n, replace=False)).astype(np.int32)
    val = rng.standard_normal(n).astype(np.float32)
    return pkg.DeltaFrame(epoch, epoch - 1, shard, size, idx, val)


@pytest.mark.parametrize("n", [0, 1, 5])
def test_frame_bytes_match_reference(n):
    buf = TR.encode_frame(make_frame(TR, n=n))
    assert buf == JR.encode_frame(make_frame(JR, n=n))
    g = TR.decode_frame(JR.encode_frame(make_frame(JR, n=n)))
    assert (g.epoch, g.base_epoch, g.shard, g.size) == (3, 2, "['wq']", 64)
    assert TR.frame_epoch(buf) == JR.frame_epoch(buf) == 3


def test_frame_damage_is_refused():
    buf = TR.encode_frame(make_frame(TR))
    damaged = [buf[:6], b"XXXX" + buf[4:], buf[:4] + b"\x02" + buf[5:],
               buf[:-3], buf[:-1] + bytes([buf[-1] ^ 0xFF])]
    for bad in damaged:
        with pytest.raises(CorruptFrameError):
            TR.decode_frame(bad)
        with pytest.raises(JR.CorruptFrameError):
            JR.decode_frame(bad)
    out_of_range = make_frame(TR)._replace(size=3)
    with pytest.raises(CorruptFrameError, match="out of range"):
        TR.decode_frame(TR.encode_frame(out_of_range))


def test_apply_delta_flat_matches_reference():
    rng = np.random.default_rng(11)
    flat = np.where(rng.random(40) < 0.3, -0.0,
                    rng.standard_normal(40)).astype(np.float32)
    # unique once negatives count from the end (the precondition)
    idx = np.array([0, 3, 39, 40, 45, -2, -38, -41, 7], np.int32)
    val = np.array([0.0, 1.5, -0.0, 9.0, 9.0, 2.0, -0.0, 9.0, -3.0],
                   np.float32)
    ref = JR.apply_delta_flat(jnp.asarray(flat), idx, val)
    given = torch.as_tensor(flat.copy())
    port = TR.apply_delta_flat(given, idx, val)
    assert_bytes_equal(ref, port)
    assert_bytes_equal(flat, given)  # a new tensor; the input is untouched


@pytest.mark.parametrize("n", [0, 4])
def test_frame_to_coo_matches_reference(n):
    from repro.runtime.delta_sync import frame_to_coo as j_frame_to_coo

    ref = j_frame_to_coo(make_frame(JR, n=n))
    port = TR.frame_to_coo(make_frame(TR, n=n), device=CPU)
    np.testing.assert_array_equal(np.asarray(ref.keys), np_of(port.keys))
    assert_bytes_equal(ref.vals, port.vals)
    assert int(ref.nnz) == int(port.nnz) and ref.shape == port.shape


# ---------------------------------------------------------------------------
# publisher and subscriber, both packages on the same data
# ---------------------------------------------------------------------------

def pub_sub(pkg, params_np, transport, *, port, sub=True, **kw):
    params = to_port(params_np) if port else to_ref(params_np)
    dev = {"device": CPU} if port else {}
    pub = pkg.DeltaPublisher(params, transport, **kw, **dev)
    if not sub:
        return pub
    return pub, pkg.DeltaSubscriber(params, transport,
                                    sleep_fn=lambda _s: None, **dev)


@pytest.mark.parametrize("selector", ["global", "block"])
@pytest.mark.parametrize("k_fraction", [0.01, 1.0])
def test_publisher_frames_are_byte_identical(selector, k_fraction):
    rng = np.random.default_rng(12)
    params = grid_tree(rng)
    ref_wire, port_wire = JR.InProcTransport(), TR.InProcTransport()
    jpub = pub_sub(JR, params, ref_wire, port=False, sub=False,
                   k_fraction=k_fraction, selector=selector)
    tpub = pub_sub(TR, params, port_wire, port=True, sub=False,
                   k_fraction=k_fraction, selector=selector)
    for epoch in range(1, 5):
        params = np_add(params, grid_tree(rng, lo=-256, hi=256))
        js = jpub.publish(to_ref(params))
        ts = tpub.publish(to_port(params))
        assert tuple(js) == tuple(ts), epoch
        assert jpub.frames_for(epoch) == tpub.frames_for(epoch), epoch
        assert ref_wire.poll() == port_wire.poll()
        assert_same_tree(jpub.shadow_params(), tpub.shadow_params())
        for r, p in zip(jpub._residual, tpub._residual):
            assert_bytes_equal(r, p, f"residual, epoch {epoch}")
    if k_fraction < 1.0:
        assert ts.selected < sum(jpub._sizes)


def test_publisher_rejects_a_changed_tree():
    params = grid_tree(np.random.default_rng(13))
    pub = pub_sub(TR, params, TR.InProcTransport(), port=True, sub=False)
    changed = dict(to_port(params))
    changed["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="tree structure changed"):
        pub.publish(changed)
    with pytest.raises(ValueError, match="monotone"):
        pub.publish(to_port(params), epoch=0)


def test_subscriber_window_fold_matches_reference():
    """Four epochs folded in one ragged SpKAdd, both packages dispatching
    with ``algorithm="auto"``."""
    rng = np.random.default_rng(14)
    params = grid_tree(rng)
    ref_wire, port_wire = JR.InProcTransport(), TR.InProcTransport()
    jpub = JR.DeltaPublisher(to_ref(params), ref_wire, k_fraction=0.05,
                             selector="block")
    jsub = JR.DeltaSubscriber(to_ref(params), ref_wire,
                              sleep_fn=lambda _s: None)
    tpub, tsub = pub_sub(TR, params, port_wire, port=True, k_fraction=0.05,
                         selector="block")
    for _ in range(4):
        params = np_add(params, grid_tree(rng, lo=-256, hi=256))
        jpub.publish(to_ref(params))
        tpub.publish(to_port(params))
    jr, tr = jsub.sync(), tsub.sync()
    assert tuple(jr) == tuple(tr) and tr.window == 4
    assert_same_tree(jsub.params, tsub.params)
    assert_same_tree(jpub.shadow_params(), tsub.params)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_frames_cross_packages_through_a_spool(tmp_path, writer):
    rng = np.random.default_rng(15)
    params = grid_tree(rng)
    root = str(tmp_path)
    if writer == "reference":
        pub = JR.DeltaPublisher(to_ref(params), JR.DirTransport(root),
                                k_fraction=0.05, selector="block")
        sub = TR.DeltaSubscriber(to_port(params), TR.DirTransport(root),
                                 sleep_fn=lambda _s: None, device=CPU)
        push = to_ref
    else:
        pub = TR.DeltaPublisher(to_port(params), TR.DirTransport(root),
                                k_fraction=0.05, selector="block", device=CPU)
        sub = JR.DeltaSubscriber(to_ref(params), JR.DirTransport(root),
                                 sleep_fn=lambda _s: None)
        push = to_port
    for _ in range(3):
        params = np_add(params, grid_tree(rng, lo=-256, hi=256))
        pub.publish(push(params))
    names = sorted(os.listdir(os.path.join(root, "frames")))
    assert names[0] == "frame_00000001_00000000.bin" and len(names) == 12
    report = sub.sync()
    assert report.window == 3 and sub.applied_epoch == 3
    if writer == "reference":
        assert_same_tree(pub.shadow_params(), sub.params)
    else:
        assert_same_tree(sub.params, pub.shadow_params())


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    params = to_port(grid_tree(np.random.default_rng(16)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.DeltaPublisher(params, TR.InProcTransport())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.DeltaSubscriber(params, TR.InProcTransport())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.frame_to_coo(make_frame(TR))


# ---------------------------------------------------------------------------
# chaos twins of benchmarks/delta_sync.py's cells, in both packages
# ---------------------------------------------------------------------------

#: the benchmark's tree and chaos wire (benchmarks/delta_sync.py)
BENCH_SHAPES = {"wq": (64, 48), "w1": (96, 32), "bias": (257,)}
CHAOS = dict(drop_p=0.15, dup_p=0.05, corrupt_p=0.06, stall_epochs=(5,),
             stall_release_after=2)


def bench_grid(rng, lo=-512, hi=512):
    return {k: rng.integers(lo, hi, s).astype(np.float32) * GRID
            for k, s in BENCH_SHAPES.items()}


def run_chaos(pkg, *, port, k_fraction, epochs=12, sync_every=2,
              max_staleness=6, seed=7, drain_rounds=4):
    """The benchmark's ``run_chaos``, written against either package."""
    rng = np.random.default_rng(seed)
    conv = to_port if port else to_ref
    dev = {"device": CPU} if port else {}
    params = bench_grid(rng)
    wire = pkg.FaultyTransport(pkg.InProcTransport(),
                               pkg.FaultSpec(seed=seed, **CHAOS))
    pub = pkg.DeltaPublisher(conv(params), wire, k_fraction=k_fraction,
                             window_epochs=epochs + 1, **dev)
    sub = pkg.DeltaSubscriber(conv(params), wire,
                              max_staleness=max_staleness, seed=seed,
                              sleep_fn=lambda _s: None, **dev)
    reports, bytes_per_sync = [], []
    for e in range(1, epochs + 1):
        params = {k: params[k] + v for k, v in
                  bench_grid(rng, -256, 256).items()}
        bytes_per_sync.append(pub.publish(conv(params)).bytes)
        if e % sync_every == 0:
            reports.append(sub.sync())
    wire.flush()
    rounds = 0
    while sub.applied_epoch < pub.epoch and rounds < drain_rounds:
        reports.append(sub.sync(hint_epoch=pub.epoch))
        rounds += 1
    windows = [r.window for r in reports if r.window]
    as_np = (lambda t: {k: np_of(v) for k, v in t.items()}) if port else \
        (lambda t: {k: np.asarray(v) for k, v in t.items()})
    sub_np, shadow_np = as_np(sub.params), as_np(pub.shadow_params())
    return {
        "converged": sub.applied_epoch == pub.epoch,
        "shadow_bitwise": all(sub_np[k].tobytes() == shadow_np[k].tobytes()
                              for k in sub_np),
        "params_bitwise": all(sub_np[k].tobytes() == params[k].tobytes()
                              for k in sub_np),
        "degradations": sub.degradations,
        "retries": sub.total_retries,
        "corrupt": sum(r.frames_corrupt for r in reports),
        "dup": sum(r.frames_duplicate for r in reports),
        "injected": dict(wire.injected),
        "bytes_per_sync": float(np.mean(bytes_per_sync)),
        "catchup_window_max": max(windows) if windows else 0,
        "drain_rounds": rounds,
        "reports": [tuple(r) for r in reports],
        "subscriber": sub_np,
    }


@pytest.mark.parametrize("cell,k_fraction", [("lossless_chaos", 1.0),
                                             ("ef_sparse", 0.01)])
def test_chaos_twin_matches_reference(cell, k_fraction):
    ref = run_chaos(JR, port=False, k_fraction=k_fraction)
    port = run_chaos(TR, port=True, k_fraction=k_fraction)
    for key in ref:
        if key == "subscriber":
            for name in ref[key]:
                assert_bytes_equal(ref[key][name], port[key][name], name)
        else:
            assert ref[key] == port[key], key
    assert port["converged"] and port["shadow_bitwise"]
    assert port["catchup_window_max"] <= 4
    assert port["injected"].get("drop") and port["injected"].get("corrupt") \
        and port["injected"].get("stall")
    if cell == "ef_sparse":
        assert port["bytes_per_sync"] == 793.75  # the ledger's b3152bed line
    else:
        assert port["params_bitwise"] and port["degradations"] == 0


def run_degrade(pkg, ckpt_dir, *, port, epochs_asleep=9, epochs_after=3,
                max_staleness=4, ckpt_every=4, seed=11):
    """The benchmark's ``run_degrade``, written against either package."""
    rng = np.random.default_rng(seed)
    conv = to_port if port else to_ref
    dev = {"device": CPU} if port else {}
    params = bench_grid(rng)
    wire = pkg.InProcTransport()
    pub = pkg.DeltaPublisher(conv(params), wire, k_fraction=1.0,
                             window_epochs=epochs_asleep + epochs_after + 1,
                             ckpt_dir=ckpt_dir, checkpoint_every=ckpt_every,
                             **dev)
    sub = pkg.DeltaSubscriber(conv(params), wire,
                              max_staleness=max_staleness, ckpt_dir=ckpt_dir,
                              seed=seed, sleep_fn=lambda _s: None, **dev)
    for _ in range(epochs_asleep):
        params = {k: params[k] + v for k, v in
                  bench_grid(rng, -256, 256).items()}
        pub.publish(conv(params))
    wake = sub.sync()
    for _ in range(epochs_after):
        params = {k: params[k] + v for k, v in
                  bench_grid(rng, -256, 256).items()}
        pub.publish(conv(params))
        sub.sync()
    return wake, sub, pub


def test_degrade_reload_twin_degrades_exactly_once(tmp_path):
    jwake, jsub, jpub = run_degrade(JR, str(tmp_path / "ref"), port=False)
    twake, tsub, tpub = run_degrade(TR, str(tmp_path / "port"), port=True)
    assert tuple(jwake) == tuple(twake)
    assert twake.degraded and tsub.degradations == 1 == jsub.degradations
    assert tsub.applied_epoch == tpub.epoch == 12
    assert_same_tree(jsub.params, tsub.params)
    assert_same_tree(jpub.shadow_params(), tsub.params)
    assert sorted(os.listdir(tmp_path / "ref")) == \
        sorted(os.listdir(tmp_path / "port"))


# ---------------------------------------------------------------------------
# the shared backoff policy and the supervisor
# ---------------------------------------------------------------------------

def test_backoff_delay_matches_reference():
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    for attempt in range(8):
        for jitter in (0.0, 0.5, 1.0):
            kw = dict(base=0.1, cap=0.4, jitter=jitter)
            assert TR.backoff_delay(attempt, rng=rt, **kw) == \
                JR.backoff_delay(attempt, rng=rj, **kw)
    flat = [TR.backoff_delay(a, base=0.1, cap=0.4, jitter=0.0, rng=rt)
            for a in range(5)]
    assert flat == [0.1, 0.2, 0.4, 0.4, 0.4]
    for bad in (dict(base=-1.0, cap=1.0, jitter=0.0),
                dict(base=0.1, cap=1.0, jitter=1.5)):
        with pytest.raises(ValueError):
            TR.backoff_delay(0, rng=rt, **bad)
    with pytest.raises(ValueError):
        TR.FaultyTransport(TR.InProcTransport(), TR.FaultSpec(drop_p=1.5))


def test_supervisor_restart_backoff(tmp_path):
    slept = []
    sup = TR.Supervisor(str(tmp_path), ckpt_every=2, max_restarts=5,
                        injector=TR.FailureInjector(fail_at_steps=(1, 3)),
                        restart_backoff_base=0.1, restart_backoff_cap=0.4,
                        restart_backoff_jitter=0.5, seed=0,
                        sleep_fn=slept.append)
    state, steps = sup.run([torch.zeros(())],
                           lambda s, i: [s[0] + 1.0], n_steps=6)
    assert steps == 6 and float(state[0]) == 6.0 and sup.restarts == 2
    assert len(slept) == 2
    for i, d in enumerate(slept):
        nominal = min(0.4, 0.1 * 2.0 ** i)
        assert 0.5 * nominal <= d <= 1.5 * nominal
    assert sup.backoff_slept == pytest.approx(sum(slept))
    # the same seed gives the reference's delays
    jslept = []
    JR.Supervisor(str(tmp_path / "ref"), ckpt_every=2, max_restarts=5,
                  injector=JR.FailureInjector(fail_at_steps=(1, 3)),
                  restart_backoff_base=0.1, restart_backoff_cap=0.4,
                  restart_backoff_jitter=0.5, seed=0,
                  sleep_fn=jslept.append).run([0.0], lambda s, i: [s[0] + 1.0],
                                              n_steps=6)
    assert slept == jslept


def test_straggler_monitor_flags_slow_steps():
    mon = TR.StragglerMonitor(window=16, threshold=2.0)
    assert not any(mon.record(i, 1.0) for i in range(8))
    assert not mon.record(8, 2.0)  # at the threshold, not past it
    assert mon.record(9, 2.5)
    assert mon.flagged == [(9, 2.5, 1.0)]


# ---------------------------------------------------------------------------
# the parameter table chip_smoke.py drives
# ---------------------------------------------------------------------------

def test_chip_smoke_smollm_table_matches_reference_init():
    from repro.configs import get_config
    from repro.models import build_model

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    model = build_model(get_config("smollm-135m"))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda leaf: tuple(leaf.shape), shapes)
    assert chip_smoke.SMOLLM_135M_SHAPES == want
    assert all(leaf.dtype == jnp.float32 for leaf in jax.tree.leaves(shapes))
    assert sum(int(np.prod(s)) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, tuple))) == 162_826_560

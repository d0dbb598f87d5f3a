"""Faithful hash-table accumulation and symbolic count: ``csrc/hash_accum.cu``
and their plain versions, with the sizing rule every hash kernel shares.

The port of ``src/repro/kernels/hash_accum.py`` (paper Alg. 5 and 6). One
linear-probing table of ``table_size`` slots (a power of two, by default
``hash_table_size(cap + 1)``) takes the whole stream in order: each key
other than ``sent`` hashes to ``(uint32(key) * HASH_PRIME) &
(table_size - 1)`` and probes at most ``table_size`` slots for an empty
slot or its own. The accumulate form stores the key there and adds the
value (raw tables: keys ``-1`` = empty, values folded left to right in
stream order from ``+0.0``, with XLA's float rules, :mod:`xla_float`); the
symbolic form counts the keys that found an empty slot. In an undersized
table a probe that misses every slot ends where it began, and the
reference then overwrites that slot (accumulate) or counts nothing
(symbolic); the port does the same.

Slot placement depends on insertion order, so the raw tables are compared
bitwise, not only after compaction. Where the table cannot fill
(``table_size > cap``, as the default sizing guarantees) the layout
depends only on the order of the keys' first occurrences: it is the unique
layout of ordered linear probing with priority = first position
(:func:`ordered_placement`), which a grid reaches with ``atomicCAS`` in any
interleaving, and the values then fold per slot in stream order; a table
that can fill keeps the one-thread loop (:func:`accumulate_route`). The
symbolic count returns no table: where the table cannot fill it is the
number of distinct keys other than ``sent`` and ``-1`` plus one for each
``-1`` (a ``-1`` key stops on an empty slot and leaves it empty), in any
insertion order, so there every thread of a grid inserts with
``atomicCAS``; a table that can fill keeps the one-thread loop
(:func:`symbolic_route`; the kernels' source note says why each is exact).
On the CPU the wrappers take :func:`hash_accumulate_plain` and
:func:`hash_symbolic_plain`, sequential loops meant for small streams.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, xla_float

HASH_PRIME = 2654435761  # Knuth multiplicative constant

#: Stream elements per tile of the hash kernels' bucketing
#: (``csrc/radix_bucket.cuh``: ``RB_TILE``) and its digits per pass.
RB_TILE = 4096
RB_RADIX = 256

#: Empty word of an ordered table: larger than every (position, key) word.
EMPTY_WORD = (1 << 64) - 1

_P = ctypes.c_void_p
_ACC_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, _P]
_ACC_PAR_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                     ctypes.c_int, _P, ctypes.c_int, _P]
_SYM_ARGTYPES = [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, _P]


def hash_table_size(distinct_bound: int) -> int:
    """The table-sizing rule every hash kernel shares: the smallest power of
    two ``>= 2 * distinct_bound``, so the load factor can never exceed 0.5
    and expected probes stay O(1)."""
    size = 1
    while size < 2 * max(int(distinct_bound), 1):
        size *= 2
    return size


def rb_scratch_ints(rows: int, cap: int) -> int:
    """int32 scratch of one bucketing of ``rows`` streams of ``cap``: the
    ``(rows, RB_RADIX, tiles)`` count matrix and the scan's partial sums."""
    matrix = rows * RB_RADIX * -(-cap // RB_TILE)
    return matrix + -(-matrix // RB_TILE) + 1


def first_positions(keys) -> list:
    """The ordered words ``(first_pos << 32) | key`` of a stream's distinct
    keys, in first-occurrence order (numpy or a sequence of ints)."""
    seen = {}
    for i, k in enumerate(np.asarray(keys, dtype=np.int64).tolist()):
        seen.setdefault(k, i)
    return [(i << 32) | (k & 0xFFFFFFFF) for k, i in seen.items()]


def ordered_placement(words, table_size: int, rng=None) -> np.ndarray:
    """Host model of the kernels' ordered linear probing: insert distinct
    ``(first_pos << 32) | key`` words into a table of ``table_size`` slots
    (empty = :data:`EMPTY_WORD`). A slot holding a smaller word is passed;
    a larger one (or empty) is swapped for the word in hand, which carries
    the displaced word on from the next slot. With ``rng`` (numpy) the
    words start in a random order and every step (one read-and-swap,
    atomic as the kernels' ``atomicCAS``) is taken by a random one of the
    inserters in flight, as threads interleave; without it, in list
    order. Returns the int64 key table (``-1`` = empty): for a table that
    cannot fill, the layout of inserting the keys one at a time in
    first-position order, in every interleaving."""
    mask = table_size - 1
    tab = [EMPTY_WORD] * table_size
    words = list(words)
    if rng is not None:
        words = [words[i] for i in rng.permutation(len(words))]
    live = [[w, (((w & 0xFFFFFFFF) * HASH_PRIME) & mask)] for w in words]
    while live:
        j = int(rng.integers(len(live))) if rng is not None else 0
        ins = live[j]
        w, h = ins
        cur = tab[h]
        if cur < w:
            ins[1] = (h + 1) & mask
            continue
        tab[h] = w
        if cur == EMPTY_WORD:
            live.pop(j)
        else:
            ins[0], ins[1] = cur, (h + 1) & mask
    keys = np.array([-1 if w == EMPTY_WORD else w & 0xFFFFFFFF for w in tab],
                    dtype=np.int64)
    return np.where(keys >= 2 ** 31, keys - 2 ** 32, keys)


def accumulate_model(keys, vals, *, sent: int, table_size: int,
                     rng=None):
    """Host model of the parallel accumulate route (``table_size > cap``):
    the layout from :func:`ordered_placement` of the keys' first positions;
    each element's slot (a ``-1`` at position ``t`` takes the first slot on
    its probe path that is empty or whose word's first position is
    ``> t``); each slot's values folded in stream order from ``+0.0`` with
    XLA's adds. Returns numpy ``(tkeys int32, tvals f32)``, equal to
    :func:`hash_accumulate_plain`'s. Used by the tests only."""
    ks = np.asarray(keys, dtype=np.int64)
    vs = torch.as_tensor(np.asarray(vals, dtype=np.float32))
    mask = table_size - 1
    real = ks[(ks != sent) & (ks != -1)]
    tk = ordered_placement(first_positions(real), table_size, rng)
    first = {}
    for i, k in enumerate(ks.tolist()):
        if k != sent and k != -1:
            first.setdefault(k, i)
    tv = torch.zeros(table_size, dtype=torch.float32)
    for t, k in enumerate(ks.tolist()):
        if k == sent:
            continue
        h = ((k & 0xFFFFFFFF) * HASH_PRIME) & mask
        if k == -1:
            while tk[h] != -1 and first[int(tk[h])] < t:
                h = (h + 1) & mask
        else:
            while tk[h] != k:
                h = (h + 1) & mask
        tv[h] = xla_float.add(tv[h], vs[t])
    return tk.astype(np.int32), tv.numpy()


def accumulate_route(cap: int, table_size: int) -> str:
    """The kernel route of :func:`hash_accumulate_raw` for a ``cap``-long
    stream: ``"serial"`` (the one-thread loop) when the table can fill
    (``table_size <= cap``), else ``"parallel"`` (first positions, ordered
    placement and the stream-order fold over grids)."""
    return "serial" if table_size <= cap else "parallel"


@functools.lru_cache(maxsize=None)
def stage_bytes(symbolic: bool) -> int:
    """Shared memory the kernel stages the stream in, beside a table that
    lives in shared memory, from the built library."""
    fn = _build.entry("hash_accum", "spk_hash_stage_bytes", [ctypes.c_int])
    return int(fn(int(symbolic)))


def table_in_smem(table_size: int, *, symbolic: bool, device) -> bool:
    """Whether the kernel keeps a ``table_size``-slot table in one block's
    shared memory (8 B a slot, 4 B for the keys-only symbolic table) or in
    device memory."""
    slot_bytes = 4 if symbolic else 8
    limit = _build.max_dynamic_smem("hash_accum", device.index or 0)
    return table_size * slot_bytes + stage_bytes(symbolic) <= limit


def symbolic_route(cap: int, table_size: int, *, device) -> str:
    """The kernel route of :func:`hash_symbolic_raw` for a ``cap``-long
    stream on a CUDA ``device``: ``"serial"`` (the one-thread loop) when the
    table can fill (``table_size <= cap``), else the parallel count with the
    table in one block's shared memory (``"smem"``) or in device memory
    (``"device"``), as :func:`table_in_smem` decides."""
    if table_size <= cap:
        return "serial"
    return ("smem" if table_in_smem(table_size, symbolic=True, device=device)
            else "device")


def _probe(tk, key: int, mask: int, table_size: int) -> int:
    """The reference's ``_probe``: the slot ``key`` ends on (empty, its own,
    or its first slot again after ``table_size`` misses)."""
    h = ((key & 0xFFFFFFFF) * HASH_PRIME) & mask
    for _ in range(table_size):
        cur = tk[h]
        if cur == -1 or cur == key:
            return h
        h = (h + 1) & mask
    return h


def _check_stream(keys, vals=None):
    if keys.dim() != 1 or (vals is not None and keys.shape != vals.shape):
        raise ValueError(f"keys/vals must be matching 1-D streams, got "
                         f"{tuple(keys.shape)} vs "
                         f"{None if vals is None else tuple(vals.shape)}")


def _resolve_table(cap: int, table_size) -> int:
    return hash_table_size(cap + 1) if table_size is None else int(table_size)


def hash_accumulate_plain(keys: torch.Tensor, vals: torch.Tensor, *,
                          sent: int, table_size: int | None = None):
    """Plain version: the reference's insert loop, one element at a time,
    on a CPU copy (values added as f32). Same contract and same raw tables
    as :func:`hash_accumulate_raw`, on the input's device."""
    _check_stream(keys, vals)
    table_size = _resolve_table(keys.shape[0], table_size)
    if table_size & (table_size - 1) != 0:
        raise ValueError("table size must be 2^q")
    mask = table_size - 1
    tk = [-1] * table_size
    tv = np.zeros(table_size, np.float32)
    vs = vals.detach().to("cpu", torch.float32).numpy()
    for e, key in enumerate(keys.tolist()):
        if key == sent:
            continue
        h = _probe(tk, key, mask, table_size)
        tk[h] = key
        tv[h] = xla_float.add_scalar(tv[h], vs[e])
    return (torch.tensor(tk, dtype=torch.int32, device=keys.device),
            torch.from_numpy(tv).to(keys.device))


def hash_accumulate_raw(keys: torch.Tensor, vals: torch.Tensor, *,
                        sent: int, table_size: int | None = None):
    """Insert every (key, val) but ``sent`` into one hash table. Returns the
    raw table ``(tkeys, tvals)``, each ``(table_size,)``, ``tkeys == -1``
    marking empty slots. CPU tensors take the plain version; CUDA tensors
    launch the route :func:`accumulate_route` names."""
    if keys.device.type == "cpu":
        return hash_accumulate_plain(keys, vals, sent=sent,
                                     table_size=table_size)
    _check_stream(keys, vals)
    table_size = _resolve_table(keys.shape[0], table_size)
    if table_size & (table_size - 1) != 0:
        raise ValueError("table size must be 2^q")
    if keys.device.type != "cuda" or vals.device != keys.device:
        raise ValueError(f"hash_accumulate_raw: unsupported devices "
                         f"{keys.device} / {vals.device}")
    if keys.dtype != torch.int32:
        raise TypeError(f"hash_accum kernel takes int32 keys, got "
                        f"{keys.dtype}")
    keys = keys.contiguous()
    vals = vals.to(torch.float32).contiguous()
    cap = keys.shape[0]
    if cap >= 2 ** 31 - 1:
        raise ValueError(f"hash_accum: a stream of {cap} elements does not "
                         f"fit int32 positions")
    dev = keys.device
    tkeys = torch.empty(table_size, dtype=torch.int32, device=dev)
    tvals = torch.empty(table_size, dtype=torch.float32, device=dev)
    route = accumulate_route(cap, table_size)
    if route == "serial":
        in_smem = table_in_smem(table_size, symbolic=False, device=dev)
        fn = _build.entry("hash_accum", "spk_hash_accumulate", _ACC_ARGTYPES)
        _build.check(fn(keys.data_ptr(), vals.data_ptr(), tkeys.data_ptr(),
                        tvals.data_ptr(), cap, sent, table_size,
                        int(in_smem), dev.index or 0,
                        _build.stream_ptr(keys)), "hash_accum launch (serial)")
        hash_accumulate_raw.serial_launches += 1
    else:
        scratch = torch.empty(parallel_scratch_bytes(cap, table_size),
                              dtype=torch.uint8, device=dev)
        fn = _build.entry("hash_accum", "spk_hash_accumulate_par",
                          _ACC_PAR_ARGTYPES)
        _build.check(fn(keys.data_ptr(), vals.data_ptr(), tkeys.data_ptr(),
                        tvals.data_ptr(), cap, sent, table_size,
                        scratch.data_ptr(), dev.index or 0,
                        _build.stream_ptr(keys)),
                     "hash_accum launch (parallel)")
    hash_accumulate_raw.launches += 1
    return tkeys, tvals


@functools.lru_cache(maxsize=None)
def fold_range(table_size: int) -> int:
    """Slots one fold warp of the parallel route owns, from the built
    library."""
    fn = _build.entry("hash_accum", "spk_hash_acc_range", [ctypes.c_int])
    return int(fn(table_size))


@functools.lru_cache(maxsize=None)
def check_rb_tile(library: str) -> None:
    """Raise unless ``library``'s bucketing tile is :data:`RB_TILE`, which
    sizes its scratch here."""
    got = int(_build.entry(library, f"spk_{library}_rb_tile", [])())
    if got != RB_TILE:
        raise RuntimeError(f"{library}: the library's bucketing tile is "
                           f"{got} elements, this module's {RB_TILE}")


def parallel_scratch_bytes(cap: int, table_size: int) -> int:
    """Device scratch of the parallel route: the table's 64-bit words, the
    bucketing's count matrix, the slots, the bucketed slots and values and
    the pass between (``cap`` each) and the ranges' first positions."""
    check_rb_tile("hash_accum")
    ranges = table_size // fold_range(table_size)
    return (8 * table_size + 4 * rb_scratch_ints(1, cap) + 20 * cap
            + 4 * (ranges + 2))


#: Calls that launched an accumulate kernel, whichever route (the plain
#: version does not count), and those of them that took the one-thread
#: route.
hash_accumulate_raw.launches = 0
hash_accumulate_raw.serial_launches = 0


def hash_symbolic_plain(keys: torch.Tensor, *, sent: int,
                        table_size: int | None = None) -> torch.Tensor:
    """Plain version of the symbolic count: the reference's loop on a CPU
    copy. Returns an int32 scalar on the input's device."""
    _check_stream(keys)
    table_size = _resolve_table(keys.shape[0], table_size)
    mask = table_size - 1
    tk = [-1] * table_size
    count = 0
    for key in keys.tolist():
        if key == sent:
            continue
        h = _probe(tk, key, mask, table_size)
        if tk[h] == -1:
            tk[h] = key
            count += 1
    return torch.tensor(count, dtype=torch.int32, device=keys.device)


def hash_symbolic_raw(keys: torch.Tensor, *, sent: int,
                      table_size: int | None = None) -> torch.Tensor:
    """The faithful hash symbolic count (a keys-only table), as an int32
    scalar. CPU tensors take the plain version; CUDA tensors launch the
    route :func:`symbolic_route` names."""
    if keys.device.type == "cpu":
        return hash_symbolic_plain(keys, sent=sent, table_size=table_size)
    _check_stream(keys)
    table_size = _resolve_table(keys.shape[0], table_size)
    if keys.device.type != "cuda":
        raise ValueError(f"hash_symbolic_raw: unsupported device "
                         f"{keys.device}")
    if keys.dtype != torch.int32:
        raise TypeError(f"hash_symbolic kernel takes int32 keys, got "
                        f"{keys.dtype}")
    keys = keys.contiguous()
    route = symbolic_route(keys.shape[0], table_size, device=keys.device)
    nz = torch.empty(1, dtype=torch.int32, device=keys.device)
    in_smem = table_in_smem(table_size, symbolic=True, device=keys.device)
    scratch = torch.empty(0 if in_smem else table_size, dtype=torch.int32,
                          device=keys.device)
    if route == "serial":
        fn = _build.entry("hash_accum", "spk_hash_symbolic", _SYM_ARGTYPES)
    else:
        fn = _build.entry("hash_accum", "spk_hash_symbolic_par",
                          _SYM_ARGTYPES)
    _build.check(fn(keys.data_ptr(), nz.data_ptr(), scratch.data_ptr(),
                    keys.shape[0], sent, table_size, int(in_smem),
                    keys.device.index or 0, _build.stream_ptr(keys)),
                 f"hash_symbolic launch ({route})")
    hash_symbolic_raw.launches += 1
    if route == "serial":
        hash_symbolic_raw.serial_launches += 1
    return nz[0]


#: Calls that launched a symbolic kernel, whichever route (the plain
#: version does not count), and those of them that took the one-thread
#: route.
hash_symbolic_raw.launches = 0
hash_symbolic_raw.serial_launches = 0

"""Multi-tenant streaming accumulation service (DESIGN.md §12).

The port of ``src/repro/core/stream_service.py``.

The paper's §V names streaming accumulation of batched sparse matrices as
the application SpKAdd serves; :class:`~repro_torch.core.streaming.StreamingAccumulator`
is one such stream. This module is the serving tier above it: a
:class:`StreamService` multiplexes thousands of concurrent tenant streams
(per-user graph snapshots, per-model gradient feeds) with robustness as
the design center.

Admission control and backpressure
----------------------------------
Every ``push`` passes a per-tenant **token bucket** (``rate`` tokens/sec,
``burst`` capacity) and the **global pending-nnz budget**: past the soft
watermark, pushes that would *open a new window* are *deferred* — the
verdict carries a retry-after hint from the shared capped-exponential
:func:`~repro_torch.runtime.faults.backoff_delay` schedule (the same formula
Supervisor restarts and delta-sync retries use). The soft→hard grace
region stays reserved for completing already-open windows, because only a
sealed window can flush and free budget — deferring continuations too
would deadlock the budget at the soft line. Past the hard watermark no
push is admitted and the service **load-sheds**, evicting the
coldest tenants' buffered-but-unflushed windows (eviction is loud: per-
tenant stats + counters, and the evicted journal records are removed so a
restart cannot resurrect shed data). Flushed state — the running sums and
their snapshots — is never shed.

Capacity-bucketed co-flush
--------------------------
Tenants are admitted into pow2 capacity buckets ``(shape, pow2(cap))``; a
bucket co-flushes all its ready tenants through **one**
:func:`~repro_torch.core.engine.spkadd_batched_ragged` call (the engine's own
pow2 capacity rounding then makes the tenants' collections share batched
launches). The flush scheduler triggers on deadline (oldest sealed window
older than ``flush_deadline``) OR bucket-full (``max_coflush_windows``
sealed windows ready). Running-sum and window buffers come from a donated
:class:`_BufferPool` — the immutable all-sentinel empties are shared across
every tenant in a capacity class instead of reallocated per registration.

Crash-safe journal and recovery
-------------------------------
With ``journal_root`` set, every admitted push is appended to the tenant's
journal as a crc32-checksummed record (``b"SPKJ"`` codec, atomic
tmp + ``os.replace`` like the delta-sync spool), and every flush commits an
atomic snapshot (``b"SPKS"``) carrying the running sum and ``last_seq`` —
the highest record folded into it. Recovery (on ``register_tenant`` over an
existing journal) restores the snapshot, deletes records at or below
``last_seq`` (already folded — this is what makes replay **exactly once**
across a crash at any point in the flush commit), quarantines torn records
(checksum/length violations move to ``quarantine/``, loudly counted, never
applied), and replays the rest into the window buffers with their original
arrival times — so the flush scheduler's state, and therefore every
subsequent flush grouping and sum, is **bitwise identical** to the
uninterrupted run at any flush boundary (pinned by the chaos cells of
``tests/test_torch_stream_service.py`` and ``chip_smoke.py``'s phase
``stream_service``).

Devices and bytes
-----------------
Running sums and window matrices live on the service's device
(``device=None``: the CUDA card; ``device="cpu"`` for the CPU); a
co-flush launches the engine's kernels there. Tenants of a capacity class
share one empty running sum, so nothing here writes into a sum or a window
tensor in place. Journal records and snapshots are the reference's bytes
(header ``dtype`` numpy's name, ``t`` and ``nnz`` plain numbers), so a
journal written by either package recovers in the other.
"""
from __future__ import annotations

import json
import math
import os
import re
import struct
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import spkadd_batched_ragged
from repro_torch.core.sparse import PaddedCOO, make_empty, resolve_device
from repro_torch.core.streaming import truncate_by_magnitude
from repro_torch.runtime.faults import backoff_delay

JOURNAL_VERSION = 1
REC_MAGIC = b"SPKJ"   # one admitted push (window member)
SNAP_MAGIC = b"SPKS"  # running sum at a flush boundary
_HDR = struct.Struct("<4sBI")  # magic, version, header_len

_TENANT_RE = re.compile(r"^[A-Za-z0-9_\-]{1,64}$")
_REC_FILE_RE = re.compile(r"^rec_(\d{8})\.bin$")

#: Value types numpy has no native dtype for: the journal stores their
#: bytes under the reference's dtype name, read back through the integer
#: type of the same width.
_BITS_DTYPES = {"bfloat16": (np.dtype(np.int16), torch.bfloat16)}


class TornRecordError(ValueError):
    """A journal record failed structural or checksum verification."""


def pow2_bucket(cap: int) -> int:
    """Smallest power of two >= ``cap`` — the capacity-bucket key."""
    if cap < 1:
        raise ValueError(f"capacity must be >= 1, got {cap}")
    return 1 << (cap - 1).bit_length()


# ---------------------------------------------------------------------------
# journal codec (crc32-checksummed records, the b"SPKD" discipline)
# ---------------------------------------------------------------------------

def _host_vals(vals) -> Tuple[bytes, str]:
    """(bytes, numpy dtype name) of a numpy array or tensor of values; a
    bf16 tensor is named ``"bfloat16"``, as numpy names the reference's."""
    if isinstance(vals, torch.Tensor):
        t = vals.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        vals = t.numpy()
    return vals.tobytes(), str(vals.dtype)


def encode_journal(magic: bytes, header: dict, keys, vals) -> bytes:
    """One record or snapshot: ``keys`` int32 and ``vals`` (numpy arrays or
    tensors), 1-D and of one length, the reference's bytes."""
    if isinstance(keys, torch.Tensor):
        keys = keys.detach().cpu().numpy()
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    if not isinstance(vals, torch.Tensor):
        vals = np.ascontiguousarray(vals)
    if keys.ndim != 1 or tuple(vals.shape) != keys.shape:
        raise ValueError(f"journal keys/vals must be matching 1-D arrays, "
                         f"got {keys.shape} vs {tuple(vals.shape)}")
    payload_vals, dtype = _host_vals(vals)
    payload = keys.tobytes() + payload_vals
    hdr = dict(header)
    hdr["n"] = int(keys.shape[0])
    hdr["dtype"] = dtype
    hdr["crc"] = zlib.crc32(payload)
    blob = json.dumps(hdr, sort_keys=True).encode("utf-8")
    return _HDR.pack(magic, JOURNAL_VERSION, len(blob)) + blob + payload


def decode_journal(buf: bytes, magic: bytes) -> Tuple[dict, np.ndarray,
                                                      np.ndarray]:
    """Decode + verify; raises :class:`TornRecordError` on any damage —
    a truncated write, a flipped byte, a wrong magic all land here. A
    ``bfloat16`` record's values come back as their int16 bits."""
    try:
        m, version, hlen = _HDR.unpack_from(buf, 0)
    except struct.error:
        raise TornRecordError("truncated journal header") from None
    if m != magic:
        raise TornRecordError(f"bad journal magic {m!r} (want {magic!r})")
    if version != JOURNAL_VERSION:
        raise TornRecordError(f"unknown journal version {version}")
    end = _HDR.size + hlen
    try:
        hdr = json.loads(buf[_HDR.size:end].decode("utf-8"))
        n = int(hdr["n"])
        name = str(hdr["dtype"])
        dtype = _BITS_DTYPES[name][0] if name in _BITS_DTYPES \
            else np.dtype(name)
        crc = int(hdr["crc"])
    except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
        raise TornRecordError(f"unreadable journal header: {e}") from None
    payload = buf[end:]
    if n < 0 or len(payload) != n * (4 + dtype.itemsize):
        raise TornRecordError(
            f"payload length {len(payload)} != n*(4+itemsize) for n={n}")
    if zlib.crc32(payload) != crc:
        raise TornRecordError("journal payload checksum mismatch")
    keys = np.frombuffer(payload[:4 * n], dtype=np.int32)
    vals = np.frombuffer(payload[4 * n:], dtype=dtype)
    return hdr, keys, vals


def _placed(device) -> torch.device:
    """``device`` as the tensors made there report it (``cuda`` ->
    ``cuda:N``), so a push's device compares equal to its tenant's."""
    return torch.empty(0, device=resolve_device(device)).device


def _atomic_write(path: str, buf: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)


def _coo_from_record(hdr: dict, keys: np.ndarray, vals: np.ndarray,
                     device) -> PaddedCOO:
    shape = (int(hdr["shape"][0]), int(hdr["shape"][1]))
    v = torch.tensor(vals)
    if hdr["dtype"] in _BITS_DTYPES:
        v = v.view(_BITS_DTYPES[hdr["dtype"]][1])
    return PaddedCOO(keys=torch.tensor(keys, dtype=torch.int32,
                                       device=device),
                     vals=v.to(device),
                     nnz=torch.tensor(int(hdr["nnz"]), dtype=torch.int32,
                                      device=device),
                     shape=shape)


# ---------------------------------------------------------------------------
# buffer pool — donated running-sum buffers
# ---------------------------------------------------------------------------

class _BufferPool:
    """Cache of the all-sentinel empties keyed by (shape, cap, dtype,
    device). Nothing in the service writes into a ``PaddedCOO`` leaf in
    place, so one zero buffer is safely donated to every tenant in a
    capacity class — registration/eviction/recovery stop paying a fresh
    device allocation per stream (the realloc churn at thousands of
    tenants)."""

    def __init__(self):
        self._cache: Dict[Tuple, PaddedCOO] = {}

    def empty(self, shape: Tuple[int, int], cap: int, dtype,
              device: torch.device) -> PaddedCOO:
        key = (shape, cap, dtype, str(device))
        hit = key in self._cache
        obs.counter("stream_service.pool.hit" if hit
                    else "stream_service.pool.miss").inc()
        if not hit:
            self._cache[key] = make_empty(shape, cap, dtype, device=device)
        return self._cache[key]


# ---------------------------------------------------------------------------
# service data model
# ---------------------------------------------------------------------------

class AdmissionVerdict(NamedTuple):
    """What one ``push`` was told. ``retry_after`` is the backpressure
    hint (seconds) for non-admitted pushes; ``seq`` the journal sequence
    of an admitted one."""
    tenant: str
    admitted: bool
    reason: str          # "ok" | "rate_limited" | "deferred"
    retry_after: float
    seq: int = -1


class SealedWindow(NamedTuple):
    """A full ``batch_k`` window waiting for its bucket's co-flush."""
    mats: Tuple[PaddedCOO, ...]
    seqs: Tuple[int, ...]
    t_first: float
    t_sealed: float
    nnz: int


class FlushReport(NamedTuple):
    ordinal: int
    bucket: Tuple
    tenants: int
    windows: int
    nnz: int


class TenantStream:
    """Per-tenant serving state: running sum, window buffers, token
    bucket, and the loud stats ledger."""

    def __init__(self, tenant: str, shape: Tuple[int, int], *,
                 cap_budget: int, batch_k: int, rate: float, burst: float,
                 dtype, device: torch.device, sum_init: PaddedCOO):
        self.tenant = tenant
        self.shape = shape
        self.cap_budget = cap_budget
        self.batch_k = batch_k
        self.rate = rate
        self.burst = burst
        self.dtype = dtype
        self.device = device
        self.sum = sum_init
        self.open_mats: List[PaddedCOO] = []
        self.open_meta: List[Tuple[float, int, int]] = []  # (t, seq, nnz)
        self.sealed: List[SealedWindow] = []
        self.buffered_nnz = 0
        self.tokens = burst
        self.t_token: Optional[float] = None
        self.last_activity = -math.inf
        self.next_seq = 0
        self.n_seen = 0
        self.n_flushes = 0
        self.deferrals = 0   # consecutive non-admissions -> backoff attempt
        self.stats: Dict[str, int] = {
            "admitted": 0, "admitted_nnz": 0, "rate_limited": 0,
            "deferred": 0,
            "evicted_windows": 0, "evicted_nnz": 0, "flushed_windows": 0,
            "flushed_nnz": 0,
            "replayed_records": 0, "quarantined_records": 0,
        }


class StreamService:
    """Multiplex thousands of :class:`StreamingAccumulator`-style streams
    behind admission control, co-flush scheduling, and a crash-safe
    journal. All clocks are caller-provided ``now`` floats (simulated or
    wall), so a chaos run replays deterministically from its seed. Tenants
    live on ``device`` (``None``: the CUDA card) unless
    :meth:`register_tenant` names another.
    """

    def __init__(self, *, soft_pending_nnz: int = 1 << 20,
                 hard_pending_nnz: int = 1 << 21,
                 flush_deadline: float = 1.0,
                 max_coflush_windows: int = 64,
                 journal_root: Optional[str] = None,
                 fault_injector=None, algorithm: str = "auto",
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 backoff_jitter: float = 0.0,
                 rng: Optional[np.random.Generator] = None, device=None):
        if not 0 < soft_pending_nnz <= hard_pending_nnz:
            raise ValueError(
                f"watermarks must satisfy 0 < soft <= hard, got "
                f"soft={soft_pending_nnz} hard={hard_pending_nnz}")
        if flush_deadline <= 0:
            raise ValueError(f"flush_deadline must be > 0, got "
                             f"{flush_deadline}")
        if max_coflush_windows < 1:
            raise ValueError("max_coflush_windows must be >= 1")
        self.soft_pending_nnz = soft_pending_nnz
        self.hard_pending_nnz = hard_pending_nnz
        self.flush_deadline = flush_deadline
        self.max_coflush_windows = max_coflush_windows
        self.journal_root = journal_root
        self.fault_injector = fault_injector
        self.algorithm = algorithm
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_jitter = backoff_jitter
        self.device = _placed(device)
        # host-side service: the seeded generator only jitters retry-after
        # hints, never device values
        self._rng = (rng if rng is not None
                     else np.random.default_rng(0))  # spkaddlint: disable=SPK105
        self._streams: Dict[str, TenantStream] = {}
        self._buckets: Dict[Tuple, List[str]] = {}
        self._pool = _BufferPool()
        self.pending_nnz = 0
        self.flush_ordinal = 0
        self.flush_latencies: List[float] = []
        if journal_root:
            os.makedirs(journal_root, exist_ok=True)

    # -- registration + recovery -------------------------------------------

    def register_tenant(self, tenant: str, shape: Tuple[int, int], *,
                        cap_budget: int, batch_k: int = 8,
                        rate: float = math.inf, burst: float = 8.0,
                        dtype=torch.float32, device=None) -> int:
        """Admit a stream into its capacity bucket. Over an existing
        journal this *recovers* the tenant — snapshot restored, consumed
        records dropped, torn records quarantined, unflushed records
        replayed exactly once. Returns the replayed-record count.
        ``device=None`` keeps the tenant on the service's device."""
        if not _TENANT_RE.match(tenant):
            raise ValueError(f"tenant id must match {_TENANT_RE.pattern}, "
                             f"got {tenant!r}")
        if tenant in self._streams:
            raise ValueError(f"tenant {tenant!r} already registered")
        if batch_k < 1:
            raise ValueError(f"batch_k must be >= 1, got {batch_k}")
        if not (rate > 0 and burst >= 1):
            raise ValueError(f"need rate > 0 and burst >= 1, got "
                             f"rate={rate} burst={burst}")
        cap_budget = min(int(cap_budget), shape[0] * shape[1])
        if cap_budget < 1:
            raise ValueError(f"cap_budget must be >= 1, got {cap_budget}")
        dev = self.device if device is None else _placed(device)
        stream = TenantStream(
            tenant, shape, cap_budget=cap_budget, batch_k=batch_k,
            rate=rate, burst=burst, dtype=dtype, device=dev,
            sum_init=self._pool.empty(shape, cap_budget, dtype, dev))
        self._streams[tenant] = stream
        key = (shape, pow2_bucket(cap_budget))
        self._buckets.setdefault(key, []).append(tenant)
        obs.counter("stream_service.tenants").inc()
        replayed = 0
        if self.journal_root:
            replayed = self._recover_tenant(stream)
        return replayed

    def _tenant_dir(self, tenant: str) -> str:
        return os.path.join(self.journal_root, tenant)

    def _recover_tenant(self, stream: TenantStream) -> int:
        tdir = self._tenant_dir(stream.tenant)
        os.makedirs(os.path.join(tdir, "quarantine"), exist_ok=True)
        last_seq = -1
        snap_path = os.path.join(tdir, "snapshot.bin")
        with obs.span("stream_service.recover", tenant=stream.tenant):
            if os.path.exists(snap_path):
                with open(snap_path, "rb") as f:
                    buf = f.read()
                try:
                    hdr, keys, vals = decode_journal(buf, SNAP_MAGIC)
                except TornRecordError:
                    # snapshots are atomically replaced, so a torn one means
                    # external damage: quarantine loudly, restart the sum
                    self._quarantine(stream, snap_path)
                else:
                    stream.sum = _coo_from_record(hdr, keys, vals,
                                                  stream.device)
                    stream.n_flushes = int(hdr["flushes"])
                    stream.n_seen = int(hdr["seen"])
                    stream.next_seq = int(hdr["next_seq"])
                    last_seq = int(hdr["last_seq"])
            replayed = self._replay_records(stream, tdir, last_seq)
        if replayed:
            obs.counter("stream_service.journal.replayed").inc(replayed)
        return replayed

    def _replay_records(self, stream: TenantStream, tdir: str,
                        last_seq: int) -> int:
        entries = []
        for name in sorted(os.listdir(tdir)):
            m = _REC_FILE_RE.match(name)
            if m:
                entries.append((int(m.group(1)), name))
        replayed = 0
        for seq, name in sorted(entries):
            path = os.path.join(tdir, name)
            if seq <= last_seq:
                os.remove(path)  # folded into the snapshot: exactly once
                continue
            with open(path, "rb") as f:
                buf = f.read()
            try:
                hdr, keys, vals = decode_journal(buf, REC_MAGIC)
            except TornRecordError:
                self._quarantine(stream, path)
                continue
            a = _coo_from_record(hdr, keys, vals, stream.device)
            # replay = re-buffer with the recorded arrival time: no
            # admission control (it already passed), no re-journaling
            self._buffer_push(stream, a, float(hdr["t"]), seq,
                              int(hdr["nnz"]))
            stream.next_seq = max(stream.next_seq, seq + 1)
            replayed += 1
            stream.stats["replayed_records"] += 1
        return replayed

    def _quarantine(self, stream: TenantStream, path: str) -> None:
        qdir = os.path.join(os.path.dirname(path), "quarantine")
        os.makedirs(qdir, exist_ok=True)
        os.replace(path, os.path.join(qdir, os.path.basename(path)))
        stream.stats["quarantined_records"] += 1
        obs.counter("stream_service.journal.quarantined").inc()

    # -- admission ----------------------------------------------------------

    def push(self, tenant: str, a: PaddedCOO, now: float) -> AdmissionVerdict:
        """Admit-or-backpressure one arrival. Shape/dtype/device mismatches
        are caller bugs (ValueError); overload is a verdict, never an
        exception."""
        stream = self._streams.get(tenant)
        if stream is None:
            raise ValueError(f"unknown tenant {tenant!r}")
        if a.shape != stream.shape:
            raise ValueError(f"tenant {tenant!r} streams {stream.shape}, "
                             f"got {a.shape}")
        if a.vals.dtype != stream.dtype:
            raise ValueError(f"tenant {tenant!r} streams {stream.dtype}, "
                             f"got {a.vals.dtype}")
        if a.keys.device != stream.device:
            raise ValueError(f"tenant {tenant!r} lives on {stream.device}, "
                             f"got a matrix on {a.keys.device}")
        nnz = int(a.nnz)
        if math.isfinite(stream.rate):
            if stream.t_token is None:
                stream.t_token = now
            stream.tokens = min(
                stream.burst,
                stream.tokens + (now - stream.t_token) * stream.rate)
            stream.t_token = now
            if stream.tokens < 1.0:
                return self._reject(stream, "rate_limited",
                                    (1.0 - stream.tokens) / stream.rate)
        if self.pending_nnz + nnz > self.hard_pending_nnz:
            # hard watermark: shed cold tenants' unflushed windows first
            self._shed(now, protect=tenant,
                       target=self.soft_pending_nnz - nnz)
        over_soft = self.pending_nnz + nnz > self.soft_pending_nnz
        over_hard = self.pending_nnz + nnz > self.hard_pending_nnz
        # the soft gate applies at *window-open* granularity: the
        # soft..hard grace region is reserved for completing already-open
        # windows (only a sealed window can ever flush and free budget);
        # the hard watermark is absolute — shedding above was its defense
        if over_hard or (over_soft and not stream.open_mats):
            hint = backoff_delay(
                stream.deferrals, base=self.backoff_base,
                cap=self.backoff_cap, jitter=self.backoff_jitter,
                rng=self._rng)
            return self._reject(stream, "deferred", hint)
        if math.isfinite(stream.rate):
            stream.tokens -= 1.0
        seq = stream.next_seq
        stream.next_seq += 1
        if self.journal_root:
            self._journal_push(stream, a, seq, now, nnz)
        self._buffer_push(stream, a, now, seq, nnz)
        stream.deferrals = 0
        stream.stats["admitted"] += 1
        stream.stats["admitted_nnz"] += nnz
        obs.counter("stream_service.admission.ok").inc()
        return AdmissionVerdict(tenant, True, "ok", 0.0, seq)

    def _reject(self, stream: TenantStream, reason: str,
                retry_after: float) -> AdmissionVerdict:
        stream.deferrals += 1
        stream.stats[reason] += 1
        obs.counter(f"stream_service.admission.{reason}").inc()
        return AdmissionVerdict(stream.tenant, False, reason,
                                float(retry_after))

    def _journal_push(self, stream: TenantStream, a: PaddedCOO, seq: int,
                      now: float, nnz: int) -> None:
        tdir = self._tenant_dir(stream.tenant)
        os.makedirs(tdir, exist_ok=True)
        buf = encode_journal(
            REC_MAGIC,
            {"tenant": stream.tenant, "seq": seq,
             "shape": list(stream.shape), "nnz": nnz, "t": now},
            a.keys, a.vals)
        if self.fault_injector is not None:
            buf = self.fault_injector.mangle_record(buf)
        _atomic_write(os.path.join(tdir, f"rec_{seq:08d}.bin"), buf)

    def _buffer_push(self, stream: TenantStream, a: PaddedCOO, t: float,
                     seq: int, nnz: int) -> None:
        stream.open_mats.append(a)
        stream.open_meta.append((t, seq, nnz))
        stream.buffered_nnz += nnz
        stream.n_seen += 1
        stream.last_activity = max(stream.last_activity, t)
        self.pending_nnz += nnz
        obs.gauge("stream_service.pending_nnz").set(self.pending_nnz)
        if len(stream.open_mats) >= stream.batch_k:
            self._seal(stream, t)

    def _seal(self, stream: TenantStream, now: float) -> None:
        stream.sealed.append(SealedWindow(
            mats=tuple(stream.open_mats),
            seqs=tuple(s for _, s, _ in stream.open_meta),
            t_first=stream.open_meta[0][0], t_sealed=now,
            nnz=sum(n for _, _, n in stream.open_meta)))
        stream.open_mats = []
        stream.open_meta = []

    # -- load shedding ------------------------------------------------------

    def _shed(self, now: float, *, protect: str, target: int) -> None:
        """Evict coldest tenants' buffered-but-unflushed windows until the
        pending budget would fit under the soft watermark. Never touches
        flushed state (sums, snapshots) and never the pushing tenant."""
        victims = sorted((s for s in self._streams.values()
                          if s.tenant != protect and s.buffered_nnz > 0),
                         key=lambda s: (s.last_activity, s.tenant))
        with obs.span("stream_service.shed", pending=self.pending_nnz,
                      target=target):
            for stream in victims:
                if self.pending_nnz <= target:
                    break
                self._evict_stream(stream)

    def _evict_stream(self, stream: TenantStream) -> None:
        windows = len(stream.sealed) + (1 if stream.open_mats else 0)
        seqs = [q for w in stream.sealed for q in w.seqs]
        seqs += [s for _, s, _ in stream.open_meta]
        nnz = stream.buffered_nnz
        stream.sealed = []
        stream.open_mats = []
        stream.open_meta = []
        stream.buffered_nnz = 0
        self.pending_nnz -= nnz
        if self.journal_root:
            tdir = self._tenant_dir(stream.tenant)
            for seq in seqs:
                try:
                    os.remove(os.path.join(tdir, f"rec_{seq:08d}.bin"))
                except OSError:
                    pass  # never journaled (or already gone): nothing to undo
        stream.stats["evicted_windows"] += windows
        stream.stats["evicted_nnz"] += nnz
        obs.counter("stream_service.evicted_windows").inc(windows)
        obs.counter("stream_service.evicted_nnz").inc(nnz)

    # -- co-flush scheduler -------------------------------------------------

    def tick(self, now: float) -> List[FlushReport]:
        """Run the flush scheduler: a bucket flushes when its oldest sealed
        window crossed ``flush_deadline`` or ``max_coflush_windows`` are
        ready."""
        reports = []
        for key, tenants in self._buckets.items():
            ready = [self._streams[t] for t in tenants
                     if self._streams[t].sealed]
            if not ready:
                continue
            total = sum(len(s.sealed) for s in ready)
            oldest = min(w.t_sealed for s in ready for w in s.sealed)
            if total >= self.max_coflush_windows \
                    or now - oldest >= self.flush_deadline:
                reports.append(self._flush_bucket(key, ready, now))
        return reports

    def drain(self, now: float) -> List[FlushReport]:
        """Seal every open window and flush every bucket — end-of-run (or
        test) barrier; also the deterministic "any flush boundary" the
        recovery bitwise contract is pinned at."""
        for stream in self._streams.values():
            if stream.open_mats:
                self._seal(stream, now)
        reports = []
        for key, tenants in self._buckets.items():
            ready = [self._streams[t] for t in tenants
                     if self._streams[t].sealed]
            if ready:
                reports.append(self._flush_bucket(key, ready, now))
        return reports

    def _flush_bucket(self, key: Tuple, ready: Sequence[TenantStream],
                      now: float) -> FlushReport:
        self.flush_ordinal += 1
        windows = sum(len(s.sealed) for s in ready)
        nnz = sum(w.nnz for s in ready for w in s.sealed)
        with obs.span("stream_service.flush", ordinal=self.flush_ordinal,
                      tenants=len(ready), windows=windows, nnz=nnz,
                      algorithm=self.algorithm):
            # one ragged batched engine call for the whole bucket: per
            # tenant, [running sum] + every sealed window's matrices
            colls = [[s.sum] + [m for w in s.sealed for m in w.mats]
                     for s in ready]
            sums = spkadd_batched_ragged(colls, algorithm=self.algorithm)
            new_sums = [truncate_by_magnitude(x, s.cap_budget)
                        for s, x in zip(ready, sums)]
            if self.fault_injector is not None:
                # the planned mid-flush crash: computed but uncommitted —
                # exactly the state only the journal can recover
                self.fault_injector.maybe_crash_flush()
            for stream, new_sum in zip(ready, new_sums):
                self._commit_flush(stream, new_sum, now)
            obs.histogram("stream_service.bucket_occupancy").observe(
                len(ready))
        return FlushReport(self.flush_ordinal, key, len(ready), windows, nnz)

    def _commit_flush(self, stream: TenantStream, new_sum: PaddedCOO,
                      now: float) -> None:
        windows = stream.sealed
        flushed_nnz = sum(w.nnz for w in windows)
        seqs = [q for w in windows for q in w.seqs]
        stream.sum = new_sum
        stream.sealed = []
        stream.buffered_nnz -= flushed_nnz
        self.pending_nnz -= flushed_nnz
        stream.n_flushes += 1
        stream.stats["flushed_windows"] += len(windows)
        stream.stats["flushed_nnz"] += flushed_nnz
        for w in windows:
            lat = now - w.t_sealed
            self.flush_latencies.append(lat)
            obs.histogram("stream_service.flush_latency").observe(lat)
        if self.journal_root:
            self._persist_flush(stream, max(seqs), seqs)
        obs.gauge("stream_service.pending_nnz").set(self.pending_nnz)

    def _persist_flush(self, stream: TenantStream, last_seq: int,
                       seqs: Sequence[int]) -> None:
        tdir = self._tenant_dir(stream.tenant)
        os.makedirs(tdir, exist_ok=True)
        buf = encode_journal(
            SNAP_MAGIC,
            {"tenant": stream.tenant, "shape": list(stream.shape),
             "nnz": int(stream.sum.nnz), "last_seq": last_seq,
             "next_seq": stream.next_seq, "flushes": stream.n_flushes,
             "seen": stream.n_seen},
            stream.sum.keys, stream.sum.vals)
        # snapshot first (atomic), then drop the consumed records: a crash
        # between the two replays nothing twice — recovery skips records at
        # or below the snapshot's last_seq
        _atomic_write(os.path.join(tdir, "snapshot.bin"), buf)
        for seq in seqs:
            try:
                os.remove(os.path.join(tdir, f"rec_{seq:08d}.bin"))
            except OSError:
                pass  # torn-quarantined or never journaled

    # -- reads --------------------------------------------------------------

    def value(self, tenant: str) -> PaddedCOO:
        """The tenant's *flushed* running sum (buffered windows are not
        folded in — call :meth:`drain` first for a stream-total read)."""
        stream = self._streams.get(tenant)
        if stream is None:
            raise ValueError(f"unknown tenant {tenant!r}")
        return stream.sum

    def dense(self, tenant: str) -> torch.Tensor:
        return self.value(tenant).to_dense()

    def stats(self) -> dict:
        per_tenant = {
            t: dict(s.stats, buffered_nnz=s.buffered_nnz,
                    flushes=s.n_flushes, seen=s.n_seen,
                    sealed_windows=len(s.sealed))
            for t, s in self._streams.items()}
        return {"pending_nnz": self.pending_nnz,
                "flushes": self.flush_ordinal,
                "buckets": {str(k): list(v)
                            for k, v in self._buckets.items()},
                "tenants": per_tenant}


def latency_percentiles(latencies: Sequence[float]
                        ) -> Tuple[float, float]:
    """(p50, p99) of flush latencies (the load generator's simulated
    seconds) — the serving numbers the load generator reports."""
    if not latencies:
        return 0.0, 0.0
    arr = np.asarray(latencies, dtype=np.float64)
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))

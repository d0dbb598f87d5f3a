"""Fault-tolerant sparse parameter-delta sync: trainer -> serving replicas.

The port of ``src/repro/runtime/delta_sync.py``. A :class:`DeltaPublisher`
top-k-sparsifies ``params_t - params_{t-1}`` per leaf with error-feedback
residuals (the ``core/topk`` EF stack) and emits epoch-versioned,
checksummed **delta frames**; a :class:`DeltaSubscriber` folds a missed
window of epochs into its params with exactly one
:func:`~repro_torch.core.engine.spkadd_batched_ragged` call.

Frame format (version 1), byte for byte the reference's
-----------------------------------------------------------
``b"SPKD" | u8 version | u32 header_len | header json | payload`` where the
header (sorted-key JSON) carries ``{epoch, base_epoch, shard, size, n,
crc}`` (crc32 of the payload) and the payload is ``int32[n] idx ++
float32[n] val``. ``shard`` is the leaf's ``jax.tree_util.keystr`` name
(:mod:`repro_torch.tree`), so frames cross between the packages. Any
structural or checksum failure raises :class:`CorruptFrameError`; corrupt
frames are counted and dropped, never applied.

Bitwise contract
----------------
The publisher keeps a **shadow** copy advanced by the same scatter-add
(:func:`apply_delta_flat`) subscribers use; EF residuals absorb the drift,
and the shadow is what the publisher checkpoints. The invariant is
``subscriber == publisher.shadow`` bitwise at any fully applied epoch.

Staleness state machine
-----------------------
Per :meth:`DeltaSubscriber.sync`: drain -> decode (checksum; drop corrupt /
duplicate) -> pick the newest epoch with evidence as the target -> bounded
retry with exponential backoff + jitter for missing frames -> fold the
window if it is contiguous and within ``max_staleness``; beyond the bound,
reload the newest shadow checkpoint (once) and fold the remainder; with no
usable checkpoint, the fold is the fallback.

State lives on one device: ``device=None`` means the CUDA card (raising
without one), ``device="cpu"`` the CPU. The publisher's and subscriber's
tensors are their own copies; ``params`` and ``shadow_params()`` return
views of them, to read and not to modify. Placing EF residuals on a mesh
(the reference's ``mesh`` argument) waits for the port's sharding.
"""
from __future__ import annotations

import collections
import json
import os
import re
import struct
import time
import zlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as _tree
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.engine import spkadd_batched_ragged
from repro_torch.core.sparse import PaddedCOO, make_empty, resolve_device
from repro_torch.core.topk import global_k, sparsify_with_feedback
from repro_torch.kernels import xla_float
from repro_torch.kernels import xla_add as _xla_add
from repro_torch.runtime.faults import backoff_delay
from repro_torch.train.step import init_ef_state

MAGIC = b"SPKD"
VERSION = 1
_HDR = struct.Struct("<4sBI")  # magic, version, header_len


class CorruptFrameError(ValueError):
    """A delta frame failed structural or checksum verification."""


class DeltaFrame(NamedTuple):
    """One leaf's sparse increment for one epoch (host-side, decoded)."""
    epoch: int
    base_epoch: int
    shard: str          # leaf name (jax keystr of the tree path)
    size: int           # flat length of the leaf
    idx: np.ndarray     # int32[n] flat indices
    val: np.ndarray     # float32[n] increments


def encode_frame(frame: DeltaFrame) -> bytes:
    idx = np.ascontiguousarray(frame.idx, dtype=np.int32)
    val = np.ascontiguousarray(frame.val, dtype=np.float32)
    if idx.shape != val.shape or idx.ndim != 1:
        raise ValueError(
            f"frame idx/val must be matching 1-D arrays, got "
            f"{idx.shape} vs {val.shape}")
    payload = idx.tobytes() + val.tobytes()
    header = json.dumps(
        {"epoch": int(frame.epoch), "base_epoch": int(frame.base_epoch),
         "shard": str(frame.shard), "size": int(frame.size),
         "n": int(idx.shape[0]), "crc": zlib.crc32(payload)},
        sort_keys=True).encode("utf-8")
    return _HDR.pack(MAGIC, VERSION, len(header)) + header + payload


def decode_frame(buf: bytes) -> DeltaFrame:
    """Decode + verify; raises :class:`CorruptFrameError` on any damage."""
    try:
        magic, version, hlen = _HDR.unpack_from(buf, 0)
    except struct.error:
        raise CorruptFrameError("truncated frame header") from None
    if magic != MAGIC:
        raise CorruptFrameError(f"bad magic {magic!r}")
    if version != VERSION:
        raise CorruptFrameError(f"unknown frame version {version}")
    end = _HDR.size + hlen
    try:
        hdr = json.loads(buf[_HDR.size:end].decode("utf-8"))
        epoch = int(hdr["epoch"])
        base_epoch = int(hdr["base_epoch"])
        shard = str(hdr["shard"])
        size = int(hdr["size"])
        n = int(hdr["n"])
        crc = int(hdr["crc"])
    except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
        raise CorruptFrameError(f"unreadable frame header: {e}") from None
    payload = buf[end:]
    if n < 0 or size < 0 or len(payload) != 8 * n:
        raise CorruptFrameError(
            f"payload length {len(payload)} != 8*n for n={n}")
    if zlib.crc32(payload) != crc:
        raise CorruptFrameError("payload checksum mismatch")
    idx = np.frombuffer(payload[:4 * n], dtype=np.int32)
    val = np.frombuffer(payload[4 * n:], dtype=np.float32)
    if n and (int(idx.min()) < 0 or int(idx.max()) >= size):
        raise CorruptFrameError("frame index out of range for leaf size")
    return DeltaFrame(epoch, base_epoch, shard, size, idx, val)


def frame_epoch(buf: bytes) -> Optional[int]:
    """Cheap header peek (no checksum): the frame's epoch, or None if the
    header is unreadable. Transports use this for routing/injection."""
    try:
        magic, version, hlen = _HDR.unpack_from(buf, 0)
        if magic != MAGIC or version != VERSION:
            return None
        hdr = json.loads(buf[_HDR.size:_HDR.size + hlen].decode("utf-8"))
        return int(hdr["epoch"])
    except (struct.error, UnicodeDecodeError, ValueError, KeyError,
            TypeError):
        return None


def apply_delta_flat(flat: torch.Tensor, idx, val) -> torch.Tensor:
    """THE scatter-add both the publisher shadow and every subscriber use:
    the reference's ``flat.at[idx].add(val, mode="drop")``, returned as a
    new tensor on ``flat``'s device.

    Only the indexed slots are touched (``flat + densify(...)`` would
    rewrite the others, and ``-0.0 + 0.0 == +0.0`` breaks bitwise
    identity). Negative indices count from the end, as JAX's do; indices
    still outside ``[0, size)`` are dropped, so engine outputs (sentinel
    ``== size``) apply directly.

    Precondition: the kept indices are unique — top-k selections and the
    engine's canonical output are. Then one gather, one add and one scatter
    give the in-order add's bits, with no atomics on values. The add is
    XLA's (:func:`xla_float.add_as`: subnormal inputs and results flushed).
    """
    size = flat.shape[0]
    idx = torch.as_tensor(idx, device=flat.device).long()
    val = torch.as_tensor(val, device=flat.device).to(torch.float32)
    idx = torch.where(idx < 0, idx + size, idx)
    keep = (idx >= 0) & (idx < size)
    idx, val = idx[keep], val[keep]
    out = flat.clone()
    out[idx] = xla_float.add_as(flat[idx], val)
    return out


def frame_to_coo(frame: DeltaFrame, device=None) -> PaddedCOO:
    """A delta frame as a ``(size, 1)`` PaddedCOO column on ``device``
    (``None`` = the CUDA card) — flat index == linearized key, sentinel ==
    size — so a missed window folds through the engine unchanged."""
    shape = (frame.size, 1)
    n = int(frame.idx.shape[0])
    dev = resolve_device(device)
    if n == 0:
        return make_empty(shape, 1, device=dev)
    return PaddedCOO(
        keys=torch.from_numpy(np.array(frame.idx, dtype=np.int32)).to(dev),
        vals=torch.from_numpy(np.array(frame.val, dtype=np.float32)).to(dev),
        nnz=torch.tensor(n, dtype=torch.int32, device=dev), shape=shape)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    arr = np.asarray(leaf)
    return int(arr.size * arr.dtype.itemsize)


def dense_sync_bytes(params) -> int:
    """Bytes a full-checkpoint ship of ``params`` would move — the baseline
    the bytes-per-sync oracle is gated against."""
    return int(sum(_nbytes(leaf) for leaf in _tree.leaves(params)))


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class Transport:
    """Pluggable frame wire. ``send``/``poll`` move opaque byte frames;
    ``request_resend`` asks the attached publisher's ring buffer to replay
    an epoch (returns False when the epoch has aged out)."""

    def __init__(self):
        self._queue: "collections.deque[bytes]" = collections.deque()
        self._pub = None

    def attach_publisher(self, pub) -> None:
        self._pub = pub

    def send(self, frame: bytes) -> None:
        self._queue.append(frame)

    def poll(self) -> List[bytes]:
        out = list(self._queue)
        self._queue.clear()
        return out

    def request_resend(self, epoch: int) -> bool:
        frames = self._pub.frames_for(epoch) if self._pub is not None else None
        if not frames:
            return False
        for buf in frames:
            self.send(buf)
        return True


#: in-process deque transport (tests / single-process chaos harness)
InProcTransport = Transport

_FRAME_FILE_RE = re.compile(r"^frame_(\d{8})_(\d{8})\.bin$")


class DirTransport(Transport):
    """Spool-directory transport: one file per frame under
    ``<root>/frames``, written atomically (tmp + ``os.replace``) so a
    concurrent reader never observes a torn frame. Works across processes
    and across the two packages: names (``frame_<epoch>_<seq>.bin``) and
    bytes are the reference's, and directory order is delivery order."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        self.frames_dir = os.path.join(root, "frames")
        os.makedirs(self.frames_dir, exist_ok=True)
        self._seen: set = set()
        seqs = [int(m.group(2)) for m in
                (_FRAME_FILE_RE.match(n) for n in os.listdir(self.frames_dir))
                if m]
        self._seq = max(seqs) + 1 if seqs else 0

    def send(self, frame: bytes) -> None:
        epoch = frame_epoch(frame)
        name = f"frame_{(epoch or 0):08d}_{self._seq:08d}.bin"
        self._seq += 1
        path = os.path.join(self.frames_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame)
        os.replace(tmp, path)

    def poll(self) -> List[bytes]:
        out: List[bytes] = []
        for name in sorted(os.listdir(self.frames_dir)):
            m = _FRAME_FILE_RE.match(name)
            if not m or name in self._seen:
                continue
            try:
                with open(os.path.join(self.frames_dir, name), "rb") as f:
                    out.append(f.read())
            except OSError:
                continue  # pruned between listdir and open
            self._seen.add(name)
        return out

    def prune_below(self, epoch: int) -> int:
        """Remove spooled frames older than ``epoch`` (aged out of the
        publisher ring — unresendable anyway). Returns files removed."""
        removed = 0
        for name in os.listdir(self.frames_dir):
            m = _FRAME_FILE_RE.match(name)
            if m and int(m.group(1)) < epoch:
                try:
                    os.remove(os.path.join(self.frames_dir, name))
                    removed += 1
                except OSError:
                    pass
        return removed


def _flat_f32(leaf, device: torch.device) -> torch.Tensor:
    """A flat f32 copy of ``leaf`` on ``device`` (never a view of it)."""
    return torch.as_tensor(leaf).reshape(-1).to(device, torch.float32,
                                                copy=True)


# ---------------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------------

class PublishStats(NamedTuple):
    epoch: int
    frames: int
    bytes: int          # wire bytes this sync (all frames, headers included)
    dense_bytes: int    # what a full-checkpoint ship would have moved
    selected: int       # nonzero entries actually transmitted


class DeltaPublisher:
    """Top-k + error-feedback delta publisher over a pluggable transport.

    Per :meth:`publish`: for each leaf, EF-compress ``cur - prev`` (XLA's
    f32 subtraction, ``kernels/xla_add``) with
    :func:`sparsify_with_feedback` (``selector`` ``"global"`` or
    ``"block"``, blocks of 4,096), emit one checksummed frame per leaf,
    advance the shadow by the same scatter subscribers apply, and keep the
    epoch's frames in a ``window_epochs``-deep ring buffer to answer
    ``request_resend``. With ``ckpt_dir`` set, the shadow is checkpointed
    every ``checkpoint_every`` epochs (epoch 0 included) — the reload target
    of the subscriber's degradation ladder.
    """

    def __init__(self, params, transport, *, k_fraction: float = 0.01,
                 selector: str = "global", window_epochs: int = 16,
                 ckpt_dir: Optional[str] = None, checkpoint_every: int = 0,
                 device=None):
        if not 0.0 < k_fraction <= 1.0:
            raise ValueError(f"k_fraction must be in (0, 1], got {k_fraction}")
        if window_epochs < 1:
            raise ValueError(f"window_epochs must be >= 1, got {window_epochs}")
        if checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        self.device = resolve_device(device)
        self.transport = transport
        transport.attach_publisher(self)
        self.k_fraction = k_fraction
        self.selector = selector
        self.window_epochs = window_epochs
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = checkpoint_every

        leaves, self._names, self._treedef = _tree.flatten_with_names(params)
        if len(set(self._names)) != len(self._names):
            raise ValueError("parameter tree has duplicate leaf names")
        self._shapes = [tuple(torch.as_tensor(l).shape) for l in leaves]
        self._prev = [_flat_f32(l, self.device) for l in leaves]  # true params
        self._shadow = list(self._prev)  # subscriber-reachable trajectory
        self._sizes = [int(f.shape[0]) for f in self._prev]
        self._k = [global_k(s, k_fraction) for s in self._sizes]
        ef = init_ef_state(self._prev, n_workers=1)
        self._residual = [leaf[0] for leaf in ef]

        self.epoch = 0
        self._ring: "collections.OrderedDict[int, List[bytes]]" = \
            collections.OrderedDict()
        if ckpt_dir and checkpoint_every:
            self._save_shadow(0)

    def _check_tree(self, params):
        leaves, treedef = _tree.flatten(params)
        if treedef != self._treedef:
            raise ValueError(
                f"publish() params tree structure changed: got "
                f"{_tree.describe(treedef)}, publisher was built for "
                f"{_tree.describe(self._treedef)}")
        return leaves

    def _save_shadow(self, epoch: int) -> None:
        save_checkpoint(self.ckpt_dir, epoch, self.shadow_params())
        obs.counter("delta_sync.shadow_ckpts").inc()

    def shadow_params(self):
        """The shadow trajectory as a params-shaped tree (fp32)."""
        leaves = [f.reshape(s) for f, s in zip(self._shadow, self._shapes)]
        return _tree.unflatten(self._treedef, leaves)

    def frames_for(self, epoch: int) -> Optional[List[bytes]]:
        """Ring-buffer lookup backing ``transport.request_resend``."""
        return self._ring.get(epoch)

    def publish(self, params, *, epoch: Optional[int] = None) -> PublishStats:
        """Sparsify + ship one epoch of parameter deltas."""
        epoch = self.epoch + 1 if epoch is None else int(epoch)
        if epoch <= self.epoch:
            raise ValueError(
                f"epochs must be monotone: got {epoch}, last {self.epoch}")
        leaves = self._check_tree(params)
        frames: List[bytes] = []
        total_bytes = 0
        selected = 0
        with obs.span("delta_sync.publish", epoch=epoch,
                      k_fraction=self.k_fraction):
            for i, leaf in enumerate(leaves):
                cur = _flat_f32(leaf, self.device)
                delta = _xla_add.xla_add_raw(cur, self._prev[i],
                                              subtract=True)
                u, self._residual[i] = sparsify_with_feedback(
                    delta, self._residual[i], self._k[i],
                    selector=self.selector)
                keep = (u.val != 0.0) & (u.idx < u.size)  # pads + exact zeros
                idx, val = u.idx[keep], u.val[keep]
                frames.append(encode_frame(DeltaFrame(
                    epoch, epoch - 1, self._names[i], u.size,
                    idx.cpu().numpy(), val.cpu().numpy())))
                self._shadow[i] = apply_delta_flat(self._shadow[i], idx, val)
                self._prev[i] = cur
                total_bytes += len(frames[-1])
                selected += int(idx.shape[0])
            for buf in frames:
                self.transport.send(buf)
        self._ring[epoch] = frames
        while len(self._ring) > self.window_epochs:
            self._ring.popitem(last=False)
        if hasattr(self.transport, "prune_below"):
            self.transport.prune_below(min(self._ring))
        self.epoch = epoch
        obs.histogram("delta_sync.bytes_per_sync").observe(total_bytes)
        obs.counter("delta_sync.frames_sent").inc(len(frames))
        if self.ckpt_dir and self.checkpoint_every \
                and epoch % self.checkpoint_every == 0:
            self._save_shadow(epoch)
        return PublishStats(epoch, len(frames), total_bytes,
                            dense_sync_bytes(params), selected)


# ---------------------------------------------------------------------------
# subscriber
# ---------------------------------------------------------------------------

class SyncReport(NamedTuple):
    """What one :meth:`DeltaSubscriber.sync` call did (all host ints)."""
    applied_epoch: int      # epoch the replica is at after this sync
    target_epoch: int       # newest epoch the replica has evidence of
    staleness: int          # target - applied *before* this sync acted
    window: int             # epochs folded (0 = no fold this call)
    retries: int            # resend retry rounds used
    degraded: bool          # reloaded a shadow checkpoint this call
    frames_received: int
    frames_corrupt: int
    frames_duplicate: int


class DeltaSubscriber:
    """Staleness-bounded delta consumer folding missed epochs via SpKAdd.

    Call :meth:`sync` between decode steps; read ``.params`` after a report
    with ``window > 0`` or ``degraded`` to hot-swap the serving weights.
    ``sleep_fn`` injects the backoff clock (tests pass a recorder).
    """

    def __init__(self, params, transport, *, max_staleness: int = 8,
                 start_epoch: int = 0, ckpt_dir: Optional[str] = None,
                 max_retries: int = 3, backoff_base: float = 0.05,
                 backoff_cap: float = 2.0, backoff_jitter: float = 0.5,
                 seed: int = 0, algorithm: str = "auto",
                 sleep_fn: Callable[[float], None] = time.sleep,
                 device=None):
        if max_staleness < 1:
            raise ValueError(f"max_staleness must be >= 1, got {max_staleness}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.device = resolve_device(device)
        self.transport = transport
        self.max_staleness = max_staleness
        self.ckpt_dir = ckpt_dir
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_jitter = backoff_jitter
        self.algorithm = algorithm
        self.sleep_fn = sleep_fn
        self._rng = np.random.default_rng(seed)

        leaves, self._names, self._treedef = _tree.flatten_with_names(params)
        self._name_set = set(self._names)
        self._shapes = [tuple(torch.as_tensor(l).shape) for l in leaves]
        self._flat = [_flat_f32(l, self.device) for l in leaves]
        self._sizes = [int(f.shape[0]) for f in self._flat]

        self.applied_epoch = start_epoch
        self._pending: Dict[int, Dict[str, DeltaFrame]] = {}
        self.degradations = 0
        self.total_retries = 0
        self.bound_exceeded = 0  # folds forced past the bound (no usable ckpt)

    @property
    def params(self):
        """Current replica params as a tree shaped like the constructor's."""
        leaves = [f.reshape(s) for f, s in zip(self._flat, self._shapes)]
        return _tree.unflatten(self._treedef, leaves)

    # -- frame intake -------------------------------------------------------

    def _drain(self) -> List[int]:
        """Poll + decode; returns [received, corrupt, duplicate] counts."""
        received = corrupt = dup = 0
        for buf in self.transport.poll():
            received += 1
            try:
                f = decode_frame(buf)
            except CorruptFrameError:
                corrupt += 1
                obs.counter("delta_sync.frames_corrupt").inc()
                continue
            if f.shard not in self._name_set:
                corrupt += 1  # structurally valid but not ours
                obs.counter("delta_sync.frames_corrupt").inc()
                continue
            if f.epoch <= self.applied_epoch \
                    or f.shard in self._pending.get(f.epoch, {}):
                dup += 1
                obs.counter("delta_sync.frames_duplicate").inc()
                continue
            self._pending.setdefault(f.epoch, {})[f.shard] = f
        return [received, corrupt, dup]

    def _complete(self, epoch: int) -> bool:
        return len(self._pending.get(epoch, {})) == len(self._names)

    def _newest_seen(self, hint: Optional[int]) -> int:
        """Newest epoch the replica has evidence of: any received frame,
        or an out-of-band hint (control-plane knowledge of the publisher's
        epoch — how a fully-dropped terminal epoch becomes chaseable)."""
        newest = max(self._pending, default=self.applied_epoch)
        if hint is not None:
            newest = max(newest, int(hint))
        return max(newest, self.applied_epoch)

    def _missing(self, newest: int) -> List[int]:
        return [e for e in range(self.applied_epoch + 1, newest + 1)
                if not self._complete(e)]

    def _fold_to(self) -> int:
        """Largest T with every epoch in (applied, T] complete — the
        contiguous prefix one SpKAdd can fold."""
        t = self.applied_epoch
        while self._complete(t + 1):
            t += 1
        return t

    # -- degradation ladder -------------------------------------------------

    def _degrade(self) -> bool:
        """Reload the newest shadow checkpoint — only if it advances the
        replica (a reload that can't is skipped, so a run degrades at most
        once per actual recovery, never in a loop)."""
        if not self.ckpt_dir:
            return False
        last = latest_step(self.ckpt_dir)
        if last is None or last <= self.applied_epoch:
            return False
        with obs.span("delta_sync.degrade", from_epoch=self.applied_epoch,
                      to_epoch=last):
            tree = restore_checkpoint(self.ckpt_dir, last, self.params)
            self._flat = [_flat_f32(l, self.device)
                          for l in _tree.leaves(tree)]
            self.applied_epoch = last
            self._gc_pending()
        self.degradations += 1
        obs.counter("delta_sync.degradations").inc()
        return True

    def _gc_pending(self) -> None:
        for e in [e for e in self._pending if e <= self.applied_epoch]:
            del self._pending[e]

    def _fold_window(self, epochs: Sequence[int]) -> None:
        """Catch up ``len(epochs)`` missed epochs with ONE ragged SpKAdd:
        per leaf, the window's frames form a k-way collection of (size, 1)
        columns; the engine's compressed sums scatter into the flat params
        through the shared :func:`apply_delta_flat`."""
        with obs.span("delta_sync.catchup", window=len(epochs),
                      to_epoch=epochs[-1]):
            colls = [[frame_to_coo(self._pending[e][name], self.device)
                      for e in epochs] for name in self._names]
            summed = spkadd_batched_ragged(colls, algorithm=self.algorithm)
            for i, s in enumerate(summed):
                self._flat[i] = apply_delta_flat(self._flat[i], s.keys,
                                                 s.vals)
        self.applied_epoch = epochs[-1]
        self._gc_pending()
        obs.histogram("delta_sync.catchup_window").observe(len(epochs))

    # -- the sync state machine ---------------------------------------------

    def sync(self, *, hint_epoch: Optional[int] = None) -> SyncReport:
        """One protocol round: drain, retry-with-backoff for missing frames,
        then fold / degrade per the staleness ladder. Cheap no-op when
        nothing new arrived. ``hint_epoch``: optional control-plane knowledge
        of the publisher's current epoch (lets the replica chase an epoch
        whose every frame was dropped — otherwise invisible)."""
        with obs.span("delta_sync.sync", applied=self.applied_epoch):
            counts = self._drain()
            newest = self._newest_seen(hint_epoch)
            missing = self._missing(newest)
            retries = 0
            degraded = False
            # bounded retry: missing frames are re-requested from the
            # publisher ring through the (still lossy) wire
            while missing and retries < self.max_retries:
                self.sleep_fn(backoff_delay(
                    retries, base=self.backoff_base, cap=self.backoff_cap,
                    jitter=self.backoff_jitter, rng=self._rng))
                retries += 1
                obs.counter("delta_sync.retries").inc()
                for e in missing:
                    self.transport.request_resend(e)
                more = self._drain()
                counts = [a + b for a, b in zip(counts, more)]
                newest = self._newest_seen(hint_epoch)
                missing = self._missing(newest)
            self.total_retries += retries
            staleness = newest - self.applied_epoch
            obs.histogram("delta_sync.staleness").observe(staleness)

            if staleness > self.max_staleness:
                # beyond the bound the ladder prefers a shadow-checkpoint
                # reload (once — _degrade skips reloads that can't advance
                # us); with no usable checkpoint the fold is the fallback
                degraded = self._degrade()
                if not degraded and not missing:
                    self.bound_exceeded += 1
                    obs.counter("delta_sync.bound_exceeded").inc()

            # fold the contiguous complete prefix — progress even when a
            # later epoch still has holes the next round will chase
            fold_to = self._fold_to()
            window = 0
            if fold_to > self.applied_epoch:
                epochs = list(range(self.applied_epoch + 1, fold_to + 1))
                self._fold_window(epochs)
                window = len(epochs)
            obs.gauge("delta_sync.applied_epoch").set(self.applied_epoch)
            return SyncReport(
                applied_epoch=self.applied_epoch, target_epoch=newest,
                staleness=staleness, window=window, retries=retries,
                degraded=degraded, frames_received=counts[0],
                frames_corrupt=counts[1], frames_duplicate=counts[2])

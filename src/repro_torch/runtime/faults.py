"""Deterministic fault injection and the shared retry policy.

The port of ``src/repro/runtime/faults.py``:

- :class:`FailureInjector` — step-level crashes for the
  :class:`~repro_torch.runtime.supervisor.Supervisor` (raise at given
  steps, once each).
- :class:`FaultyTransport` — frame-level chaos for the delta-sync wire
  (``runtime/delta_sync.py``): drop / duplicate / reorder / corrupt /
  stall, every draw from one ``numpy`` generator seeded by
  :class:`FaultSpec`, in the reference's order, so a chaos run replays the
  reference's run from the same seed.
- :class:`ServiceFaultInjector` — durability-level chaos for the
  multi-tenant stream service (``core/stream_service.py``): journal torn
  writes (a record file left truncated, as a crash mid-``write`` would),
  planned mid-flush crashes (:class:`InjectedCrash` raised after the engine
  call, before any state or journal commit), and the slow-tenant stall /
  burst-arrival plan the ``launch/stream_serve.py`` load generator reads.
  Its draws come from one ``numpy`` generator seeded by
  :class:`ServiceFaultSpec`, in the reference's order, so a torn-write run
  cuts the reference's records at the same bytes.
- :func:`backoff_delay` — the capped-exponential-backoff-with-jitter
  schedule shared by the supervisor's restarts, the subscriber's resend
  retries and the stream service's retry-after hints.
"""
from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np


class FailureInjector:
    """Deterministic fault injection: raise at the given steps (once each)."""

    def __init__(self, fail_at_steps=()):
        self.remaining = set(fail_at_steps)

    def maybe_fail(self, step: int):
        if step in self.remaining:
            self.remaining.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")


def backoff_delay(attempt: int, *, base: float, cap: float,
                  jitter: float, rng: np.random.Generator) -> float:
    """Capped exponential backoff with symmetric jitter.

    ``min(cap, base * 2**attempt)`` scaled by ``1 + jitter*U(-1, 1)`` —
    attempt 0 is the first retry. Jitter decorrelates replicas that failed
    on the same epoch so their resend requests don't stampede in lockstep.
    """
    if base < 0 or cap < 0 or not 0.0 <= jitter <= 1.0:
        raise ValueError(
            f"backoff_delay: base/cap must be >= 0 and 0 <= jitter <= 1 "
            f"(got base={base}, cap={cap}, jitter={jitter})")
    delay = min(cap, base * (2.0 ** attempt))
    return max(0.0, delay * (1.0 + jitter * float(rng.uniform(-1.0, 1.0))))


class FaultSpec(NamedTuple):
    """Per-frame fault probabilities + stall plan for :class:`FaultyTransport`.

    Probabilities are independent per frame; ``stall_epochs`` buffers every
    frame of those epochs and releases them (intact, in order) once an epoch
    ``>= stall_epoch + stall_release_after`` is sent — a straggling publisher
    link, not a loss.
    """
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    corrupt_p: float = 0.0
    stall_epochs: Tuple[int, ...] = ()
    stall_release_after: int = 2
    seed: int = 0

    def validate(self) -> "FaultSpec":
        for name in ("drop_p", "dup_p", "reorder_p", "corrupt_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultSpec.{name} must be in [0, 1], got {p}")
        if self.stall_release_after < 1:
            raise ValueError("FaultSpec.stall_release_after must be >= 1")
        return self


class FaultyTransport:
    """Wrap a transport with seeded frame-level faults (the chaos wire).

    Send-side only: ``poll`` passes straight through, so the injected chaos
    models the network between publisher and spool. Resend requests answered
    from the publisher's ring buffer re-enter through :meth:`send` — retried
    frames face the same lossy wire as originals.

    ``self.injected`` counts every fault applied (``drop`` / ``dup`` /
    ``reorder`` / ``corrupt`` / ``stall``) for assertions and chaos reports.
    """

    def __init__(self, inner, spec: FaultSpec):
        self.inner = inner
        self.spec = spec.validate()
        self._rng = np.random.default_rng(spec.seed)
        self._pub = None
        self._held: Optional[bytes] = None
        self._stalled: Dict[int, List[bytes]] = {}
        self._released: set = set()  # stall epochs already released once
        self.injected: "collections.Counter[str]" = collections.Counter()

    def attach_publisher(self, pub) -> None:
        self._pub = pub

    def poll(self) -> List[bytes]:
        return self.inner.poll()

    def request_resend(self, epoch: int) -> bool:
        frames = self._pub.frames_for(epoch) if self._pub is not None else None
        if not frames:
            return False
        for buf in frames:
            self.send(buf)
        return True

    def send(self, frame: bytes) -> None:
        from repro_torch.runtime.delta_sync import frame_epoch  # import cycle

        epoch = frame_epoch(frame)
        if epoch is not None:
            # release stalls whose hold window has passed
            for stalled in [e for e in self._stalled
                            if epoch >= e + self.spec.stall_release_after]:
                self._released.add(stalled)
                for buf in self._stalled.pop(stalled):
                    self.inner.send(buf)  # late but intact and in order
            # a stall triggers once per epoch: resends after the release
            # take the normal lossy path instead of re-stalling forever
            if epoch in self.spec.stall_epochs \
                    and epoch not in self._released:
                self._stalled.setdefault(epoch, []).append(frame)
                self.injected["stall"] += 1
                return
        self._deliver(frame)

    def _deliver(self, frame: bytes) -> None:
        # the draw order (drop, corrupt [+ position], dup, reorder) is the
        # reference's: one seed gives both packages the same faults
        if self._rng.random() < self.spec.drop_p:
            self.injected["drop"] += 1
            return
        if self._rng.random() < self.spec.corrupt_p:
            frame = self._corrupt(frame)
        dup = self._rng.random() < self.spec.dup_p
        if self._rng.random() < self.spec.reorder_p and self._held is None:
            self._held = frame  # delivered right after the next frame
            self.injected["reorder"] += 1
            return
        self.inner.send(frame)
        if dup:
            self.injected["dup"] += 1
            self.inner.send(frame)
        if self._held is not None:
            held, self._held = self._held, None
            self.inner.send(held)

    def _corrupt(self, frame: bytes) -> bytes:
        ba = bytearray(frame)
        # flip a byte in the latter half: payload/crc region for any
        # non-trivial frame, header json for tiny ones — either way the
        # subscriber's decode must reject it
        pos = int(self._rng.integers(len(ba) // 2, len(ba)))
        ba[pos] ^= 0xFF
        self.injected["corrupt"] += 1
        return bytes(ba)

    def flush(self) -> None:
        """Deliver everything still buffered (held reorder frame, unreleased
        stalls) — end-of-run drain so a test's tail frames aren't stranded."""
        if self._held is not None:
            held, self._held = self._held, None
            self.inner.send(held)
        for epoch in sorted(self._stalled):
            self._released.add(epoch)
            for buf in self._stalled.pop(epoch):
                self.inner.send(buf)


# ---------------------------------------------------------------------------
# stream-service chaos (core/stream_service.py)
# ---------------------------------------------------------------------------

class InjectedCrash(RuntimeError):
    """A planned crash from a :class:`ServiceFaultSpec` — the process is
    considered dead at the raise site; recovery goes through the journal."""


class ServiceFaultSpec(NamedTuple):
    """Seeded fault plan for the multi-tenant stream service.

    ``torn_write_p`` — per-record probability that the journal file lands
    truncated (the bytes a crash mid-``write`` would leave; checksums must
    catch it at recovery). ``crash_at_flush`` — 1-based flush ordinals that
    raise :class:`InjectedCrash` mid-flush: after the engine computed the
    co-flush, before any in-memory or journal commit — the point where an
    unjournaled service would lose the window. ``stall_tenants`` emit no
    arrivals in ``(stall_from, stall_until)`` (a slow tenant going cold —
    the load generator reads this); ``burst_at`` are times the generator
    compresses ``burst_factor`` windows of arrivals into one instant.
    """
    torn_write_p: float = 0.0
    crash_at_flush: Tuple[int, ...] = ()
    stall_tenants: Tuple[str, ...] = ()
    stall_from: float = 0.0
    stall_until: float = 0.0
    burst_at: Tuple[float, ...] = ()
    burst_factor: int = 1
    seed: int = 0

    def validate(self) -> "ServiceFaultSpec":
        if not 0.0 <= self.torn_write_p <= 1.0:
            raise ValueError(
                f"ServiceFaultSpec.torn_write_p must be in [0, 1], got "
                f"{self.torn_write_p}")
        if any(o < 1 for o in self.crash_at_flush):
            raise ValueError("crash_at_flush ordinals are 1-based (>= 1)")
        if self.burst_factor < 1:
            raise ValueError("ServiceFaultSpec.burst_factor must be >= 1")
        if self.stall_until < self.stall_from:
            raise ValueError("stall_until must be >= stall_from")
        return self


class ServiceFaultInjector:
    """Injection hooks the stream service calls at its durability points.

    ``self.injected`` counts every fault applied (``torn_write`` /
    ``crash``) for assertions and chaos reports; the generator-side plan
    (stalls, bursts) is read straight off ``spec`` by the load generator.
    """

    def __init__(self, spec: ServiceFaultSpec):
        self.spec = spec.validate()
        self._rng = np.random.default_rng(spec.seed)
        self._flushes = 0
        self.injected: "collections.Counter[str]" = collections.Counter()

    def mangle_record(self, buf: bytes) -> bytes:
        """Journal-write hook: with ``torn_write_p``, return a truncated
        record (cut somewhere past the magic so the damage is a checksum /
        length violation, not a missing file)."""
        if len(buf) > 8 and self._rng.random() < self.spec.torn_write_p:
            cut = int(self._rng.integers(8, len(buf)))
            self.injected["torn_write"] += 1
            return buf[:cut]
        return buf

    def maybe_crash_flush(self) -> None:
        """Flush hook: called once per co-flush, after the engine call and
        before any commit; raises on planned ordinals."""
        self._flushes += 1
        if self._flushes in self.spec.crash_at_flush:
            self.injected["crash"] += 1
            raise InjectedCrash(
                f"injected mid-flush crash at flush #{self._flushes}")

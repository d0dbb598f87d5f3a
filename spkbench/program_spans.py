"""The port's own spans (``repro_torch.obs``) over a measured window, and
the SUMMA block's device time split by stage, read from them.

:func:`switch_on` clears the port's spans and switches them on after a
synchronize; :func:`switch_off`, after the window's last synchronize,
returns the finished records with their device times resolved and
switches spans off. The readers of ``metrics/`` take those records from
``trace.program_spans``; they read nothing where the records carry no
device time (spans off, the CPU, or a program without device-timed spans).

A *block* is one ``spgemm.summa_block`` span. Records come in finish
order, so the records between one block's and the one before belong to
it. Its *leaves* (:data:`LEAVES`) are ordered and do not overlap on the
stream, and together they cover every device operation of the block; the
device time between one leaf's exit event and the next leaf's enter event
is a *gap*: the card waiting for the host, or passing from one queued leaf
to the next where the host was ahead (:func:`gaps_by_host` tells them
apart).
"""
from __future__ import annotations

from typing import Dict, List, Optional

BLOCK = "spgemm.summa_block"
#: Each leaf span of a SUMMA block, in the order of the stream.
LEAVES = ("spgemm.stage_matmul", "spgemm.from_dense", "engine.concat",
          "engine.plan", "engine.accumulate", "engine.canonical_gather",
          "spgemm.to_dense")
#: Where a gap's midpoint lies in no span of its block.
OUTSIDE = "outside the program's spans"
#: A gap that opened after the host had already recorded the next leaf's
#: enter event: the card was not waiting for the host there, but passing
#: from one queued leaf to the next (the events' and launches' own time).
QUEUED = "queued: the host was ahead"


def _sync() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def switch_on() -> None:
    """Clear the port's spans and switch them on, after a synchronize."""
    from repro_torch import obs

    _sync()
    obs.clear()
    obs.set_enabled(True)


def switch_off() -> List[dict]:
    """The spans recorded since :func:`switch_on`, device times resolved
    after a synchronize; spans are switched off and cleared."""
    from repro_torch import obs

    _sync()
    recs = obs.spans()
    obs.set_enabled(False)
    obs.clear()
    return recs


def _timed(rec: dict) -> bool:
    return rec.get("dev_ns") is not None and \
        rec.get("dev_start_ns") is not None


def blocks(records: Optional[List[dict]]) -> List[tuple]:
    """``(block, members, leaves)`` of every block whose span and leaves all
    carry device time: ``members`` are the records that finished inside
    it, ``leaves`` those of :data:`LEAVES` in device order."""
    out, members = [], []
    for rec in records or ():
        if rec["name"] != BLOCK:
            members.append(rec)
            continue
        leaves = [r for r in members if r["name"] in LEAVES]
        if _timed(rec) and leaves and all(_timed(r) for r in leaves):
            leaves.sort(key=lambda r: r["dev_start_ns"])
            out.append((rec, members, leaves))
        members = []
    return out


def leaf_ms(trace, *names: str) -> Optional[float]:
    """Device ms a block of the leaves named ``names``, averaged over the
    blocks of ``trace.program_spans``; None where no block is timed."""
    bl = blocks(getattr(trace, "program_spans", None))
    if not bl:
        return None
    ns = sum(r["dev_ns"] for _, _, leaves in bl for r in leaves
             if r["name"] in names)
    return ns / 1e6 / len(bl)


def gaps(leaves: List[dict]) -> List[tuple]:
    """``(start_ns, end_ns, next leaf)`` of the device time between
    consecutive leaves (in device order) that no leaf covers."""
    out = []
    reach = leaves[0]["dev_start_ns"] + leaves[0]["dev_ns"]
    for r in leaves[1:]:
        if r["dev_start_ns"] > reach:
            out.append((reach, r["dev_start_ns"], r))
        reach = max(reach, r["dev_start_ns"] + r["dev_ns"])
    return out


def gap_ms(trace) -> Optional[float]:
    """Device ms a block between its leaves; None where no block is
    timed."""
    bl = blocks(getattr(trace, "program_spans", None))
    if not bl:
        return None
    ns = sum(hi - lo for _, _, leaves in bl for lo, hi, _ in gaps(leaves))
    return ns / 1e6 / len(bl)


def _innermost(spans: List[dict], t: float) -> str:
    """The deepest span, then the latest to start, whose host interval
    holds ``t``; :data:`OUTSIDE` where none does."""
    open_ = [r for r in spans if r["t_ns"] <= t <= r["t_ns"] + r["dur_ns"]]
    if not open_:
        return OUTSIDE
    return max(open_, key=lambda r: (r["depth"], r["t_ns"]))["name"]


def gaps_by_host(records: Optional[List[dict]]) -> List[list]:
    """``[label, ms a block]`` pairs that split the gaps' device time; the
    largest first. A gap the card spent waiting for the host (the next
    leaf entered on the host after the card had finished the previous
    one) goes to the innermost span of the block whose host interval holds
    the gap's midpoint on the shared clock; any other gap to
    :data:`QUEUED`."""
    bl = blocks(records)
    by: Dict[str, float] = {}
    for block, members, leaves in bl:
        spans = members + [block]
        for lo, hi, nxt in gaps(leaves):
            label = QUEUED if nxt["t_ns"] <= lo else _innermost(
                spans, (lo + hi) / 2)
            by[label] = by.get(label, 0.0) + (hi - lo) / 1e6
    return sorted(([k, v / len(bl)] for k, v in by.items()),
                  key=lambda r: -r[1])

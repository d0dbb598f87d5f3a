"""Device ms a co-flush: the device time inside the ticks of the traced
window (each co-flushing tick ends in a synchronize; a tick that does not
co-flush launches nothing), over the co-flushes they ran."""


def read(trace):
    took = trace.ranges.get("spkbench.tick", [0.0])[0]
    n = trace.work.get("coflushes")
    return took * 1e3 / n if n and took else None

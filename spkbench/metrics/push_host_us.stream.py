"""Host microseconds a ``StreamService.push`` call (admission, journal,
windows), timed by the harness around each call of the window."""


def read(trace):
    xs = trace.spans.get("push_us")
    return sum(xs) / len(xs) if xs else None

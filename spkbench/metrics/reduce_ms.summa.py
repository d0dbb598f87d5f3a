"""Device ms a block of the SpKAdd reduction and the dense C tile
(``spkadd_run(...).to_dense()``): between CUDA events the harness records
at the reduction's call and after the block, over every block of the
window."""


def read(trace):
    xs = trace.spans.get("reduce_ms")
    return sum(xs) / len(xs) if xs else None

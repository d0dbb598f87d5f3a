"""Device ms a block of the stage products and their partials
(``core.spgemm.summa_partials``): between CUDA events the harness records
before the block and at the reduction's call, over every block of the
window."""


def read(trace):
    xs = trace.spans.get("partials_ms")
    return sum(xs) / len(xs) if xs else None

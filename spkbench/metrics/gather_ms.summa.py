"""Device ms a block of the reduction's canonical gather: the port's
``engine.canonical_gather`` spans, averaged over the window's
``spgemm.summa_block`` spans."""
from spkbench import program_spans


def read(trace):
    return program_spans.leaf_ms(trace, "engine.canonical_gather")

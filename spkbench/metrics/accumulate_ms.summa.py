"""Device ms a block of the reduction's accumulation: the port's
``engine.accumulate`` spans (the value gather into the padded stream and
the partition kernel's launch), averaged over the window's
``spgemm.summa_block`` spans."""
from spkbench import program_spans


def read(trace):
    return program_spans.leaf_ms(trace, "engine.accumulate")

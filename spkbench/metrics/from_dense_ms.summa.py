"""Device ms a block of the partials' conversion: the port's
``spgemm.from_dense`` spans (each stage's top-k by magnitude and key
sort), averaged over the window's ``spgemm.summa_block`` spans."""
from spkbench import program_spans


def read(trace):
    return program_spans.leaf_ms(trace, "spgemm.from_dense")

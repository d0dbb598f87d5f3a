"""Device ms a block of the dense C tile: the port's ``spgemm.to_dense``
spans (a second sort of the reduced slots and their fold), averaged over
the window's ``spgemm.summa_block`` spans."""
from spkbench import program_spans


def read(trace):
    return program_spans.leaf_ms(trace, "spgemm.to_dense")

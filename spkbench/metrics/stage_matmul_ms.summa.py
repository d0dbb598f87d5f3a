"""Device ms a block of the stage products: the port's
``spgemm.stage_matmul`` spans (the stripe slices and the f32 product),
averaged over the window's ``spgemm.summa_block`` spans."""
from spkbench import program_spans


def read(trace):
    return program_spans.leaf_ms(trace, "spgemm.stage_matmul")

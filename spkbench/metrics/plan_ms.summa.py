"""Device ms a block of the reduction's plan: the port's ``engine.concat``
(the 16 partials concatenated) and ``engine.plan`` spans (the plan's stable
sort and the step tables), averaged over the window's
``spgemm.summa_block`` spans."""
from spkbench import program_spans


def read(trace):
    return program_spans.leaf_ms(trace, "engine.concat", "engine.plan")

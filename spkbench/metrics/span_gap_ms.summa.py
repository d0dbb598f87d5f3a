"""Device ms a block that no leaf span covers: between one leaf's exit
event and the next leaf's enter event in a ``spgemm.summa_block`` span,
averaged over the window's blocks. The card waiting for the host there,
or passing from one queued leaf to the next; ``program_spans.gaps_by_host``
splits the two."""
from spkbench import program_spans


def read(trace):
    return program_spans.gap_ms(trace)

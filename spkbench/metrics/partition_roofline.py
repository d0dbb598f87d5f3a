"""The partition kernel's (``csrc/partition.cu``, ``partitioned_kernel``)
share of its roofline, in percent: its inputs' valid keys and values read
once and its dense accumulator written once, over 3.35 TB/s, against the
kernel's device time in the traced window."""
from spkbench.reference import roofline


def read(trace):
    nbytes = trace.work.get("partition.bytes")
    took = trace.kernel_s("partitioned_kernel")
    if not nbytes or not took:
        return None
    return roofline.share_pct(roofline.bound_s(nbytes=nbytes), took)

"""The sliding-hash launch's (``csrc/hash_slide.cu``) share of its
roofline, in percent: the keys and values its inputs hold, read once, and
one key and value a distinct key of its output, written once, over 3.35
TB/s, against the device time of the library's kernels in the traced
window: ``hash_slide_kernel`` and the bucketing's (``csrc/radix_bucket.cuh``
with ``SlideBucket``, and its scans, which no other library runs in this
cell). The tables' empty slots do not count: they are the kernel's own
waste."""
from spkbench.reference import roofline

KERNELS = ("hash_slide_kernel", "SlideBucket", "rb_scan_reduce_kernel",
           "rb_scan_apply_kernel")


def read(trace):
    nbytes = trace.work.get("hash_slide.bytes")
    took = trace.kernel_s(*KERNELS)
    if not nbytes or not took:
        return None
    return roofline.share_pct(roofline.bound_s(nbytes=nbytes), took)

"""The stage products' share of the f32 roofline, in percent: the dense
products' operations (2 m k n each, 16 a block) over 67 TFLOP/s, against
the device time of the cuBLAS f32 product kernels (names holding
``gemm``; TF32 off) in the traced window."""
from spkbench.reference import roofline


def read(trace):
    flops = trace.work.get("stage_matmul.flops")
    took = trace.kernel_s("gemm")
    if not flops or not took:
        return None
    return roofline.share_pct(roofline.bound_s(flops=flops), took)

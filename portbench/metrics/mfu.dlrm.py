"""mfu.dlrm: model FLOPs (the MLPs and the interaction's upper triangle,
forward and backward, no recompute) of every iteration of the timed window
over its whole time x 67 TFLOP/s (f32 outside the tensor cores; the
program runs f32 with TF32 off), host clock."""
from portbench.reference.peaks import F32_FLOPS
from portbench.reference.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, F32_FLOPS)

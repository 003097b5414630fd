"""mfu_p95.dlrm: one iteration's model FLOPs over step_ms.p95 x 67 TFLOP/s,
host clock."""
from portbench.reference.peaks import F32_FLOPS
from portbench.reference.readers import p95


def read(rec):
    xs = rec.get("iter_s")
    if not xs or len(xs) < 2:
        return None
    return 100.0 * rec["flops_per_iter"] / p95(xs) / F32_FLOPS

"""mfu.lm: model FLOPs (6·N·tokens with the tied head, plus 12·L·H·Q·T a
token, no recompute) of every step of the timed window over its whole
time, syncs included, x 989 TFLOP/s (bf16 tensor cores), host clock."""
from portbench.reference.peaks import BF16_FLOPS
from portbench.reference.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, BF16_FLOPS)

"""k1_roofline: K1 (embedding bag, ``embeddings/table.py::lookup``) over
the traced window: the least time its bytes (each distinct row read once,
the ids, the pooled bags written) and adds allow at the data-sheet peaks,
over its device time."""
from portbench.reference.peaks import F32_FLOPS
from portbench.reference.readers import roofline_pct

KERNELS = ("embedding_bag_kernel",)


def read(rec):
    return roofline_pct(rec, "k1", KERNELS, F32_FLOPS)

"""k2_roofline: K2 (sparse Adagrad,
``embeddings/table.py::sparse_adagrad_update_fused``, its two kernels) over
the traced window: the least time its bytes (the bag gradients, the ids,
each distinct row's table and accumulator read and written once) and
operations allow, over its device time."""
from portbench.reference.peaks import F32_FLOPS
from portbench.reference.readers import roofline_pct

KERNELS = ("sparse_adagrad_tile_kernel", "sparse_adagrad_combine_kernel")


def read(rec):
    return roofline_pct(rec, "k2", KERNELS, F32_FLOPS)

"""k3_us.dlrm: device microseconds of K3 (EASGD's landing,
``core/algorithms.py::EASGD.land_flat`` -> ``easgd_round_kernel``) a
landing over the traced window, the landings counted by replaying the
shadow clocks. Not a roofline share: the five planes a one-replica landing
moves (48 MB at this cell's dense size) fit in the card's 50 MB L2 cache,
so the kernel beats the HBM bound that a roofline would divide by."""
from portbench.reference.readers import kernel_s

KERNELS = ("easgd_round_kernel",)


def read(rec):
    t = kernel_s(rec, KERNELS)
    if t is None or not rec.get("trace_landings"):
        return None
    return 1e6 * t / rec["trace_landings"]

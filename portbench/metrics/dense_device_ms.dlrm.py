"""dense_device_ms.dlrm: device ms an iteration outside K1-K3 and outside
the harness's own batch draw: the dense step (MLPs, interaction, autograd,
Adagrad), the flat engine's pack and unpack, and the sync's gathers;
device trace."""
from portbench.reference.readers import kernel_s

K1_K3 = ("embedding_bag_kernel", "sparse_adagrad_tile_kernel", "sparse_adagrad_combine_kernel",
         "easgd_round_kernel")


def read(rec):
    summ = rec.get("trace")
    if not summ:
        return None
    total = sum(t for t, _ in summ["kernels"].values())
    rest = total - (kernel_s(rec, K1_K3) or 0.0) - summ["harness_s"]
    return 1e3 * rest / rec["trace_iters"]

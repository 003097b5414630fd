"""launches_per_iter.dlrm: device launches (kernels, copies, sets) an
iteration of the traced window; the runner's dispatch, device trace."""


def read(rec):
    summ = rec.get("trace")
    return summ["launches"] / rec["trace_iters"] if summ else None

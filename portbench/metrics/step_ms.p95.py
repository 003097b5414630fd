"""step_ms.p95: the 95th percentile of every iteration of the timed window,
host clock (``on_iter`` stamps, each after the iteration's loss is read)."""
from portbench.reference.readers import p95


def read(rec):
    xs = rec.get("iter_s")
    return 1e3 * p95(xs) if xs and len(xs) > 1 else None

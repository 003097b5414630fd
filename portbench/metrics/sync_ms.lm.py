"""sync_ms.lm: the mean time of the timed window's syncs
(``core/spmd.py::make_sync_step`` -> ``core/sync.py``), host clock between
two synchronises."""


def read(rec):
    xs = rec.get("sync_s")
    return 1e3 * sum(xs) / len(xs) if xs else None

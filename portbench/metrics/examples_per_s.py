"""examples_per_s: every example trained in the timed window over all of
its time, host clock."""


def read(rec):
    return rec["examples"] / rec["window_s"] if "examples" in rec else None

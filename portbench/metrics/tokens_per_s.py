"""tokens_per_s: every token trained in the timed window over all of its
time, syncs included, host clock."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if "tokens" in rec else None

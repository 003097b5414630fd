"""peak_mem_gb.lm: ``torch.cuda.max_memory_allocated`` over the timed
window, in GB (1e9 bytes)."""


def read(rec):
    return rec["window_peak_bytes"] / 1e9 if rec.get("window_peak_bytes") else None

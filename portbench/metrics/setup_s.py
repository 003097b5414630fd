"""setup_s: process start to the first timed iteration (imports, builds,
weights and inputs, the checked steps and the warm-up), host clock."""


def read(rec):
    return rec["setup_s"]

"""idle_share.dlrm: the share of the traced window in which no device
operation ran, device trace."""
from portbench.reference.readers import idle_pct


def read(rec):
    return idle_pct(rec)

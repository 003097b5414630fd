"""Partition rules and the activation context (``rules.py``, ``ctx.py``),
the twin of ``repro/sharding``: plain spec data, read by the dry run."""

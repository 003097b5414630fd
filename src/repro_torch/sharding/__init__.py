"""Partition rules and the activation context (``rules.py``, ``ctx.py``),
the twin of ``repro/sharding``: specs as data, DTensor placements on a
device mesh, and the constraints model code asks for."""

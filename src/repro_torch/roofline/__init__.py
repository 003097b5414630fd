"""Parameter counts and model FLOPs (``params.py``, ``analysis.py``), the
twin of ``repro/roofline``'s arithmetic over ``ArchConfig``."""

"""Parameter counts, model FLOPs and the one-card roofline terms
(``params.py``, ``analysis.py``), the twin of ``repro/roofline``."""

"""Model FLOPs from ArchConfig (the reference's ``repro/roofline/analysis.py``
holds this and the roofline terms).

Only ``model_flops_estimate`` is ported here. The ``Roofline`` terms with the
H100's constants, and the parser of XLA's HLO for collective bytes, are
ROADMAP queue 1 item 9b.
"""
from __future__ import annotations


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D with N = active params (MoE: non-expert + top_k/E of experts),
    for every family as the reference counts it (whisper's encoder and
    decoder parameters together). Decode shapes: D = global_batch tokens
    (one step); others global_batch * seq_len; 2*N*D outside training."""
    from repro_torch.roofline.params import active_param_count

    n_active = active_param_count(cfg)
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens

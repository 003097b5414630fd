"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,  # GQA kv=8
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=128, n_groups=8, chunk=256),
    # 1 attention layer per 8 (1:7 mamba:attn interleave), attn at position 3.
    layer_pattern="MMMAMMMM",
    source="arXiv:2403.19887 (Jamba-1.5)",
)

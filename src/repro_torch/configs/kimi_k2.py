"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,  # GQA kv=8
    d_ff=2048,  # per-expert FFN width (per assignment table)
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, every=1, n_shared_experts=1),
    source="arXiv:2501.kimi2 (Kimi K2)",
)

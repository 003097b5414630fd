"""minicpm-2b — WSD schedule, llama-like arch, MHA [arXiv:2404.06395]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,  # MHA
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    source="arXiv:2404.06395 (MiniCPM)",
)

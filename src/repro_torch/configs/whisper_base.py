"""whisper-base — enc-dec, conv/mel frontend is a stub [arXiv:2212.04356].

The TRANSFORMER backbone only: 6 encoder + 6 decoder layers; input_specs() provides
precomputed frame embeddings (1500 frames = 30 s at 50 Hz after the conv stack).
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig, FrontendConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder=EncoderConfig(n_layers=6, n_ctx=1500),
    frontend=FrontendConfig(kind="audio", n_tokens=1500),
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    source="arXiv:2212.04356 (Whisper base)",
)

"""llava-next-34b — VLM backbone, anyres tiling; vision tower is a stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf]. The LANGUAGE backbone only — input_specs()
provides precomputed patch embeddings (anyres: base 576 + 4 tiles x 576 = 2880).
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,  # GQA kv=8
    d_ff=20480,
    vocab_size=64000,
    frontend=FrontendConfig(kind="vision", n_tokens=2880),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (LLaVA-NeXT, anyres)",
)

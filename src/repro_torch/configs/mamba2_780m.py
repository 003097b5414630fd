"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,  # ssm heads: expand*d_model/headdim = 2*1536/64
    n_kv_heads=48,
    d_ff=0,  # attn-free, no MLP block (mamba2 block is the mixer+ff in one)
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, n_groups=1, chunk=256),
    layer_pattern="M",
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2, SSD)",
)

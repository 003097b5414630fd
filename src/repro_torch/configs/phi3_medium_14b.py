"""phi3-medium-14b — RoPE SwiGLU GQA [arXiv:2404.14219].

Beyond-paper extra: we expose a sliding-window variant (window 4096) so this dense
arch can run the long_500k decode shape sub-quadratically (see DESIGN.md §4).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,  # GQA kv=10
    d_ff=17920,
    vocab_size=100352,
    source="arXiv:2404.14219 (Phi-3 Medium)",
)

# Sliding-window variant used only for the long_500k decode shape.
CONFIG_SWA = dataclasses.replace(CONFIG, sliding_window=4096)

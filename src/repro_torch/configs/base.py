"""Architecture configuration system (the port's own copy of the JAX
package's ``configs/base.py``: plain data, so both resolve the same ids).

Every assigned architecture gets one module in this package exporting CONFIG.
``get_config(name)`` resolves by arch id, ``reduced(cfg)`` produces the smoke-test
variant (<=2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

ARCH_IDS = (
    "mamba2-780m",
    "jamba-1.5-large-398b",
    "granite-34b",
    "phi3-medium-14b",
    "kimi-k2-1t-a32b",
    "minicpm-2b",
    "llava-next-34b",
    "whisper-base",
    "granite-20b",
    "phi3.5-moe-42b-a6.6b",
)

_MODULE_FOR = {
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "granite-34b": "granite_34b",
    "phi3-medium-14b": "phi3_medium_14b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "minicpm-2b": "minicpm_2b",
    "llava-next-34b": "llava_next_34b",
    "whisper-base": "whisper_base",
    "granite-20b": "granite_20b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "dlrm-ctr": "dlrm_ctr",
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # Every ``every``-th layer is MoE (1 = all layers). Jamba uses 2.
    every: int = 1
    n_shared_experts: int = 0
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 1e-3
    dt_max: float = 1e-1


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) models."""

    n_layers: int = 6
    n_ctx: int = 1500  # frames after the (stubbed) conv frontend


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend: input_specs() provides precomputed embeddings."""

    kind: str  # "vision" | "audio"
    n_tokens: int  # patch/frame embeddings prepended / consumed


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Per-layer kind pattern, tiled over n_layers: 'A' attention, 'M' mamba.
    layer_pattern: str = "A"
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # PaLM-style parallel block: y = x + mixer(norm(x)) + ffn(norm(x)).
    # Beyond-paper perf variant: both branches' partial sums share ONE
    # tensor-parallel all-reduce per layer instead of two (see §Perf).
    parallel_block: bool = False
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.layer_pattern
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.n_layers])

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        # Jamba convention: MoE on odd layer indices when every=2.
        return (i % self.moe.every) == (self.moe.every - 1)

    def supports_long_context(self) -> bool:
        """True when serve_step at 500k context is sub-quadratic."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders (whisper: enc-dec)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    updates = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64,
        dtype="float32",
    )
    updates["n_kv_heads"] = min(cfg.n_kv_heads, updates["n_heads"])
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 256),
            # Dropless in smoke tests so decode == forward exactly.
            capacity_factor=float(cfg.moe.n_experts),
        )
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 32), headdim=32, chunk=32
        )
    if cfg.encoder is not None:
        updates["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2, n_ctx=64)
    if cfg.frontend is not None:
        updates["frontend"] = dataclasses.replace(cfg.frontend, n_tokens=16)
    if cfg.sliding_window is not None:
        updates["sliding_window"] = min(cfg.sliding_window, 64)
    # Keep the hybrid pattern but 2 layers: one mamba + one attention.
    if cfg.family == "hybrid":
        updates["layer_pattern"] = "MA"
    return dataclasses.replace(cfg, **updates)

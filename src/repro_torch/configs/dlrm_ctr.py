"""DLRM CTR model — the paper's own architecture [arXiv:1906.00091 / ShadowSync §3].

Criteo-like: 13 dense features, 26 categorical features. Table sizes follow a
power-law mix so the embedding-PS bin-packing layer has real work to do.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-ctr"
    family: str = "dlrm"
    n_dense_features: int = 13
    n_sparse_features: int = 26
    embedding_dim: int = 64
    # Rows per categorical table (power-law: a few huge, many small).
    table_sizes: Tuple[int, ...] = (
        4_000_000, 2_000_000, 1_000_000, 800_000, 400_000, 200_000,
        100_000, 100_000, 60_000, 60_000, 40_000, 40_000, 20_000,
        20_000, 10_000, 10_000, 10_000, 4_000, 4_000, 2_000,
        2_000, 1_000, 1_000, 500, 200, 100,
    )
    # Multi-hot lookups per feature (pooled).
    multi_hot: int = 4
    bottom_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 256, 1)
    interaction: str = "dot"  # pairwise dot-product interaction
    dtype: str = "float32"
    source: str = "arXiv:1906.00091 (DLRM); ShadowSync paper §3"

    @property
    def n_embedding_rows(self) -> int:
        return sum(self.table_sizes)


CONFIG = DLRMConfig()


def tiny(embedding_dim: int = 16) -> DLRMConfig:
    """Laptop-scale DLRM used by tests/examples."""
    from dataclasses import replace

    return replace(
        CONFIG,
        embedding_dim=embedding_dim,
        table_sizes=(1000, 800, 600, 400, 200, 100, 50, 20),
        n_sparse_features=8,
        multi_hot=2,
        bottom_mlp=(64, embedding_dim),
        top_mlp=(64, 32, 1),
    )

"""Plain PyTorch version of the embedding-bag kernel (twin of the JAX ref)."""
import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (rows, d); idx: (n_bags, m) -> (n_bags, d) sum-pooled, fp32."""
    return table[idx.long()].float().sum(1)

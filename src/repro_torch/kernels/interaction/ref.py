"""Plain PyTorch version of the interaction kernel (twin of the JAX ref; equal
to the dot part of ``models.dlrm.interact``)."""
import torch


def interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, d) -> (B, F*(F-1)/2) f32 upper-triangle pairwise dots, i < j
    in ``np.triu_indices`` order."""
    zf = z.float()
    gram = torch.einsum("bfd,bgd->bfg", zf, zf)
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], offset=1, device=z.device)
    return gram[:, iu, ju]

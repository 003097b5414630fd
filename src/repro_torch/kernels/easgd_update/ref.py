"""Plain PyTorch version of the EASGD round kernel (twin of the JAX ref).

Updates ``stack`` and ``w_ps`` in place, as the kernel does."""
import torch


def easgd_round_ref(stack: torch.Tensor, w_ps: torch.Tensor, snapshot: torch.Tensor,
                    fired: torch.Tensor, alpha: float):
    """Sequential masked round: stack (R, n, 128); snapshot (F, n, 128) holds
    the FIRED replicas' launch copies, positionally aligned with ``fired``
    (replica ids in exchange order). Returns (stack, w_ps)."""
    ps = w_ps.float()
    for k, i in enumerate(fired.tolist()):
        ps = (1 - alpha) * ps + alpha * snapshot[k].float()
        stack[i] = ((1 - alpha) * stack[i].float() + alpha * ps).to(stack.dtype)
    w_ps.copy_(ps)
    return stack, w_ps

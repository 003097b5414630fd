"""Plain PyTorch versions of the EASGD kernels (twins of the JAX refs).

``easgd_round_ref`` updates ``stack`` and ``w_ps`` in place, as its kernel
does; ``easgd_update_ref`` returns two new planes, as its kernel does."""
import torch


def easgd_update_ref(w_ps: torch.Tensor, w_i: torch.Tensor, alpha: float):
    ps = w_ps.float()
    wi = w_i.float()
    new_ps = (1 - alpha) * ps + alpha * wi
    new_wi = (1 - alpha) * wi + alpha * new_ps
    return new_ps.to(w_ps.dtype), new_wi.to(w_i.dtype)


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

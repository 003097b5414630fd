"""Plain PyTorch versions of the gossip kernels (twins of the JAX refs, which
are ``core.algorithms.Gossip``'s tree math on flat replica buffers).

``gossip_pair_ref`` returns two new planes, as its kernel does;
``gossip_round_ref`` updates ``stack`` in place, as its kernel does."""
import torch


def gossip_pair_ref(w_a: torch.Tensor, w_b: torch.Tensor, alpha: float):
    a, b = w_a.float(), w_b.float()
    mix = 0.5 * (a + b)
    new_a = (1.0 - alpha) * a + alpha * mix
    new_b = (1.0 - alpha) * b + alpha * mix
    return new_a.to(w_a.dtype), new_b.to(w_b.dtype)


def gossip_round_ref(stack: torch.Tensor, snapshot: torch.Tensor, land: torch.Tensor,
                     self_pos: torch.Tensor, partner_pos: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """Pair landings on a (R, n, 128) buffer. ``snapshot`` is the (F, n, 128)
    launch gather; ``land``/``self_pos``/``partner_pos`` are (P,) index
    vectors: each participant's row, and its own and its partner's position
    in the snapshot."""
    if land.shape[0] == 0:
        return stack
    r = land.long()
    mix = 0.5 * (snapshot[self_pos.long()].float() + snapshot[partner_pos.long()].float())
    stack[r] = ((1.0 - alpha) * stack[r].float() + alpha * mix).to(stack.dtype)
    return stack

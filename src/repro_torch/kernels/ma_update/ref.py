"""Plain PyTorch versions of the Model-Averaging kernels (twins of the JAX
refs, which are ``core.sync.ma_round`` on flat replica buffers).

The means return new planes. The pull-backs update ``stack`` in place, as
their kernel does (the TPU kernels alias it), or write ``out`` when one is
given, and return what they wrote."""
import torch


def replica_mean_ref(stack: torch.Tensor) -> torch.Tensor:
    return stack.float().mean(0)


def replica_mean_rows_ref(stack: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Mean over the live rows only: the elastic-membership denominator."""
    return stack[rows.long()].float().mean(0)


def ma_update_ref(stack: torch.Tensor, mean: torch.Tensor, alpha: float,
                  out: torch.Tensor = None) -> torch.Tensor:
    new = (1.0 - alpha) * stack.float() + alpha * mean[None].float()
    dst = stack if out is None else out
    return dst.copy_(new.to(dst.dtype))


def ma_update_rows_ref(stack: torch.Tensor, mean: torch.Tensor, rows: torch.Tensor,
                       alpha: float) -> torch.Tensor:
    """Pull only the live rows toward ``mean``; dead rows are untouched."""
    r = rows.long()
    new = (1.0 - alpha) * stack[r].float() + alpha * mean[None].float()
    stack[r] = new.to(stack.dtype)
    return stack

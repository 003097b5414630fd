"""Plain PyTorch versions of the BMUF landing (twins of the JAX refs, which
are ``core.sync.bmuf_round`` given a precomputed snapshot mean, on flat
replica buffers).

Like their kernel they update ``stack`` (the listed rows), ``w_global`` and
``velocity`` in place, and return the three."""
import torch


def _global_step(mean, w_global, velocity, eta, block_momentum, nesterov, scale):
    desc = mean.float() - w_global
    vel = block_momentum * velocity + eta * scale * desc
    wg = w_global + vel
    look = wg + block_momentum * vel if nesterov else wg
    w_global.copy_(wg)
    velocity.copy_(vel)
    return look


def bmuf_update_ref(stack, mean, w_global, velocity, alpha, *, eta=1.0, block_momentum=0.0,
                    nesterov=False, scale=1.0):
    look = _global_step(mean, w_global, velocity, eta, block_momentum, nesterov, scale)
    new = (1.0 - alpha) * stack.float() + alpha * look[None]
    stack.copy_(new.to(stack.dtype))
    return stack, w_global, velocity


def bmuf_update_rows_ref(stack, mean, w_global, velocity, rows, alpha, *, eta=1.0,
                         block_momentum=0.0, nesterov=False, scale=1.0):
    """Elastic-membership landing: the global step is unchanged, the elastic
    pull-back touches only the live ``rows``."""
    look = _global_step(mean, w_global, velocity, eta, block_momentum, nesterov, scale)
    r = rows.long()
    new = (1.0 - alpha) * stack[r].float() + alpha * look[None]
    stack[r] = new.to(stack.dtype)
    return stack, w_global, velocity

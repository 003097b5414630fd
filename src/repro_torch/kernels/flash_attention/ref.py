"""Plain PyTorch versions of the flash-attention kernel: ``attention_ref``
(twin of the JAX ref) and ``gqa_attention_ref``, the JAX wrapper's
``use_pallas=False`` path on (B, S, H, d)."""
import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, d). Scores, softmax and the product in f32; the result
    in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, d); k, v: (B, S, Hkv, d). KV heads repeated, (B, H)
    folded, ``attention_ref``, unfolded."""
    B, S, H, d = q.shape
    n_rep = H // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, d)

    out = attention_ref(fold(q), fold(k), fold(v), causal=causal)
    return out.reshape(B, H, S, d).transpose(1, 2)

"""Losses: the port of ops/losses.py.

`chunked_softmax_cross_entropy` runs the tied head chunk by chunk so the
[B, T, V] f32 logits never exist at once (2 GiB at B=16, T=1024,
V=32768), and recomputes each chunk's probabilities in the backward
from the saved per-token logsumexp, the custom VJP of the JAX package
(`softmax - onehot`). The `lax.scan` over chunks becomes a Python loop;
a T that the chunk does not divide ends with a shorter chunk, where the
JAX package pads. Plain PyTorch: there is no Pallas kernel here.
"""
import typing as tp

import torch
import torch.nn.functional as F


def _chunk_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """f32 logits of one chunk: operands in x's dtype, f32 accumulation
    (the dense head's scheme)."""
    return x.float() @ head.to(x.dtype).float().t()


class _ChunkedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head, labels, chunk_size):
        losses, lses = [], []
        for c0 in range(0, hidden.shape[1], chunk_size):
            logits = _chunk_logits(hidden[:, c0:c0 + chunk_size], head)
            lse = torch.logsumexp(logits, dim=-1)
            correct = torch.gather(logits, -1,
                                   labels[:, c0:c0 + chunk_size, None].long())
            losses.append(lse - correct[..., 0])
            lses.append(lse)
        ctx.save_for_backward(hidden, head, labels, torch.cat(lses, dim=1))
        ctx.chunk_size = chunk_size
        return torch.cat(losses, dim=1)

    @staticmethod
    def backward(ctx, grad):
        hidden, head, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk_size
        head_c = head.to(hidden.dtype).float()
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        dxs = []
        for c0 in range(0, hidden.shape[1], chunk):
            x = hidden[:, c0:c0 + chunk]
            logits = _chunk_logits(x, head)
            # d(lse - correct)/dlogits = softmax - onehot(label); the saved
            # logsumexp removes the second full reduction
            probs = torch.exp(logits - lse[:, c0:c0 + chunk, None])
            onehot = F.one_hot(labels[:, c0:c0 + chunk].long(),
                               head.shape[0]).to(probs.dtype)
            dlogits = (probs - onehot) * grad[:, c0:c0 + chunk, None].float()
            dl = dlogits.to(hidden.dtype).float()
            dxs.append(dl @ head_c)
            dhead = dhead + torch.einsum("bcv,bcd->vd", dl, x.float())
        dx = torch.cat(dxs, dim=1).to(hidden.dtype)
        return dx, dhead.to(head.dtype), None, None


def chunked_softmax_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                                  labels: torch.Tensor,
                                  chunk_size: int = 256) -> torch.Tensor:
    """Per-token CE of a tied/linear LM head without full logits.

    hidden [B, T, D] (compute dtype), head [V, D] (grads come back in its
    dtype), labels [B, T] int. Returns [B, T] f32 per-token
    `logsumexp(logits) - logits[label]`; reduce at the call site.
    """
    return _ChunkedCrossEntropy.apply(hidden, head, labels, chunk_size)


def lm_next_token_loss(model: tp.Callable, tokens: torch.Tensor, *,
                       mode: str = "dense", chunk_size: int = 256,
                       aux_weight: tp.Optional[float] = None
                       ) -> torch.Tensor:
    """Mean next-token CE of a TransformerLM, dense or chunked head.

    'dense' materializes the [B, T, V] f32 logits; 'chunked' runs
    `chunked_softmax_cross_entropy` over the final hidden states. Both
    are the same math. With `aux_weight` (an MoE model; dense only) the
    loss adds `aux_weight` times the MoE layers' load-balancing loss.
    """
    if mode not in ("dense", "chunked"):
        raise ValueError(f"mode must be 'dense' or 'chunked', got {mode!r}")
    if mode == "dense":
        if aux_weight is None:
            logits, aux = model(tokens), None
        else:
            logits, aux = model(tokens, return_aux=True)
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                             tokens[:, 1:].reshape(-1).long())
        return ce if aux is None else ce + aux_weight * aux
    if aux_weight is not None:
        raise ValueError("the chunked loss takes no MoE aux loss")
    hidden, head = model(tokens, return_hidden=True)
    return chunked_softmax_cross_entropy(hidden[:, :-1], head, tokens[:, 1:],
                                         chunk_size).mean()

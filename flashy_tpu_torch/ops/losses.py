"""Losses: the port of ops/losses.py.

`chunked_softmax_cross_entropy` runs the tied head chunk by chunk so the
[B, T, V] f32 logits never exist at once (2 GiB at B=16, T=1024,
V=32768), and recomputes each chunk's probabilities in the backward
from the saved per-token logsumexp, the custom VJP of the JAX package
(`softmax - onehot`). The `lax.scan` over chunks becomes a Python loop;
a T that the chunk does not divide ends with a shorter chunk, where the
JAX package pads. Plain PyTorch: there is no Pallas kernel here.

`head_matmul` is every product of the tied head, here, in the model's
dense head (`tied_head`) and in the decode steps: operands in the
compute dtype, f32 accumulation and output, as the JAX package's
`preferred_element_type=jnp.float32` einsums run them.
"""
import typing as tp

import torch
import torch.nn.functional as F


def head_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] -> f32 [..., N], both operands in the model's
    compute dtype: the tied head's products. bf16 operands on CUDA run on
    the tensor cores with f32 output (`torch.mm`'s `out_dtype`; the
    products of bf16 values are exact in f32, so only the order of the
    sums differs from an f32 product). On the CPU, and for f32 operands
    everywhere, it is the f32 product of the operands widened exactly (f32
    x f32 on CUDA runs in full f32 unless the caller turns TF32 on). A
    bf16-output product cast to f32 would round the logits; this never
    does."""
    if a.dtype != b.dtype:
        raise ValueError(f"head_matmul: operand dtypes differ ({a.dtype}, "
                         f"{b.dtype}); cast both to the compute dtype")
    flat = a.reshape(-1, a.shape[-1])
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        out = torch.mm(flat, b, out_dtype=torch.float32)
    else:
        out = flat.float() @ b.float()
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _TiedHead(torch.autograd.Function):
    """The dense tied head: f32 logits of x against the embedding cast to
    x's dtype. The backward rounds dlogits to x's dtype and runs dX and
    dEmbed through `head_matmul`, as the JAX package's chunked VJP does;
    dEmbed comes back in the embedding's dtype."""

    @staticmethod
    def forward(ctx, x, embed):
        head = embed.to(x.dtype)
        ctx.save_for_backward(x, head)
        ctx.embed_dtype = embed.dtype
        return head_matmul(x, head.t())

    @staticmethod
    def backward(ctx, grad):
        x, head = ctx.saved_tensors
        dl = grad.to(x.dtype)
        dx = head_matmul(dl, head).to(x.dtype)
        flat_x = x.reshape(-1, x.shape[-1])
        dhead = head_matmul(flat_x.t(), dl.reshape(-1, dl.shape[-1])).t()
        return dx, dhead.to(ctx.embed_dtype)


def tied_head(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """f32 logits [..., V] of final hidden states x [..., D] (compute
    dtype) against the tied embedding [V, D] (any dtype; cast to x's)."""
    return _TiedHead.apply(x, embed)


def _chunk_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """f32 logits of one chunk: operands in x's dtype, f32 accumulation
    (the dense head's scheme)."""
    return head_matmul(x, head.to(x.dtype).t())


def _chunk_stats(logits: torch.Tensor, labels: torch.Tensor,
                 mesh: tp.Any) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(per-token loss, logsumexp) of one chunk's f32 logits [B, c, V]
    (with a vocab-parallel `mesh`, the rank's [B, c, V/T] columns, the
    statistics all-reduced over 'tensor')."""
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        correct = torch.gather(logits, -1, labels[..., None].long())
        return lse - correct[..., 0], lse
    from ..parallel.tensor import _vocab_stats
    flat = logits.reshape(-1, logits.shape[-1])
    top, log_sums, target = _vocab_stats(flat, labels.reshape(-1), mesh)
    return ((log_sums - target).view(labels.shape),
            (top + log_sums).view(labels.shape))


def _chunk_onehot(labels: torch.Tensor, cols: int, mesh: tp.Any,
                  dtype: torch.dtype) -> torch.Tensor:
    if mesh is None:
        return F.one_hot(labels.long(), cols).to(dtype)
    from ..parallel.tensor import _onehot_local
    return _onehot_local(labels, cols, mesh, dtype)


class _ChunkedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head, labels, chunk_size, mesh):
        losses, lses = [], []
        for c0 in range(0, hidden.shape[1], chunk_size):
            logits = _chunk_logits(hidden[:, c0:c0 + chunk_size], head)
            loss, lse = _chunk_stats(logits, labels[:, c0:c0 + chunk_size],
                                     mesh)
            losses.append(loss)
            lses.append(lse)
        ctx.save_for_backward(hidden, head, labels, torch.cat(lses, dim=1))
        ctx.chunk_size = chunk_size
        ctx.mesh = mesh
        return torch.cat(losses, dim=1)

    @staticmethod
    def backward(ctx, grad):
        hidden, head, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk_size
        head_c = head.to(hidden.dtype)
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        dxs = []
        for c0 in range(0, hidden.shape[1], chunk):
            x = hidden[:, c0:c0 + chunk]
            logits = _chunk_logits(x, head)
            # d(lse - correct)/dlogits = softmax - onehot(label); the saved
            # logsumexp removes the second full reduction
            probs = torch.exp(logits - lse[:, c0:c0 + chunk, None])
            onehot = _chunk_onehot(labels[:, c0:c0 + chunk], head.shape[0],
                                   ctx.mesh, probs.dtype)
            dlogits = (probs - onehot) * grad[:, c0:c0 + chunk, None].float()
            # operands in the compute dtype, f32 accumulation
            dl = dlogits.to(hidden.dtype)
            dxs.append(head_matmul(dl, head_c))
            dhead = dhead + head_matmul(
                dl.reshape(-1, dl.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        dx = torch.cat(dxs, dim=1).to(hidden.dtype)
        return dx, dhead.to(head.dtype), None, None, None


def chunked_softmax_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                                  labels: torch.Tensor,
                                  chunk_size: int = 256,
                                  mesh: tp.Any = None) -> torch.Tensor:
    """Per-token CE of a tied/linear LM head without full logits.

    hidden [B, T, D] (compute dtype), head [V, D] (grads come back in its
    dtype), labels [B, T] int. Returns [B, T] f32 per-token
    `logsumexp(logits) - logits[label]`; reduce at the call site. With a
    vocab-parallel `mesh` (a 'tensor' axis above 1) `head` is the rank's
    [V/T, D] rows: each chunk's statistics are all-reduced over 'tensor'
    as `parallel.tensor.vocab_parallel_cross_entropy` reduces them, and
    the hidden states' gradient is the rank's partial sum (pass `hidden`
    through `copy_to_tensor`, which sums it).
    """
    from ..parallel.tensor import tensor_width
    if tensor_width(mesh) == 1:
        mesh = None
    return _ChunkedCrossEntropy.apply(hidden, head, labels, chunk_size, mesh)


def lm_next_token_loss(model: tp.Callable, tokens: torch.Tensor, *,
                       mode: str = "dense", chunk_size: int = 256,
                       aux_weight: tp.Optional[float] = None,
                       vocab_mesh: tp.Any = None,
                       **model_kwargs: tp.Any) -> torch.Tensor:
    """Mean next-token CE of a TransformerLM, dense or chunked head.

    'dense' materializes the [B, T, V] f32 logits; 'chunked' runs
    `chunked_softmax_cross_entropy` over the final hidden states. Both
    are the same math. With `aux_weight` (an MoE model; dense only) the
    loss adds `aux_weight` times the MoE layers' load-balancing loss.
    `vocab_mesh` is the mesh of a model cut over 'tensor' (its logits
    the rank's V/T columns): the dense loss is then
    `vocab_parallel_cross_entropy` and the chunked one runs on the
    rank's embedding rows. `model_kwargs` go to the model's forward
    (`train=True, dropout_seed=s` for dropout).
    """
    if mode not in ("dense", "chunked"):
        raise ValueError(f"mode must be 'dense' or 'chunked', got {mode!r}")
    if mode == "dense":
        if aux_weight is None:
            logits, aux = model(tokens, **model_kwargs), None
        else:
            logits, aux = model(tokens, return_aux=True, **model_kwargs)
        if vocab_mesh is not None:
            from ..parallel.tensor import vocab_parallel_cross_entropy
            ce = vocab_parallel_cross_entropy(logits[:, :-1], tokens[:, 1:],
                                              vocab_mesh).mean()
        else:
            ce = F.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]),
                tokens[:, 1:].reshape(-1).long())
        return ce if aux is None else ce + aux_weight * aux
    if aux_weight is not None:
        raise ValueError("the chunked loss takes no MoE aux loss")
    hidden, head = model(tokens, return_hidden=True, **model_kwargs)
    if vocab_mesh is not None:
        from ..parallel.tensor import copy_to_tensor
        hidden = copy_to_tensor(hidden, vocab_mesh)
    return chunked_softmax_cross_entropy(hidden[:, :-1], head, tokens[:, 1:],
                                         chunk_size, vocab_mesh).mean()

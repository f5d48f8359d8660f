"""Attention over [B, T, H, D] tensors: the port of ops/attention.py.

* `dot_product_attention`: plain attention, O(T^2) memory, with the
  `_guarded_probs` convention (a query with no visible key attends to
  nothing: zero output, zero gradients).
* `flash_attention`: the FlashAttention-2 decomposition through the
  hand-written Hopper kernels (forward, split dQ, split dK/dV, fused
  one-pass backward), wrapped in a `torch.autograd.Function` whose
  forward saves (q, k, v, out, lse) and whose backward recomputes P
  blockwise from the logsumexp. The dtype and head dim pick the route
  (`flash_route`): bf16 at head_dim 64 and 128 runs
  `csrc/flash_attention.cu` (the wgmma/TMA steps of `csrc/flash_tile.cuh`);
  f32 at every head_dim, and bf16 at the others, runs the general route
  `csrc/flash_general.cu`, which tiles the head dim in slabs of up to 128
  columns (`general_plan`).

Beside the kernels live their plain versions, which step at the same
tiles (`flash_forward_blockwise`, `flash_backward_dq_blockwise`,
`flash_backward_dkv_blockwise`, `flash_backward_fused_blockwise`). The
wrapper takes them only for tensors that lie on the CPU; for CUDA
tensors it launches the kernels or raises. The backward's D =
rowsum(dO * O) is plain PyTorch around the kernels, as the JAX package
leaves it to XLA. The fused backward's dQ is the left fold, in k order,
of per-k-block f32 block products: the Hopper kernel folds them itself,
the general route's kernel writes them out as partials and
`fold_dq_partials` folds them here. Either way the fused dQ is bit-equal to the split kernel's,
which `fused_backward=False` keeps as the oracle.
"""
import ctypes
import math
import typing as tp

import numpy as np
import torch

from . import _build

NEG_INF = -1e30

FLASH_BLOCK = 64             # q and k tile of the kernels (kBlock)
# head dims of the Hopper route, by kernel (a name of `_KERNEL_NAMES`, or
# 'ring_fwd'), in bf16; f32 takes the general route at every head dim
FLASH_HEAD_DIMS = {"flash_fwd": (64, 128), "flash_bwd_dq": (64, 128),
                   "flash_bwd_dkv": (64, 128), "flash_bwd_fused": (64, 128),
                   "ring_fwd": (64, 128)}
GENERAL_SLAB = 128           # the general route's widest head-dim slab
SMEM_BYTES = 232448          # shared memory of a block on sm_90 (kMaxSmem)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BWD_DQ, _BWD_DKV, _BWD_FUSED = 0, 1, 2
_KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_fused")

# Launches of the flash kernels: a plain integer per kernel and route
# ("<kernel>" the Hopper route at head_dim 64, "<kernel>_128" at 128,
# "<kernel>_general" the general route), bumped where the kernel is
# launched and nowhere else.
launch_counts: tp.Dict[str, int] = {
    f"{name}{suffix}": 0 for suffix in ("", "_128", "_general")
    for name in _KERNEL_NAMES}

_FUNCTIONS = {
    "flashy_flash_forward": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                    # out, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, Tq
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # Tk, D, causal
        ctypes.c_float, ctypes.c_void_p)),                   # scale, stream
    "flashy_flash_backward": (ctypes.c_int, (
        ctypes.c_int,                                        # kind
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dO, lse, D
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dq, dk, dv
        ctypes.c_void_p, ctypes.c_void_p,                    # scratch, counts
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, Tq
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # Tk, D, causal
        ctypes.c_float, ctypes.c_void_p)),                   # scale, stream
}


_POINTERS = ctypes.POINTER(ctypes.c_void_p)
_GENERAL_FUNCTIONS = {
    "flashy_flash_general_forward": (ctypes.c_int, (
        ctypes.c_int, ctypes.c_void_p,                       # dtype, q
        _POINTERS, _POINTERS, ctypes.c_int, ctypes.c_int,    # k, v, n, causal0
        ctypes.c_void_p, ctypes.c_void_p,                    # out, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, Tq
        ctypes.c_int, ctypes.c_int,                          # Tk, D
        ctypes.c_float, ctypes.c_void_p)),                   # scale, stream
    "flashy_flash_general_backward": (ctypes.c_int, (
        ctypes.c_int, ctypes.c_int,                          # kind, dtype
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dO, lse, D
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dq, dk, dv
        ctypes.c_void_p,                                     # dQ partials
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, Tq
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # Tk, D, causal
        ctypes.c_float, ctypes.c_void_p)),                   # scale, stream
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def flash_route(head_dim: int, kernel: str = "flash_fwd",
                dtype: torch.dtype = torch.bfloat16) -> str:
    """The route of flash kernel `kernel` (a name of `_KERNEL_NAMES`, or
    'ring_fwd') at this head dim and dtype on CUDA: 'hopper' (bf16 at
    FLASH_HEAD_DIMS[kernel]: `csrc/flash_attention.cu`,
    `csrc/ring_attention.cu`) or 'general' (every other head dim:
    `csrc/flash_general.cu`). A head dim below 1 raises ValueError."""
    if dtype == torch.bfloat16 and head_dim in FLASH_HEAD_DIMS[kernel]:
        return "hopper"
    if head_dim >= 1:
        return "general"
    raise ValueError(f"flash attention kernel: head_dim {head_dim} < 1")


def general_plan(head_dim: int) -> tp.Dict[str, int]:
    """How `csrc/flash_general.cu` tiles this head dim: slabs of `width`
    columns (the smallest multiple of 32 that holds the head dim, up to
    GENERAL_SLAB), `slabs` of them, tiles of `rows` query or key rows,
    and the shared memory of a forward and of a backward block in bytes
    (`fwd_floats`, `bwd_floats` there). Only `slabs` grows with the head
    dim: S and dP run over the slabs in turn, and each output slab is a
    block of its own."""
    width = min(32 * -(-head_dim // 32), GENERAL_SLAB)
    rows, ld = FLASH_BLOCK, width + 1
    return {"width": width, "slabs": -(-head_dim // width), "rows": rows,
            "forward_smem": 4 * (3 * rows * ld + rows * (rows + 1)
                                 + 3 * rows),
            "backward_smem": 4 * (4 * rows * ld + 2 * rows * (rows + 1)
                                  + 2 * rows)}


def counter_name(kernel: str, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16) -> str:
    """The launch counter of `kernel` (a name of `_KERNEL_NAMES`, or
    'ring_fwd') on its route at this head dim and dtype: `kernel` on the
    Hopper route at 64, `kernel_<head_dim>` there at the other widths,
    `kernel_general` on the general route."""
    if flash_route(head_dim, kernel, dtype) == "general":
        return f"{kernel}_general"
    return kernel if head_dim == 64 else f"{kernel}_{head_dim}"


def score_scale(head_dim: int) -> float:
    """1/sqrt(head_dim) in f32 arithmetic, as the JAX package's cached
    and paged reads compute it (`1 / jnp.sqrt(jnp.float32(head_dim))`)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def flash_scale(head_dim: int) -> float:
    """The flash path's scale: `1.0 / np.sqrt(dim)` in f64, rounded to
    f32 where it multiplies the f32 scores (`_flash_forward`). It can
    differ from `score_scale` by an ulp (not at head_dim 64)."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _guarded_probs(scores: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """exp(scores - ref) with fully-masked rows forced to zero.

    `ref` is a per-row statistic (running max or logsumexp) that sits at
    ~NEG_INF when the row saw no visible key; there exp(scores - ref)
    would be exp(0) = 1 for every masked key. A query with no visible
    key attends to nothing.
    """
    return torch.where(ref > NEG_INF * 0.5, torch.exp(scores - ref),
                       torch.zeros((), dtype=scores.dtype,
                                   device=scores.device))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          mask: tp.Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain attention over [B, T, H, D] tensors; scores in f32.

    Queries with no visible key produce zero output rather than
    softmax's uniform average over masked keys. Causal masks align
    bottom-right (`offset = t_k - t_q`).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        causal_mask = torch.ones((t_q, t_k), dtype=torch.bool,
                                 device=q.device).tril(t_k - t_q)
        scores = scores.masked_fill(~causal_mask[None, None], NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    probs = _guarded_probs(scores, m)
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = probs / denom
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


# ----------------------------------------------------------------------
# plain versions of the four kernels, stepping at the kernels' tiles
# ----------------------------------------------------------------------
def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> f32 [B, H, T, D] (values exact: bf16 fits f32)."""
    return x.transpose(1, 2).float()


def _scores(qh: torch.Tensor, kh: torch.Tensor, q0: int, k0: int, *,
            scale: float, causal: bool, offset: int) -> torch.Tensor:
    """Masked f32 scores of query rows q0.. against keys k0.. (JAX's
    `_block_scores`: q.k * scale, then NEG_INF where causally hidden)."""
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        q_pos = q0 + torch.arange(qh.shape[2], device=qh.device)[:, None]
        k_pos = k0 + torch.arange(kh.shape[2], device=qh.device)[None, :]
        scores = scores.masked_fill(q_pos + offset < k_pos, NEG_INF)
    return scores


def flash_forward_blockwise(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = False, *,
                            block_k: int = FLASH_BLOCK
                            ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in plain PyTorch (`_flash_kernel`).

    The online softmax steps once per `block_k` keys: running max, the
    guarded exp, P rounded to V's dtype before P.V, the accumulator
    rescaled, so bf16 results round where the kernel's do. A key block
    that no row may see changes no value, so all query rows step
    together. A T that the block does not divide is handled by a shorter
    last block. Returns out [B, Tq, H, D] in q's dtype and the f32
    logsumexp [B, H, Tq].
    """
    return online_softmax_blockwise(q, ((k, v, causal),), block_k=block_k)


def online_softmax_blockwise(q: torch.Tensor, blocks: tp.Iterable[
        tp.Tuple[torch.Tensor, torch.Tensor, bool]], *,
                             block_k: int = FLASH_BLOCK
                             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One online softmax over a sequence of (k, v, causal) key blocks,
    visited in order, each in `block_k`-key steps: the loop of the flash
    forward kernel (one block) and of the ring kernel (the ring's visible
    blocks, `parallel.ring_fused.ring_forward_plain`). Each block's
    causal mask aligns bottom-right against q. Returns (out in q's
    dtype, f32 logsumexp [B, H, Tq])."""
    t_q, dim = q.shape[1], q.shape[3]
    scale = flash_scale(dim)
    qh = _heads(q)
    m = torch.full(qh.shape[:3] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k, v, causal in blocks:
        t_k = k.shape[1]
        offset = t_k - t_q
        kh, vh = _heads(k), _heads(v)
        for k0 in range(0, t_k, block_k):
            if causal and k0 > t_q - 1 + offset:
                break  # no query row sees these keys
            scores = _scores(qh, kh[:, :, k0:k0 + block_k], 0, k0,
                             scale=scale, causal=causal, offset=offset)
            m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            probs = _guarded_probs(scores, m_new)
            l = l * alpha + probs.sum(-1, keepdim=True)
            pv = torch.matmul(probs.to(v.dtype).float(),
                              vh[:, :, k0:k0 + block_k])
            acc = acc * alpha + pv
            m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype).transpose(1, 2)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out.contiguous(), lse.contiguous()


def _probs_and_ds(qh, kh, vh, doh, lse, delta, q0, k0, *, scale, causal,
                  offset):
    """P (guarded against the logsumexp) and dS = P (dP - D) scale of
    query rows q0.. against keys k0.., f32 (the backward kernels'
    shared block)."""
    scores = _scores(qh, kh, q0, k0, scale=scale, causal=causal,
                     offset=offset)
    probs = _guarded_probs(scores, lse[..., None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    return probs, probs * (dp - delta[..., None]) * scale


def flash_delta(grad_out: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, [B, H, Tq] (plain, as in JAX)."""
    return (grad_out.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()


def _dq_partial(qh, kh, vh, doh, lse, delta, k0, block_k, dtype, *, scale,
                causal, offset):
    """One k-block's f32 dQ contribution dS.K for every query row."""
    kb, vb = kh[:, :, k0:k0 + block_k], vh[:, :, k0:k0 + block_k]
    _, ds = _probs_and_ds(qh, kb, vb, doh, lse, delta, 0, k0, scale=scale,
                          causal=causal, offset=offset)
    return torch.matmul(ds.to(dtype).float(), kb)


def flash_backward_dq_blockwise(q, k, v, grad_out, lse, delta, causal=False,
                                *, block_k: int = FLASH_BLOCK
                                ) -> torch.Tensor:
    """The split dQ kernel in plain PyTorch (`_flash_dq_kernel`): dQ is
    the f32 sum, in k order, of each k-block's dS.K (dS rounded to K's
    dtype), cast to q's dtype. [B, Tq, H, D]."""
    t_q, t_k, dim = q.shape[1], k.shape[1], q.shape[3]
    scale, offset = flash_scale(dim), t_k - t_q
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(grad_out)
    dq = torch.zeros_like(qh)
    for k0 in range(0, t_k, block_k):
        if causal and k0 > t_q - 1 + offset:
            break
        dq = dq + _dq_partial(qh, kh, vh, doh, lse, delta, k0, block_k,
                              k.dtype, scale=scale, causal=causal,
                              offset=offset)
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_backward_dkv_blockwise(q, k, v, grad_out, lse, delta, causal=False,
                                 *, block_q: int = FLASH_BLOCK
                                 ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The split dK/dV kernel in plain PyTorch (`_flash_dkv_kernel`):
    per q-block, dV += P^T.dO (P rounded to dO's dtype) and dK += dS^T.Q
    (dS rounded to Q's dtype), f32, in q order. [B, Tk, H, D] each."""
    t_q, t_k, dim = q.shape[1], k.shape[1], q.shape[3]
    scale, offset = flash_scale(dim), t_k - t_q
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(grad_out)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for q0 in range(0, t_q, block_q):
        qb, dob = qh[:, :, q0:q0 + block_q], doh[:, :, q0:q0 + block_q]
        probs, ds = _probs_and_ds(
            qb, kh, vh, dob, lse[:, :, q0:q0 + block_q],
            delta[:, :, q0:q0 + block_q], q0, 0, scale=scale, causal=causal,
            offset=offset)
        dv = dv + torch.matmul(probs.to(grad_out.dtype).float()
                               .transpose(-1, -2), dob)
        dk = dk + torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qb)
    return (dk.to(k.dtype).transpose(1, 2).contiguous(),
            dv.to(v.dtype).transpose(1, 2).contiguous())


def flash_backward_fused_blockwise(q, k, v, grad_out, lse, delta,
                                   causal=False, *,
                                   block_q: int = FLASH_BLOCK,
                                   block_k: int = FLASH_BLOCK):
    """The fused kernel in plain PyTorch (`_flash_bwd_fused_kernel`):
    dK and dV as the split kernel computes them, and the f32 dQ partials
    [nk, B, Tq, H, D], one per k-block (zero where causality skips the
    pair). `fold_dq_partials` turns them into dQ."""
    t_q, t_k, dim = q.shape[1], k.shape[1], q.shape[3]
    scale, offset = flash_scale(dim), t_k - t_q
    dk, dv = flash_backward_dkv_blockwise(q, k, v, grad_out, lse, delta,
                                          causal, block_q=block_q)
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(grad_out)
    partials = [_dq_partial(qh, kh, vh, doh, lse, delta, k0, block_k,
                            k.dtype, scale=scale, causal=causal,
                            offset=offset).transpose(1, 2)
                for k0 in range(0, t_k, block_k)]
    return dk, dv, torch.stack(partials)


def fold_dq_partials(partials: torch.Tensor, dtype: torch.dtype
                     ) -> torch.Tensor:
    """dQ from the fused backward's f32 partials [nk, B, Tq, H, D]: an
    explicit left fold in k order from zero (the split dQ kernel's
    addition sequence), then cast to `dtype`."""
    dq = torch.zeros_like(partials[0])
    for i in range(partials.shape[0]):
        dq = dq + partials[i]
    return dq.to(dtype)


# ----------------------------------------------------------------------
# kernel launches
# ----------------------------------------------------------------------
def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    def check(cond, message):
        if not cond:
            raise ValueError(f"flash attention kernel: {message}")

    check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
          f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
          f"must be [B, T, H, D] with matching k and v")
    check(q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:],
          f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    check(q.dtype == k.dtype == v.dtype and q.dtype in _FLASH_DTYPES,
          f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: float32 or bfloat16, "
          f"all the same")
    flash_route(q.shape[3])
    check(q.device.type == "cuda", f"runs on CUDA tensors, got {q.device}")
    check(k.device == q.device and v.device == q.device,
          "tensors span devices")
    # the bf16 forward's tensor maps need contiguous rows at 16-byte
    # aligned addresses: `_kernel_operand` makes both, and a map that
    # cuTensorMapEncodeTiled refuses is raised (`_build.launch_error`),
    # never bypassed


def _check_backward_inputs(q: torch.Tensor, grad_out: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor) -> None:
    """dO shaped like q; lse and D f32 [B, H, Tq] beside it."""
    stat = (q.shape[0], q.shape[2], q.shape[1])
    if grad_out.shape != q.shape or grad_out.device != q.device:
        raise ValueError(f"flash attention kernel: dO {tuple(grad_out.shape)}"
                         f" on {grad_out.device} must match q "
                         f"{tuple(q.shape)} on {q.device}")
    for name, t in (("lse", lse), ("D", delta)):
        if t.dtype != torch.float32 or t.shape != stat \
                or t.device != q.device:
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"float32 {stat} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


_LIBRARIES = {"flash_attention": _FUNCTIONS,
              "flash_general": _GENERAL_FUNCTIONS}


def _call(library: str, symbol: str, *args) -> None:
    err = getattr(_build.load(library, _LIBRARIES[library]), symbol)(*args)
    if err != 0:
        raise _build.launch_error(
            f"flash attention kernel launch failed ({symbol})", err)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address: the Hopper kernels read
    through TMA tensor maps, whose base must be 16-byte aligned, and write
    rows with 4- and 16-byte stores. A view at an odd offset is
    copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _geometry(q: torch.Tensor, k: torch.Tensor, causal: bool):
    batch, t_q, heads, dim = q.shape
    return (batch, heads, t_q, k.shape[1], dim, int(causal),
            flash_scale(dim), torch.cuda.current_stream(q.device).cuda_stream)


def launch_general_forward(q: torch.Tensor, ks: tp.Sequence[torch.Tensor],
                           vs: tp.Sequence[torch.Tensor], causal0: bool
                           ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The general route's forward over the key segments (ks[i], vs[i])
    in order, segment 0 causal where `causal0`: (out, lse). The flash
    forward passes one segment, the ring forward one per visible ring
    step. Operands are contiguous already."""
    n = len(ks)
    k_table = (ctypes.c_void_p * n)(*(x.data_ptr() for x in ks))
    v_table = (ctypes.c_void_p * n)(*(x.data_ptr() for x in vs))
    batch, t_q, heads, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, t_q), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        _call("flash_general", "flashy_flash_general_forward",
              _FLASH_DTYPES[q.dtype],
              q.data_ptr(), k_table, v_table, n, int(causal0),
              out.data_ptr(), lse.data_ptr(), batch, heads, t_q,
              ks[0].shape[1], dim, flash_scale(dim),
              torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def _launch_forward(q, k, v, causal):
    _check_kernel_inputs(q, k, v)
    q, k, v = map(_kernel_operand, (q, k, v))
    name = counter_name("flash_fwd", q.shape[3], q.dtype)
    if name == "flash_fwd_general":
        out, lse = launch_general_forward(q, [k], [v], causal)
        launch_counts[name] += 1
        return out, lse
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _call("flash_attention", "flashy_flash_forward", q.data_ptr(),
              k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
              *_geometry(q, k, causal))
    launch_counts[name] += 1
    return out, lse


def _launch_backward(kind, q, k, v, grad_out, lse, delta, causal):
    """One backward kernel: (dq, dk, dv, partials), each None where the
    kernel does not write it. The fused kernel of the Hopper route writes
    dq, through an f32 accumulator [B*H, nq*64, D] and zeroed counters
    [B*H*nq] that it is handed here; the general route's fused kernel
    writes the f32 dQ partials [nk, B, Tq, H, D] instead, one per 64
    keys."""
    _check_kernel_inputs(q, k, v)
    _check_backward_inputs(q, grad_out, lse, delta)
    q, k, v = map(_kernel_operand, (q, k, v))
    grad_out = _kernel_operand(grad_out.to(q.dtype))
    lse, delta = lse.contiguous(), delta.contiguous()
    name = counter_name(_KERNEL_NAMES[kind + 1], q.shape[3], q.dtype)
    general = name.endswith("_general")
    dq = dk = dv = partials = scratch = counts = None
    if kind != _BWD_DQ:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    if kind == _BWD_FUSED and general:
        nk = -(-k.shape[1] // FLASH_BLOCK)
        partials = torch.empty((nk,) + tuple(q.shape), dtype=torch.float32,
                               device=q.device)
    elif kind != _BWD_DKV:
        dq = torch.empty_like(q)
        if kind == _BWD_FUSED:
            batch, t_q, heads, dim = q.shape
            nq = -(-t_q // FLASH_BLOCK)
            scratch = torch.empty((batch * heads, nq * FLASH_BLOCK, dim),
                                  dtype=torch.float32, device=q.device)
            counts = torch.zeros(batch * heads * nq, dtype=torch.int32,
                                 device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), ptr(dq), ptr(dk), ptr(dv))
    with torch.cuda.device(q.device):
        if general:
            _call("flash_general", "flashy_flash_general_backward", kind,
                  _FLASH_DTYPES[q.dtype], *operands, ptr(partials),
                  *_geometry(q, k, causal))
        else:
            _call("flash_attention", "flashy_flash_backward", kind,
                  *operands, ptr(scratch), ptr(counts),
                  *_geometry(q, k, causal))
    launch_counts[name] += 1
    return dq, dk, dv, partials


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA tensors (the "
                         f"kernels) or CPU tensors (their plain versions), "
                         f"got {t.device}")
    return False


def flash_forward(q, k, v, causal=False):
    """(out, lse): the forward kernel on CUDA, its plain version at the
    kernel's tile on the CPU."""
    if _on_cpu(q):
        return flash_forward_blockwise(q, k, v, causal)
    return _launch_forward(q, k, v, causal)


def flash_backward_split(q, k, v, grad_out, lse, delta, causal=False):
    """(dq, dk, dv) through the split pair (the oracle)."""
    if _on_cpu(q):
        dq = flash_backward_dq_blockwise(q, k, v, grad_out, lse, delta,
                                         causal)
        dk, dv = flash_backward_dkv_blockwise(q, k, v, grad_out, lse, delta,
                                              causal)
        return dq, dk, dv
    dq = _launch_backward(_BWD_DQ, q, k, v, grad_out, lse, delta, causal)[0]
    _, dk, dv, _ = _launch_backward(_BWD_DKV, q, k, v, grad_out, lse, delta,
                                    causal)
    return dq, dk, dv


def flash_backward_fused(q, k, v, grad_out, lse, delta, causal=False):
    """(dq, dk, dv) through the one-pass backward, as JAX's
    `_flash_backward_fused` returns them: the Hopper kernel folds dQ
    itself; the general route's dQ partials, and on the CPU the plain
    version's, are folded here in k order."""
    if _on_cpu(q):
        dk, dv, partials = flash_backward_fused_blockwise(
            q, k, v, grad_out, lse, delta, causal)
        return fold_dq_partials(partials, q.dtype), dk, dv
    dq, dk, dv, partials = _launch_backward(_BWD_FUSED, q, k, v, grad_out,
                                            lse, delta, causal)
    if partials is not None:
        dq = fold_dq_partials(partials, q.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """`_flash` with its custom VJP: the forward saves (q, k, v, out,
    lse), the backward takes the fused kernel or the split pair."""

    @staticmethod
    def forward(ctx, q, k, v, causal, fused):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.fused = causal, fused
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        grad_out = grad_out.to(q.dtype)
        delta = flash_delta(grad_out, out)
        backward = flash_backward_fused if ctx.fused else flash_backward_split
        dq, dk, dv = backward(q, k, v, grad_out, lse, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, *,
                    fused_backward: tp.Optional[bool] = None
                    ) -> torch.Tensor:
    """Flash attention over [B, T, H, D]: the Hopper kernels on CUDA.

    Forward and backward are kernels (O(T) sequence memory; the backward
    recomputes P blockwise from the forward's logsumexp). The backward
    defaults to the fused one-pass kernel (`fused_backward=None` ->
    True); `fused_backward=False` takes the split pair, the bit-identical
    oracle. Any T works: the kernels mask the ragged edge. On CUDA the
    kernels take float32 or bfloat16 at any head dim (the route by
    `flash_route`), and raise on anything else; on the CPU the plain
    versions run at the kernels' tile.
    """
    if fused_backward is None:
        fused_backward = True
    return _FlashAttention.apply(q, k, v, causal, fused_backward)

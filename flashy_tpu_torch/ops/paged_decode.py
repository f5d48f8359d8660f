"""Paged-attention read through the hand-written Hopper kernel (port of
flashy_tpu/ops/paged_decode.py).

Every multi-token read the engine makes shares one contract: T query
rows at CONSECUTIVE positions `base..base+T-1` per slot (decode T = 1,
speculative verify T = k+1, chunked prefill T = chunk). Two hand-written
kernels serve it, picked by the shape (`kernel_route`):
`csrc/paged_decode.cu` takes head_dim 64 with block sizes that are
powers of two up to 64 (the 235M layout), `csrc/paged_general.cu` every
other head_dim and block size (its shared memory, `general_smem_bytes`,
does not depend on the block size; it splits the T rows into groups
where they do not fit together). Their plain version is
`ops.paged_attention.paged_attention`.
`entrywise_paged_attention` spells the kernel's body in plain PyTorch,
with its rounding points, so that bf16 results can be held to it
closely where the plain version rounds P at other points.

The wrapper takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises: there is no
fallback that could let the plain path pass for the kernel.
"""
import ctypes
import typing as tp

import torch

from . import _build
from .attention import NEG_INF, _guarded_probs, score_scale
from .paged_attention import block_bytes, paged_attention

MAX_QUERIES = 64  # T bound of both kernels (kMaxQueries in the sources)
HEAD_DIM = 64     # the head_dim paged_decode.cu takes (kDh)
MAX_BLOCK = 64    # its block sizes: powers of two up to this
SMEM_BYTES = 232448  # shared memory of a block on sm_90 (kMaxSmem)

# Launches of the kernels, by route and pool variant: a plain integer per
# name, bumped where the kernel is launched and nowhere else.
launch_counts: tp.Dict[str, int] = {"paged_decode": 0,
                                    "paged_decode_int8": 0,
                                    "paged_decode_general": 0,
                                    "paged_decode_int8_general": 0}

_FUNCTIONS = {
    "flashy_paged_decode": (ctypes.c_int, (
        ctypes.c_int,                                    # variant
        ctypes.c_void_p,                                 # q
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # q strides
        ctypes.c_void_p, ctypes.c_void_p,                # k, v
        ctypes.c_void_p, ctypes.c_void_p,                # k/v scales
        ctypes.c_void_p,                                 # table
        ctypes.c_void_p, ctypes.c_longlong,              # positions, row stride
        ctypes.c_void_p,                                 # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # B, T, H
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # Dh, E, bs
        ctypes.c_float,                                  # score scale
        ctypes.c_void_p)),                               # stream
}
_GENERAL_FUNCTIONS = {
    "flashy_paged_general": (ctypes.c_int, (
        ctypes.c_int,                                    # variant
        ctypes.c_void_p,                                 # q (contiguous)
        ctypes.c_void_p, ctypes.c_void_p,                # k, v
        ctypes.c_void_p, ctypes.c_void_p,                # k/v scales
        ctypes.c_void_p,                                 # table
        ctypes.c_void_p, ctypes.c_longlong,              # positions, row stride
        ctypes.c_void_p,                                 # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # B, T, H
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # Dh, E, bs
        ctypes.c_float,                                  # score scale
        ctypes.c_void_p)),                               # stream
}
_VARIANTS = {(torch.float32, False): 0, (torch.bfloat16, False): 1,
             (torch.float32, True): 2, (torch.bfloat16, True): 3}
# argument signatures (`_signature`) the checks have passed: the engine
# calls with the same shapes, strides, dtypes and devices every layer of
# every step, so each is checked once
_checked: tp.Set[tuple] = set()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def default_kernel(device: torch.device) -> str:
    """The engine's `kernel='auto'` resolution: the kernel on CUDA, the
    plain gather path on the CPU."""
    return "fused" if torch.device(device).type == "cuda" else "gather"


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"paged decode kernel: {message}")


def kernel_route(head_dim: int, block_size: int) -> str:
    """The kernel a read of these widths launches: 'paged_decode'
    (`csrc/paged_decode.cu`: head_dim 64, block sizes that are powers of
    two up to 64) or 'general' (`csrc/paged_general.cu`: any other)."""
    if (head_dim == HEAD_DIM and 1 <= block_size <= MAX_BLOCK
            and block_size & (block_size - 1) == 0):
        return "paged_decode"
    return "general"


def general_smem_bytes(queries: int, head_dim: int,
                       q_dtype: torch.dtype) -> int:
    """Shared memory of a general-route block of `queries` query rows
    (`smem_bytes` in csrc/paged_general.cu), whatever the block size: the
    f64 chain (f32 with bf16 q) and, in f32, q, K or V of 64 keys, the
    scores of 64 keys a row, the per-row statistics, the scales of 64
    keys, and for an entry past 64 keys (which goes in two passes of
    64-key chunks) the P.V sums, the lanes' partial sums and the entry's
    max."""
    ld, rows = head_dim + 1, queries
    chain = 8 if q_dtype == torch.float32 else 4
    return (chain * rows * (head_dim + 1)
            + 4 * (rows * ld + 64 * ld + rows * 64 + rows + rows * 64
                   + 2 * 64 + rows * head_dim + rows * 32 + rows))


def _signature(q: torch.Tensor, entry: tp.Dict[str, torch.Tensor],
               table: torch.Tensor, positions: torch.Tensor,
               head_dim: int) -> tuple:
    """What `_check_call` reads of its arguments."""
    return (head_dim, q.dtype, q.device, q.shape) + tuple(
        (name, t.shape, t.stride(), t.dtype, t.device) for name, t in
        (*entry.items(), ("table", table), ("positions", positions)))


def _check_call(q: torch.Tensor, entry: tp.Dict[str, torch.Tensor],
                table: torch.Tensor, positions: torch.Tensor,
                head_dim: int) -> None:
    """Everything the kernel needs of its arguments; raises otherwise."""
    batch, queries, heads, dim = q.shape
    quant = "k_scale" in entry
    k, v = entry["k"], entry["v"]
    _check(dim == head_dim, f"q head_dim {dim} != {head_dim}")
    _check(1 <= queries <= MAX_QUERIES,
           f"T={queries} outside [1, {MAX_QUERIES}]")
    _check((q.dtype, quant) in _VARIANTS,
           f"q dtype {q.dtype} unsupported (float32 or bfloat16)")
    _check(k.dim() == 4 and k.shape[2:] == (heads, dim)
           and v.shape == k.shape,
           f"pool k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
           f"q {tuple(q.shape)}")
    _check(k.shape[1] >= 1, "empty blocks")
    _check(k.dtype == v.dtype == (torch.int8 if quant else q.dtype),
           f"pool dtype {k.dtype} does not match q {q.dtype} "
           f"(int8 pools carry scales)")
    tensors = [k, v, table]
    if quant:
        for name in ("k_scale", "v_scale"):
            s = entry[name]
            _check(s.dtype == torch.float32 and s.shape == k.shape[:3],
                   f"{name} must be float32 {tuple(k.shape[:3])}")
            tensors.append(s)
    _check(table.dim() == 2 and table.shape[0] == batch
           and table.dtype == torch.int32, "table must be int32 [B, E]")
    _check(positions.shape == (batch, queries), "positions must be [B, T]")
    if kernel_route(dim, k.shape[1]) == "general":
        need = general_smem_bytes(1, dim, q.dtype)
        _check(need <= SMEM_BYTES,
               f"head_dim {dim} needs {need} bytes of shared memory for "
               f"one query row, over the {SMEM_BYTES} of a block")
    for t in tensors + [positions]:
        _check(t.device == q.device, f"tensors span {t.device} and "
                                     f"{q.device}")
    for t in tensors:
        _check(t.is_contiguous(), "pools and table must be contiguous")


def _launch(q: torch.Tensor, entry: tp.Dict[str, torch.Tensor],
            table: torch.Tensor, positions: torch.Tensor,
            head_dim: int) -> torch.Tensor:
    signature = _signature(q, entry, table, positions, head_dim)
    if signature not in _checked:
        _check_call(q, entry, table, positions, head_dim)
        _checked.add(signature)
    batch, queries, heads, dim = q.shape
    quant = "k_scale" in entry
    k, v = entry["k"], entry["v"]
    route = kernel_route(dim, k.shape[1])
    if route == "general" or q.stride(3) != 1:
        q = q.contiguous()
    if positions.dtype != torch.int64:
        positions = positions.long()
    out = torch.empty((batch, queries, heads, dim), dtype=q.dtype,
                      device=q.device)
    scales = (entry["k_scale"].data_ptr() if quant else None,
              entry["v_scale"].data_ptr() if quant else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "paged_decode":
            lib = _build.load("paged_decode", _FUNCTIONS)
            err = lib.flashy_paged_decode(
                _VARIANTS[(q.dtype, quant)], q.data_ptr(), q.stride(0),
                q.stride(1), q.stride(2), k.data_ptr(), v.data_ptr(),
                *scales, table.data_ptr(), positions.data_ptr(),
                positions.stride(0), out.data_ptr(), batch, queries, heads,
                dim, table.shape[1], k.shape[1], score_scale(head_dim),
                stream)
        else:
            lib = _build.load("paged_general", _GENERAL_FUNCTIONS)
            err = lib.flashy_paged_general(
                _VARIANTS[(q.dtype, quant)], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), *scales, table.data_ptr(),
                positions.data_ptr(), positions.stride(0), out.data_ptr(),
                batch, queries, heads, dim, table.shape[1], k.shape[1],
                score_scale(head_dim), stream)
    if err != 0:
        hint = (f" (invalid value: the shapes do not fit in shared memory)"
                if err == 1 else "")
        raise RuntimeError(f"paged decode kernel launch failed ({route}): "
                           f"cudaError {err}{hint}")
    name = "paged_decode_int8" if quant else "paged_decode"
    launch_counts[name if route == "paged_decode" else f"{name}_general"] \
        += 1
    return out


def fused_paged_attention(q: torch.Tensor, entry: tp.Dict[str, torch.Tensor],
                          table: torch.Tensor, positions: torch.Tensor, *,
                          head_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """`paged_attention`'s contract, one kernel launch.

    q [B, T, H, Dh] (rotary applied; any strides), one layer's pool
    `entry`, int32 tables [B, E], int64 positions [B, T] that must be
    CONSECUTIVE per row (`positions[:, t] == positions[:, 0] + t`): the
    kernel derives the causal mask from `positions[:, 0]`, read in
    place. Every engine read path satisfies that; arbitrary per-row
    patterns need `paged_attention`. Returns [B, T, H, Dh] in `dtype`.
    On CUDA the shape picks the kernel (`kernel_route`); T above 64,
    pools that do not match q, unsupported dtypes and a head_dim whose
    one query row does not fit in shared memory raise.
    """
    if q.device.type == "cpu":
        return paged_attention(q, entry, table, positions,
                               head_dim=head_dim, dtype=dtype)
    if q.device.type != "cuda":
        raise ValueError(f"the paged decode kernel runs on CUDA tensors, "
                         f"got {q.device}")
    return _launch(q.to(dtype), entry, table, positions, head_dim)


def entrywise_paged_attention(q: torch.Tensor,
                              entry: tp.Dict[str, torch.Tensor],
                              table: torch.Tensor, positions: torch.Tensor, *,
                              head_dim: int, dtype: torch.dtype
                              ) -> torch.Tensor:
    """The kernel's body in plain PyTorch, one table entry at a time.

    `fused_paged_attention`'s contract and result, computed the way the
    TPU kernel's `_fused_body` steps it: per entry, masked f32 scores
    (K scale folded in), the running max, guarded probabilities, P
    rounded to V's dtype (int8: P*v_scale rounded to q's dtype), and the
    accumulator rescaled, up to each slot's last live entry. Its bf16
    results therefore round where the kernel's do; the gather version
    normalizes over the whole row first and rounds elsewhere. Products
    are taken elementwise in f32 (no TF32 matmul). In f32 the chain
    (accumulator and normalizer) is carried in f64, as the kernel carries
    it (`csrc/paged_decode.cu`): the TPU body's f32 chain drifts by
    ~1e-5 over hundreds of entries. For checks only.
    """
    q = q.to(dtype)
    batch, queries, heads, dim = q.shape
    quant = "k_scale" in entry
    bs = entry["k"].shape[1]
    device = q.device
    base = positions[:, 0].long()
    last = ((base + queries - 1).clamp_min(0) // bs).clamp_max(
        table.shape[1] - 1)
    q_pos = base[:, None] + torch.arange(queries, device=device)
    qf = q.float().permute(0, 2, 1, 3)[:, :, :, None, :]  # [B,H,T,1,Dh]
    chain = torch.float64 if dtype == torch.float32 else torch.float32
    m = torch.full((batch, heads, queries, 1), NEG_INF, device=device)
    l = torch.zeros_like(m, dtype=chain)
    acc = torch.zeros((batch, heads, queries, dim), dtype=chain,
                      device=device)
    for e in range(int(last.max()) + 1):
        blk = table[:, e].long()
        k = entry["k"][blk].to(dtype).float().permute(0, 2, 1, 3)
        scores = (qf * k[:, :, None]).sum(-1) * score_scale(head_dim)
        if quant:
            scores = scores * entry["k_scale"][blk].permute(0, 2, 1)[:, :,
                                                                    None]
        k_pos = e * bs + torch.arange(bs, device=device)
        visible = k_pos[None, None, :] <= q_pos[:, :, None]   # [B,T,bs]
        scores = scores.masked_fill(~visible[:, None], NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        probs = _guarded_probs(scores, m_new)
        l_new = l * alpha.to(chain) + probs.sum(-1, keepdim=True).to(chain)
        v = entry["v"][blk].permute(0, 2, 1, 3)                # [B,H,bs,Dh]
        if quant:
            probs = probs * entry["v_scale"][blk].permute(0, 2, 1)[:, :,
                                                                   None]
            probs, v = probs.to(dtype), v.to(dtype)
        else:
            probs = probs.to(v.dtype)
        pv = (probs.float()[..., None] * v.float()[:, :, None]).sum(-2)
        on = (e <= last)[:, None, None, None]
        m = torch.where(on, m_new, m)
        l = torch.where(on, l_new, l)
        acc = torch.where(on, acc * alpha.to(chain) + pv.to(chain), acc)
    out = (acc / l.clamp_min(1e-30)).to(dtype)
    return out.permute(0, 2, 1, 3).contiguous()


def fused_speculative_verify(q: torch.Tensor,
                             entry: tp.Dict[str, torch.Tensor],
                             table: torch.Tensor, positions: torch.Tensor,
                             *, head_dim: int, dtype: torch.dtype
                             ) -> torch.Tensor:
    """The [S, k+1] speculative-verify scoring read: the same kernel at
    T = k+1 >= 2."""
    if q.shape[1] < 2:
        raise ValueError(f"speculative verify scores k+1 >= 2 rows per "
                         f"slot, got T={q.shape[1]} (plain decode is "
                         f"fused_paged_attention at T=1)")
    return fused_paged_attention(q, entry, table, positions,
                                 head_dim=head_dim, dtype=dtype)


def decode_read_bytes_per_token(cfg, context_len: int,
                                kv_dtype: str = "model") -> int:
    """Device-memory bytes ONE decode token must stream from the K/V
    pools across all layers: every live K/V byte of its context plus
    the int8 scales (host arithmetic)."""
    return block_bytes(cfg, 1, kv_dtype) * context_len

"""State-space-duality (SSD) chunked scan (port of
flashy_tpu/ops/ssd_scan.py).

One linear-attention layer, `S_t = a_t * S_{t-1} + v_t (x) b_t` and
`y_t = S_t . c_t` (per-head scalar decay a_t in (0, 1], state S
[Dh, Dstate] per head), has two evaluation orders:

  * the CHUNKED form (prefill): within a chunk of C tokens the pairwise
    decay products become a [C, C] mask over the (c . b) scores, and
    the recurrence survives only between chunks as an f32 state carry;
  * the RECURRENT form (decode): one token at a time against the
    resident [B, H, Dh, Dstate] f32 state, constant bytes per slot
    whatever the context length.

Every decay exponent is a DIRECT sum of log-decays, never a difference
of cumulative sums: a segment reset sets log a_t = SSD_LOG_RESET
(-1e30), which a cumsum difference would cancel into garbage, while a
direct sum holding it stays near -1e30 and its exp is exactly 0.

The chunked form has the reference's seam, kernel='auto'|'gather'|
'fused': 'fused' is the hand-written Hopper kernel `csrc/ssd_scan.cu`
(the port of the TPU kernel `_fused_ssd_body`), 'gather' its plain
version `_chunked_reference` on any device, 'auto' the kernel for CUDA
tensors and the plain version on the CPU. An explicit 'fused' on the
CPU raises. The kernel is forward-only, as the TPU kernel is: a 'fused'
call on tensors that require grad raises (SSD training is
`TODO_SSD_TRAINING`). The port has no tuning cache, so `chunk=None`
takes `default_chunk(T)`, the reference's choice on a cache miss.
"""
import ctypes
import typing as tp

import torch

from . import _build

# Log-decay value that RESETS the state across a segment boundary:
# exp(-1e30) is exactly 0.0 in f32, and a sum holding it stays ~-1e30
# (f32 max ~3.4e38), so every decay product spanning a boundary is 0.
SSD_LOG_RESET = -1e30

# Chunk candidates of the reference's tuning sweep; `default_chunk`
# picks among them. The kernel takes any chunk up to MAX_CHUNK.
CHUNK_CANDIDATES: tp.Tuple[int, ...] = (16, 32, 64, 128, 256)
MAX_CHUNK = 256

TODO_SSD_TRAINING = ("ROADMAP.md queue A item 2, T9 (SSD training: autograd "
                     "through the plain chunked form)")

# Launches of the kernel: a plain integer, bumped where the kernel is
# launched and nowhere else.
launch_counts: tp.Dict[str, int] = {"ssd_scan": 0}

_FUNCTIONS = {
    "flashy_ssd_scan": (ctypes.c_int, (
        ctypes.c_int,                                    # variant
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # c, b, v
        ctypes.c_void_p, ctypes.c_void_p,                # la, state in
        ctypes.c_void_p, ctypes.c_void_p,                # y, state out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # B, H, T
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # N, Dh, chunk
        ctypes.c_void_p)),                               # stream
}
_VARIANTS = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def default_ssd_kernel(device: torch.device) -> str:
    """kernel='auto' resolution: the kernel for CUDA tensors, the plain
    chunked form on the CPU."""
    return "fused" if torch.device(device).type == "cuda" else "gather"


def default_chunk(seq_len: int) -> int:
    """Largest candidate chunk dividing `seq_len`; else the largest
    candidate that fits (the sub-chunk tail chains exactly); else the
    sequence itself (one chunk)."""
    for cand in sorted(CHUNK_CANDIDATES, reverse=True):
        if seq_len % cand == 0:
            return cand
    for cand in sorted(CHUNK_CANDIDATES, reverse=True):
        if cand < seq_len:
            return cand
    return seq_len


def _to_heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, *] <-> [B, H, T, *] (the scan-internal layout)."""
    return x.transpose(1, 2)


def _masked_inputs(b: torch.Tensor, log_a: torch.Tensor,
                   token_mask: tp.Optional[torch.Tensor]
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Null out padded tokens: a masked token neither decays the state
    (log a := 0) nor feeds it (b := 0). `token_mask` is [B, T] bool,
    True on real tokens."""
    if token_mask is None:
        return b, log_a
    m = token_mask[:, :, None]
    return (torch.where(m[..., None], b, torch.zeros_like(b)),
            torch.where(m, log_a, torch.zeros_like(log_a)))


def _chunk_body(c, b, v, la, state):
    """One chunk of the chunked form, heads-first, in f32.

    c/b: [B, H, C, N]; v: [B, H, C, Dh]; la: [B, H, C] f32 log-decays;
    state: [B, H, Dh, N] f32 carried in. Returns (y [B, H, C, Dh] f32,
    new state f32). bf16 operands are widened first: their products are
    exact in f32, so this is the reference's bf16 product with f32
    accumulation.
    """
    c, b, v = c.float(), b.float(), v.float()
    size = la.shape[-1]
    idx = torch.arange(size, device=la.device)
    causal = idx[:, None] >= idx[None, :]               # [t, s]: s <= t
    incl_tril = causal.float()                          # r <= t
    strict = (idx[:, None] > idx[None, :]).float()      # r > s
    # seg[t, s] = sum_{s<r<=t} la_r, a direct sum (contrib[r, s] = la_r
    # for r > s), never a cumsum difference
    contrib = la[..., :, None] * strict                 # [B, H, C, C]
    seg = torch.einsum("tr,bhrs->bhts", incl_tril, contrib)
    decay = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))
    incl = torch.einsum("tr,bhr->bht", incl_tril, la)   # sum_{r<=t} la_r
    suffix = torch.einsum("sr,bhr->bhs", strict.t(), la)  # sum_{r>s} la_r
    total = la.sum(-1)                                  # [B, H]

    scores = torch.einsum("bhtn,bhsn->bhts", c, b) * decay
    y_intra = torch.einsum("bhts,bhsd->bhtd", scores, v)
    y_inter = torch.exp(incl)[..., None] * torch.einsum(
        "bhtn,bhdn->bhtd", c, state)
    weighted_b = b * torch.exp(suffix)[..., None]
    new_state = torch.exp(total)[..., None, None] * state + torch.einsum(
        "bhsd,bhsn->bhdn", v, weighted_b)
    return y_intra + y_inter, new_state


def _chunked_reference(c, b, v, la, state, chunk: int):
    """The kernel's plain version: heads-first c/b [B, H, T, N], v
    [B, H, T, Dh], la [B, H, T] f32, state [B, H, Dh, N] f32. Chunks of
    `chunk` tokens in order, the last one the sub-chunk tail, the f32
    state carried between them. Returns (y [B, H, T, Dh] in v's dtype,
    final state f32)."""
    seq = la.shape[-1]
    ys = []
    for lo in range(0, seq, chunk):
        hi = min(lo + chunk, seq)
        y, state = _chunk_body(c[:, :, lo:hi], b[:, :, lo:hi],
                               v[:, :, lo:hi], la[:, :, lo:hi], state)
        ys.append(y)
    return torch.cat(ys, dim=2).to(v.dtype), state


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"ssd scan kernel: {message}")


def _launch(c, b, v, la, state, chunk: int):
    batch, heads, seq, dstate = c.shape
    dim = v.shape[-1]
    _check(c.dtype in _VARIANTS, f"dtype {c.dtype} unsupported (float32 "
                                 f"or bfloat16)")
    _check(b.dtype == v.dtype == c.dtype, "c, b and v must share a dtype")
    _check(b.shape == c.shape and v.shape[:3] == c.shape[:3],
           f"c {tuple(c.shape)}, b {tuple(b.shape)} and v {tuple(v.shape)} "
           f"disagree")
    _check(la.shape == c.shape[:3] and la.dtype == torch.float32,
           "la must be float32 [B, H, T]")
    _check(state.shape == (batch, heads, dim, dstate)
           and state.dtype == torch.float32,
           f"state must be float32 {(batch, heads, dim, dstate)}")
    _check(1 <= chunk <= MAX_CHUNK, f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    for t in (b, v, la, state):
        _check(t.device == c.device, f"tensors span {t.device} and "
                                     f"{c.device}")
    for t in (c, b, v, la, state):
        _check(t.is_contiguous(), "tensors must be contiguous")
    y = torch.empty_like(v)
    final = torch.empty_like(state)
    lib = _build.load("ssd_scan", _FUNCTIONS)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.flashy_ssd_scan(
            _VARIANTS[c.dtype], c.data_ptr(), b.data_ptr(), v.data_ptr(),
            la.data_ptr(), state.data_ptr(), y.data_ptr(), final.data_ptr(),
            batch, heads, seq, dstate, dim, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd scan kernel launch failed: cudaError {err}")
    launch_counts["ssd_scan"] += 1
    return y, final


def fused_ssd_chunks(c: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                     la: torch.Tensor, state: torch.Tensor, chunk: int
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """`_chunked_reference`'s contract (heads-first, the tail chunk
    included), one kernel launch. Tensors on the CPU take the plain
    version; CUDA tensors launch the kernel or raise."""
    if c.device.type == "cpu":
        return _chunked_reference(c, b, v, la, state, chunk)
    if c.device.type != "cuda":
        raise ValueError(f"the ssd scan kernel runs on CUDA tensors, got "
                         f"{c.device}")
    return _launch(c.contiguous(), b.contiguous(), v.contiguous(),
                   la.contiguous(), state.contiguous(), chunk)


def ssd_chunked_scan(c: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                     log_decay: torch.Tensor, *,
                     state: tp.Optional[torch.Tensor] = None,
                     chunk: tp.Optional[int] = None,
                     token_mask: tp.Optional[torch.Tensor] = None,
                     kernel: str = "auto"
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The CHUNKED form: [B, T] tokens -> outputs plus the final state,
    equal to running the recurrence token by token.

    Args:
        c: [B, T, H, Dstate] output projections (the "C" of SSD).
        b: [B, T, H, Dstate] state input projections (the "B").
        v: [B, T, H, Dh] values.
        log_decay: [B, T, H] per-token log decays, <= 0
            (`SSD_LOG_RESET` at a segment start zeroes the carried state).
        state: optional [B, H, Dh, Dstate] f32 carried-in state; zeros
            when None.
        chunk: intra-chunk length; `default_chunk(T)` when None. T need
            not be a multiple: the tail is one final chunk against the
            carried state, so splitting a stream at a multiple of
            `chunk` and passing the state is bit-identical to one call.
        token_mask: optional [B, T] bool, True on real tokens; padded
            tokens neither decay nor feed the state.
        kernel: 'fused' (the Hopper kernel, CUDA only), 'gather' (its
            plain version) or 'auto' (`default_ssd_kernel`).

    Returns (y [B, T, H, Dh] in v's dtype, final state [B, H, Dh,
    Dstate] f32).
    """
    if kernel not in ("auto", "gather", "fused"):
        raise ValueError(f"kernel must be 'auto', 'gather' or 'fused', "
                         f"got {kernel!r}")
    if kernel == "auto":
        kernel = default_ssd_kernel(c.device)
    if kernel == "fused":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (c, b, v, log_decay, state)):
            raise NotImplementedError(
                f"the ssd scan kernel is forward-only, as the TPU kernel "
                f"is: {TODO_SSD_TRAINING}")
        if c.device.type != "cuda":
            raise ValueError(
                f"kernel='fused' cannot run here: the ssd scan kernel is "
                f"CUDA-only and the tensors lie on {c.device}; use "
                f"kernel='gather' (or 'auto')")
    batch, seq, heads, dstate = c.shape
    dim = v.shape[-1]
    b, log_decay = _masked_inputs(b, log_decay, token_mask)
    if chunk is None:
        chunk = default_chunk(seq)
    elif chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    chunk = min(int(chunk), seq)
    if state is None:
        state = torch.zeros((batch, heads, dim, dstate),
                            dtype=torch.float32, device=c.device)
    args = (_to_heads_first(c), _to_heads_first(b), _to_heads_first(v),
            _to_heads_first(log_decay.float()), state.float(), chunk)
    scan = fused_ssd_chunks if kernel == "fused" else _chunked_reference
    y, final = scan(*args)
    return _to_heads_first(y).to(v.dtype), final


def ssd_recurrent_scan(c: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                       log_decay: torch.Tensor, state: torch.Tensor
                       ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The RECURRENT form: advance the f32 state one token at a time.

    Same shapes as `ssd_chunked_scan` plus the mandatory [B, H, Dh,
    Dstate] f32 `state`; T is usually 1 (a decode step). A loop over
    time in plain PyTorch (the reference's `lax.scan`, no kernel).
    Returns (y [B, T, H, Dh] in v's dtype, new state f32).
    """
    ch, bh, vh = (_to_heads_first(x).float() for x in (c, b, v))
    lah = _to_heads_first(log_decay.float())
    state = state.float()
    ys = []
    for t in range(lah.shape[-1]):
        state = (torch.exp(lah[:, :, t])[..., None, None] * state
                 + vh[:, :, t, :, None] * bh[:, :, t, None, :])
        ys.append(torch.einsum("bhdn,bhn->bhd", state, ch[:, :, t]))
    y = torch.stack(ys, dim=2)                     # [B, H, T, Dh]
    return _to_heads_first(y).to(v.dtype), state


def ssd_state_bytes(num_heads: int, head_dim: int, dstate: int) -> int:
    """Bytes of ONE layer's per-sequence SSD state: the [H, Dh, Dstate]
    f32 carry, independent of context length."""
    return num_heads * head_dim * dstate * 4

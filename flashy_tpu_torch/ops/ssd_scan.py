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
CPU raises. On CUDA a call is one launch: the kernel reads c, b, v and
the log-decays where they lie (the model's projection slices, by their
strides), applies the token mask itself and writes y in [B, T, H, Dh]
(`kernel_args`). The kernel is forward-only, as the TPU kernel is.
Training goes through `SsdScanFunction`: its forward is the kernel, its
backward recomputes the plain chunked form from the saved inputs and
differentiates it, which is what the JAX package's `jax.grad` does (XLA's
autodiff of `_chunked_reference`; no backward kernel exists to port).
'fused' and, on CUDA, 'auto' take it whenever an input requires grad.
The port has no tuning cache, so `chunk=None` takes `default_chunk(T)`,
the reference's choice on a cache miss.
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

# Launches of the kernels, by route: a plain integer each, bumped where
# the kernel is launched and nowhere else. "ssd_scan" is the bf16 tile
# kernel on the tensor cores, "ssd_scan_fma" the FMA kernel (f32, and
# bf16 at the widths the tile kernel does not take).
launch_counts: tp.Dict[str, int] = {"ssd_scan": 0, "ssd_scan_fma": 0}
# Recomputes of the plain chunked form in `SsdScanFunction`'s backward
# (plain PyTorch, not a kernel launch): one a backward.
backward_counts: tp.Dict[str, int] = {"ssd_scan_backward": 0}


class _SsdArgs(ctypes.Structure):
    """csrc/ssd_scan.cu `SsdArgs`: pointers, element strides (batch,
    token, head), sizes, and whether b and v follow c in one row."""
    _fields_ = [("c", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("la", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("state_in", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("state_out", ctypes.c_void_p),
                ("c_stride", ctypes.c_longlong * 3),
                ("b_stride", ctypes.c_longlong * 3),
                ("v_stride", ctypes.c_longlong * 3),
                ("la_stride", ctypes.c_longlong * 3),
                ("mask_stride", ctypes.c_longlong * 2),
                ("B", ctypes.c_int), ("T", ctypes.c_int), ("H", ctypes.c_int),
                ("N", ctypes.c_int), ("Dh", ctypes.c_int), ("C", ctypes.c_int),
                ("cbv", ctypes.c_int)]


_FUNCTIONS = {
    "flashy_ssd_scan": (ctypes.c_int, (
        ctypes.c_int, ctypes.POINTER(_SsdArgs),  # variant, arguments
        ctypes.c_void_p)),                        # stream
}
# csrc/ssd_scan.cu `flashy_ssd_scan` variants, by route
_VARIANTS = {("ssd_scan_fma", torch.float32): 0,
             ("ssd_scan", torch.bfloat16): 1,
             ("ssd_scan_fma", torch.bfloat16): 2}
TILE_MAX_STATE = 16   # the tile kernel's widths: N <= 16, even Dh <= 64
TILE_MAX_HEAD_DIM = 64

# signatures whose arguments passed `_check_call`
_checked: tp.Set[tuple] = set()


def reset_launch_counts() -> None:
    for counts in (launch_counts, backward_counts):
        for name in counts:
            counts[name] = 0


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


def kernel_route(dtype: torch.dtype, dstate: int, head_dim: int) -> str:
    """The kernel a call of these widths launches: 'ssd_scan' (the bf16
    tile kernel on the tensor cores, N <= 16 and even Dh <= 64) or
    'ssd_scan_fma' (f32, and bf16 at every other width)."""
    if (dtype == torch.bfloat16 and dstate <= TILE_MAX_STATE
            and head_dim <= TILE_MAX_HEAD_DIM and head_dim % 2 == 0):
        return "ssd_scan"
    return "ssd_scan_fma"


def _signature(*tensors: tp.Optional[torch.Tensor]) -> tuple:
    """What `_check_call` reads of its tensor arguments."""
    return tuple(None if t is None else (t.shape, t.stride(), t.dtype,
                                         t.device) for t in tensors)


def _check_call(c, b, v, la, state, mask, chunk: int) -> None:
    """Everything the kernel needs of its arguments; raises otherwise."""
    _check(c.dim() == 4 and v.dim() == 4, "c, b and v must be [B, T, H, *]")
    batch, seq, heads, dstate = c.shape
    dim = v.shape[-1]
    _check(c.dtype in (torch.float32, torch.bfloat16),
           f"dtype {c.dtype} unsupported (float32 or bfloat16)")
    _check(b.dtype == v.dtype == c.dtype, "c, b and v must share a dtype")
    _check(b.shape == c.shape and v.shape[:3] == c.shape[:3],
           f"c {tuple(c.shape)}, b {tuple(b.shape)} and v {tuple(v.shape)} "
           f"disagree")
    _check(la.shape == c.shape[:3] and la.dtype == torch.float32,
           "la must be float32 [B, T, H]")
    if state is not None:
        _check(state.shape == (batch, heads, dim, dstate)
               and state.dtype == torch.float32 and state.is_contiguous(),
               f"state must be contiguous float32 "
               f"{(batch, heads, dim, dstate)}")
    if mask is not None:
        _check(mask.shape == (batch, seq) and mask.dtype == torch.bool,
               "token_mask must be bool [B, T]")
    for name, t in (("c", c), ("b", b), ("v", v)):
        _check(t.shape[-1] == 1 or t.stride(-1) == 1,
               f"{name}'s last dimension must be contiguous (stride "
               f"{t.stride(-1)})")
    _check(1 <= chunk <= MAX_CHUNK, f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    _check(batch <= 65535 and heads <= 65535 and seq < 2 ** 31,
           f"sizes {tuple(c.shape)} exceed the kernel's grid")
    for t in (b, v, la, state, mask):
        _check(t is None or t.device == c.device,
               f"tensors span {t.device if t is not None else None} and "
               f"{c.device}")


def kernel_args(c: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                la: torch.Tensor, state: tp.Optional[torch.Tensor],
                mask: tp.Optional[torch.Tensor], chunk: int,
                y: torch.Tensor, final: torch.Tensor) -> _SsdArgs:
    """The kernel's argument block for `ssd_chunked_scan`'s [B, T, H, *]
    inputs, each read where it lies: c, b, v (last dimension contiguous)
    and f32 la by their element strides, the bool mask [B, T] by its
    strides (None: every token real), the contiguous f32 state (None: a
    zero state); y [B, T, H, Dh] and final [B, H, Dh, N] are the outputs.
    `cbv` says that b and v follow c in one row, as the model's projection
    lays them out, so the kernel copies each token's three slices at once.
    No tensor is copied; a layout the kernel does not take raises
    ValueError. The checks run once per signature."""
    signature = (chunk,) + _signature(c, b, v, la, state, mask)
    if signature not in _checked:
        _check_call(c, b, v, la, state, mask, chunk)
        _checked.add(signature)
    batch, seq, heads, dstate = c.shape
    step = dstate * c.element_size()
    # the model's projection: c, b, v adjacent in each [2N + Dh + 1] row
    cbv = (b.data_ptr() == c.data_ptr() + step
           and v.data_ptr() == c.data_ptr() + 2 * step
           and b.stride()[:3] == c.stride()[:3] == v.stride()[:3])
    return _SsdArgs(
        c=c.data_ptr(), b=b.data_ptr(), v=v.data_ptr(), la=la.data_ptr(),
        mask=None if mask is None else mask.data_ptr(),
        state_in=None if state is None else state.data_ptr(),
        y=y.data_ptr(), state_out=final.data_ptr(),
        c_stride=(ctypes.c_longlong * 3)(*c.stride()[:3]),
        b_stride=(ctypes.c_longlong * 3)(*b.stride()[:3]),
        v_stride=(ctypes.c_longlong * 3)(*v.stride()[:3]),
        la_stride=(ctypes.c_longlong * 3)(*la.stride()),
        mask_stride=(ctypes.c_longlong * 2)(
            *(mask.stride() if mask is not None else (0, 0))),
        B=batch, T=seq, H=heads, N=dstate, Dh=v.shape[-1], C=chunk,
        cbv=int(cbv))


def _launch(c, b, v, la, state, mask, chunk: int):
    """One kernel launch on [B, T, H, *] inputs: (y [B, T, H, Dh] in v's
    dtype, final state [B, H, Dh, N] f32)."""
    batch, seq, heads, dstate = c.shape
    dim = v.shape[-1]
    y = torch.empty((batch, seq, heads, dim), dtype=v.dtype,
                    device=c.device)
    final = torch.empty((batch, heads, dim, dstate), dtype=torch.float32,
                        device=c.device)
    args = kernel_args(c, b, v, la, state, mask, chunk, y, final)
    route = kernel_route(c.dtype, dstate, dim)
    lib = _build.load("ssd_scan", _FUNCTIONS)
    with torch.cuda.device(c.device):
        err = lib.flashy_ssd_scan(
            _VARIANTS[(route, c.dtype)], ctypes.byref(args),
            torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd scan kernel launch failed ({route}): "
                           f"cudaError {err}")
    launch_counts[route] += 1
    return y, final


def _plain_scan(c, b, v, la, state, mask, chunk: int):
    """The plain chunked form on [B, T, H, *] inputs, the token mask
    applied as `_masked_inputs` does: (y [B, T, H, Dh] in v's dtype, final
    state f32). `state=None` is a zero state."""
    b, la = _masked_inputs(b, la, mask)
    if state is None:
        state = torch.zeros((c.shape[0], c.shape[2], v.shape[-1],
                             c.shape[-1]), dtype=torch.float32,
                            device=c.device)
    y, final = _chunked_reference(
        _to_heads_first(c), _to_heads_first(b), _to_heads_first(v),
        _to_heads_first(la.float()), state.float(), chunk)
    return _to_heads_first(y).to(v.dtype), final


class SsdScanFunction(torch.autograd.Function):
    """The chunked scan for training: the forward is `forward_fn` (the
    Hopper kernel, `_launch`), which returns y and the final state; only
    the inputs are saved. The backward recomputes the plain chunked form
    (`_plain_scan`) on detached copies under grad and returns
    `torch.autograd.grad` of it for c, b, v, the log decays and the
    carried-in state; either output's gradient may be None. Each
    backward adds one to `backward_counts['ssd_scan_backward']`.

    `SsdScanFunction.apply(c, b, v, la, state, mask, chunk, forward_fn)`:
    la f32, state f32 or None, mask bool [B, T] or None.
    """

    @staticmethod
    def forward(ctx, c, b, v, la, state, mask, chunk, forward_fn):
        ctx.save_for_backward(c, b, v, la, state, mask)
        ctx.chunk = chunk
        return forward_fn(c, b, v, la, state, mask, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        *saved, mask = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [i for i, t in enumerate(inputs)
                  if t is not None and t.requires_grad]
        grads: tp.List[tp.Optional[torch.Tensor]] = [None] * len(inputs)
        if wanted and (grad_y is not None or grad_final is not None):
            with torch.enable_grad():
                y, final = _plain_scan(*inputs, mask, ctx.chunk)
            pairs = [(out, grad) for out, grad in ((y, grad_y),
                                                   (final, grad_final))
                     if grad is not None]
            found = torch.autograd.grad(
                [out for out, _ in pairs], [inputs[i] for i in wanted],
                [grad for _, grad in pairs], allow_unused=True)
            backward_counts["ssd_scan_backward"] += 1
            for i, grad in zip(wanted, found):
                grads[i] = grad
        return (*grads, None, None, None)


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
            plain version) or 'auto' (`default_ssd_kernel`). Where an
            input requires grad (and grad is on), 'fused' runs the kernel
            through `SsdScanFunction`, whose backward differentiates the
            plain version.

    Returns (y [B, T, H, Dh] in v's dtype, final state [B, H, Dh,
    Dstate] f32).
    """
    if kernel not in ("auto", "gather", "fused"):
        raise ValueError(f"kernel must be 'auto', 'gather' or 'fused', "
                         f"got {kernel!r}")
    if kernel == "auto":
        kernel = default_ssd_kernel(c.device)
    if kernel == "fused" and c.device.type != "cuda":
        raise ValueError(
            f"kernel='fused' cannot run here: the ssd scan kernel is "
            f"CUDA-only and the tensors lie on {c.device}; use "
            f"kernel='gather' (or 'auto')")
    seq = c.shape[1]
    if chunk is None:
        chunk = default_chunk(seq)
    elif chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    chunk = min(int(chunk), seq)
    if kernel == "gather":
        return _plain_scan(c, b, v, log_decay, state, token_mask, chunk)
    la = log_decay.float()
    state = None if state is None else state.float().contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (c, b, v, la, state)):
        return SsdScanFunction.apply(c, b, v, la, state, token_mask, chunk,
                                     _launch)
    return _launch(c, b, v, la, state, token_mask, chunk)


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

"""Single-kernel ring attention: the port of flashy_tpu/parallel/ring_fused.py.

The whole ring-attention forward of one rank is one launch of the
hand-written Hopper kernel `csrc/ring_attention.cu` in bf16 at head_dim
64 and 128, or of the flash forward's general route
`csrc/flash_general.cu` in f32 and at every other head dim (both
replace the Pallas TPU kernel `_fused_kernel`): for rank r it runs
the flash online softmax across the ring steps s = 0, 1, ... over the
K/V blocks of owners (r - s) mod n, skipping the steps s > r under
`causal` and masking step 0 in-block. The kernel pulls every visiting
block through a table of the ranks' K and V tensor maps (TMA; the flash
forward's Hopper step) or, on the general route, of the visible steps'
base pointers; the TPU kernel's RDMA slots, its communication sweep and
semaphores have no counterpart (see the kernel's source note). The backward is the scan ring's (`ring._ring_backward_pass`), as
the JAX custom VJP `_fused_bwd` has it.

`ring_forward_plain` is the kernel's plain version: the same loop in
PyTorch at the kernel's 64-key tile and in the same order, so in f32 it
is the same function and in bf16 it rounds P where the kernel does. The
wrapper `ring_forward` takes it only for tensors on the CPU; on CUDA it
launches the kernel or raises.
"""
import ctypes
import typing as tp

import torch

from ..ops import _build
from ..ops.attention import (_FLASH_DTYPES, _kernel_operand, _on_cpu,
                             counter_name, flash_route, flash_scale,
                             launch_general_forward,
                             online_softmax_blockwise)
from .ring import owner, run_ring, visible_steps

# Launches of the ring kernel, one per rank and forward, by route
# (`attention.counter_name`: "ring_fwd" and "ring_fwd_128" bf16 at head_dim
# 64 and 128 on `csrc/ring_attention.cu`, "ring_fwd_general" the general
# forward of `csrc/flash_general.cu`): a plain integer bumped where the
# kernel is launched and nowhere else.
launch_counts: tp.Dict[str, int] = {"ring_fwd": 0, "ring_fwd_128": 0,
                                    "ring_fwd_general": 0}

_POINTERS = ctypes.POINTER(ctypes.c_void_p)
_FUNCTIONS = {
    "flashy_ring_forward": (ctypes.c_int, (
        ctypes.c_void_p,                                     # q
        _POINTERS, _POINTERS, ctypes.c_int, ctypes.c_int,    # k, v, n, rank
        ctypes.c_void_p, ctypes.c_void_p,                    # out, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, T
        ctypes.c_int, ctypes.c_int,                          # D, causal
        ctypes.c_float, ctypes.c_void_p)),                   # scale, stream
    "flashy_tensor_map_us": (ctypes.c_double, (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # base, B, T
        ctypes.c_int, ctypes.c_int)),                        # H, reps
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def ring_forward_plain(q: torch.Tensor, ks: tp.Sequence[torch.Tensor],
                       vs: tp.Sequence[torch.Tensor], rank: int,
                       causal: bool = False
                       ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch for rank `rank`: one
    online softmax over the visible steps' blocks in ring order, 64 keys
    at a time. Returns (out [B, T, H, D] in q's dtype, lse [B, H, T])."""
    n = len(ks)
    blocks = [(ks[owner(rank, s, n)], vs[owner(rank, s, n)],
               causal and s == 0) for s in visible_steps(rank, n, causal)]
    return online_softmax_blockwise(q, blocks)


def _check_kernel_inputs(q, ks, vs, rank):
    def check(cond, message):
        if not cond:
            raise ValueError(f"ring attention kernel: {message}")

    check(len(ks) == len(vs) >= 1 and 0 <= rank < len(ks),
          f"{len(ks)} k and {len(vs)} v blocks for rank {rank}")
    check(q.dim() == 4 and all(x.shape == q.shape for x in (*ks, *vs)),
          f"every block must be [B, T, H, D] like q {tuple(q.shape)}")
    check(all(x.dtype == q.dtype for x in (*ks, *vs))
          and q.dtype in _FLASH_DTYPES,
          f"dtypes must all be float32 or all bfloat16, q is {q.dtype}")
    flash_route(q.shape[3], "ring_fwd", q.dtype)
    check(q.device.type == "cuda", f"runs on CUDA tensors, got {q.device}")
    check(all(x.device == q.device for x in (*ks, *vs)),
          "the ranks' blocks span devices")


def _launch(q, ks, vs, rank, causal):
    _check_kernel_inputs(q, ks, vs, rank)
    q = _kernel_operand(q)
    # contiguous, 16-byte aligned blocks; these references keep any copy
    # alive until the launch is enqueued, and the stream orders its reuse
    ks, vs = [_kernel_operand(x) for x in ks], [_kernel_operand(x) for x in vs]
    n = len(ks)
    name = counter_name("ring_fwd", q.shape[3], q.dtype)
    if name == "ring_fwd_general":
        # the flash forward's general route over the visible steps' blocks
        steps = [owner(rank, s, n) for s in visible_steps(rank, n, causal)]
        out, lse = launch_general_forward(q, [ks[i] for i in steps],
                                          [vs[i] for i in steps], causal)
        launch_counts[name] += 1
        return out, lse
    k_table = (ctypes.c_void_p * n)(*(x.data_ptr() for x in ks))
    v_table = (ctypes.c_void_p * n)(*(x.data_ptr() for x in vs))
    batch, t, heads, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, t), dtype=torch.float32,
                      device=q.device)
    lib = _build.load("ring_attention", _FUNCTIONS)
    with torch.cuda.device(q.device):
        err = lib.flashy_ring_forward(
            q.data_ptr(), k_table, v_table, n, rank,
            out.data_ptr(), lse.data_ptr(), batch, heads, t, dim,
            int(causal), flash_scale(dim),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise _build.launch_error("ring attention kernel launch failed", err)
    launch_counts[name] += 1
    return out, lse


def ring_forward(q: torch.Tensor, ks: tp.Sequence[torch.Tensor],
                 vs: tp.Sequence[torch.Tensor], rank: int,
                 causal: bool = False
                 ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Rank `rank`'s ring forward (out, lse [B, H, T]): the kernel on
    CUDA (bfloat16 at head_dim 64 and 128 on the ring kernel; float32, and
    bfloat16 at every other head dim, on the flash forward's general route
    over the visible steps' blocks), its plain version on the CPU."""
    if _on_cpu(q):
        return ring_forward_plain(q, ks, vs, rank, causal)
    return _launch(q, ks, vs, rank, causal)


def tensor_map_us(x: torch.Tensor, reps: int = 1000) -> float:
    """Host microseconds to encode one TMA tensor map of the bf16 [B, T,
    H, D] CUDA tensor `x` (the mean over `reps`): a bf16 launch encodes
    1 + 2n of them. Raises where the map is refused."""
    x = _kernel_operand(x)
    lib = _build.load("ring_attention", _FUNCTIONS)
    batch, t, heads, _ = x.shape
    us = lib.flashy_tensor_map_us(x.data_ptr(), batch, t, heads, reps)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused a TMA tensor map")
    return us


def _fused_forward_pass(qs, ks, vs, causal: bool):
    """Per-rank (outs, lses): one ring kernel launch per rank."""
    results = [ring_forward(q, ks, vs, rank, causal)
               for rank, q in enumerate(qs)]
    return [out for out, _ in results], [lse for _, lse in results]


def fused_ring_attention(qs: tp.Sequence[torch.Tensor],
                         ks: tp.Sequence[torch.Tensor],
                         vs: tp.Sequence[torch.Tensor],
                         causal: bool = False) -> tp.List[torch.Tensor]:
    """`ring.ring_attention`'s contract (the ranks' [B, T_local, H, D]
    blocks in ring order in, their output blocks out), with the forward
    one ring kernel per rank and the backward the scan ring's rotation
    pass."""
    return run_ring(_fused_forward_pass, qs, ks, vs, causal)

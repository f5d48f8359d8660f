"""Grouped matrix products over expert-sorted rows: the semantics of
megablox `gmm` and `tgmm` (the Pallas TPU kernels the JAX package's
dropless MoE layer calls, `jax/experimental/pallas/ops/tpu/megablox/
gmm.py`), on the hand-written Hopper kernels of `csrc/grouped_matmul.cu`.

Rows are sorted by group: group g owns rows `offsets[g]:offsets[g+1]`,
the prefix sums of `group_sizes` (an [E] int32 tensor) clamped to M.

* `gmm(lhs [M, K], rhs [E, K, N], group_sizes, out_dtype)` -> [M, N]:
  each group's rows times `rhs[g]`; with `transpose_rhs=True`, rhs is
  [E, N, K] and the rows multiply `rhs[g].T` (the input gradient of a
  grouped projection). Rows past `sum(group_sizes)` come out as zeros.
* `tgmm(lhs [M, K], rhs [M, N], group_sizes, out_dtype)` -> [E, K, N]:
  `out[g] = lhs[rows of g].T @ rhs[rows of g]` (the weight gradient); a
  group with no rows gives exact zeros. lhs is taken as it lies and
  contracted over its rows (megablox takes `lhs.swapaxes(0, 1)`).

Types follow megablox's `select_input_dtype`: two bf16 operands give
bf16 products with f32 accumulation; any f32 operand makes the products
f32, with f32 accumulation and no TF32. The result is cast to
`out_dtype`.

The plain versions `_gmm_reference` and `_tgmm_reference` (a loop over
groups of `torch.matmul` on f32-widened slices) are what CPU tensors
take. A CUDA tensor launches the kernel or raises; the kernels need K
and N to be multiples of 8. The CUDA path never reads the group sizes
to the host: the grid is sized from the static bound `ceil(M / 128) + E`
row-tile visits and each block finds its visit on the device.
"""
import ctypes
import typing as tp

import torch

from . import _build

# Launches of the kernels: a plain integer per kernel, bumped where the
# kernel is launched and nowhere else.
launch_counts: tp.Dict[str, int] = {"gmm": 0, "gmm_t": 0, "tgmm": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = (ctypes.c_int, (
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # lhs, rhs, out dtypes
    ctypes.c_void_p, ctypes.c_void_p,                   # lhs, rhs
    ctypes.c_void_p, ctypes.c_void_p,                   # group sizes, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # M, K, N
    ctypes.c_int, ctypes.c_void_p))                     # E, stream
_SYMBOLS = {"gmm": "flashy_gmm", "gmm_t": "flashy_gmm_t",
            "tgmm": "flashy_tgmm"}
_FUNCTIONS = {symbol: _SIGNATURE for symbol in _SYMBOLS.values()}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def group_offsets(group_sizes: torch.Tensor, m: int) -> torch.Tensor:
    """[E + 1] int64 row offsets of the groups, clamped to [0, m]."""
    ends = torch.cumsum(group_sizes.long().clamp(min=0), 0).clamp(max=m)
    return torch.cat([ends.new_zeros(1), ends])


def _gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, out_dtype: torch.dtype,
                   transpose_rhs: bool = False) -> torch.Tensor:
    """The plain version of `gmm`: per group, the f32-widened rows times
    the f32-widened weight (bf16 products are exact in f32, so this is
    the bf16-product, f32-accumulate rule too)."""
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((lhs.shape[0], n), dtype=torch.float32,
                      device=lhs.device)
    offsets = group_offsets(group_sizes, lhs.shape[0]).tolist()
    for g in range(rhs.shape[0]):
        lo, hi = offsets[g], offsets[g + 1]
        if hi > lo:
            w = rhs[g].float()
            out[lo:hi] = lhs[lo:hi].float() @ (w.t() if transpose_rhs else w)
    return out.to(out_dtype)


def _tgmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                    group_sizes: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of `tgmm`: per group, the f32-widened rows of lhs
    transposed times those of rhs; groups with no rows stay zero."""
    groups = group_sizes.shape[0]
    out = torch.zeros((groups, lhs.shape[1], rhs.shape[1]),
                      dtype=torch.float32, device=lhs.device)
    offsets = group_offsets(group_sizes, lhs.shape[0]).tolist()
    for g in range(groups):
        lo, hi = offsets[g], offsets[g + 1]
        if hi > lo:
            out[g] = lhs[lo:hi].float().t() @ rhs[lo:hi].float()
    return out.to(out_dtype)


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"grouped matmul: {message}")


def _validate(lhs, rhs, group_sizes, out_dtype, rhs_dims):
    _check(lhs.dim() == 2, f"lhs must be 2-D, got {tuple(lhs.shape)}")
    _check(rhs.dim() == rhs_dims, f"rhs must be {rhs_dims}-D, got "
                                  f"{tuple(rhs.shape)}")
    _check(group_sizes.dim() == 1 and group_sizes.dtype == torch.int32,
           f"group_sizes must be a 1-D int32 tensor, got "
           f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    _check(group_sizes.shape[0] >= 1, "no groups")
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        _check(t.dtype in _DTYPES, f"{name} dtype {t.dtype} unsupported "
                                   f"(float32 or bfloat16)")
    _check(out_dtype in _DTYPES, f"out_dtype {out_dtype} unsupported "
                                 f"(float32 or bfloat16)")
    for t in (rhs, group_sizes):
        _check(t.device == lhs.device, f"tensors span {t.device} and "
                                       f"{lhs.device}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"the grouped matmul kernels run on CUDA tensors "
                         f"(their plain versions on CPU tensors), got "
                         f"{t.device}")
    return False


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernels read rows
    16 bytes at a time): a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: torch.Tensor, out: torch.Tensor, k: int,
            n: int) -> torch.Tensor:
    _check(k % 8 == 0 and n % 8 == 0,
           f"the kernels need K and N to be multiples of 8, got K={k}, "
           f"N={n}")
    lhs, rhs = _kernel_operand(lhs), _kernel_operand(rhs)
    group_sizes = group_sizes.contiguous()
    lib = _build.load("grouped_matmul", _FUNCTIONS)
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        err = getattr(lib, _SYMBOLS[name])(
            _DTYPES[lhs.dtype], _DTYPES[rhs.dtype], _DTYPES[out.dtype],
            lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), lhs.shape[0], k, n, group_sizes.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"grouped matmul kernel {name} launch failed: "
                           f"cudaError {err}")
    launch_counts[name] += 1
    return out


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        out_dtype: torch.dtype = torch.float32,
        transpose_rhs: bool = False) -> torch.Tensor:
    """[M, N]: rows of group g times `rhs[g]` (or `rhs[g].T`).

    lhs [M, K]; rhs [E, K, N], or [E, N, K] with `transpose_rhs`;
    group_sizes [E] int32. Kernel `gmm` (or `gmm_t`) on CUDA tensors,
    `_gmm_reference` on CPU tensors.
    """
    _validate(lhs, rhs, group_sizes, out_dtype, 3)
    k = lhs.shape[1]
    n, rhs_k = ((rhs.shape[1], rhs.shape[2]) if transpose_rhs
                else (rhs.shape[2], rhs.shape[1]))
    _check(rhs_k == k and rhs.shape[0] == group_sizes.shape[0],
           f"lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} "
           f"(transpose_rhs={transpose_rhs}) and {group_sizes.shape[0]} "
           f"groups disagree")
    if _on_cpu(lhs):
        return _gmm_reference(lhs, rhs, group_sizes, out_dtype,
                              transpose_rhs)
    out = torch.empty((lhs.shape[0], n), dtype=out_dtype, device=lhs.device)
    if lhs.shape[0] == 0:
        return out
    return _launch("gmm_t" if transpose_rhs else "gmm", lhs, rhs,
                   group_sizes, out, k, n)


def tgmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[E, K, N]: per group, `lhs[rows of g].T @ rhs[rows of g]`.

    lhs [M, K]; rhs [M, N]; group_sizes [E] int32. Kernel `tgmm` on CUDA
    tensors, `_tgmm_reference` on CPU tensors.
    """
    _validate(lhs, rhs, group_sizes, out_dtype, 2)
    _check(rhs.shape[0] == lhs.shape[0],
           f"lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} have "
           f"different row counts")
    if _on_cpu(lhs):
        return _tgmm_reference(lhs, rhs, group_sizes, out_dtype)
    out = torch.empty((group_sizes.shape[0], lhs.shape[1], rhs.shape[1]),
                      dtype=out_dtype, device=lhs.device)
    return _launch("tgmm", lhs, rhs, group_sizes, out, lhs.shape[1],
                   rhs.shape[1])

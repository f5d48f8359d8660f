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
take. A CUDA tensor launches the kernel or raises. The kernels take K
and N that are multiples of 8 (TMA's 16-byte rows); for any other K or N
the wrapper pads the operands with zero columns up to the next multiple
(`pad_operands`) and slices the output back: zeros in give exact zeros
out, so the function does not change, and a width that 8 divides
launches as it is, with no copy. Two bf16 operands, or one bf16 and one
f32 (the second projection's backward), run on the tensor cores: the f32
operand is first split by a kernel of its own into three bf16 planes
(`split_bf16`: hi + mid + lo == x exactly for normal values of 2^-110 <=
|x| < 3.39e38), and the product runs over the three planes, each an
exact bf16 product summed in f32. `_gmm_split_reference` and
`_tgmm_split_reference` are that route's plain versions (per group, the
three products summed lo, mid, hi). Two f32 operands run scalar f32
FMAs.
The CUDA path never reads the group sizes to the host: each
block of the kernels finds its tiles on the device.
"""
import ctypes
import typing as tp

import torch

from . import _build

# Launches of the kernels: a plain integer per kernel and route, bumped
# where the kernel is launched and nowhere else. "<name>_padded" counts the
# launches whose K or N the wrapper padded to a multiple of 8.
launch_counts: tp.Dict[str, int] = {"gmm": 0, "gmm_t": 0, "tgmm": 0,
                                    "gmm_padded": 0, "gmm_t_padded": 0,
                                    "tgmm_padded": 0, "split_bf16": 0}
ALIGN = 8   # K and N the kernels take: multiples of this (16-byte TMA rows)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLANES = 2     # the C entry points' dtype code of an operand in planes
_SIGNATURE = (ctypes.c_int, (
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # lhs, rhs, out dtypes
    ctypes.c_void_p, ctypes.c_void_p,                   # lhs, rhs
    ctypes.c_void_p, ctypes.c_void_p,                   # group sizes, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # M, K, N
    ctypes.c_int, ctypes.c_void_p))                     # E, stream
_SYMBOLS = {"gmm": "flashy_gmm", "gmm_t": "flashy_gmm_t",
            "tgmm": "flashy_tgmm"}
_FUNCTIONS = {symbol: _SIGNATURE for symbol in _SYMBOLS.values()}
_FUNCTIONS["flashy_split_bf16"] = (ctypes.c_int, (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p))


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


def split_bf16(x: torch.Tensor
               ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, mid, lo), bf16 tensors of x's shape with hi + mid + lo == x
    exactly: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
    each rounded to nearest even, each subtraction exact in f32. Exact
    for normal values with 2^-110 <= |x| (below it lo's bits fall under
    bf16's smallest subnormal) and |x| under bf16's overflow threshold
    (2 - 2^-8) 2^127 ~ 3.39e38 (past it hi is inf); zeros split into
    zeros."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _split_sum(product, lhs: torch.Tensor, rhs: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """`product(a, b)` (an f32 grouped product) over the split route's
    operands, one f32 and one bf16: the f32 operand's planes lo, mid and
    hi each against the bf16 operand, summed in that order in f32."""
    _check({lhs.dtype, rhs.dtype} == {torch.float32, torch.bfloat16},
           f"the split route takes one f32 and one bf16 operand, got "
           f"{lhs.dtype} and {rhs.dtype}")
    if lhs.dtype == torch.float32:
        parts = [product(plane, rhs) for plane in split_bf16(lhs)[::-1]]
    else:
        parts = [product(lhs, plane) for plane in split_bf16(rhs)[::-1]]
    return (parts[0] + parts[1] + parts[2]).to(out_dtype)


def _gmm_split_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                         group_sizes: torch.Tensor, out_dtype: torch.dtype,
                         transpose_rhs: bool = False) -> torch.Tensor:
    """The plain version of the kernels' split route of `gmm`: one operand
    f32, the other bf16; per group, the f32 operand's three bf16 planes
    each times the bf16 operand (f32-widened, so each product is exact),
    summed lo, mid, hi in f32."""
    return _split_sum(lambda a, b: _gmm_reference(
        a, b, group_sizes, torch.float32, transpose_rhs), lhs, rhs,
        out_dtype)


def _tgmm_split_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                          group_sizes: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of the kernels' split route of `tgmm`, as
    `_gmm_split_reference`."""
    return _split_sum(lambda a, b: _tgmm_reference(
        a, b, group_sizes, torch.float32), lhs, rhs, out_dtype)


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


def _split_planes(t: torch.Tensor) -> torch.Tensor:
    """[3, *t.shape] bf16 planes (hi, mid, lo) of the f32 CUDA tensor t, by
    the split kernel: `split_bf16` of t, stacked."""
    _check(t.dtype == torch.float32 and not _on_cpu(t),
           f"the split kernel takes an f32 CUDA tensor, got {t.dtype} on "
           f"{t.device}")
    _check(t.numel() % 4 == 0, f"the split kernel takes a multiple of 4 "
                               f"values, got {t.numel()}")
    t = _kernel_operand(t)
    planes = torch.empty((3,) + tuple(t.shape), dtype=torch.bfloat16,
                         device=t.device)
    lib = _build.load("grouped_matmul", _FUNCTIONS)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.flashy_split_bf16(t.data_ptr(), planes.data_ptr(),
                                    t.numel(), stream)
    if err != 0:
        raise _build.launch_error("grouped matmul split kernel", err)
    launch_counts["split_bf16"] += 1
    return planes


def _padded(k: int) -> int:
    return -(-k // ALIGN) * ALIGN


def pad_operands(name: str, lhs: torch.Tensor, rhs: torch.Tensor, k: int,
                 n: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """lhs and rhs of kernel `name` with K and N padded by zero columns
    up to multiples of ALIGN: lhs [M, K] -> [M, K']; rhs [E, K, N]
    (gmm), [E, N, K] (gmm_t) or [M, N] (tgmm) likewise. The products of
    the pad columns are exact zeros, which the caller slices away."""
    kp, np_ = _padded(k) - k, _padded(n) - n
    lhs = torch.nn.functional.pad(lhs, (0, kp))
    if name == "gmm":
        rhs = torch.nn.functional.pad(rhs, (0, np_, 0, kp))
    elif name == "gmm_t":
        rhs = torch.nn.functional.pad(rhs, (0, kp, 0, np_))
    else:
        rhs = torch.nn.functional.pad(rhs, (0, np_))
    return lhs, rhs


def _launch(name: str, lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: torch.Tensor, out: torch.Tensor, k: int,
            n: int) -> torch.Tensor:
    """Kernel `name` into `out`. K or N that ALIGN does not divide takes
    the padded route: zero columns in, the padded output sliced back."""
    route = name
    if k % ALIGN or n % ALIGN:
        route = f"{name}_padded"
        lhs, rhs = pad_operands(name, lhs, rhs, k, n)
        full = out
        k, n = _padded(k), _padded(n)
        out = torch.empty(out.shape[:-2] + (
            k if name == "tgmm" else out.shape[-2], n), dtype=out.dtype,
            device=out.device)
    codes = [_DTYPES[lhs.dtype], _DTYPES[rhs.dtype]]
    operands = [lhs, rhs]
    if lhs.dtype != rhs.dtype:
        # the f32 operand as three bf16 planes for the tensor cores
        f32 = 0 if lhs.dtype == torch.float32 else 1
        operands[f32] = _split_planes(operands[f32])
        codes[f32] = _PLANES
    lhs_, rhs_ = (_kernel_operand(t) for t in operands)
    group_sizes = group_sizes.contiguous()
    lib = _build.load("grouped_matmul", _FUNCTIONS)
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        err = getattr(lib, _SYMBOLS[name])(
            codes[0], codes[1], _DTYPES[out.dtype], lhs_.data_ptr(),
            rhs_.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            lhs.shape[0], k, n, group_sizes.shape[0], stream)
    if err != 0:
        raise _build.launch_error(f"grouped matmul kernel {route}", err)
    launch_counts[route] += 1
    if route != name:
        full.copy_(out[..., :full.shape[-2], :full.shape[-1]])
        out = full
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
    if lhs.shape[0] == 0:
        return out.zero_()
    return _launch("tgmm", lhs, rhs, group_sizes, out, lhs.shape[1],
                   rhs.shape[1])

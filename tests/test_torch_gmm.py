# The grouped matmul kernels' split route (flashy_tpu_torch/ops/
# grouped_matmul.py: `split_bf16`, `_gmm_split_reference`,
# `_tgmm_split_reference`), held on the CPU against exact arithmetic and
# against the JAX package:
# * `split_bf16` writes an f32 tensor as three bf16 planes whose sum, in
#   f64, is the tensor exactly, over ±30 decades of seeded values, signed
#   zeros and values near bf16's largest finite value; the limits are
#   stated, not hidden: exact down to 2^-110 (below it the lowest plane's
#   bits fall under bf16's smallest subnormal), and past bf16's overflow
#   threshold (2 - 2^-8) 2^127 the hi plane is inf;
# * the split route's plain versions, in both mixed forms (f32 x bf16 and
#   bf16 x f32), against megablox `gmm` (plain and transpose_rhs) and
#   `tgmm` in interpret mode on the group-edge cases of
#   tests/test_torch_moe.py, 1e-5 of max |value| (f32 sums in another
#   order);
# * the bf16 grouped MLP's gradients with the split route swapped in for
#   its mixed launches, against jax.vjp through the megablox custom VJP.
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_moe import GROUP_CASES, TOL, _rel_close

BF16_MAX = float(torch.finfo(torch.bfloat16).max)
# the least f32 that rounds to inf in bf16: (2 - 2^-8) 2^127
BF16_OVERFLOW = (2 - 2 ** -8) * 2.0 ** 127


def _split_sum(x: np.ndarray) -> np.ndarray:
    from flashy_tpu_torch.ops.grouped_matmul import split_bf16
    hi, mid, lo = split_bf16(torch.from_numpy(x))
    return (hi.double() + mid.double() + lo.double()).numpy()


def _decades(rng):
    signs = rng.choice([-1.0, 1.0], 1 << 16)
    return (signs * rng.standard_normal(1 << 16).__abs__()
            * 10.0 ** rng.uniform(-30, 30, 1 << 16)).astype(np.float32)


SPLIT_CASES = {
    "thirty_decades": _decades,
    "signed_zeros": lambda rng: np.array([0.0, -0.0] * 8, np.float32),
    "near_bf16_max": lambda rng: (
        np.float32(BF16_MAX) * rng.uniform(0.5, 1.0, 4096).astype(np.float32)
        * rng.choice([-1.0, 1.0], 4096)).astype(np.float32),
    "at_the_limits": lambda rng: np.concatenate([
        # every mantissa bit set at random at exponent -110: the lowest is
        # 2^-133, bf16's smallest subnormal
        (2.0 ** 23 + rng.integers(0, 2 ** 23, 512)) * 2.0 ** -133
        * [[1], [-1]],
        [[np.nextafter(np.float32(BF16_OVERFLOW), np.float32(0)),
          -BF16_MAX]]], axis=None).astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_bf16_is_exact(case):
    x = SPLIT_CASES[case](np.random.default_rng(len(case)))
    assert np.array_equal(_split_sum(x), x.astype(np.float64)), case


def test_split_bf16_limits():
    from flashy_tpu_torch.ops.grouped_matmul import split_bf16
    # past the overflow threshold the hi plane is inf: no exact split
    big = torch.tensor([BF16_OVERFLOW, 3.4e38], dtype=torch.float32)
    assert torch.isinf(split_bf16(big)[0]).all()
    # below 2^-110 a bit under 2^-133 is lost: the split is not exact
    for tiny in ((2.0 ** 23 + 1) * 2.0 ** -134, 1.2345678e-40):
        x = np.array([tiny], np.float32)
        assert _split_sum(x)[0] != float(x[0])
    # each plane is what is left, rounded to nearest even
    x = torch.tensor([1 + 2 ** -10 + 2 ** -20], dtype=torch.float32)
    hi, mid, lo = split_bf16(x)
    assert (hi.item(), mid.item(), lo.item()) == (1.0, 2 ** -10, 2 ** -20)


def _megablox():
    # the kernels' module (the package exports its custom-VJP `gmm` under
    # the same name)
    return importlib.import_module(
        "jax.experimental.pallas.ops.tpu.megablox.gmm")


@pytest.mark.parametrize("form", ["f32_x_bf16", "bf16_x_f32"])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_split_references_match_megablox(case, form):
    from flashy_tpu_torch.ops import grouped_matmul as G
    megablox = _megablox()
    m, sizes = GROUP_CASES[case]
    k, n, groups = 16, 24, len(sizes)
    total = sum(sizes)
    rng = np.random.default_rng(len(sizes) * 100 + m + 7)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((groups, k, n)).astype(np.float32)
    rhs_t = rng.standard_normal((groups, n, k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    tiling = (4, 8, 8)
    lhs_bf16 = form == "bf16_x_f32"
    # the bf16 operand as bf16 on both sides, the f32 one as f32
    types = ((jnp.bfloat16, torch.bfloat16) if lhs_bf16
             else (jnp.float32, torch.float32),
             (jnp.float32, torch.float32) if lhs_bf16
             else (jnp.bfloat16, torch.bfloat16))

    def both(x, side):
        jt, tt = types[side]
        x = np.asarray(jnp.asarray(x, jt).astype(jnp.float32))
        return jnp.asarray(x, jt), torch.from_numpy(x).to(tt)

    (jl, tl), (jr, tr), (jrt, trt) = (both(lhs, 0), both(rhs, 1),
                                      both(rhs_t, 1))
    jgs, tgs = jnp.asarray(gs), torch.from_numpy(gs)

    got = G._gmm_split_reference(tl, tr, tgs, torch.float32).numpy()
    want = np.asarray(megablox.gmm(jl, jr, jgs, jnp.float32, tiling,
                                   interpret=True))
    _rel_close(got[:total], want[:total], TOL, "gmm")
    assert not got[total:].any(), "rows past the groups must be zeros"

    got = G._gmm_split_reference(tl, trt, tgs, torch.float32,
                                 transpose_rhs=True).numpy()
    want = np.asarray(megablox.gmm(jl, jrt, jgs, jnp.float32, tiling,
                                   transpose_rhs=True, interpret=True))
    _rel_close(got[:total], want[:total], TOL, "gmm_t")
    assert not got[total:].any()

    # tgmm: lhs rows contracted against dY rows, dY in the rhs's type
    (jd, td) = both(dy, 1)
    got = G._tgmm_split_reference(tl, td, tgs, torch.float32).numpy()
    want = np.asarray(megablox.tgmm(jl.T, jd, jgs, jnp.float32, tiling,
                                    interpret=True))
    _rel_close(got, want, TOL, "tgmm")
    for g, size in enumerate(sizes):
        if size == 0:
            assert not got[g].any(), "an empty group's tgmm must be zeros"


def _recording(reference, split_reference, calls):
    """`reference` with its mixed-dtype calls sent to `split_reference`
    (the kernels' route for an f32 operand against a bf16 one); every
    call's operands and result appended to `calls`."""
    def route(lhs, rhs, *args, **kwargs):
        fn = split_reference if lhs.dtype != rhs.dtype else reference
        out = fn(lhs, rhs, *args, **kwargs)
        calls.append((fn.__name__, lhs.detach(), rhs.detach(), out.detach()))
        return out
    return route


def _within_one_ulp(got, want, what):
    """bf16 `got` within one bf16 ulp (2^-8 relative) of each value of
    `want`, past a floor of 1e-5 of max |want| (gmm_check's bf16 bar)."""
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    excess = np.abs(got - want) - 2.0 ** -8 * np.abs(want)
    assert excess.max() <= TOL * np.abs(want).max(), (what, excess.max())


def test_bf16_grouped_mlp_grads_with_the_split_route_match_megablox_vjp(
        monkeypatch):
    """The bf16 grouped MLP (the MoE layer's compute dtype on the card)
    with the split route swapped in for its backward's two f32-dY
    launches, held projection by projection against jax.vjp through the
    megablox custom VJP (interpret mode) on the port's own intermediates
    (the two frameworks' bf16 gelu round apart, so each projection gets
    the same bf16 inputs): each projection's f32 output within 1e-5 of
    max |value|; its input and weight gradients, bf16 tensors, within one
    bf16 ulp of each value past a floor of 1e-5 of max |value| (f32 sums
    in another order before each cast to bf16). Every row is routed, as
    in the dropless layer."""
    from jax.experimental.pallas.ops.tpu.megablox import ops as mb_ops
    from flashy_tpu_torch.ops import grouped_matmul as G
    from flashy_tpu_torch.parallel import moe_ep
    calls = []
    monkeypatch.setattr(moe_ep, "gmm", _recording(
        G._gmm_reference, G._gmm_split_reference, calls))
    monkeypatch.setattr(moe_ep, "tgmm", _recording(
        G._tgmm_reference, G._tgmm_split_reference, calls))
    rng = np.random.default_rng(21)
    sizes = np.asarray([9, 0, 30, 25], np.int32)
    m, dim, hidden, groups = int(sizes.sum()), 32, 64, len(sizes)
    t = torch.from_numpy
    xs = t(rng.standard_normal((m, dim)).astype(np.float32)).bfloat16()
    w_up = t((rng.standard_normal((groups, dim, hidden)) * 0.2).astype(
        np.float32))
    w_down = t((rng.standard_normal((groups, hidden, dim)) * 0.2).astype(
        np.float32))
    cot = t(rng.standard_normal((m, dim)).astype(np.float32))
    x_t = xs.clone().requires_grad_()
    up_t, down_t = w_up.clone().requires_grad_(), w_down.clone(
    ).requires_grad_()
    moe_ep.grouped_mlp(x_t, up_t, down_t, t(sizes),
                       torch.bfloat16).backward(cot)
    # forward up, forward down, backward: gmm_t and tgmm on dY (split),
    # then gmm_t and tgmm on dH
    names = [c[0] for c in calls]
    assert names == ["_gmm_reference", "_gmm_reference",
                     "_gmm_split_reference", "_tgmm_split_reference",
                     "_gmm_reference", "_tgmm_reference"], names
    (_, x_in, up_in, h), (_, g_in, down_in, y) = calls[:2]
    dy, dh = calls[2][1], calls[4][1]

    def jnp_of(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16
                           if x.dtype == torch.bfloat16 else jnp.float32)

    tiling = (8, 8, 8)
    jsizes = jnp.asarray(sizes)
    for label, (lhs, rhs, out, cot_in, d_lhs, d_rhs) in {
            "up": (x_in, up_in, h, dh, x_t.grad, up_t.grad),
            "down": (g_in, down_in, y, dy, calls[2][3], down_t.grad),
    }.items():
        want, vjp = jax.vjp(lambda a, b: mb_ops.gmm(
            a, b, jsizes, jnp.float32, tiling, None, None, False, True),
            jnp_of(lhs), jnp_of(rhs))
        # JAX's cotangent of a bf16 cast is f32: dH (bf16 values) widened
        want_lhs, want_rhs = vjp(jnp.asarray(cot_in.float().numpy()))
        _rel_close(out.numpy(), np.asarray(want), TOL, f"{label} output")
        _within_one_ulp(d_lhs, want_lhs, f"{label} input gradient")
        # the f32 weight's gradient is the bf16 kernel result widened
        _within_one_ulp(d_rhs, want_rhs, f"{label} weight gradient")


@pytest.mark.parametrize("k,n", [(260, 12), (12, 100)])
def test_padded_operands_match_megablox_at_widths_8_does_not_divide(k, n):
    """K and N that 8 does not divide (the w260 layout's dim 260, and 12
    and 100): the wrappers pad both operands with zero columns up to a
    multiple of 8 (`pad_operands`) and slice the kernel's output back.
    The plain products on the padded operands, sliced, against megablox
    `gmm`, `gmm` with transpose_rhs and `tgmm` in interpret mode on the
    unpadded ones, f32, 1e-5 of max |value| (sums in another order): the
    pad columns add exact zeros, and the pad rows of tgmm come out zero."""
    from flashy_tpu_torch.ops import grouped_matmul as G
    megablox = _megablox()
    sizes = (9, 0, 30, 25)
    m, groups = sum(sizes), len(sizes)
    rng = np.random.default_rng(k + n)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((groups, k, n)).astype(np.float32)
    rhs_t = rng.standard_normal((groups, n, k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    jgs, tgs = jnp.asarray(gs), torch.from_numpy(gs)
    tiling = (8, k // 4 if k % 4 == 0 else k, n)
    t = torch.from_numpy
    f32 = torch.float32
    for name, args, ref, want in (
            ("gmm", (lhs, rhs), lambda a, b: G._gmm_reference(a, b, tgs, f32),
             megablox.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jgs,
                          jnp.float32, tiling, interpret=True)),
            ("gmm_t", (lhs, rhs_t),
             lambda a, b: G._gmm_reference(a, b, tgs, f32, True),
             megablox.gmm(jnp.asarray(lhs), jnp.asarray(rhs_t), jgs,
                          jnp.float32, tiling, transpose_rhs=True,
                          interpret=True)),
            ("tgmm", (lhs, dy), lambda a, b: G._tgmm_reference(a, b, tgs, f32),
             megablox.tgmm(jnp.asarray(lhs).T, jnp.asarray(dy), jgs,
                           jnp.float32, tiling, interpret=True))):
        a, b = G.pad_operands(name, *map(t, args), k, n)
        assert a.shape[-1] % G.ALIGN == 0 and b.shape[-1] % G.ALIGN == 0
        padded = ref(a, b)
        got = padded[..., :k, :n] if name == "tgmm" else padded[:, :n]
        _rel_close(got.numpy(), np.asarray(want), TOL, name)
        if name == "tgmm":
            assert not padded[:, k:].any() and not padded[..., n:].any()
        else:
            assert not padded[:, n:].any()

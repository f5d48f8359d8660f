# The port's flash attention (flashy_tpu_torch/ops/attention.py: the
# plain versions of the four Hopper kernels, and the autograd wrapper
# that takes them on the CPU) held against the JAX package's Pallas
# kernels in interpret mode on identical inputs. f32 tolerance 1e-5:
# reduction order only. The port's fused backward must be bit-equal to
# its split pair in both dtypes, as the JAX package pins for its own
# kernels. In bf16 the blockwise forward and backward are held to the
# Pallas kernels' rounding points.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape_q, shape_k, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(dtype)
    k = rng.standard_normal(shape_k).astype(dtype)
    v = rng.standard_normal(shape_k).astype(dtype)
    do = rng.standard_normal(shape_q).astype(dtype)
    return q, k, v, do


def _np_lse(q, k, causal):
    """Reference logsumexp [B, H, Tq] of the masked f32 scores (rows
    with no visible key at the forward's clamp floor)."""
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        visible = np.tril(np.ones((t_q, t_k), bool), t_k - t_q)
        scores = np.where(visible, scores, -np.inf)
    m = scores.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    total = np.exp(scores - m).sum(-1)
    return np.where(total > 0, m[..., 0] + np.log(np.maximum(total, 1e-300)),
                    -1e30)


# (t_q, t_k, causal, block): square, t_k > t_q, t_k < t_q with empty
# rows (whole skipped q-block at block 16, a mixed one at 32), and a T
# the blocks do not divide (JAX's reference there is its dense fallback)
CASES = [(64, 64, True, 32), (64, 64, False, 32), (32, 64, True, 16),
         (32, 16, True, 16), (32, 16, True, 32), (48, 48, True, 32),
         (40, 56, False, 32)]


@pytest.mark.parametrize("t_q,t_k,causal,block", CASES)
def test_blockwise_forward_matches_jax_flash(t_q, t_k, causal, block):
    from flashy_tpu.ops.attention import _flash_forward
    from flashy_tpu.ops.attention import flash_attention as jax_flash
    from flashy_tpu_torch.ops.attention import flash_forward_blockwise
    q, k, v, _ = _inputs((2, t_q, 2, 16), (2, t_k, 2, 16), seed=t_q + t_k)
    out, lse = flash_forward_blockwise(*map(torch.from_numpy, (q, k, v)),
                                       causal, block_k=block)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                     block_q=block, block_k=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    if t_q % block == 0 and t_k % block == 0:
        _, jax_lse = _flash_forward(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, block_q=block,
                                    block_k=block, interpret=True)
        want_lse = np.asarray(jax_lse)[:, :, 0].reshape(lse.shape)
        np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    np.testing.assert_allclose(lse.numpy(), _np_lse(q, k, causal), **TOL)
    if causal and t_k < t_q:
        np.testing.assert_array_equal(out.numpy()[:, :t_q - t_k], 0.0)


def _port_grads(q, k, v, do, causal, block):
    from flashy_tpu_torch.ops.attention import (
        flash_backward_dkv_blockwise, flash_backward_dq_blockwise,
        flash_backward_fused_blockwise, flash_delta, flash_forward_blockwise,
        fold_dq_partials)
    q, k, v, do = map(torch.as_tensor, (q, k, v, do))
    out, lse = flash_forward_blockwise(q, k, v, causal, block_k=block)
    delta = flash_delta(do, out)
    split = (flash_backward_dq_blockwise(q, k, v, do, lse, delta, causal,
                                         block_k=block),
             *flash_backward_dkv_blockwise(q, k, v, do, lse, delta, causal,
                                           block_q=block))
    dk, dv, partials = flash_backward_fused_blockwise(
        q, k, v, do, lse, delta, causal, block_q=block, block_k=block)
    return split, (fold_dq_partials(partials, q.dtype), dk, dv)


@pytest.mark.parametrize("t_q,t_k,causal,block", CASES)
def test_blockwise_backward_matches_jax_and_fused_equals_split(
        t_q, t_k, causal, block):
    from flashy_tpu.ops.attention import flash_attention as jax_flash
    q, k, v, do = _inputs((1, t_q, 2, 16), (1, t_k, 2, 16), seed=7)
    split, fused = _port_grads(q, k, v, do, causal, block)
    for a, b in zip(fused, split):
        assert torch.equal(a, b)
    for jax_fused in (True, False):
        _, vjp = jax.vjp(lambda q, k, v: jax_flash(
            q, k, v, causal=causal, block_q=block, block_k=block,
            fused_backward=jax_fused), *map(jnp.asarray, (q, k, v)))
        for got, want in zip(split, vjp(jnp.asarray(do))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal and t_k < t_q:
        np.testing.assert_array_equal(split[0].numpy()[:, :t_q - t_k], 0.0)


def _placement_misses(got, want):
    """(largest excess over one bf16 ulp of |want|, share not bit-equal)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    excess = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
    return float(excess.max()), float((got != want).mean())


def test_bf16_forward_rounds_where_the_pallas_kernel_does():
    # The kernel rounds the unnormalized P to bf16 once per k-block; the
    # blockwise forward must round at the same points (at most 1% of
    # outputs not bit-equal, each within one bf16 ulp), which the dense
    # path, rounding the normalized P over the whole row, does not.
    from flashy_tpu.ops.attention import flash_attention as jax_flash
    from flashy_tpu_torch.ops.attention import (dot_product_attention,
                                                flash_forward_blockwise)
    q, k, v, _ = _inputs((2, 128, 2, 32), (2, 128, 2, 32), seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=32,
                                block_k=32).astype(jnp.float32))
    got, _ = flash_forward_blockwise(tq, tk, tv, True, block_k=32)
    excess, share = _placement_misses(got.float().numpy(), want)
    assert excess <= 2.0 ** -10 and share <= 0.01, (excess, share)
    dense = dot_product_attention(tq, tk, tv, causal=True)
    _, dense_share = _placement_misses(dense.float().numpy(), want)
    assert dense_share > 0.01, dense_share


@pytest.mark.parametrize("jax_fused", [True, False])
def test_bf16_backward_rounds_where_the_pallas_kernels_do(jax_fused):
    # The backward kernels round P to bf16 before P^T.dO and dS before
    # dS^T.Q and dS.K; the blockwise split and fused versions must round
    # at the same points as JAX's Pallas backward (either form): each
    # gradient within one bf16 ulp of |want| plus 2^-9 (a P or dS whose
    # f32 value sits on a bf16 rounding boundary may round the other way,
    # the two frameworks' exp differing by an f32 ulp: one ulp of P times
    # |dO| at these unit-scale inputs), at most 1% not bit-equal. Dense
    # autograd in f32, which rounds only the gradients, misses that
    # share.
    from flashy_tpu.ops.attention import flash_attention as jax_flash
    from flashy_tpu_torch.ops.attention import dot_product_attention
    q, k, v, do = _inputs((2, 128, 2, 32), (2, 128, 2, 32), seed=3)
    split, fused = _port_grads(*(torch.from_numpy(x).bfloat16()
                                 for x in (q, k, v, do)), True, 32)
    for a, b in zip(fused, split):
        assert torch.equal(a, b)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=True, block_q=32, block_k=32,
        fused_backward=jax_fused), jq, jk, jv)
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jdo)]
    leaves = [torch.from_numpy(x).bfloat16().float().requires_grad_()
              for x in (q, k, v)]
    dot_product_attention(*leaves, causal=True).backward(
        torch.from_numpy(do).bfloat16().float())
    for got, dense, w in zip(split, leaves, want):
        excess = (np.abs(got.float().numpy() - w) - 2.0 ** -7 * np.abs(w))
        share = float((got.float().numpy() != w).mean())
        assert excess.max() <= 2.0 ** -9 and share <= 0.01, (excess.max(),
                                                               share)
        _, dense_share = _placement_misses(
            dense.grad.bfloat16().float().numpy(), w)
        assert dense_share > 0.01, dense_share


@pytest.mark.parametrize("t_q,t_k,causal,block", CASES)
def test_bf16_blockwise_fused_equals_split(t_q, t_k, causal, block):
    # The kernels' contract in bf16 too: the fused backward's dQ (its
    # partials folded in k order) and its dK, dV bit-equal to the split
    # pair's.
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(
        (1, t_q, 2, 16), (1, t_k, 2, 16), seed=t_q * t_k))
    split, fused = _port_grads(q, k, v, do, causal, block)
    for a, b in zip(fused, split):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_fused_returns_the_folded_gradient(dtype):
    # `flash_backward_fused` returns (dq, dk, dv), as JAX's
    # `_flash_backward_fused` does: dq is `fold_dq_partials` of the plain
    # version's partials, bit for bit, and dk, dv are its own.
    from flashy_tpu_torch.ops.attention import (
        flash_backward_fused, flash_backward_fused_blockwise, flash_delta,
        flash_forward, fold_dq_partials)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(
        (2, 96, 2, 64), (2, 160, 2, 64), seed=19))
    out, lse = flash_forward(q, k, v, True)
    args = (q, k, v, do, lse, flash_delta(do, out), True)
    dq, dk, dv = flash_backward_fused(*args)
    want_dk, want_dv, partials = flash_backward_fused_blockwise(*args)
    assert dq.shape == q.shape and dq.dtype == dtype
    assert torch.equal(dq, fold_dq_partials(partials, dtype))
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


def test_wrapper_on_cpu_runs_the_plain_versions_at_the_kernel_tile():
    from flashy_tpu_torch.ops.attention import (FLASH_BLOCK, flash_attention,
                                                launch_counts)
    q, k, v, do = _inputs((1, 96, 2, 16), (1, 96, 2, 16), seed=11)
    before = dict(launch_counts)
    grads = {}
    for fused in (None, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, causal=True, fused_backward=fused)
        out.backward(torch.from_numpy(do))
        grads[fused] = [x.grad for x in leaves]
    assert launch_counts == before  # no kernel on the CPU
    split, fused = _port_grads(q, k, v, do, True, FLASH_BLOCK)
    for a, b, c in zip(grads[None], grads[False], split):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_kernel_path_refuses_what_the_kernels_do_not_take():
    from flashy_tpu_torch.ops import attention
    meta = dict(device="meta")
    # head_dim 32 is no longer refused: it takes the general route, as
    # every head_dim does in f32 and all but 64 and 128 do in bf16, above
    # 256 too (the head dim in slabs of 128); below 1 raises
    assert attention.flash_route(32) == "general"
    assert attention.flash_route(300) == attention.flash_route(576) == \
        "general"
    with pytest.raises(ValueError, match="head_dim 0"):
        attention.flash_route(0)
    # bf16 at 64 and 128 runs the Hopper kernels, each counted by width
    for kernel in (*attention._KERNEL_NAMES, "ring_fwd"):
        for dim in (64, 128):
            assert attention.flash_route(dim, kernel) == "hopper"
            assert attention.flash_route(
                dim, kernel, torch.float32) == "general"
        assert attention.counter_name(kernel, 64) == kernel
        assert attention.counter_name(kernel, 128) == f"{kernel}_128"
        assert attention.counter_name(kernel, 64, torch.float32) == \
            f"{kernel}_general"
        assert attention.counter_name(kernel, 96) == f"{kernel}_general"
    q = torch.empty((1, 8, 2, 32), **meta)
    with pytest.raises(ValueError, match="runs on CUDA"):
        attention._check_kernel_inputs(q, q, q)
    q = torch.empty((1, 8, 2, 300), **meta)
    with pytest.raises(ValueError, match="runs on CUDA"):
        attention._check_kernel_inputs(q, q, q)
    q = torch.empty((1, 8, 2, 64), dtype=torch.float16, **meta)
    with pytest.raises(ValueError, match="dtypes"):
        attention._check_kernel_inputs(q, q, q)
    q = torch.empty((1, 8, 2, 64), **meta)
    with pytest.raises(ValueError, match="runs on CUDA"):
        attention._check_kernel_inputs(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.flash_attention(q, q, q)
    stat = torch.empty((1, 2, 8), **meta)
    attention._check_backward_inputs(q, q, stat, stat)
    with pytest.raises(ValueError, match="dO"):
        attention._check_backward_inputs(q, q[:, :4], stat, stat)
    with pytest.raises(ValueError, match="lse must be float32"):
        attention._check_backward_inputs(q, q, stat[:, :, :4], stat)
    with pytest.raises(ValueError, match="D must be float32"):
        attention._check_backward_inputs(q, q, stat, stat.bfloat16())


@pytest.mark.parametrize("dim", [32, 65, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax_flash_at_general_head_dims(dim, causal):
    # Head dims of the general route (flash_general.cu) in f32: 32, an odd
    # 65 and the d128 layout's 128. The Pallas kernels take every one of them
    # in interpret mode, so the port's plain versions, at the kernels' own
    # 64-key tile, are held to JAX's `flash_attention` there (forward,
    # logsumexp and both backwards), f32 1e-5; fused bit-equal to split.
    from flashy_tpu.ops.attention import _flash_forward
    from flashy_tpu.ops.attention import flash_attention as jax_flash
    from flashy_tpu_torch.ops.attention import (FLASH_BLOCK, flash_route,
                                                flash_forward_blockwise)
    assert flash_route(dim, "flash_bwd_fused", torch.float32) == "general"
    t = 128
    q, k, v, do = _inputs((1, t, 2, dim), (1, t, 2, dim), seed=dim)
    out, lse = flash_forward_blockwise(*map(torch.from_numpy, (q, k, v)),
                                       causal)
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    want = jax_flash(*jargs, causal=causal, block_q=FLASH_BLOCK,
                     block_k=FLASH_BLOCK)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    _, jax_lse = _flash_forward(*jargs, causal=causal, block_q=FLASH_BLOCK,
                                block_k=FLASH_BLOCK, interpret=True)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax_lse)[:, :, 0].reshape(lse.shape), **TOL)
    split, fused = _port_grads(q, k, v, do, causal, FLASH_BLOCK)
    for a, b in zip(fused, split):
        assert torch.equal(a, b)
    for jax_fused in (True, False):
        _, vjp = jax.vjp(lambda q, k, v: jax_flash(
            q, k, v, causal=causal, block_q=FLASH_BLOCK, block_k=FLASH_BLOCK,
            fused_backward=jax_fused), *jargs)
        for got, want in zip(split, vjp(jnp.asarray(do))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

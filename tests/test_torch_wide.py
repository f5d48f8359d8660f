# The general routes at the widths that used to be refused (ROADMAP queue
# C, C1b and C2b), on the CPU: the flash general route's head-dim plan
# (`csrc/flash_general.cu` tiles the head dim in slabs of up to 128
# columns) keeps a block's shared memory within the 227 KB of an H100
# block at every head dim from 1 to 4096, and the plain path it is held to
# on the card matches the JAX package's flash attention (Pallas kernels in
# interpret mode) at head dims 320 and 576, f32, 1e-5 (reduction order
# only); the paged general route's shared memory does not depend on the
# block size, and the entry-by-entry reference it is held to matches the
# JAX Pallas kernel in interpret mode on one table entry of 1024 keys
# (f32 1e-5; bf16 within one ulp, almost everywhere bit-equal).
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_flash import TOL, _inputs, _port_grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_flash_plan_fits_every_head_dim(dtype):
    from flashy_tpu_torch.ops import attention
    for dim in range(1, 4097):
        for kernel in (*attention._KERNEL_NAMES, "ring_fwd"):
            route = attention.flash_route(dim, kernel, dtype)
            assert route == ("hopper" if dtype == torch.bfloat16
                             and dim in (64, 128) else "general")
        plan = attention.general_plan(dim)
        width, slabs = plan["width"], plan["slabs"]
        assert width % 32 == 0 and width <= attention.GENERAL_SLAB
        assert (slabs - 1) * width < dim <= slabs * width
        assert plan["rows"] == attention.FLASH_BLOCK
        assert plan["forward_smem"] <= attention.SMEM_BYTES
        assert plan["backward_smem"] <= attention.SMEM_BYTES
    # one slab up to 128 (the layouts before C1b keep their tiles), then
    # slabs of 128: sarvam-105b's 576 in five
    assert attention.general_plan(96) == {**attention.general_plan(96),
                                          "width": 96, "slabs": 1}
    assert (attention.general_plan(576)["width"],
            attention.general_plan(576)["slabs"]) == (128, 5)


@pytest.mark.parametrize("dim", [320, 576])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax_flash_above_256(dim, causal):
    # Head dims past the old 256 bound, on the general route: the port's
    # plain versions at the kernels' 64-key tile (what the card holds the
    # slab kernels to) against JAX's `flash_attention`, forward,
    # logsumexp and both backwards, f32 1e-5; fused bit-equal to split.
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
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=FLASH_BLOCK, block_k=FLASH_BLOCK),
        *jargs)
    for got, want in zip(split, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dim", [64, 256])
def test_paged_general_smem_ignores_the_block_size(dim):
    # An entry past 64 keys goes through shared memory in two passes of
    # 64-key chunks, so what a block keeps depends on its query rows and
    # the head dim only: the wrapper takes every block size (meta
    # tensors: the checks need no data), one block of 65,536 keys too.
    import inspect
    from flashy_tpu_torch.ops.paged_decode import (SMEM_BYTES, _check_call,
                                                   general_smem_bytes,
                                                   kernel_route)
    assert "block_size" not in inspect.signature(general_smem_bytes
                                                 ).parameters
    assert general_smem_bytes(1, dim, torch.float32) <= SMEM_BYTES
    meta = dict(device="meta")
    q = torch.zeros((1, 64, 2, dim), **meta)
    table = torch.zeros((1, 1), dtype=torch.int32, **meta)
    positions = torch.arange(64, **meta)[None]
    for bs in (65, 200, 1024, 16384, 65536):
        assert kernel_route(dim, bs) == "general"
        entry = {name: torch.zeros((2, bs, 2, dim), **meta)
                 for name in ("k", "v")}
        _check_call(q, entry, table, positions, dim)


def _one_block(kv_dtype, dtype, seed=3, bs=1024, heads=2, dim=16):
    """One table entry of `bs` keys per slot (slot 2 all-sentinel), the
    JAX entry and the port's entry on the same values."""
    from flashy_tpu.models.quantize import quantize_kv
    rng = np.random.default_rng(seed)
    shape = (3, bs, heads, dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = quantize_kv(jnp.asarray(k)), quantize_kv(
            jnp.asarray(v))
        jentry = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        entry = {n: torch.from_numpy(np.array(a)) for n, a in jentry.items()}
    else:
        jentry = {"k": jnp.asarray(k, dtype), "v": jnp.asarray(v, dtype)}
        entry = {n: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
            for n, a in jentry.items()}
    table = np.array([[1], [2], [0]], np.int32)
    return jentry, entry, table


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("queries", [1, 5])
def test_entrywise_matches_jax_kernel_on_one_block_of_1024_keys(kv_dtype,
                                                                queries):
    # One table entry of 1024 keys (C2b's shape at a CPU size): the
    # entry-by-entry reference against the Pallas kernel in interpret
    # mode, f32 within 1e-5, and in bf16 (model pools) within one ulp
    # with at most 1% of outputs not bit-equal.
    from flashy_tpu.ops.paged_decode import fused_paged_attention as jax_fused
    from flashy_tpu_torch.ops.paged_decode import entrywise_paged_attention
    rng = np.random.default_rng(queries)
    base = np.array([1023 - queries + 1, 700, 300])
    positions = (base[:, None] + np.arange(queries)).astype(np.int32)
    dtypes = [(jnp.float32, torch.float32)]
    if kv_dtype == "model":
        dtypes.append((jnp.bfloat16, torch.bfloat16))
    for jdtype, tdtype in dtypes:
        jentry, entry, table = _one_block(kv_dtype, jdtype)
        dim = entry["k"].shape[-1]
        q = rng.normal(size=(3, queries, 2, dim)).astype(np.float32)
        want = np.asarray(jax_fused(
            jnp.asarray(q, jdtype), jentry, jnp.asarray(table),
            jnp.asarray(positions), head_dim=dim, dtype=jdtype,
            interpret=True).astype(jnp.float32))
        got = entrywise_paged_attention(
            torch.from_numpy(q), entry, torch.from_numpy(table),
            torch.from_numpy(positions), head_dim=dim,
            dtype=tdtype).float().numpy()
        if tdtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -10)
            assert float((got != want).mean()) <= 0.01

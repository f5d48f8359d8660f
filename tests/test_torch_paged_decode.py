# The port's paged read (flashy_tpu_torch/ops/paged_attention.py, the
# plain version of the Hopper kernel, and ops/paged_decode.py, the
# kernel's wrapper and its entry-by-entry reference) held against the
# JAX package's gather path and its Pallas kernel in interpret mode, on
# identical f32 pools. Tolerance 1e-5: f32 reduction order only (the
# JAX package holds its own gather/fused pair to the same order of
# agreement). In bf16 the entry-by-entry reference is held to the
# Pallas kernel's rounding points.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import tiny_pair

BS, HEADS, DH, ENTRIES, BLOCKS = 4, 2, 8, 4, 10
# slot 0 and 1: live blocks then sentinel padding; slot 2: all-sentinel
TABLE = np.array([[3, 7, 2, 0], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
BASE = np.array([9, 2, 5])


def _pools(kv_dtype, seed=0):
    """One layer's pool as numpy arrays (int8 via the JAX quantizer)."""
    from flashy_tpu.models.quantize import quantize_kv
    rng = np.random.default_rng(seed)
    shape = (BLOCKS, BS, HEADS, DH)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if kv_dtype == "model":
        return {"k": k, "v": v}
    kq, ks = quantize_kv(jnp.asarray(k))
    vq, vs = quantize_kv(jnp.asarray(v))
    return {name: np.array(a) for name, a in
            (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))}


def _case(kv_dtype, queries):
    pools = _pools(kv_dtype)
    q = np.random.default_rng(1).normal(
        size=(len(TABLE), queries, HEADS, DH)).astype(np.float32)
    positions = (BASE[:, None] + np.arange(queries)[None]).astype(np.int32)
    return q, pools, positions


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("queries", [1, 3, 5])
def test_plain_paged_attention_matches_jax_gather_and_kernel(kv_dtype,
                                                              queries):
    from flashy_tpu.ops.paged_attention import paged_attention as jax_gather
    from flashy_tpu.ops.paged_decode import fused_paged_attention as jax_fused
    from flashy_tpu_torch.ops.paged_attention import paged_attention
    from flashy_tpu_torch.ops.paged_decode import entrywise_paged_attention

    q, pools, positions = _case(kv_dtype, queries)
    jentry = {n: jnp.asarray(a) for n, a in pools.items()}
    args = (jnp.asarray(q), jentry, jnp.asarray(TABLE),
            jnp.asarray(positions))
    want_gather = np.asarray(jax_gather(*args, head_dim=DH,
                                        dtype=jnp.float32))
    want_kernel = np.asarray(jax_fused(*args, head_dim=DH,
                                       dtype=jnp.float32, interpret=True))
    got = paged_attention(
        torch.from_numpy(q), {n: torch.from_numpy(a) for n, a in
                              pools.items()},
        torch.from_numpy(TABLE), torch.from_numpy(positions),
        head_dim=DH, dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want_gather, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
    entrywise = entrywise_paged_attention(
        torch.from_numpy(q), {n: torch.from_numpy(a) for n, a in
                              pools.items()},
        torch.from_numpy(TABLE), torch.from_numpy(positions),
        head_dim=DH, dtype=torch.float32).numpy()
    np.testing.assert_allclose(entrywise, want_kernel, rtol=1e-5, atol=1e-5)


def _bf16_case(kv_dtype, queries, seed=5):
    """A wider bf16 case (16-entry tables, ragged slots) for rounding
    placement: numpy pools, the JAX entry and the port's entry."""
    from flashy_tpu.models.quantize import quantize_kv
    rng = np.random.default_rng(seed)
    batch, heads, dim, entries = 4, 4, 32, 16
    n = 1 + batch * entries
    k, v = (rng.normal(size=(n, BS, heads, dim)).astype(np.float32)
            for _ in range(2))
    if kv_dtype == "model":
        jentry = {"k": jnp.asarray(k, jnp.bfloat16),
                  "v": jnp.asarray(v, jnp.bfloat16)}
        entry = {n_: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16) for n_, a in jentry.items()}
    else:
        (kq, ks), (vq, vs) = quantize_kv(jnp.asarray(k)), quantize_kv(
            jnp.asarray(v))
        jentry = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        entry = {n_: torch.from_numpy(np.array(a)) for n_, a in
                 jentry.items()}
    base = np.array([58, 13, 33, 2])
    table = np.zeros((batch, entries), np.int32)
    blocks = rng.permutation(n - 1) + 1
    for b in range(batch):
        live = (base[b] + queries - 1) // BS + 1
        table[b, :live] = blocks[b * entries:b * entries + live]
    positions = (base[:, None] + np.arange(queries)).astype(np.int32)
    q = rng.normal(size=(batch, queries, heads, dim)).astype(np.float32)
    return q, jentry, entry, table, positions


def _mismatch_share(got, want):
    """Share of output elements that are not bit-equal."""
    return float((got != want).mean())


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("queries", [1, 5])
def test_entrywise_reference_rounds_where_the_jax_kernel_does(kv_dtype,
                                                              queries):
    # bf16: the entry-by-entry reference (what the CUDA kernel is held
    # to on the card) against the Pallas kernel in interpret mode. The
    # gather version, which rounds P after normalizing the whole row,
    # is the control: the mismatch share tells the two placements apart.
    from flashy_tpu.ops.paged_decode import fused_paged_attention as jax_fused
    from flashy_tpu_torch.ops.paged_attention import paged_attention
    from flashy_tpu_torch.ops.paged_decode import entrywise_paged_attention
    q, jentry, entry, table, positions = _bf16_case(kv_dtype, queries)
    dim = q.shape[-1]
    want = np.asarray(jax_fused(
        jnp.asarray(q, jnp.bfloat16), jentry, jnp.asarray(table),
        jnp.asarray(positions), head_dim=dim, dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    args = (torch.from_numpy(q), entry, torch.from_numpy(table),
            torch.from_numpy(positions))
    got = entrywise_paged_attention(*args, head_dim=dim,
                                    dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # at most one bf16 ulp of |want| apart (2^-10 floor near zero), and
    # almost everywhere bit-equal: f32 summation order may flip the
    # rounding of a rare P element, a shifted rounding point flips many
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -10)
    assert _mismatch_share(got, want) <= 0.01
    gather = paged_attention(*args, head_dim=dim, dtype=torch.bfloat16)
    assert _mismatch_share(gather.float().numpy(), want) > 0.05


def test_quantize_kv_bit_equal_to_jax():
    from flashy_tpu.models.quantize import quantize_kv as jax_quantize
    from flashy_tpu_torch.models.quantize import dequantize_kv, quantize_kv
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 3, 16)).astype(np.float32) * 3
    x[0, 0] = 0.0                                    # all-zero row
    # absmax 254 -> scale 2: x/scale lands on .5 ties (half to even)
    x[1, 2] = 0.0
    x[1, 2, :5] = [254.0, 1.0, 3.0, -5.0, 7.0]
    jq, js = (np.asarray(a) for a in jax_quantize(jnp.asarray(x)))
    tq, ts = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts[0, 0].item() == 1.0 and not tq[0, 0].any()
    assert tq[1, 2, :5].tolist() == [127, 0, 2, -2, 4]
    np.testing.assert_allclose(dequantize_kv(tq, ts).numpy(), x,
                               atol=np.abs(x).max() / 254 + 1e-6)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_wrapper_on_cpu_tensors_takes_the_plain_version(kv_dtype):
    from flashy_tpu_torch.ops import paged_decode
    from flashy_tpu_torch.ops.paged_attention import paged_attention

    q, pools, positions = _case(kv_dtype, 3)
    args = (torch.from_numpy(q),
            {n: torch.from_numpy(a) for n, a in pools.items()},
            torch.from_numpy(TABLE), torch.from_numpy(positions))
    before = dict(paged_decode.launch_counts)
    got = paged_decode.fused_paged_attention(*args, head_dim=DH,
                                             dtype=torch.float32)
    want = paged_attention(*args, head_dim=DH, dtype=torch.float32)
    assert torch.equal(got, want)
    assert paged_decode.launch_counts == before  # no kernel launch counted
    verify = paged_decode.fused_speculative_verify(
        *args, head_dim=DH, dtype=torch.float32)
    assert torch.equal(verify, want)
    with pytest.raises(ValueError, match="k\\+1 >= 2"):
        paged_decode.fused_speculative_verify(
            args[0][:, :1], *args[1:3], args[3][:, :1], head_dim=DH,
            dtype=torch.float32)


def test_explicit_fused_kernel_on_cpu_raises():
    from flashy_tpu_torch.serve.engine import DecodeEngine
    _, _, model = tiny_pair()
    with pytest.raises(ValueError, match="CUDA-only"):
        DecodeEngine(model, slots=2, block_size=4, kernel="fused",
                     cache_layout="paged", device="cpu")


def test_decode_read_bytes_per_token_matches_jax():
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.ops.paged_decode import decode_read_bytes_per_token \
        as jax_bytes
    from flashy_tpu_torch.models.transformer import TransformerConfig
    from flashy_tpu_torch.ops.paged_decode import decode_read_bytes_per_token
    kw = dict(vocab_size=32768, dim=1024, num_layers=12, num_heads=16)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        for kv in ("model", "int8"):
            assert decode_read_bytes_per_token(
                TransformerConfig(**kw, dtype=tdt), 192, kv) == jax_bytes(
                JaxConfig(**kw, dtype=jdt), 192, kv)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_paged_write_and_slot_readback_match_jax(kv_dtype):
    from flashy_tpu.ops.paged_attention import paged_write as jax_write
    from flashy_tpu.ops.paged_attention import slot_kv as jax_slot_kv
    from flashy_tpu_torch.ops.paged_attention import paged_write, slot_kv
    pools = _pools(kv_dtype)
    rng = np.random.default_rng(4)
    new_k, new_v = (rng.normal(size=(3, 2, HEADS, DH)).astype(np.float32)
                    for _ in range(2))
    # slot 2 writes past its table's coverage: redirected to the sentinel
    positions = np.array([[6, 7], [3, 4], [16, 17]], np.int32)
    jentry = jax_write({n: jnp.asarray(a) for n, a in pools.items()},
                       jnp.asarray(new_k), jnp.asarray(new_v),
                       jnp.asarray(TABLE), jnp.asarray(positions))
    entry = paged_write({n: torch.from_numpy(a.copy())
                         for n, a in pools.items()},
                        torch.from_numpy(new_k), torch.from_numpy(new_v),
                        torch.from_numpy(TABLE), torch.from_numpy(positions))
    for name in pools:
        np.testing.assert_array_equal(entry[name].numpy(),
                                      np.asarray(jentry[name]))
    for row in TABLE:
        jk, jv = jax_slot_kv(jentry, row, 10)
        k, v = slot_kv(entry, row, 10)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)


def _growing_case(kv_dtype, bs, queries, seed=11):
    """bf16 pools whose scores grow from entry to entry: every key of
    logical entry e carries 3e/4 times the head's q direction, so the
    running max steps at every entry and every per-entry rescale and
    rounding point of the online softmax is taken. Four slots of 8
    heads at head_dim 64 (32 rows at T=1: an f32-order flip of one P
    element moves up to a whole row of 64 outputs, so one flipped row
    stays under the 1% bar); slots 1 and 3 end inside an entry."""
    from flashy_tpu.models.quantize import quantize_kv
    rng = np.random.default_rng(seed)
    batch, heads, dim, entries = 4, 8, 64, 8
    base = np.array([entries * bs - queries, 5 * bs + 3 - queries,
                     7 * bs - 1 - queries, 3 * bs + bs // 2 - queries])
    base = np.maximum(base, 0)
    n = 1 + batch * entries
    u = rng.normal(size=(heads, dim)) / 2
    table = np.zeros((batch, entries), np.int32)
    blocks = rng.permutation(n - 1) + 1
    k = rng.normal(size=(n, bs, heads, dim)) / 2
    v = rng.normal(size=(n, bs, heads, dim))
    for b in range(batch):
        live = (base[b] + queries - 1) // bs + 1
        table[b, :live] = blocks[b * entries:b * entries + live]
        for e in range(live):
            k[table[b, e]] += (3 * e / 4) * u[None]
    k, v = k.astype(np.float32), v.astype(np.float32)
    q = (u[None, None] + 0.3 * rng.normal(
        size=(batch, queries, heads, dim))).astype(np.float32) / 2
    if kv_dtype == "model":
        jentry = {"k": jnp.asarray(k, jnp.bfloat16),
                  "v": jnp.asarray(v, jnp.bfloat16)}
        entry = {n_: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16) for n_, a in jentry.items()}
    else:
        (kq, ks), (vq, vs) = quantize_kv(jnp.asarray(k)), quantize_kv(
            jnp.asarray(v))
        jentry = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        entry = {n_: torch.from_numpy(np.array(a)) for n_, a in
                 jentry.items()}
    positions = (base[:, None] + np.arange(queries)).astype(np.int32)
    return q, jentry, entry, table, positions


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("queries", [1, 16])
def test_entrywise_reference_at_serving_blocks_with_growing_max(
        kv_dtype, bs, queries):
    # bf16, the serving block sizes and T of a decode step and of a
    # prefill chunk: the entry-by-entry reference (what the CUDA kernel
    # is held to on the card) against the Pallas kernel in interpret
    # mode, at the same bars as above (one bf16 ulp, <= 1% of outputs
    # not bit-equal), on pools whose running max grows entry by entry
    from flashy_tpu.ops.paged_decode import fused_paged_attention as jax_fused
    from flashy_tpu_torch.ops.paged_decode import entrywise_paged_attention
    q, jentry, entry, table, positions = _growing_case(kv_dtype, bs, queries)
    dim = q.shape[-1]
    # the premise: per entry, the largest score of slot 0's last query row
    # grows (each entry steps the running max)
    kf = np.asarray(jentry["k"].astype(jnp.float32))
    if kv_dtype == "int8":
        kf = kf * np.asarray(jentry["k_scale"])[..., None]
    live = (positions[0, -1]) // bs + 1
    maxima = [(kf[table[0, e]] * q[0, -1][None]).sum(-1).max()
              for e in range(live)]
    assert np.all(np.diff(maxima) > 0)
    want = np.asarray(jax_fused(
        jnp.asarray(q, jnp.bfloat16), jentry, jnp.asarray(table),
        jnp.asarray(positions), head_dim=dim, dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    got = entrywise_paged_attention(
        torch.from_numpy(q), entry, torch.from_numpy(table),
        torch.from_numpy(positions), head_dim=dim,
        dtype=torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -10)
    assert _mismatch_share(got, want) <= 0.01


def test_entrywise_f32_chain_in_f64_stays_on_the_gather_path():
    # The kernel (and its entry-by-entry reference) carries the f32
    # rescale chain in f64. Over 256 entries of 4 keys the TPU body's f32
    # chain drifts from the gather path; the f64 chain stays within the
    # kernel's 1e-5 bar of it. Held against both JAX paths: the gather
    # path at 1e-5, the Pallas kernel (interpret mode) at 1e-4, the f32
    # chain's drift over that many entries (observed ~1e-5).
    from flashy_tpu.ops.paged_attention import paged_attention as jax_gather
    from flashy_tpu.ops.paged_decode import fused_paged_attention as jax_fused
    from flashy_tpu_torch.ops.paged_decode import entrywise_paged_attention
    rng = np.random.default_rng(7)
    batch, heads, dim, bs, entries, queries = 2, 2, 64, 4, 256, 4
    n = 1 + batch * entries
    k, v = (rng.normal(size=(n, bs, heads, dim)).astype(np.float32)
            for _ in range(2))
    table = (1 + rng.permutation(n - 1)).reshape(batch, entries).astype(
        np.int32)
    base = np.array([entries * bs - queries, 700])
    positions = (base[:, None] + np.arange(queries)).astype(np.int32)
    q = rng.normal(size=(batch, queries, heads, dim)).astype(np.float32)
    jargs = (jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
             jnp.asarray(table), jnp.asarray(positions))
    gather = np.asarray(jax_gather(*jargs, head_dim=dim, dtype=jnp.float32))
    kernel = np.asarray(jax_fused(*jargs, head_dim=dim, dtype=jnp.float32,
                                  interpret=True))
    got = entrywise_paged_attention(
        torch.from_numpy(q), {"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v)},
        torch.from_numpy(table), torch.from_numpy(positions),
        head_dim=dim, dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, gather, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, kernel, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bs,dim,route", [(12, 64, "general"),
                                          (128, 64, "general"),
                                          (16, 32, "general"),
                                          (16, 64, "paged_decode")])
def test_kernel_checks_refuse_shapes_it_does_not_take(bs, dim, route):
    # The shape picks the kernel: head_dim 64 at a power-of-two block up
    # to 64 runs paged_decode.cu, every other head_dim and block size the
    # general route (paged_general.cu). The checks the wrapper runs before
    # a CUDA launch pass both routes' shapes and still refuse what no
    # route takes: T above 64, pools that do not match q, wrong dtypes.
    from flashy_tpu_torch.ops.paged_decode import _check_call, kernel_route
    assert kernel_route(dim, bs) == route
    q = torch.zeros((1, 1, 2, dim), dtype=torch.bfloat16)
    entry = {name: torch.zeros((3, bs, 2, dim), dtype=torch.bfloat16)
             for name in ("k", "v")}
    table = torch.zeros((1, 2), dtype=torch.int32)
    positions = torch.zeros((1, 1), dtype=torch.int64)
    _check_call(q, entry, table, positions, dim)
    with pytest.raises(ValueError, match="outside"):
        _check_call(q.expand(1, 65, 2, dim), entry, table,
                    torch.zeros((1, 65), dtype=torch.int64), dim)
    with pytest.raises(ValueError, match="do not match"):
        _check_call(q, {name: t[..., :dim - 1] for name, t in entry.items()},
                    table, positions, dim)
    with pytest.raises(ValueError, match="does not match q"):
        _check_call(q, {name: t.float() for name, t in entry.items()},
                    table, positions, dim)
    with pytest.raises(ValueError, match="unsupported"):
        _check_call(q.half(), entry, table, positions, dim)


@pytest.mark.parametrize("dim,bs,fits", [(128, 256, True),
                                         (256, 16, True),
                                         (256, 256, True),
                                         (256, 16384, True)])
def test_general_route_bounds_its_key_tile_by_shared_memory(dim, bs, fits):
    # The general route (paged_general.cu) splits the T query rows into
    # groups where 64 rows do not fit in a block's shared memory together
    # (f32 q at head_dim 256 takes ~0.37 MB at T 64; 128 fits), and
    # passes K and V through it 64 keys at a time, an entry past 64 keys
    # in two passes of 64-key chunks (its max, then exp, sums and P.V):
    # nothing it keeps grows with the block size, so block 16384 at
    # head_dim 256 fits as block 16 does. (The shapes' checks need no
    # data: meta tensors.)
    from flashy_tpu_torch.ops.paged_decode import (SMEM_BYTES, _check_call,
                                                   general_smem_bytes,
                                                   kernel_route)
    assert kernel_route(dim, bs) == "general"
    assert (general_smem_bytes(64, dim, torch.float32) > SMEM_BYTES) == \
        (dim > 128)
    assert (general_smem_bytes(1, dim, torch.float32) <= SMEM_BYTES) == fits
    meta = dict(device="meta")
    q = torch.zeros((1, 64, 2, dim), **meta)
    entry = {name: torch.zeros((3, bs, 2, dim), **meta)
             for name in ("k", "v")}
    table = torch.zeros((1, 2), dtype=torch.int32, **meta)
    positions = torch.arange(64, **meta)[None]
    _check_call(q, entry, table, positions, dim)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("dim,bs", [(128, 16), (128, 12), (64, 12)])
def test_plain_and_entrywise_match_jax_at_general_widths(kv_dtype, dim, bs):
    # The widths the general route (paged_general.cu) takes: head_dim 128
    # (the d128 layout) and block size 12, which paged_decode.cu does
    # not. The plain version and the entry-by-entry reference (the two
    # the card holds that route to) against the JAX gather path and the
    # Pallas kernel in interpret mode, f32, 1e-5 (reduction order only).
    from flashy_tpu.models.quantize import quantize_kv
    from flashy_tpu.ops.paged_attention import paged_attention as jax_gather
    from flashy_tpu.ops.paged_decode import fused_paged_attention as jax_fused
    from flashy_tpu_torch.ops.paged_attention import paged_attention
    from flashy_tpu_torch.ops.paged_decode import (entrywise_paged_attention,
                                                   kernel_route)
    assert kernel_route(dim, bs) == "general"
    rng = np.random.default_rng(dim + bs)
    heads = 2
    table = np.array([[3, 7, 2, 0], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    base = np.array([2 * bs + 3, 2, bs - 1])
    shape = (8, bs, heads, dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if kv_dtype == "model":
        pools = {"k": k, "v": v}
    else:
        kq, ks = quantize_kv(jnp.asarray(k))
        vq, vs = quantize_kv(jnp.asarray(v))
        pools = {name: np.array(a) for name, a in (
            ("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))}
    for queries in (1, 5):
        q = rng.normal(size=(len(table), queries, heads, dim)).astype(
            np.float32)
        positions = (base[:, None] + np.arange(queries)[None]).astype(
            np.int32)
        jargs = (jnp.asarray(q), {n: jnp.asarray(a) for n, a in
                                  pools.items()},
                 jnp.asarray(table), jnp.asarray(positions))
        targs = (torch.from_numpy(q), {n: torch.from_numpy(a) for n, a in
                                       pools.items()},
                 torch.from_numpy(table), torch.from_numpy(positions))
        kw = dict(head_dim=dim)
        want_gather = np.asarray(jax_gather(*jargs, dtype=jnp.float32, **kw))
        want_kernel = np.asarray(jax_fused(*jargs, dtype=jnp.float32,
                                           interpret=True, **kw))
        for got in (paged_attention(*targs, dtype=torch.float32, **kw),
                    entrywise_paged_attention(*targs, dtype=torch.float32,
                                              **kw)):
            np.testing.assert_allclose(got.numpy(), want_gather, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got.numpy(), want_kernel, rtol=1e-5,
                                       atol=1e-5)

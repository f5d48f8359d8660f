# The port's SSD serving slice (flashy_tpu_torch: ops/ssd_scan.py,
# models/ssd.py, the SSD decode path and DecodeEngine(cache_layout='ssd'))
# held against the JAX package on the same numpy inputs and converted
# weights, in f32 on the CPU, where the scan runs the kernel's plain
# version. Tolerances: the chunked scan 1e-5 against both JAX paths
# (the JAX gather path and its Pallas kernel in interpret mode differ
# from each other by ~4e-7), the recurrence 1e-5, the port's two forms
# against each other 1e-4, logits 1e-4; chaining and padding bitwise;
# greedy streams token-exact. Every chunk is pinned on both sides.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import TINY, jax_generate, tiny_pair

SSD = dict(mixer="ssd", ssd_state_dim=8, ssd_chunk=8)
HYBRID = dict(SSD, mixer="ssd,attention")
VOCAB = 256


def _inputs(batch=2, seq=29, heads=2, head_dim=8, dstate=4, seed=0):
    """c, b, v [B, T, H, *] and f32 log-decays <= 0, as numpy."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    log_a = -np.logaddexp(draw(batch, seq, heads), 0).astype(np.float32)
    return (draw(batch, seq, heads, dstate), draw(batch, seq, heads, dstate),
            draw(batch, seq, heads, head_dim), log_a)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _scan_case(seed=0):
    """Ragged T (29), a carried state, a reset sentinel at t=13 of row 0
    and the last five tokens of row 1 padded."""
    from flashy_tpu.ops.ssd_scan import SSD_LOG_RESET
    c, b, v, log_a = _inputs(seed=seed)
    log_a[0, 13] = SSD_LOG_RESET
    state = np.random.default_rng(seed + 1).standard_normal(
        (2, 2, 8, 4)).astype(np.float32)
    mask = np.ones((2, 29), bool)
    mask[1, -5:] = False
    return c, b, v, log_a, state, mask


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_chunked_scan_matches_jax_gather_and_fused(chunk):
    from flashy_tpu.ops.ssd_scan import ssd_chunked_scan as jax_scan
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    c, b, v, log_a, state, mask = _scan_case(seed=chunk)
    y, s = ssd_chunked_scan(*_torch(c, b, v, log_a), state=_torch(state)[0],
                            chunk=chunk, token_mask=_torch(mask)[0])
    real = mask[:, :, None, None]
    for kw in ({"kernel": "gather"}, {"kernel": "fused", "interpret": True}):
        scan = jax.jit(functools.partial(jax_scan, chunk=chunk, **kw))
        y_j, s_j = scan(*_jax(c, b, v, log_a), state=jnp.asarray(state),
                        token_mask=jnp.asarray(mask))
        np.testing.assert_allclose(np.where(real, y.numpy(), 0),
                                   np.where(real, np.asarray(y_j), 0),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5,
                                   rtol=1e-5)


def _wide_case(seq, seed):
    """The slice's full widths: N 16, Dh 64 (chunk 64 at the call), B 2,
    H 2, a carried state, a reset sentinel in row 0 and the last 9
    tokens of row 1 padded."""
    from flashy_tpu.ops.ssd_scan import SSD_LOG_RESET
    c, b, v, log_a = _inputs(seq=seq, head_dim=64, dstate=16, seed=seed)
    log_a[0, seq // 2 + 3] = SSD_LOG_RESET
    state = np.random.default_rng(seed + 1).standard_normal(
        (2, 2, 64, 16)).astype(np.float32)
    mask = np.ones((2, seq), bool)
    mask[1, -9:] = False
    return c, b, v, log_a, state, mask


@pytest.mark.parametrize("seq", [64, 150])
def test_chunked_reference_matches_jax_at_serving_widths(seq):
    # the kernel's plain version (what chip_smoke holds the Hopper kernel
    # to) at the widths the kernel runs: ragged T (150 = 64 + 64 + 22)
    from flashy_tpu.ops.ssd_scan import ssd_chunked_scan as jax_scan
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    c, b, v, log_a, state, mask = _wide_case(seq, seed=seq)
    y, s = ssd_chunked_scan(*_torch(c, b, v, log_a), state=_torch(state)[0],
                            chunk=64, token_mask=_torch(mask)[0],
                            kernel="gather")
    real = mask[:, :, None, None]
    for kw in ({"kernel": "gather"}, {"kernel": "fused", "interpret": True}):
        scan = jax.jit(functools.partial(jax_scan, chunk=64, **kw))
        y_j, s_j = scan(*_jax(c, b, v, log_a), state=jnp.asarray(state),
                        token_mask=jnp.asarray(mask))
        np.testing.assert_allclose(np.where(real, y.numpy(), 0),
                                   np.where(real, np.asarray(y_j), 0),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5,
                                   rtol=1e-5)


def _model_projection(seq=9, dtype=torch.bfloat16):
    """c, b, v and log_a as the SSD layer makes them: views of one fused
    projection [B, T, H, 2N+Dh+1] (N 16, Dh 64, H 4)."""
    from flashy_tpu_torch.models.ssd import ssd_projections
    from flashy_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(**{**TINY, "num_heads": 4, "dim": 256},
                            mixer="ssd", ssd_state_dim=16, dtype=dtype)
    g = torch.Generator().manual_seed(0)
    normed = torch.randn((2, seq, cfg.dim), generator=g).to(dtype)
    cbv = torch.randn((cfg.dim, 4, 2 * 16 + 64 + 1), generator=g).to(dtype)
    return ssd_projections(cfg, normed, cbv, torch.zeros(4))


def test_kernel_args_read_the_projection_in_place():
    # the main path's call: the projection's slices, the f32 log-decays,
    # the mask and the state reach the kernel by pointer and strides
    from flashy_tpu_torch.ops import ssd_scan
    c, b, v, log_a = _model_projection()
    assert c.data_ptr() != b.data_ptr() and not c.is_contiguous()
    mask = torch.ones((2, 9), dtype=torch.bool)
    mask[1, 6:] = False
    state = torch.zeros((2, 4, 64, 16))
    y = torch.empty((2, 9, 4, 64), dtype=torch.bfloat16)
    final = torch.empty((2, 4, 64, 16))
    args = ssd_scan.kernel_args(c, b, v, log_a, state, mask, 8, y, final)
    for name, t in (("c", c), ("b", b), ("v", v), ("la", log_a),
                    ("mask", mask), ("state_in", state), ("y", y),
                    ("state_out", final)):
        assert getattr(args, name) == t.data_ptr(), name
    row = 2 * 16 + 64 + 1
    assert tuple(args.c_stride) == tuple(args.b_stride) == tuple(
        args.v_stride) == (9 * 4 * row, 4 * row, row)
    assert tuple(args.la_stride) == log_a.stride()
    assert tuple(args.mask_stride) == mask.stride()
    assert (args.B, args.T, args.H, args.N, args.Dh, args.C, args.cbv) == (
        2, 9, 4, 16, 64, 8, 1)
    bare = ssd_scan.kernel_args(c, b, v, log_a, None, None, 8, y, final)
    assert bare.mask is None and bare.state_in is None
    # separate tensors: one copy a slice
    apart = ssd_scan.kernel_args(*(x.contiguous() for x in (c, b, v)), log_a,
                                 None, None, 8, y, final)
    assert apart.cbv == 0


@pytest.mark.parametrize("case", ["strided_rows", "mixed_dtype",
                                  "mask_shape", "la_dtype", "mask_dtype",
                                  "state_layout", "chunk"])
def test_kernel_args_refuse_layouts_the_kernel_does_not_take(case):
    from flashy_tpu_torch.ops import ssd_scan
    c, b, v, log_a = _model_projection()
    state, mask, chunk = torch.zeros((2, 4, 64, 16)), None, 8
    if case == "strided_rows":      # elements of a slice not adjacent
        c = c.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "mixed_dtype":     # b not in c's dtype
        b = b.float()
    elif case == "mask_shape":      # one token too many
        mask = torch.ones((2, 10), dtype=torch.bool)
    elif case == "la_dtype":
        log_a = log_a.bfloat16()
    elif case == "mask_dtype":
        mask = torch.ones((2, 9), dtype=torch.int32)
    elif case == "state_layout":
        state = torch.zeros((2, 4, 16, 64)).transpose(2, 3)
    else:
        chunk = ssd_scan.MAX_CHUNK + 1
    y = torch.empty(v.shape, dtype=v.dtype)
    final = torch.empty((2, 4, v.shape[-1], c.shape[-1]))
    with pytest.raises(ValueError, match="ssd scan kernel"):
        ssd_scan.kernel_args(c, b, v, log_a, state, mask, chunk, y, final)


@pytest.mark.parametrize("dstate,head_dim", [(8, 32), (128, 64), (16, 128),
                                              (16, 33)])
def test_kernel_args_take_every_width(dstate, head_dim):
    # bf16 at widths other than the serving ones: the tile kernel's
    # zero-padded N and Dh (8, 32), or the FMA kernel (N 128 as Mamba-2's
    # d_state, Dh 128, odd Dh), each read in place
    from flashy_tpu_torch.ops import ssd_scan
    row = 2 * dstate + head_dim + 1
    proj = torch.zeros((2, 9, 4, row), dtype=torch.bfloat16)
    c, b = proj[..., :dstate], proj[..., dstate:2 * dstate]
    v = proj[..., 2 * dstate:2 * dstate + head_dim]
    log_a = torch.zeros((2, 9, 4))
    y = torch.empty((2, 9, 4, head_dim), dtype=torch.bfloat16)
    final = torch.empty((2, 4, head_dim, dstate))
    args = ssd_scan.kernel_args(c, b, v, log_a, None, None, 8, y, final)
    assert (args.N, args.Dh, args.cbv) == (dstate, head_dim, 1)
    assert tuple(args.v_stride) == (9 * 4 * row, 4 * row, row)


def test_recurrent_scan_matches_jax():
    from flashy_tpu.ops.ssd_scan import ssd_recurrent_scan as jax_rec
    from flashy_tpu_torch.ops.ssd_scan import ssd_recurrent_scan
    c, b, v, log_a, state, _ = _scan_case(seed=2)
    y, s = ssd_recurrent_scan(*_torch(c, b, v, log_a, state))
    y_j, s_j = jax.jit(jax_rec)(*_jax(c, b, v, log_a, state))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("chunk", [4, 16])
def test_dual_form_parity(chunk):
    # chunked == recurrent: the same polynomial in another order
    from flashy_tpu_torch.ops.ssd_scan import (ssd_chunked_scan,
                                               ssd_recurrent_scan)
    c, b, v, log_a = _torch(*_inputs(seed=3))
    state = torch.zeros((2, 2, 8, 4))
    y_rec, s_rec = ssd_recurrent_scan(c, b, v, log_a, state)
    y, s = ssd_chunked_scan(c, b, v, log_a, state=state, chunk=chunk)
    torch.testing.assert_close(y, y_rec, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, s_rec, atol=1e-4, rtol=1e-4)


def test_chunk_chaining_is_bit_exact():
    # a stream split at a chunk multiple, the state passed between the
    # calls, is bit-equal to one call: why chunked prefill matches
    # generate's single prefill
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    c, b, v, log_a = _torch(*_inputs(seq=37, seed=4))
    y, s = ssd_chunked_scan(c, b, v, log_a, chunk=8)
    y_a, s_a = ssd_chunked_scan(c[:, :16], b[:, :16], v[:, :16],
                                log_a[:, :16], chunk=8)
    y_b, s_b = ssd_chunked_scan(c[:, 16:], b[:, 16:], v[:, 16:],
                                log_a[:, 16:], state=s_a, chunk=8)
    assert torch.equal(torch.cat([y_a, y_b], dim=1), y)
    assert torch.equal(s_b, s)


def test_token_mask_padding_is_exact():
    # padded tokens zero b and log_a: a right-padded call carries exactly
    # the state of the unpadded one (its real outputs are bit-equal too on
    # the kernel, chip_smoke.py; here matmul blocking may differ by an ulp)
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    c, b, v, log_a = _torch(*_inputs(seq=16, seed=5))
    mask = (torch.arange(16) < 11)[None].expand(2, 16)
    y_pad, s_pad = ssd_chunked_scan(c, b, v, log_a, chunk=8,
                                    token_mask=mask)
    y, s = ssd_chunked_scan(c[:, :11], b[:, :11], v[:, :11], log_a[:, :11],
                            chunk=8)
    assert torch.equal(s_pad, s)
    torch.testing.assert_close(y_pad[:, :11], y, atol=1e-6, rtol=1e-6)


def test_segment_reset_severs_state():
    # SSD_LOG_RESET at t=6: the second segment equals itself run alone
    # (exp of a direct sum holding -1e30 is exactly 0)
    from flashy_tpu_torch.ops.ssd_scan import SSD_LOG_RESET, ssd_chunked_scan
    c, b, v, log_a = _torch(*_inputs(seq=12, seed=6))
    log_a[:, 6] = SSD_LOG_RESET
    state = torch.randn((2, 2, 8, 4), generator=torch.Generator().manual_seed(0))
    y, _ = ssd_chunked_scan(c, b, v, log_a, state=state, chunk=4)
    y_alone, _ = ssd_chunked_scan(c[:, 6:], b[:, 6:], v[:, 6:],
                                  log_a[:, 6:], chunk=4)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y[:, 6:], y_alone, atol=1e-5, rtol=1e-5)


def test_default_chunk_and_state_bytes_match_jax():
    from flashy_tpu.ops import ssd_scan as ref
    from flashy_tpu_torch.ops import ssd_scan
    assert ssd_scan.SSD_LOG_RESET == ref.SSD_LOG_RESET
    assert ssd_scan.CHUNK_CANDIDATES == ref.CHUNK_CANDIDATES
    for seq in (1, 7, 15, 16, 48, 64, 100, 256, 300, 1024, 1030):
        assert ssd_scan.default_chunk(seq) == ref.default_chunk(seq)
    assert ssd_scan.ssd_state_bytes(16, 64, 16) == ref.ssd_state_bytes(
        16, 64, 16)


def test_ssd_log_decay_matches_jax_above_softplus_threshold():
    # torch's softplus turns into the identity above 20, jax's does not
    from flashy_tpu.models.ssd import ssd_log_decay as jax_decay
    from flashy_tpu_torch.models.ssd import ssd_log_decay
    dt = np.array([[-30.0, -3.0, 0.0, 3.0, 19.5, 20.5, 25.0, 40.0]],
                  np.float32)
    bias = np.full(8, 1.5, np.float32)
    got = ssd_log_decay(*_torch(dt, bias)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_decay(*_jax(dt, bias))),
                               rtol=1e-6, atol=0)


def test_fused_kernel_seam_on_the_cpu():
    from flashy_tpu_torch.ops import ssd_scan
    c, b, v, log_a = _torch(*_inputs(seed=7))
    assert ssd_scan.default_ssd_kernel(c.device) == "gather"
    with pytest.raises(ValueError, match="CUDA-only"):
        ssd_scan.ssd_chunked_scan(c, b, v, log_a, chunk=8, kernel="fused")
    # with grad too: 'fused' never quietly takes the plain path
    with pytest.raises(ValueError, match="CUDA-only"):
        ssd_scan.ssd_chunked_scan(c.requires_grad_(), b, v, log_a, chunk=8,
                                  kernel="fused")
    # 'auto' takes the plain version for CPU tensors, no launch
    ssd_scan.reset_launch_counts()
    c = c.detach()
    got = ssd_scan.ssd_chunked_scan(c, b, v, log_a, chunk=8)
    heads = [x.transpose(1, 2) for x in (c, b, v, log_a)]
    want = ssd_scan._chunked_reference(*heads, torch.zeros((2, 2, 8, 4)), 8)
    assert torch.equal(got[0], want[0].transpose(1, 2))
    assert torch.equal(got[1], want[1])
    assert ssd_scan.launch_counts["ssd_scan"] == 0


@pytest.mark.parametrize("overrides", [SSD, HYBRID], ids=["ssd", "hybrid"])
def test_converter_covers_ssd_and_hybrid_trees(overrides):
    from flashy_tpu_torch.models.convert import params_from_jax
    _, params, model = tiny_pair(seed=1, **overrides)
    tree = jax.tree.map(np.asarray, params)["params"]
    state = model.state_dict()
    assert set(state) == set(params_from_jax(tree, model.config))
    np.testing.assert_array_equal(state["block_0.ssd.cbv.kernel"].numpy(),
                                  tree["block_0"]["ssd"]["cbv"]["kernel"])
    np.testing.assert_array_equal(state["block_0.ssd.dt_bias"].numpy(),
                                  tree["block_0"]["ssd"]["dt_bias"])
    assert state["block_0.ssd.out.kernel"].shape == (4, 8, 32)
    mixer = "attn" if "attention" in overrides["mixer"] else "ssd"
    assert f"block_1.{mixer}.out.kernel" in state
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["block_0"]["ssd"]["dt_bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(wrong, model.config)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("overrides", [SSD, HYBRID], ids=["ssd", "hybrid"])
def test_uncached_logits_match_jax(overrides, packed):
    jax_model, params, model = tiny_pair(seed=2, **overrides)
    tokens = np.random.default_rng(8).integers(0, VOCAB, (2, 24)).astype(
        np.int32)
    kw = {}
    if packed:
        # two documents and padding per row; positions restart per document
        segments = np.array([[1] * 9 + [2] * 11 + [0] * 4,
                             [1] * 17 + [2] * 7], np.int32)
        positions = np.stack([
            np.concatenate([np.arange(9), np.arange(11), np.arange(4)]),
            np.concatenate([np.arange(17), np.arange(7)])]).astype(np.int32)
        kw = {"segment_ids": segments, "positions": positions}
    want = np.asarray(jax.jit(jax_model.apply)(
        params, jnp.asarray(tokens), **{k: jnp.asarray(a)
                                        for k, a in kw.items()}))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens),
                    **{k: torch.from_numpy(a) for k, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_pure_ssd_generate_streams_past_max_seq_len_token_exact():
    # nothing caps a pure-SSD stack: 6 + 30 > max_seq_len 16
    jax_model, params, model = tiny_pair(seed=3, **SSD, max_seq_len=16)
    from flashy_tpu_torch.models.decoding import generate
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 6)).astype(
        np.int32)
    got = generate(model, prompt, max_new_tokens=30, device="cpu").numpy()
    assert got.shape == (2, 36)
    with torch.no_grad():  # the uncached forward is not capped either
        assert torch.isfinite(model(torch.from_numpy(got))).all()
    np.testing.assert_array_equal(
        got, jax_generate(jax_model, params, prompt, max_new_tokens=30))


def test_hybrid_generate_token_exact_and_capped():
    jax_model, params, model = tiny_pair(seed=4, **HYBRID)
    from flashy_tpu_torch.models.decoding import generate
    prompt = np.random.default_rng(10).integers(0, VOCAB, (2, 13)).astype(
        np.int32)
    got = generate(model, prompt, max_new_tokens=12, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, jax_generate(jax_model, params, prompt, max_new_tokens=12))
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(model, prompt, max_new_tokens=60, device="cpu")


def _port_model(seed=0, **overrides):
    """A port model alone (no JAX side), tiny and f32, on the CPU."""
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    cfg = TransformerConfig(**{**TINY, "attention": "dense", **overrides},
                            dtype=torch.float32)
    return TransformerLM(cfg, device="cpu", seed=seed)


def _ssd_engine(model, **kw):
    from flashy_tpu_torch.serve.engine import DecodeEngine
    engine = DecodeEngine(model, **{"slots": 2, "max_seq_len": 64,
                                    "chunk": 8, "cache_layout": "ssd",
                                    "device": "cpu", **kw})
    engine.warmup()
    return engine


def test_engine_ssd_streams_token_exact_past_ceiling():
    # chunked prefill + recurrent decode through a ceiling-64 engine, every
    # stream ending past the ceiling: token-exact against the port's and
    # the JAX package's generate (ssd_chunk == the engine chunk)
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.ops.ssd_scan import ssd_state_bytes
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    jax_model, params, model = tiny_pair(seed=5, **SSD, max_seq_len=4096)
    engine = _ssd_engine(model)
    assert engine.unbounded and engine.pool is None
    assert engine.state_bytes_per_slot() == 2 * ssd_state_bytes(4, 8, 8)
    scheduler = ContinuousBatchingScheduler(engine)
    rng = np.random.default_rng(11)
    workload = [(rng.integers(0, VOCAB, 11), 70),
                (rng.integers(0, VOCAB, 23), 60),
                (rng.integers(0, VOCAB, 7), 80)]
    requests = [scheduler.submit(p, n) for p, n in workload]
    scheduler.run()
    for request, (prompt, max_new) in zip(requests, workload):
        assert request.done and len(prompt) + max_new > engine.max_seq_len
        want = generate(model, prompt[None], max_new_tokens=max_new,
                        device="cpu")[0].numpy()
        np.testing.assert_array_equal(request.output, want)
        np.testing.assert_array_equal(request.output, jax_generate(
            jax_model, params, prompt[None], max_new_tokens=max_new)[0])


def test_engine_ssd_retire_and_readmit_resets_state():
    # slot reuse: the slice at start == 0 zeroes the slot's states, so a
    # readmitted request does not see its predecessor's
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    model = _port_model(seed=6, **SSD, max_seq_len=256)
    engine = _ssd_engine(model, slots=1)
    scheduler = ContinuousBatchingScheduler(engine)
    rng = np.random.default_rng(12)
    first = scheduler.submit(rng.integers(0, VOCAB, 20), 8)
    scheduler.run()
    assert first.done
    prompt = rng.integers(0, VOCAB, 13)
    second = scheduler.submit(prompt, 8)
    scheduler.run()
    want = generate(model, prompt[None], max_new_tokens=8,
                    device="cpu")[0].numpy()
    np.testing.assert_array_equal(second.output, want)


def test_engine_layout_validation():
    from flashy_tpu_torch.serve.engine import DecodeEngine
    model, attn, hybrid = (_port_model(**kw) for kw in (SSD, {}, HYBRID))
    for layout in ("paged", "dense"):
        with pytest.raises(ValueError, match="cache_layout='ssd'"):
            DecodeEngine(model, slots=2, cache_layout=layout, device="cpu")
    with pytest.raises(ValueError, match="SSD layer"):
        DecodeEngine(attn, slots=2, cache_layout="ssd", device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        DecodeEngine(model, slots=2, cache_layout="ssd", spec_k=2,
                     device="cpu")
    engine = DecodeEngine(hybrid, slots=2, cache_layout="ssd", device="cpu")
    assert not engine.unbounded
    with pytest.raises(ValueError, match="speculative"):
        DecodeEngine(hybrid, slots=2, cache_layout="ssd", spec_k=2,
                     device="cpu")
    with pytest.raises(ValueError, match="int8"):
        DecodeEngine(model, slots=2, cache_layout="ssd", kv_dtype="int8",
                     device="cpu")


def test_state_bytes_per_slot_matches_jax_and_is_constant():
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.serve.engine import state_bytes_per_slot as jax_bytes
    from flashy_tpu_torch.models.transformer import TransformerConfig
    from flashy_tpu_torch.serve.engine import state_bytes_per_slot
    kw = dict(vocab_size=32768, dim=1024, num_layers=12, num_heads=16,
              ssd_state_dim=16)
    lens = (1024, 8192, 65536)
    for mixer in ("ssd", "ssd,attention"):
        cfg = TransformerConfig(**kw, mixer=mixer, dtype=torch.bfloat16)
        jcfg = JaxConfig(**kw, mixer=mixer, dtype=jnp.bfloat16)
        got = [state_bytes_per_slot(cfg, n, "ssd") for n in lens]
        assert got == [jax_bytes(jcfg, n, "ssd") for n in lens]
    ssd = TransformerConfig(**kw, mixer="ssd", dtype=torch.bfloat16)
    assert {state_bytes_per_slot(ssd, n, "ssd") for n in lens} == {
        12 * 16 * 64 * 16 * 4}


def test_scheduler_records_the_ssd_layout():
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    engine = _ssd_engine(_port_model(seed=8, **SSD), max_seq_len=16)
    scheduler = ContinuousBatchingScheduler(engine)
    info = scheduler.metrics.static_info
    assert info["cache_layout"] == "ssd"
    assert info["state_bytes_per_slot"] == engine.state_bytes_per_slot()
    assert engine.pool_stats() is None and engine.can_admit([1, 2], 99)
    request = scheduler.submit(np.arange(1, 12), 20)  # past the ceiling
    scheduler.run()
    assert request.done and len(request.output) == 31
    summary = scheduler.metrics.summary()
    assert summary["completed"] == 1 and "pool_occupancy_p50" not in summary


def test_chunked_reference_matches_jax_at_mamba2_state_width():
    # Mamba-2's N 128 at chunk 256 (what `default_chunk` picks for a
    # prompt that 256 divides), T 512: the widths at which the FMA kernel
    # now launches (its c and b pass through shared memory 64 state
    # columns at a time). Its plain version against the JAX gather path
    # and the Pallas kernel in interpret mode, f32 1e-5, with a carried
    # state, a reset sentinel and a padded row.
    from flashy_tpu.ops.ssd_scan import SSD_LOG_RESET
    from flashy_tpu.ops.ssd_scan import ssd_chunked_scan as jax_scan
    from flashy_tpu_torch.ops.ssd_scan import (default_chunk, kernel_route,
                                               ssd_chunked_scan)
    seq, dstate, head_dim = 512, 128, 16
    assert default_chunk(seq) == 256
    for dtype in (torch.float32, torch.bfloat16):
        assert kernel_route(dtype, dstate, head_dim) == "ssd_scan_fma"
    c, b, v, log_a = _inputs(seq=seq, head_dim=head_dim, dstate=dstate,
                             seed=128)
    log_a[0, 300] = SSD_LOG_RESET
    state = np.random.default_rng(129).standard_normal(
        (2, 2, head_dim, dstate)).astype(np.float32)
    mask = np.ones((2, seq), bool)
    mask[1, -40:] = False
    y, s = ssd_chunked_scan(*_torch(c, b, v, log_a), state=_torch(state)[0],
                            chunk=256, token_mask=_torch(mask)[0],
                            kernel="gather")
    real = mask[:, :, None, None]
    for kw in ({"kernel": "gather"}, {"kernel": "fused", "interpret": True}):
        scan = jax.jit(functools.partial(jax_scan, chunk=256, **kw))
        y_j, s_j = scan(*_jax(c, b, v, log_a), state=jnp.asarray(state),
                        token_mask=jnp.asarray(mask))
        np.testing.assert_allclose(np.where(real, y.numpy(), 0),
                                   np.where(real, np.asarray(y_j), 0),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("overrides", [SSD, HYBRID], ids=["ssd", "hybrid"])
def test_ssd_lm_loss_and_grads_match_jax(overrides):
    # SSD training: the port's autograd of the chunked form against
    # jax.value_and_grad through the JAX gather path, at rtol 1e-5 /
    # atol 1e-6
    import optax
    from flashy_tpu_torch.models.convert import params_from_jax
    jax_model, params, model = tiny_pair(seed=5, ssd_kernel="gather",
                                         **overrides)
    tokens = np.random.default_rng(9).integers(0, VOCAB, (2, 29)).astype(
        np.int32)

    def loss_fn(params):
        logits = jax_model.apply(params, jnp.asarray(tokens))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], jnp.asarray(tokens[:, 1:])).mean()

    want, jax_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    logits = model(torch.from_numpy(tokens))
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, VOCAB),
        torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jax_grads),
                                 model.config)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _projection_case(seed, with_state, with_mask):
    """c, b, v as slices of one [B, T, H, 2N+Dh+1] projection (the
    model's layout) and f32 log-decays from its last column; a reset
    sentinel, a carried state and padding where asked."""
    from flashy_tpu_torch.models.ssd import ssd_log_decay
    rng = np.random.default_rng(seed)
    n, dh = 4, 8
    proj = torch.from_numpy(rng.standard_normal(
        (2, 29, 2, 2 * n + dh + 1)).astype(np.float32)).requires_grad_()
    bias = torch.zeros(2)
    state = torch.from_numpy(rng.standard_normal((2, 2, dh, n)).astype(
        np.float32)).requires_grad_() if with_state else None
    mask = None
    if with_mask:
        mask = torch.ones(2, 29, dtype=torch.bool)
        mask[1, -5:] = False

    def inputs():
        la = ssd_log_decay(proj[..., -1], bias)
        la = torch.where(torch.arange(29)[None, :, None] == 13,
                         torch.full_like(la, -1e30), la)
        return (proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n:-1], la,
                state, mask)

    return proj, state, inputs


@pytest.mark.parametrize("outputs", ["both", "y", "state"])
@pytest.mark.parametrize("with_state,with_mask", [(True, True),
                                                  (False, False)],
                         ids=["state_mask", "plain"])
def test_scan_function_backward_bit_equal_to_autograd(outputs, with_state,
                                                      with_mask):
    # the T9 Function with the plain forward in the kernel's place: its
    # recomputing backward gives autograd's own gradients, bit for bit
    from flashy_tpu_torch.ops import ssd_scan
    proj, state, inputs = _projection_case(3, with_state, with_mask)
    rng = np.random.default_rng(4)
    grad_y = torch.from_numpy(rng.standard_normal((2, 29, 2, 8)).astype(
        np.float32))
    grad_final = torch.from_numpy(rng.standard_normal((2, 2, 8, 4)).astype(
        np.float32))

    def grads(scan):
        proj.grad = None
        if state is not None:
            state.grad = None
        y, final = scan(*inputs(), 8)
        total = 0
        if outputs in ("both", "y"):
            total = total + (y * grad_y).sum()
        if outputs in ("both", "state"):
            total = total + (final * grad_final).sum()
        total.backward()
        return [t.grad.clone() for t in (proj, state) if t is not None]

    want = grads(ssd_scan._plain_scan)
    ssd_scan.reset_launch_counts()
    got = grads(lambda *args: ssd_scan.SsdScanFunction.apply(
        *args, ssd_scan._plain_scan))
    assert ssd_scan.backward_counts == {"ssd_scan_backward": 1}
    assert ssd_scan.launch_counts == {"ssd_scan": 0, "ssd_scan_fma": 0}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_scan_function_forward_is_what_it_is_given():
    # the forward is the callable (the kernel on the card); no input is
    # copied for the backward and no gradient means no recompute
    from flashy_tpu_torch.ops import ssd_scan
    proj, state, inputs = _projection_case(5, True, True)
    calls = []

    def forward(*args):
        calls.append(args)
        return ssd_scan._plain_scan(*args)

    ssd_scan.reset_launch_counts()
    c, b, v, la, st, mask = inputs()
    y, final = ssd_scan.SsdScanFunction.apply(c, b, v, la, st, mask, 8,
                                              forward)
    assert len(calls) == 1 and calls[0][0].data_ptr() == c.data_ptr()
    want = ssd_scan._plain_scan(c, b, v, la, st, mask, 8)
    assert torch.equal(y, want[0]) and torch.equal(final, want[1])
    assert y.requires_grad and final.requires_grad
    with torch.no_grad():
        ssd_scan.SsdScanFunction.apply(c, b, v, la, st, mask, 8, forward)
    assert ssd_scan.backward_counts["ssd_scan_backward"] == 0

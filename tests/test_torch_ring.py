# The port's sequence-parallel ring attention (flashy_tpu_torch.parallel:
# mesh, ring, ring_fused) against the JAX package's, f32 on the CPU, the
# inputs drawn with numpy from fixed seeds:
#   * the fused ring's plain version (the ring kernel's arithmetic) vs
#     the JAX `_fused_kernel` in interpret mode (`impl='fused'`), and its
#     gradients vs the JAX fused custom VJP;
#   * the scan ring vs the JAX scan ring, on the XLA block path and on
#     the Pallas block path in interpret mode, outputs and gradients;
#   * the tiny LM with attention='ring_fused' and 'ring' vs the JAX LM
#     with attention='ring' (the JAX LM with 'ring_fused' needs 128-row
#     blocks, and inside the model its interpret-mode kernel runs for
#     minutes on the CPU, so the JAX fused kernel is held per call);
#   * `make_mesh` vs the JAX `make_mesh`, and the LM solver's mesh.
# Tolerances: attention outputs and gradients 1e-5 absolute on unit-normal
# inputs (f32 reduction order only); the LM's loss 1e-5 relative and each
# gradient 1e-4 of its largest |value| (two layers and the head). Every
# JAX mesh is a sub-mesh of at most 4 of the 8 CPU devices: an
# interpret-mode ring over all of them deadlocks (tests/test_ring_fused.py).
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import TINY, tiny_pair

ATOL = 1e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax_mesh(n):
    from flashy_tpu.parallel import make_mesh
    return make_mesh({"seq": n, "data": 1}, devices=jax.devices()[:n])


def _jax_ring(arrays, n, causal, impl):
    from flashy_tpu.parallel import ring_self_attention
    q, k, v = (jnp.asarray(a) for a in arrays)
    return np.asarray(ring_self_attention(q, k, v, mesh=_jax_mesh(n),
                                          causal=causal, batch_axes=("data",),
                                          impl=impl))


def _jax_ring_grads(arrays, cotangent, n, causal, impl):
    from flashy_tpu.parallel import ring_self_attention
    mesh = _jax_mesh(n)

    def loss(q, k, v):
        out = ring_self_attention(q, k, v, mesh=mesh, causal=causal,
                                  batch_axes=("data",), impl=impl)
        return jnp.sum(out * cotangent)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))]


def _port_ring(arrays, n, causal, impl, cotangent=None):
    from flashy_tpu_torch.parallel import make_mesh, ring_self_attention
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = ring_self_attention(q, k, v, mesh=make_mesh({"seq": n}),
                              causal=causal, impl=impl)
    if cotangent is None:
        return out.detach().numpy(), None
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(cotangent))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("n,shape", [(2, (1, 256, 2, 64)),
                                     (4, (1, 512, 2, 64))])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_plain_matches_the_jax_fused_kernel(n, shape, causal):
    arrays = _inputs(shape, seed=n + 10 * causal)
    want = _jax_ring(arrays, n, causal, "fused")
    got, _ = _port_ring(arrays, n, causal, "fused")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fused_plain_is_the_kernel_loop_per_rank():
    # the plain version of one rank against dense attention of its rows
    # over the keys it may see (the whole prefix, causal bottom-right)
    from flashy_tpu_torch.ops.attention import dot_product_attention
    from flashy_tpu_torch.parallel.ring_fused import ring_forward_plain
    n, t = 4, 100                      # a ragged block: 64 + 36 keys
    q, k, v = (torch.from_numpy(a) for a in _inputs((2, n * t, 3, 16), 4))
    ks, vs = list(k.split(t, 1)), list(v.split(t, 1))
    for rank in range(n):
        rows = slice(rank * t, (rank + 1) * t)
        out, lse = ring_forward_plain(q[:, rows], ks, vs, rank, causal=True)
        keys = slice(0, (rank + 1) * t)
        want = dot_product_attention(q[:, rows], k[:, keys], v[:, keys],
                                     causal=True)
        torch.testing.assert_close(out, want, rtol=0, atol=ATOL)
        assert lse.shape == (2, 3, t) and torch.isfinite(lse).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 192])
def test_one_rank_ring_plain_is_the_flash_forward_plain(dtype, causal, t):
    # The contract the ring kernel and the flash forward share (they run
    # one forward step, so one rank is bit-equal to flash on the card),
    # held here on their plain versions: out and lse bit for bit. T = 100
    # and 192 half fill the kernels' last 128-row query tile.
    from flashy_tpu_torch.ops.attention import flash_forward_blockwise
    from flashy_tpu_torch.parallel.ring_fused import ring_forward_plain
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs((2, t, 3, 64), seed=t + causal))
    out, lse = ring_forward_plain(q, [k], [v], 0, causal)
    want, want_lse = flash_forward_blockwise(q, k, v, causal)
    assert out.dtype == dtype and lse.shape == (2, 3, t)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("shape,n,causal", [
    ((2, 16, 2, 8), 4, True),      # t_local 4: the JAX XLA block path
    ((2, 16, 2, 8), 4, False),
    ((1, 256, 2, 32), 2, True),    # t_local 128: Pallas blocks, interpret
])
def test_scan_ring_matches_the_jax_scan_ring(shape, n, causal):
    arrays = _inputs(shape, seed=sum(shape) + causal)
    cotangent = np.random.default_rng(99).normal(size=shape).astype(
        np.float32)
    want = _jax_ring(arrays, n, causal, "scan")
    want_grads = _jax_ring_grads(arrays, cotangent, n, causal, "scan")
    got, grads = _port_ring(arrays, n, causal, "scan", cotangent)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


def test_fused_ring_grads_match_the_jax_fused_vjp():
    shape, n = (1, 256, 1, 64), 2
    arrays = _inputs(shape, seed=21)
    cotangent = np.random.default_rng(22).normal(size=shape).astype(
        np.float32)
    want = _jax_ring_grads(arrays, cotangent, n, True, "fused")
    _, grads = _port_ring(arrays, n, True, "fused", cotangent)
    for name, g, w in zip("qkv", grads, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


def test_fused_and_scan_rings_share_the_backward():
    # the same forward function and the same backward pass: gradients
    # equal to f32 reordering, launch counters untouched on the CPU
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.parallel import ring_fused
    arrays = _inputs((2, 96, 2, 16), seed=5)
    cotangent = np.random.default_rng(6).normal(size=(2, 96, 2, 16)).astype(
        np.float32)
    before = (dict(attention.launch_counts), dict(ring_fused.launch_counts))
    scan, scan_grads = _port_ring(arrays, 3, True, "scan", cotangent)
    fused, fused_grads = _port_ring(arrays, 3, True, "fused", cotangent)
    np.testing.assert_allclose(fused, scan, rtol=0, atol=ATOL)
    for g, w in zip(fused_grads, scan_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert (dict(attention.launch_counts),
            dict(ring_fused.launch_counts)) == before


def _lm_loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(tokens))
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    return float(loss.detach()), {name: p.grad.clone()
                                  for name, p in model.named_parameters()}


def _jax_lm_loss_and_grads(attention, params, tokens, n):
    import optax
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    cfg = JaxConfig(**TINY, attention=attention, dtype=jnp.float32)
    model = JaxLM(cfg, mesh=_jax_mesh(n))

    def loss(p, t):
        logits = model.apply(p, t)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], t[:, 1:]).mean()

    return jax.value_and_grad(loss)(params, jnp.asarray(tokens))


def _assert_lm_close(port, jax_result, cfg):
    from flashy_tpu_torch.models.convert import params_from_jax
    loss, grads = port
    want_loss, jax_grads = jax_result
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jax_grads), cfg)
    assert set(want) == set(grads)
    for name, grad in want.items():
        scale = float(grad.abs().max())
        err = float((grads[name] - grad).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), (name, err, scale)


@pytest.fixture(scope="module")
def jax_ring_lm():
    """(port dense model with the weights, tokens, the JAX ring LM's loss
    and grads) on a 2-device sub-mesh, once for the module."""
    _, params, dense = tiny_pair(seed=1)
    tokens = np.random.default_rng(2).integers(
        0, TINY["vocab_size"], (2, 32)).astype(np.int32)
    return dense, tokens, _jax_lm_loss_and_grads("ring", params, tokens, 2)


@pytest.mark.parametrize("attention", ["ring_fused", "ring"])
def test_ring_lm_loss_and_grads_match_the_jax_ring_lm(attention, jax_ring_lm):
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.parallel import make_mesh
    dense, tokens, want = jax_ring_lm
    cfg = TransformerConfig(**TINY, attention=attention, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu", mesh=make_mesh({"seq": 2}))
    model.load_state_dict(dense.state_dict())
    _assert_lm_close(_lm_loss_and_grads(model, tokens), want, cfg)


def test_ring_model_without_a_mesh_takes_the_default_one_rank_ring():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    _, _, dense = tiny_pair(seed=3)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, TINY["vocab_size"], (2, 24)).astype(np.int32))
    for attention in ("ring", "ring_fused"):
        cfg = TransformerConfig(**TINY, attention=attention,
                                dtype=torch.float32)
        model = TransformerLM(cfg, device="cpu")
        model.load_state_dict(dense.state_dict())
        torch.testing.assert_close(model(tokens), dense(tokens), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("shape,devices", [
    ({"seq": 4}, 4), ({"seq": -1}, 4), ({"seq": 2, "data": -1}, 2),
    (None, 1), ({"data": -1}, 1), ({"seq": 1, "tensor": 1}, 1),
])
def test_make_mesh_sizes_match_jax(shape, devices):
    from flashy_tpu.parallel import make_mesh as jax_make_mesh
    from flashy_tpu_torch.parallel import make_mesh
    want = jax_make_mesh(shape, devices=jax.devices()[:devices])
    got = make_mesh(shape, devices=["cpu"] * devices)
    assert dict(got.shape) == dict(want.shape)
    assert tuple(got.shape) == tuple(want.axis_names)
    assert got.devices == (torch.device("cpu"),) * devices


@pytest.mark.parametrize("shape,devices", [
    ({"sequence": 2}, 2), ({"seq": -1, "data": -1}, 4), ({"seq": 3}, 4),
])
def test_make_mesh_errors_match_jax(shape, devices):
    from flashy_tpu.parallel import make_mesh as jax_make_mesh
    from flashy_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError) as want:
        jax_make_mesh(shape, devices=jax.devices()[:devices])
    with pytest.raises(ValueError) as got:
        make_mesh(shape, devices=["cpu"] * devices)
    assert str(got.value) == str(want.value)


def test_make_mesh_refuses_what_one_device_cannot_run():
    from flashy_tpu_torch.parallel import (default_mesh, make_mesh,
                                           mesh_shape_from_devices,
                                           set_default_mesh)
    from flashy_tpu.parallel import mesh_shape_from_devices as jax_shape
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A items "
                                                  "5 and 8"):
        make_mesh({"seq": 2}, devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        make_mesh({"data": 2, "seq": 2})
    for axis in ("fsdp", "tensor", "pipe", "expert"):
        with pytest.raises(NotImplementedError, match="queue A item 8"):
            make_mesh({axis: 2})
    assert mesh_shape_from_devices(8, seq=4) == jax_shape(8, seq=4)
    set_default_mesh(None)
    assert default_mesh().size == 1 and default_mesh().devices is None
    mesh = make_mesh({"seq": 2})
    set_default_mesh(mesh)
    try:
        assert default_mesh() is mesh
    finally:
        set_default_mesh(None)


def test_ring_self_attention_refuses_bad_calls():
    from flashy_tpu_torch.parallel import make_mesh, ring_self_attention
    q = torch.zeros((1, 10, 2, 8))
    with pytest.raises(ValueError, match="does not split"):
        ring_self_attention(q, q, q, mesh=make_mesh({"seq": 4}))
    with pytest.raises(ValueError, match="impl"):
        ring_self_attention(q, q, q, mesh=make_mesh({"seq": 2}), impl="x")
    with pytest.raises(ValueError, match="meta"):
        ring_self_attention(q, q, q,
                            mesh=make_mesh({"seq": 2}, devices=["meta"] * 2))


SOLVER_ARGS = ["device=cpu", "model.vocab_size=256", "model.dim=32",
               "model.num_layers=2", "model.num_heads=4", "seq_len=32",
               "batch_size=4", "steps_per_epoch=2", "valid_steps=1",
               "epochs=1", "warmup_steps=1", "lr=1e-2"]


def test_check_mesh_takes_the_seq_axis_for_ring_attention_only():
    from flashy_tpu_torch.examples.lm.solver import check_mesh
    base = {"data": -1, "fsdp": 1, "tensor": 1, "seq": 1, "pipe": 1}
    assert check_mesh(base, "flash").size == 1
    mesh = check_mesh({**base, "seq": 4}, "ring_fused")
    assert mesh.shape["seq"] == 4 and mesh.shape["data"] == 1
    assert check_mesh({**base, "seq": 2}, "ring").shape["seq"] == 2
    for attention in ("flash", "dense"):
        with pytest.raises(ValueError, match="ring"):
            check_mesh({**base, "seq": 2}, attention)
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        check_mesh({**base, "seq": 2, "tensor": 2}, "ring_fused")


def test_lm_solver_trains_with_ring_attention_on_the_cpu(tmp_path):
    import logging
    from flashy_tpu_torch.examples.lm.solver import main
    from flashy_tpu_torch.parallel import ring_fused
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        before = dict(ring_fused.launch_counts)
        ring = main(SOLVER_ARGS + ["mesh.seq=2", "model.attention=ring_fused",
                                   f"dora.dir={tmp_path / 'ring'}"])
        dense = main(SOLVER_ARGS + ["model.attention=dense",
                                    f"dora.dir={tmp_path / 'dense'}"])
    finally:
        for handler in root.handlers[:]:
            if handler not in handlers:
                root.removeHandler(handler)
                handler.close()
        root.setLevel(level)
    assert ring.mesh.shape["seq"] == 2
    assert dict(ring_fused.launch_counts) == before  # plain on the CPU
    # the solver computes in bf16: at the first step (the same weights)
    # the two attention paths differ only where they round P, after an
    # update their bf16 gradients have moved the weights apart as well
    np.testing.assert_allclose(ring.step_losses[0], dense.step_losses[0],
                               rtol=1e-5)
    np.testing.assert_allclose(ring.step_losses, dense.step_losses,
                               rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_plain_matches_the_jax_fused_kernel_at_head_dim_128(causal):
    # head_dim 128 (the d128 layout), which the ring takes in f32 on the
    # flash forward's general route (in bf16 on the ring kernel built at
    # 128): the ring's plain version (what the card holds both routes to)
    # against the JAX fused ring kernel in interpret mode, two ranks of 128
    # rows, f32 1e-5
    from flashy_tpu_torch.ops.attention import flash_route
    assert flash_route(128, "ring_fwd", torch.float32) == "general"
    arrays = _inputs((1, 256, 2, 128), seed=128 + causal)
    want = _jax_ring(arrays, 2, causal, "fused")
    got, _ = _port_ring(arrays, 2, causal, "fused")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

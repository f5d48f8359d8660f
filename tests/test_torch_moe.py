# The port's dropless MoE slice (flashy_tpu_torch/ops/grouped_matmul.py,
# parallel/moe_ep.py, models/moe.py and the MoE paths of the model,
# converter, decoding and LM solver) held against the JAX package on the
# CPU, in f32, on identical inputs made with numpy:
# * the plain grouped matmuls against megablox gmm / tgmm in interpret
#   mode on every group-edge case, 1e-5 of max |value| (f32 sums in
#   another order);
# * routing ids, gates and hard density equal; MoEMLP outputs and aux
#   (einsum, sorted at capacity factors 8.0 and 0.25, dropless) 1e-5;
# * dropless grads against jax.grad through the megablox custom VJP,
#   1e-5 of each leaf's max |value|;
# * the tiny MoE LM's ce + 0.01 aux and every grad, 1e-4 per leaf (f32
#   reduction order through two layers and the head, as
#   test_torch_train.py);
# * MoE `generate` token-exact, both evaluation orders.
# Every routing input is checked for near ties first: the top-2 margins
# (p1 - p2 and p2 - p3) of every token must exceed 1e-5, so a tie never
# reads as a divergence.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import TINY, jax_generate, tiny_pair

TOL = 1e-5
MARGIN = 1e-5


def _rel_close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _assert_no_near_tie(probs):
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    margin = np.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2])
    assert margin.min() > MARGIN, f"near tie: margin {margin.min():.2e}"


# (M, group sizes): empty groups first and last, a group of one row, all
# rows in one group, and sum(group_sizes) < M (M not a multiple of any
# kernel tile in every case)
GROUP_CASES = {
    "empty_first_and_last": (32, [0, 13, 19, 0]),
    "one_row_group": (24, [5, 1, 18]),
    "all_in_one_group": (40, [0, 40, 0]),
    "sum_below_m": (36, [7, 11, 6]),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_plain_grouped_matmuls_match_megablox(case):
    import importlib
    from flashy_tpu_torch.ops import grouped_matmul as G
    # the kernels' module (the package exports its custom-VJP `gmm` under
    # the same name)
    megablox = importlib.import_module(
        "jax.experimental.pallas.ops.tpu.megablox.gmm")
    m, sizes = GROUP_CASES[case]
    k, n, groups = 16, 24, len(sizes)
    total = sum(sizes)
    rng = np.random.default_rng(len(sizes) * 100 + m)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((groups, k, n)).astype(np.float32)
    rhs_t = rng.standard_normal((groups, n, k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    tiling = (4, 8, 8)
    t = torch.from_numpy
    before = dict(G.launch_counts)

    got = G.gmm(t(lhs), t(rhs), t(gs)).numpy()
    want = np.asarray(megablox.gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                                   jnp.asarray(gs), jnp.float32, tiling,
                                   interpret=True))
    _rel_close(got[:total], want[:total], TOL, "gmm")
    assert not got[total:].any(), "rows past the groups must be zeros"

    got = G.gmm(t(lhs), t(rhs_t), t(gs), transpose_rhs=True).numpy()
    want = np.asarray(megablox.gmm(jnp.asarray(lhs), jnp.asarray(rhs_t),
                                   jnp.asarray(gs), jnp.float32, tiling,
                                   transpose_rhs=True, interpret=True))
    _rel_close(got[:total], want[:total], TOL, "gmm_t")
    assert not got[total:].any()

    got = G.tgmm(t(lhs), t(dy), t(gs)).numpy()
    want = np.asarray(megablox.tgmm(jnp.asarray(lhs.T), jnp.asarray(dy),
                                    jnp.asarray(gs), jnp.float32, tiling,
                                    interpret=True))
    _rel_close(got, want, TOL, "tgmm")
    for g, size in enumerate(sizes):
        if size == 0:
            assert not got[g].any(), "an empty group's tgmm must be zeros"
    assert G.launch_counts == before   # CPU tensors take the plain versions


def test_grouped_matmul_dtypes_and_guards():
    from flashy_tpu_torch.ops import grouped_matmul as G
    rng = np.random.default_rng(1)
    lhs = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    gs = torch.tensor([4, 6], dtype=torch.int32)
    # bf16 x bf16: bf16 products (exact in f32), f32 sums, cast at the end
    got = G.gmm(lhs.bfloat16(), rhs.bfloat16(), gs, torch.bfloat16)
    want = G.gmm(lhs.bfloat16().float(), rhs.bfloat16().float(), gs)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())
    with pytest.raises(ValueError, match="int32"):
        G.gmm(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="disagree"):
        G.gmm(lhs, rhs, torch.tensor([10], dtype=torch.int32))
    with pytest.raises(ValueError, match="row counts"):
        G.tgmm(lhs, lhs[:5], gs)
    # neither CPU nor CUDA: no plain fallback
    meta = [t.to("meta") for t in (lhs, rhs, gs)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        G.gmm(*meta)


def test_topk_route_matches_jax():
    from flashy_tpu.parallel.moe_ep import _topk_route as jax_route
    from flashy_tpu_torch.parallel.moe_ep import _topk_route
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 6)).astype(np.float32) * 2
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    _assert_no_near_tie(probs)
    ids, gates, density = _topk_route(torch.from_numpy(probs), 6, 3)
    want_ids, want_gates, want_density = jax_route(jnp.asarray(probs), 6, 3)
    assert np.array_equal(ids.numpy(), np.asarray(want_ids))
    assert np.array_equal(gates.numpy(), np.asarray(want_gates))
    np.testing.assert_allclose(density.numpy(), np.asarray(want_density),
                               rtol=1e-6)


def _moe_pair(dispatch, capacity_factor, seed=0):
    """(jax MoEMLP, its params, the port's MoEMLP on the same weights):
    dim 32, hidden 64, 4 experts, top-2, f32."""
    from flashy_tpu.models.moe import MoEMLP as JaxMoE
    from flashy_tpu_torch.models.moe import MoEMLP
    kw = dict(dim=32, hidden=64, num_experts=4, top_k=2,
              capacity_factor=capacity_factor, dispatch=dispatch)
    jax_moe = JaxMoE(**kw, dtype=jnp.float32)
    params = {"params": jax.jit(jax_moe.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, 32), jnp.float32))[
            "params"]}
    port = MoEMLP(32, 64, 4, 2, capacity_factor, torch.float32, dispatch,
                  generator=torch.Generator().manual_seed(0), device="cpu")
    p = params["params"]
    port.load_state_dict({
        "router.kernel": torch.from_numpy(np.asarray(p["router"]["kernel"])),
        "w_up": torch.from_numpy(np.asarray(p["w_up"])),
        "w_down": torch.from_numpy(np.asarray(p["w_down"]))})
    return jax_moe, params, port


def _moe_input(port, seed=5):
    x = np.random.default_rng(seed).standard_normal((2, 16, 32)).astype(
        np.float32)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, 32)
                          @ port.router.kernel.detach(), -1)
    _assert_no_near_tie(probs.numpy())
    return x


@pytest.mark.parametrize("dispatch,capacity_factor", [
    ("einsum", 8.0), ("einsum", 0.25), ("sorted", 8.0), ("sorted", 0.25),
    ("dropless", 1.25)])
def test_moe_mlp_forward_and_aux_match_jax(dispatch, capacity_factor):
    jax_moe, params, port = _moe_pair(dispatch, capacity_factor)
    x = _moe_input(port)
    want, mutated = jax.jit(lambda p, xj: jax_moe.apply(
        p, xj, mutable=["losses"]))(params, jnp.asarray(x))
    want_aux = mutated["losses"]["moe_aux"][0]
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _rel_close(got.numpy(), np.asarray(want), TOL, dispatch)
    np.testing.assert_allclose(float(port.aux), float(want_aux), rtol=TOL)


def test_dropless_grads_match_jax_through_the_megablox_vjp():
    jax_moe, params, port = _moe_pair("dropless", 1.25)
    x = _moe_input(port, seed=7)
    cot = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)

    def loss(p, xj):
        out, mutated = jax_moe.apply(p, xj, mutable=["losses"])
        return (jnp.sum(out * cot)
                + 0.5 * mutated["losses"]["moe_aux"][0])

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    (torch.sum(out * torch.from_numpy(cot)) + 0.5 * port.aux).backward()
    w = want_p["params"]
    _rel_close(xt.grad.numpy(), np.asarray(want_x), TOL, "x")
    _rel_close(port.router.kernel.grad.numpy(),
               np.asarray(w["router"]["kernel"]), TOL, "router")
    _rel_close(port.w_up.grad.numpy(), np.asarray(w["w_up"]), TOL, "w_up")
    _rel_close(port.w_down.grad.numpy(), np.asarray(w["w_down"]), TOL,
               "w_down")


MOE = dict(moe_experts=4, moe_top_k=2)


def _lm_router_probs(model, tokens):
    """The softmax router probabilities every MoE layer of the port's
    model sees on `tokens` ([layers x tokens, E])."""
    from flashy_tpu_torch.models.moe import MoEMLP
    seen = []

    def hook(module, args):
        x = args[0].reshape(-1, args[0].shape[-1])
        seen.append(torch.softmax(x.float() @ module.router.kernel, -1))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, MoEMLP)]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for handle in handles:
            handle.remove()
    return torch.cat(seen).numpy()


def test_tiny_moe_lm_loss_and_grads_match_jax():
    import optax
    from flashy_tpu.models import moe_aux_loss as jax_aux
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    jax_model, params, model = tiny_pair(seed=1, moe_dispatch="dropless",
                                         **MOE)
    tokens = np.random.default_rng(2).integers(
        0, TINY["vocab_size"], (2, 32)).astype(np.int32)
    _assert_no_near_tie(_lm_router_probs(model, torch.from_numpy(tokens)))

    def loss_fn(p, toks):
        logits, mutated = jax_model.apply(p, toks, mutable=["losses"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], toks[:, 1:]).mean()
        return ce + 0.01 * jax_aux(mutated)

    want, jax_grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(tokens))
    loss = lm_next_token_loss(model, torch.from_numpy(tokens),
                              aux_weight=0.01)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    wanted = params_from_jax(jax.tree.map(np.asarray, jax_grads),
                             model.config)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(wanted) == set(got) and any("moe.w_up" in k for k in got)
    for name, grad in wanted.items():
        _rel_close(got[name].numpy(), grad.numpy(), 1e-4, name)


def test_moe_generate_token_exact_vs_jax():
    from flashy_tpu_torch.models import decoding
    from flashy_tpu_torch.models.decoding import generate
    jax_model, params, model = tiny_pair(seed=3, **MOE)
    rng = np.random.default_rng(4)
    # 2 x 40 = 80 prompt tokens: the prefill streams over the experts;
    # each decode step (2 tokens) gathers per token
    prompt = rng.integers(1, TINY["vocab_size"], (2, 40))
    assert prompt.size > decoding._MOE_GATHER_MAX_TOKENS >= 2
    got = generate(model, prompt, max_new_tokens=8, device="cpu").numpy()
    want = jax_generate(jax_model, params, prompt, max_new_tokens=8)
    _assert_no_near_tie(_lm_router_probs(model, torch.from_numpy(got)))
    assert np.array_equal(got, want)


def test_moe_decode_orders_agree():
    from flashy_tpu_torch.models import decoding
    model = _tiny_moe_model()
    mp = decoding.decode_params(model)["block_0"]["moe"]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 40, TINY["dim"])).astype(np.float32))
    streamed = decoding._moe_forward(model.config, mp, x)
    gathered = torch.cat([decoding._moe_forward(model.config, mp,
                                                x[:, i:i + 16])
                          for i in range(0, 40, 16)], dim=1)
    _rel_close(gathered.numpy(), streamed.numpy(), TOL, "orders")


def _raises_chunked_loss():
    import yaml
    from pathlib import Path
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.xp import Config, temporary_xp
    root = Path(__file__).resolve().parent.parent
    cfg = Config(yaml.safe_load((root / "examples/lm/config/config.yaml")
                                .read_text()))
    cfg["model"].update({"vocab_size": 64, "dim": 16, "num_layers": 1,
                         "num_heads": 2, "moe_experts": 2})
    cfg["loss"] = "chunked"
    with temporary_xp(cfg):
        LMSolver(cfg, device="cpu")


def _raises_chunked_aux():
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    tokens = torch.zeros((1, 8), dtype=torch.long)
    lm_next_token_loss(_tiny_moe_model(), tokens, mode="chunked",
                       aux_weight=0.01)


def _raises_dropless_ep():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    TransformerLM(TransformerConfig(**TINY, **MOE, moe_dispatch="dropless_ep",
                                    dtype=torch.float32), device="cpu")


def _raises_ep_exchange():
    from flashy_tpu_torch.parallel.moe_ep import ep_dropless_moe
    ep_dropless_moe()


def _raises_scan_layers():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    TransformerLM(TransformerConfig(**TINY, **MOE, scan_layers=True,
                                    dtype=torch.float32), device="cpu")


def _tiny_moe_model():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    return TransformerLM(TransformerConfig(**TINY, **MOE,
                                           dtype=torch.float32),
                         device="cpu")


def _raises_engine():
    from flashy_tpu_torch.serve.engine import DecodeEngine
    DecodeEngine(_tiny_moe_model(), slots=2, block_size=4, device="cpu")


def _raises_bad_leaf():
    # the port's own weights as a flax-shaped tree convert back exactly;
    # one expert slab of the wrong shape raises
    from flashy_tpu_torch.models.convert import params_from_jax
    model = _tiny_moe_model()
    tree = {}
    for name, value in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.numpy()
    state = params_from_jax({"params": tree}, model.config)
    assert all(torch.equal(state[k], v)
               for k, v in model.state_dict().items())
    tree["block_0"]["moe"]["w_up"] = np.zeros((4, 32, 8), np.float32)
    params_from_jax(tree, model.config)


@pytest.mark.parametrize("action,error,match", [
    (_raises_chunked_loss, ValueError, "loss=chunked"),
    (_raises_chunked_aux, ValueError, "chunked loss takes no MoE aux"),
    (_raises_dropless_ep, NotImplementedError, "queue A item 8"),
    (_raises_ep_exchange, NotImplementedError, "queue A item 8"),
    (_raises_scan_layers, NotImplementedError, "L7"),
    (_raises_engine, NotImplementedError, "L7"),
    (_raises_bad_leaf, ValueError, "moe/w_up"),
], ids=["chunked_loss", "chunked_aux", "dropless_ep", "ep_exchange",
        "scan_layers", "engine", "bad_leaf"])
def test_unported_moe_paths_raise(action, error, match):
    with pytest.raises(error, match=match):
        action()


def test_lm_solver_trains_a_dropless_moe_lm_on_the_cpu(tmp_path):
    from flashy_tpu_torch.examples.lm.solver import main
    from flashy_tpu_torch.ops.grouped_matmul import launch_counts
    before = dict(launch_counts)
    solver = main(["device=cpu", "model.vocab_size=256", "model.dim=32",
                   "model.num_layers=2", "model.num_heads=4", "seq_len=32",
                   "batch_size=4", "steps_per_epoch=3", "valid_steps=1",
                   "warmup_steps=2", "lr=1e-2", "epochs=2",
                   "model.moe_experts=4", "model.moe_top_k=2",
                   "model.moe_dispatch=dropless", f"dora.dir={tmp_path}"])
    assert launch_counts == before   # the CPU runs the plain versions
    assert solver.model.block_0.moe.dispatch == "dropless"
    losses = [entry["train"]["loss"] for entry in solver.history]
    assert np.isfinite(losses).all() and losses[1] < losses[0]

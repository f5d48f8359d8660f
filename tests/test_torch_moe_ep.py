# The expert-parallel exchange (flashy_tpu_torch/parallel/moe_ep.py) held
# against the JAX package on the CPU, in f32, at the reference test's
# sizes (dim 32, hidden 64, 4 experts, top-2; 4 x 8 tokens):
# * the exchange's bookkeeping (slot, keep, destination, the sentinel
#   ids of the send buffer, the receiving shard's group sizes) equal to
#   the JAX package's rule on the JAX package's routing;
# * `ep_dropless_shard` for each of the 8 shards of a data 4 x expert 2
#   mesh, driven in this process, a thread each (its exchanges served by
#   a list transpose, its means by a mean over the shards), against the JAX
#   package: at capacity factor 8.0, where nothing drops, the outputs,
#   the aux loss and the gradients of the router, the experts and the
#   tokens within 1e-5 of the JAX `dropless` dispatch (the JAX
#   `ep_dropless_moe` equals it there); at 0.1 the same assignments
#   dropped and the outputs within 1e-5 of the JAX `ep_dropless_moe` on
#   a {"expert": 2, "data": 4} host mesh (run once, module-scoped: it
#   runs megablox in interpret mode);
# * `MoEMLP(dispatch='dropless_ep')` without a mesh raises ValueError,
#   as the JAX package does; at one expert shard it equals 'dropless'.
# Every routing input is checked for near ties first (top-2 margins above
# 1e-5), so a tie never reads as a divergence.
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = 1e-5
MARGIN = 1e-5
DIM, HIDDEN, EXPERTS, TOP_K = 32, 64, 4, 2
DATA, SHARDS = 4, 2                  # the host mesh {"expert": 2, "data": 4}


def _rel_close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _assert_no_near_tie(probs):
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    margin = np.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2])
    assert margin.min() > MARGIN, f"near tie: margin {margin.min():.2e}"


def _jax_module(dispatch, cf, mesh=None):
    from flashy_tpu.models.moe import MoEMLP
    return MoEMLP(dim=DIM, hidden=HIDDEN, num_experts=EXPERTS, top_k=TOP_K,
                  capacity_factor=cf, dtype=jnp.float32, dispatch=dispatch,
                  mesh=mesh)


@pytest.fixture(scope="module")
def case():
    """The reference test's tokens (seed 12) and the JAX module's
    parameters, as numpy."""
    x = np.random.default_rng(12).normal(size=(4, 8, DIM)).astype(np.float32)
    params = _jax_module("dropless", 8.0).init(jax.random.PRNGKey(0),
                                               jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    probs = jax.nn.softmax(x.reshape(-1, DIM) @ params["router"]["kernel"])
    _assert_no_near_tie(probs)
    return x, params


@pytest.fixture(scope="module")
def jax_ep_drop(case):
    """The JAX `ep_dropless_moe` at capacity factor 0.1 on the
    {"expert": 2, "data": 4} host mesh: (out, aux)."""
    from flashy_tpu.models import moe_aux_loss
    from flashy_tpu.parallel import make_mesh
    x, params = case
    mesh = make_mesh({"expert": SHARDS, "data": DATA})
    out, mutated = _jax_module("dropless_ep", 0.1, mesh).apply(
        {"params": params}, jnp.asarray(x), mutable=["losses"])
    return np.asarray(out), float(moe_aux_loss(mutated))


def _port_params(params, requires_grad=True):
    return {"router": torch.tensor(params["router"]["kernel"],
                                   requires_grad=requires_grad),
            "w_up": torch.tensor(params["w_up"], requires_grad=requires_grad),
            "w_down": torch.tensor(params["w_down"],
                                   requires_grad=requires_grad)}


class _Shards:
    """The exchanges of `count` shards run in this process, a thread
    each: a call waits until every shard has made it, then hands each its
    result, computed from every shard's tensor (the autograd graph spans
    the shards, as the collectives' backward would)."""

    def __init__(self, count):
        self.barrier = threading.Barrier(count, timeout=60)
        self.sent = [None] * count

    def _swap(self, rank, tensor, combine):
        self.sent[rank] = tensor
        self.barrier.wait()
        result = combine(list(self.sent), rank)
        self.barrier.wait()
        return result

    def exchange(self, rank):
        # block j of shard (d, i) goes to shard (d, j)
        return lambda tensor: self._swap(rank, tensor, lambda sent, r: (
            torch.cat([sent[r // SHARDS * SHARDS + j].chunk(SHARDS)[
                r % SHARDS] for j in range(SHARDS)])))

    def mean(self, rank):
        return lambda tensor: self._swap(
            rank, tensor, lambda sent, r: torch.stack(sent).mean(0))


def _in_process(x_flat, params, cf):
    """The 8 shards of a data 4 x expert 2 mesh in this process: shard r
    sits at (data r // 2, expert r % 2), holds the r-th block of the
    tokens and its expert index's 2 experts. Its body's exchanges go to
    the shards of its data index (a list transpose), its means over
    every shard. Returns (the shards' outputs joined [N, D], their aux
    losses)."""
    from flashy_tpu_torch.parallel.moe_ep import ep_dropless_shard
    count = DATA * SHARDS
    local = EXPERTS // SHARDS
    probs = torch.softmax(x_flat @ params["router"], dim=-1)
    tokens, routed = x_flat.chunk(count), probs.chunk(count)
    shards = _Shards(count)

    def body(r):
        return ep_dropless_shard(
            tokens[r], routed[r], params["w_up"][r % SHARDS * local:][:local],
            params["w_down"][r % SHARDS * local:][:local],
            num_experts=EXPERTS, shards=SHARDS, top_k=TOP_K,
            capacity_factor=cf, dtype=torch.float32,
            exchange=shards.exchange(r), mean=shards.mean(r))

    with ThreadPoolExecutor(count) as pool:
        outs, auxes = zip(*pool.map(body, range(count)))
    return torch.cat(outs), list(auxes)


def _jax_plan(probs_loc, cf):
    """The JAX package's bookkeeping of one shard (its `_topk_route`, the
    slot rule of `ep_dropless_moe`'s body, written out on jnp)."""
    from flashy_tpu.parallel.moe_ep import _topk_route
    n_loc = probs_loc.shape[0]
    local = EXPERTS // SHARDS
    capacity = max(1, -(-int(cf * TOP_K * n_loc) // SHARDS))
    ids, gates, _ = _topk_route(jnp.asarray(probs_loc), EXPERTS, TOP_K)
    expert = ids.reshape(-1)
    dest = expert // local
    position = jnp.cumsum(jax.nn.one_hot(dest, SHARDS, dtype=jnp.int32),
                          axis=0) - 1
    slot = jnp.take_along_axis(position, dest[:, None], axis=-1)[:, 0]
    keep = slot < capacity
    flat = jnp.where(keep, dest * capacity + slot, SHARDS * capacity)
    eid = jnp.full((SHARDS * capacity,), local, jnp.int32).at[flat].set(
        (expert % local).astype(jnp.int32), mode="drop")
    return {"dest_shard": dest, "slot": slot, "keep": keep,
            "flat_dest": flat, "send_eid": eid, "gate": gates.reshape(-1),
            "capacity": capacity}


@pytest.mark.parametrize("cf", [8.0, 0.1])
def test_exchange_bookkeeping_matches_the_reference(case, cf):
    from flashy_tpu_torch.parallel.moe_ep import (_topk_route, ep_capacity,
                                                  ep_plan)
    x, params = case
    probs = jax.nn.softmax(x.reshape(-1, DIM) @ params["router"]["kernel"])
    blocks = np.split(np.asarray(probs), DATA * SHARDS)
    sent = []
    for probs_loc in blocks:
        want = _jax_plan(probs_loc, cf)
        capacity = ep_capacity(cf, TOP_K, probs_loc.shape[0], SHARDS)
        assert capacity == want["capacity"]
        ids, gates, _ = _topk_route(torch.tensor(probs_loc), EXPERTS,
                                    TOP_K)
        plan = ep_plan(ids, gates, SHARDS, EXPERTS // SHARDS, capacity)
        for key in ("dest_shard", "slot", "keep", "flat_dest", "send_eid"):
            np.testing.assert_array_equal(getattr(plan, key).numpy(),
                                          np.asarray(want[key]), err_msg=key)
        np.testing.assert_array_equal(plan.gate.numpy(),
                                      np.asarray(want["gate"]))
        sent.append(plan.send_eid)
    if cf < 1.0:
        assert not all(bool(np.all(_jax_plan(p, cf)["keep"])) for p in blocks)
    # the receiving shard's groups: the reference folds the empty
    # (sentinel) slots into its last group; the port leaves them past the
    # groups' sum
    local = EXPERTS // SHARDS
    for d in range(DATA):
        for i in range(SHARDS):
            recv = torch.cat([sent[d * SHARDS + j].chunk(SHARDS)[i]
                              for j in range(SHARDS)])
            folded = np.bincount(np.minimum(recv.numpy(), local - 1),
                                 minlength=local)
            ours = np.bincount(recv.numpy(), minlength=local + 1)
            sentinels = int((recv == local).sum())
            assert ours[local] == sentinels
            np.testing.assert_array_equal(
                ours[:local], folded - np.eye(local, dtype=int)[-1]
                * sentinels)


def test_in_process_shards_match_jax_dropless_without_drops(case):
    from flashy_tpu.models import moe_aux_loss
    x, params = case
    module = _jax_module("dropless", 8.0)

    def loss(p, x):
        out, mutated = module.apply({"params": p}, x, mutable=["losses"])
        return (out ** 2).sum() + 0.01 * moe_aux_loss(mutated), (
            out, moe_aux_loss(mutated))

    (_, (want_out, want_aux)), (grads, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    port = _port_params(params)
    x_flat = torch.tensor(x.reshape(-1, DIM), requires_grad=True)
    out, auxes = _in_process(x_flat, port, 8.0)
    assert all(torch.equal(a, auxes[0]) for a in auxes)
    _rel_close(out.detach(), np.asarray(want_out).reshape(-1, DIM), TOL,
               "out")
    _rel_close(float(auxes[0].detach()), float(want_aux), TOL, "aux")
    ((out ** 2).sum() + 0.01 * auxes[0]).backward()
    _rel_close(port["router"].grad, grads["router"]["kernel"], TOL, "router")
    _rel_close(port["w_up"].grad, grads["w_up"], TOL, "w_up")
    _rel_close(port["w_down"].grad, grads["w_down"], TOL, "w_down")
    _rel_close(x_flat.grad, np.asarray(dx).reshape(-1, DIM), TOL, "x")
    assert float(port["router"].grad.abs().max()) > 0


def test_in_process_shards_drop_as_jax_does(case, jax_ep_drop):
    x, params = case
    want_out, want_aux = jax_ep_drop
    port = _port_params(params, requires_grad=False)
    x_flat = torch.tensor(x.reshape(-1, DIM))
    out, auxes = _in_process(x_flat, port, 0.1)
    _rel_close(out, want_out.reshape(-1, DIM), TOL, "out")
    _rel_close(float(auxes[0]), want_aux, TOL, "aux")
    full, _ = _in_process(x_flat, port, 8.0)
    # the overflow dropped: whole tokens lose an expert's contribution
    assert float((out - full).abs().max()) > 1e-3
    dropped = (out - full).abs().amax(-1) > 1e-4
    want_dropped = np.abs(want_out.reshape(-1, DIM)
                          - full.numpy()).max(-1) > 1e-4
    np.testing.assert_array_equal(dropped.numpy(), want_dropped)


def test_moe_mlp_dropless_ep_needs_a_mesh_and_equals_dropless_on_one_shard(
        case):
    from flashy_tpu_torch.models.moe import MoEMLP
    from flashy_tpu_torch.parallel import make_mesh
    x, params = case
    kwargs = dict(dim=DIM, hidden=HIDDEN, num_experts=EXPERTS, top_k=TOP_K,
                  capacity_factor=8.0, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs the mesh"):
        MoEMLP(dispatch="dropless_ep", **kwargs)
    outs, grads = [], []
    for dispatch, mesh in (("dropless", None),
                           ("dropless_ep", make_mesh({"data": 1}))):
        layer = MoEMLP(dispatch=dispatch, mesh=mesh, **kwargs)
        layer.load_state_dict({"router.kernel": torch.tensor(
            params["router"]["kernel"]), "w_up": torch.tensor(
            params["w_up"]), "w_down": torch.tensor(params["w_down"])})
        out = layer(torch.tensor(x))
        ((out ** 2).sum() + 0.01 * layer.aux).backward()
        outs.append((out.detach(), layer.aux.detach()))
        grads.append({n: p.grad for n, p in layer.named_parameters()})
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for name, grad in grads[0].items():
        assert torch.equal(grads[1][name], grad), name


def test_expert_parallel_refuses_what_it_does_not_compose_with():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.parallel import model_state, wrap, zero_sharding
    from flashy_tpu_torch.parallel.mesh import AXES, Mesh
    mesh = Mesh({axis: 2 if axis == "expert" else 1 for axis in AXES})
    cfg = TransformerConfig(vocab_size=64, dim=DIM, num_layers=1,
                            num_heads=4, moe_experts=EXPERTS, moe_top_k=2,
                            dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="queue A item 8f"):
        wrap(model, mesh=mesh, fsdp=True)
    with pytest.raises(NotImplementedError, match="queue A item 8f"):
        wrap(model, mesh=mesh, state_sharding=zero_sharding(
            model_state(model), mesh))

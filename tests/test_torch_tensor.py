# The port's tensor-parallel layouts (queue A item 8b) held against the
# JAX package in one process: validate_tensor_args' accepted combination
# and its four messages (the reference's words and divisor hints);
# tensor_state_sharding over the tiny LM's converted tree, dense and a
# hybrid SSD stack, and seq2seq_shardings, compared leaf for leaf with
# the reference's on a {"data": 4, "tensor": 2} mesh (the JAX side on the
# conftest's virtual CPU devices, the port's on a Mesh record of the same
# axis sizes); describe_state_sharding's tensor, tensor+zero1 and
# tensor+fsdp summaries; the `pairs` layout of the gated MLP's fused `up`
# kernel (every rank's slice joined back is the reference's tensor, bit
# for bit, and rank t's slice computes its half of the hidden width);
# an indivisible vocabulary's ValueError. The runs across processes are
# test_torch_tensor_multiproc.py.
import numpy as np
import pytest
import torch

from flashy_tpu_torch.parallel.mesh import AXES, Mesh
from flashy_tpu_torch.parallel.sharding import NamedSharding, P

KWARGS = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4,
              mlp_ratio=2, attention="dense")


def _port_mesh(**sizes):
    return Mesh({axis: int(sizes.get(axis, 1)) for axis in AXES})


def _jax_mesh(**sizes):
    import jax
    from flashy_tpu.parallel import make_mesh
    n = int(np.prod(list(sizes.values())))
    return make_mesh(dict(sizes), devices=jax.devices()[:n])


def _message(fn, *args, **kwargs):
    with pytest.raises(ValueError) as exc:
        fn(*args, **kwargs)
    return str(exc.value)


@pytest.mark.parametrize("args,kwargs", [
    ((4, 128, 0), {}), ((6, 128, 4), {}), ((8, 20, 8), {}),
    ((8, 128, 8), {"num_devices": 12})])
def test_validate_tensor_args_messages_equal_the_references(args, kwargs):
    from flashy_tpu.parallel import validate_tensor_args as jax_validate
    from flashy_tpu_torch.parallel import validate_tensor_args
    assert _message(validate_tensor_args, *args, **kwargs) == \
        _message(jax_validate, *args, **kwargs)
    validate_tensor_args(4, 128, 2, num_devices=8)  # the accepted combo


def _jax_state(mixer):
    import jax
    import jax.numpy as jnp
    import optax
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    cfg = JaxConfig(**KWARGS, mixer=mixer, ssd_state_dim=4, ssd_chunk=8,
                    dtype=jnp.float32)
    variables = JaxLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
    variables = {"params": variables["params"]}
    return {"params": variables,
            "opt_state": optax.adamw(1e-3).init(variables)}


@pytest.mark.parametrize("mixer,min_size", [
    ("attention", 1), ("attention", 2 ** 12), ("ssd,attention", 1)])
def test_tensor_state_sharding_matches_jax(mixer, min_size):
    import jax
    from flashy_tpu.parallel import tensor_state_sharding as jax_specs
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import TransformerConfig
    from flashy_tpu_torch.parallel import tensor_state_sharding
    from flashy_tpu_torch.parallel.zero import _paths
    state = _jax_state(mixer)
    jspec = jax_specs(state, _jax_mesh(data=4, tensor=2), min_size=min_size)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            jspec, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        if keys[0] == "params":
            key = ("params", ".".join(keys[2:]))
        elif keys[-1] == "count":
            key = ("opt_state", "count")
        else:  # ['opt_state'][0].mu['params'][...]
            key = ("opt_state", keys[2], ".".join(keys[4:]))
        want[key] = tuple(sharding.spec)
    conv = params_from_jax(jax.tree.map(np.asarray, state["params"]),
                           TransformerConfig(**KWARGS, mixer=mixer,
                                             ssd_state_dim=4))
    port_state = {"params": conv, "opt_state": {
        "mu": dict(conv), "nu": dict(conv),
        "count": np.zeros((), np.int32)}}
    got = {path: tuple(leaf.spec) for path, leaf in _paths(
        tensor_state_sharding(port_state, _port_mesh(data=4, tensor=2),
                              min_size=min_size))}
    assert got == want
    # the moments ride the zero axis; the fused `up` kernel is cut block
    # by block in both trees
    sharded = tensor_state_sharding(port_state, _port_mesh(data=4, tensor=2),
                                    min_size=min_size)
    assert sharded["params"]["block_1.mlp.up.kernel"].pairs == 2
    assert sharded["opt_state"]["mu"]["block_1.mlp.up.kernel"].pairs == 2
    if min_size == 1:
        assert "data" in sharded["opt_state"]["mu"]["embed"].spec.axes()


def test_seq2seq_shardings_match_jax():
    import jax
    import jax.numpy as jnp
    from flashy_tpu.models.seq2seq import Seq2SeqConfig as JaxConfig
    from flashy_tpu.models.seq2seq import Seq2SeqTransformer as JaxModel
    from flashy_tpu.models.seq2seq import seq2seq_shardings as jax_specs
    from flashy_tpu_torch.models import seq2seq_shardings
    tiny = dict(vocab_size=64, dim=32, enc_layers=1, dec_layers=2,
                num_heads=4, max_seq_len=32)
    src = jnp.zeros((1, 6), jnp.int32)
    params = JaxModel(JaxConfig(**tiny, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), src, src)
    want = {"/".join(str(getattr(k, "key", k)) for k in path[1:]):
            tuple(spec) for path, spec in jax.tree_util.tree_flatten_with_path(
                jax_specs(params),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]}
    flat = {"/".join(str(getattr(k, "key", k)) for k in path[1:]): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {name.replace(".", "/"): tuple(spec) for name, spec in
           seq2seq_shardings({n.replace("/", "."): np.asarray(v)
                              for n, v in flat.items()}).items()}
    assert got == want
    assert got["dec_blocks_1/xattn/q/kernel"] == ("fsdp", "tensor", None)


@pytest.mark.parametrize("layout", ["tensor", "tensor+zero1",
                                    "tensor+fsdp"])
def test_describe_state_sharding_tensor_modes_match_jax(layout):
    import jax
    from jax.sharding import NamedSharding as JaxNamed
    from jax.sharding import PartitionSpec as JP
    from flashy_tpu.models import transformer_shardings as jax_tshard
    from flashy_tpu.parallel import describe_state_sharding as jax_describe
    from flashy_tpu.parallel import tensor_state_sharding as jax_tss
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     transformer_shardings)
    from flashy_tpu_torch.parallel import (describe_state_sharding,
                                           tensor_state_sharding)
    state = _jax_state("attention")
    sizes = {"fsdp": 4, "tensor": 2} if layout == "tensor+fsdp" \
        else {"data": 4, "tensor": 2}
    jmesh, pmesh = _jax_mesh(**sizes), _port_mesh(**sizes)
    conv = params_from_jax(jax.tree.map(np.asarray, state["params"]),
                           TransformerConfig(**KWARGS))
    port_state = {"params": conv, "opt_state": {"mu": dict(conv)}}
    if layout == "tensor+zero1":
        jspec = jax_tss(state, jmesh, min_size=1)
        pspec = tensor_state_sharding(port_state, pmesh, min_size=1)
    else:
        specs = jax_tshard(state["params"])
        jparams = jax.tree.map(lambda s: JaxNamed(jmesh, s), specs,
                               is_leaf=lambda x: isinstance(x, JP))
        jspec = {"params": jparams, "opt_state": jparams}
        local = {name: NamedSharding(pmesh, spec) for name, spec in
                 transformer_shardings(conv).items()}
        pspec = {"params": local, "opt_state": {"mu": local}}
    want = jax_describe(jax.device_put(
        jax.tree.map(np.asarray, state if layout == "tensor+zero1" else
                     {"params": state["params"],
                      "opt_state": state["params"]}), jspec))
    got = describe_state_sharding(pspec)
    assert got["summary"] == want["summary"] == {
        "tensor": "tensor(tensor=2)",
        "tensor+zero1": "tensor+zero1(data=4,tensor=2)",
        "tensor+fsdp": "tensor+fsdp(fsdp=4,tensor=2)"}[layout]
    assert got["mode"] == want["mode"]


def test_mlp_up_pairs_layout_round_trip_and_local_product(monkeypatch):
    # rank t holds its columns of `gate` then the same columns of
    # `value`: the rows of `down` it holds see exactly their hidden units
    from flashy_tpu_torch.models.transformer import transformer_spec
    from flashy_tpu_torch.parallel.sharding import join_pairs
    gen = torch.Generator().manual_seed(0)
    dim, hidden, tensor = 8, 12, 2
    up = torch.randn(dim, 2 * hidden, generator=gen)
    down = torch.randn(hidden, dim, generator=gen)
    x = torch.randn(5, dim, generator=gen)
    mesh = _port_mesh(data=2, tensor=tensor)
    spec = transformer_spec("block_0/mlp/up/kernel")
    assert tuple(spec) == ("fsdp", "tensor") and spec.pairs == 2
    up_sharding = NamedSharding(mesh, spec)
    down_sharding = NamedSharding(mesh, P("tensor", "fsdp"))
    # the moments' layout: the zero axis rides along as ('tensor', 'data')
    ride = NamedSharding(mesh, P("fsdp", ("tensor", "data")), pairs=2)
    slices, partial = [], torch.zeros(5, dim)
    gate, value = (x @ up).chunk(2, -1)
    want = (torch.nn.functional.silu(gate) * value) @ down
    for t in range(tensor):
        monkeypatch.setattr(Mesh, "coord",
                            lambda self, axis, t=t: t if axis == "tensor"
                            else 0)
        local = up_sharding.shard(up)
        assert local.shape == (dim, 2 * hidden // tensor)
        cols = slice(t * hidden // tensor, (t + 1) * hidden // tensor)
        assert torch.equal(local, torch.cat([up[:, :hidden][:, cols],
                                             up[:, hidden:][:, cols]], 1))
        slices.append(local)
        g, v = (x @ local).chunk(2, -1)
        partial += (torch.nn.functional.silu(g) * v) @ \
            down_sharding.shard(down)
        # the ('tensor', 'data') slices of rank t join back to its slice
        pieces = []
        for d in range(2):
            monkeypatch.setattr(
                Mesh, "coord", lambda self, axis, t=t, d=d:
                {"tensor": t, "data": d}.get(axis, 0))
            pieces.append(ride.shard(up))
        assert torch.equal(join_pairs(pieces, 1, 2), local)
    assert torch.equal(join_pairs(slices, 1, 2), up)
    assert torch.allclose(partial, want, rtol=1e-5, atol=1e-5)


def test_indivisible_vocabulary_raises_naming_the_leaf_and_divisors():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.parallel import wrap
    mesh = _port_mesh(tensor=2)
    model = TransformerLM(TransformerConfig(**{**KWARGS, "vocab_size": 63}),
                          device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match=r"embed: dim 0 .*63.*"
                                         r"\[1, 3, 7, 9, 21, 63\]"):
        wrap(model, mesh=mesh)
    # MoE blocks under tensor build (item 8d); an expert count the
    # expert axis does not divide raises naming the leaf and divisors
    TransformerLM(TransformerConfig(**KWARGS, moe_experts=4), device="cpu",
                  mesh=mesh)
    experts = _port_mesh(expert=2)
    moe = TransformerLM(TransformerConfig(**KWARGS, moe_experts=3),
                        device="cpu", mesh=experts)
    with pytest.raises(ValueError, match=r"block_0\.moe\.w_up: dim 0 .*"
                                         r"\[1, 3\]"):
        wrap(moe, mesh=experts)

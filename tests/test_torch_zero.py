# The port's layout records and ZeRO/FSDP rules (queue A item 8a) held
# against the JAX package in one process: the specs of the leaf rule,
# fsdp_sharding, zero_sharding and transformer_shardings compared leaf
# for leaf with the reference's on the same trees and mesh shapes (the
# JAX side on the conftest's virtual CPU devices, the port's on a Mesh
# record of the same axis sizes), describe_state_sharding's dict on
# replicated, zero1, fsdp, size-1-axis and 1-device layouts,
# per_device_bytes of rank 0's shards at two ways, audit_expectations,
# the accounting's op names and arithmetic, set_state_sharding's
# KeyError. The runs across processes are test_torch_zero_multiproc.py.
import numpy as np
import pytest
import torch

from flashy_tpu_torch.parallel.mesh import AXES, Mesh
from flashy_tpu_torch.parallel.sharding import NamedSharding, P


def _port_mesh(**sizes):
    return Mesh({axis: int(sizes.get(axis, 1)) for axis in AXES})


def _jax_mesh(**sizes):
    import jax
    from flashy_tpu.parallel import make_mesh
    n = int(np.prod(list(sizes.values()))) if sizes else 1
    return make_mesh(dict(sizes), devices=jax.devices()[:n])


def _tree(seed=0):
    """A state of numpy leaves: big, small, odd and scalar shapes."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 32), "v": (8, 48, 6), "odd": (7, 9), "b": (32,),
              "s": ()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    return {"params": params,
            "opt_state": {"mu": dict(params), "nu": dict(params),
                          "count": np.zeros((), np.int32)}}


def _specs(tree):
    """Every leaf's spec as a tuple of parts, by its path."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {jax.tree_util.keystr(path): tuple(leaf.spec)
            for path, leaf in flat}


def _port_specs(tree):
    from flashy_tpu_torch.parallel.zero import _paths, keystr
    return {keystr(path): tuple(leaf.spec) for path, leaf in _paths(tree)}


@pytest.mark.parametrize("sizes,axis,min_size", [
    ({"data": 2}, "data", 1), ({"data": 8}, "data", 1),
    ({"data": 2}, "data", 2 ** 10), ({"fsdp": 2}, "fsdp", 1),
    ({"fsdp": 4}, "fsdp", 2 ** 8), ({"data": 2, "fsdp": 2}, "fsdp", 1)])
def test_axis_leaf_and_fsdp_sharding_match_jax(sizes, axis, min_size):
    from flashy_tpu.parallel import fsdp_sharding as jax_fsdp
    from flashy_tpu.parallel.data_parallel import (
        axis_leaf_sharding as jax_rule)
    from flashy_tpu_torch.parallel import axis_leaf_sharding, fsdp_sharding
    tree = _tree()["params"]
    jmesh, pmesh = _jax_mesh(**sizes), _port_mesh(**sizes)
    jrule, prule = jax_rule(jmesh, axis, min_size), \
        axis_leaf_sharding(pmesh, axis, min_size)
    for key, leaf in tree.items():
        assert tuple(prule(leaf).spec) == tuple(jrule(leaf).spec), key
    assert _port_specs(fsdp_sharding(tree, pmesh, axis, min_size)) == \
        _specs(jax_fsdp(tree, jmesh, axis, min_size))


def test_axis_leaf_sharding_composes_a_base_spec_as_jax_does():
    # a tensor split already on a leaf: the zero shard takes the largest
    # free dim, or rides along the split one (the HSDP spelling)
    from jax.sharding import PartitionSpec as JP
    from flashy_tpu.parallel.data_parallel import (
        axis_leaf_sharding as jax_rule)
    from flashy_tpu_torch.parallel import axis_leaf_sharding
    jmesh, pmesh = _jax_mesh(data=2, tensor=2), _port_mesh(data=2, tensor=2)
    cases = [((8, 6), ("tensor", None)), ((8, 8), ("tensor", None)),
             ((4, 6), (None, "tensor")), ((8,), ("tensor",))]
    for shape, base in cases:
        x = np.zeros(shape, np.float32)
        want = jax_rule(jmesh, "data", 1, base=lambda _, b=base: JP(*b))(x)
        got = axis_leaf_sharding(pmesh, "data", 1,
                                 base=lambda _, b=base: P(*b))(x)
        assert tuple(got.spec) == tuple(want.spec), (shape, base)


@pytest.mark.parametrize("form", ["mapping", "min_size", "master",
                                  "shard_keys", "bare"])
def test_zero_sharding_matches_jax(form):
    from flashy_tpu.parallel import zero_sharding as jax_zero
    from flashy_tpu_torch.parallel import zero_sharding
    state = _tree()
    kwargs = {"min_size": 1}
    if form == "min_size":
        kwargs = {"min_size": 2 ** 10}
    elif form == "master":
        state["master_params"] = dict(state["params"])
    elif form == "shard_keys":
        kwargs["shard_keys"] = ("params",)
    elif form == "bare":
        # a non-mapping tree (an optimizer state's tuple) is all update
        state = (state["opt_state"]["mu"], state["opt_state"]["nu"])
    jmesh, pmesh = _jax_mesh(data=2), _port_mesh(data=2)
    got = _port_specs(zero_sharding(state, pmesh, **kwargs))
    assert got == _specs(jax_zero(state, jmesh, **kwargs))
    assert any(spec != () for spec in got.values()) or form == "min_size"


@pytest.mark.parametrize("kind", ["dense", "moe", "scan"])
def test_transformer_shardings_match_jax(kind):
    import jax
    import jax.numpy as jnp
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    from flashy_tpu.models import transformer_shardings as jax_specs
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     transformer_shardings)
    kwargs = dict(vocab_size=64, dim=32, num_layers=2, num_heads=2,
                  mlp_ratio=2, attention="dense")
    if kind == "moe":
        kwargs.update(moe_experts=4, moe_top_k=2)
    if kind == "scan":
        kwargs.update(scan_layers=True)
    variables = JaxLM(JaxConfig(**kwargs)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = {"params": variables["params"]}
    want = {"/".join(str(getattr(k, "key", k)) for k in path[1:]):
            tuple(spec) for path, spec in jax.tree_util.tree_flatten_with_path(
                jax_specs(params),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]}
    port = params_from_jax(jax.tree.map(np.asarray, params),
                           TransformerConfig(**kwargs))
    got = {name.replace(".", "/"): tuple(spec)
           for name, spec in transformer_shardings(port).items()}
    assert got == want


def _jax_placed(state, shardings):
    import jax
    return jax.device_put(jax.tree.map(np.asarray, state), shardings)


@pytest.mark.parametrize("layout", ["replicated", "zero1", "fsdp",
                                    "size1_axis", "one_device", "nested"])
def test_describe_state_sharding_matches_jax(layout):
    import jax
    from flashy_tpu.parallel import describe_state_sharding as jax_describe
    from flashy_tpu.parallel import fsdp_sharding as jax_fsdp
    from flashy_tpu.parallel import zero_sharding as jax_zero
    from flashy_tpu_torch.parallel import (describe_state_sharding,
                                           fsdp_sharding, zero_sharding)
    state = _tree()
    if layout == "replicated":
        assert describe_state_sharding(state) == jax_describe(state) \
            == {"mode": "replicated", "param_axes": [], "update_axes": [],
                "axis_sizes": {}, "summary": "replicated"}
        return
    if layout in ("zero1", "nested"):
        sizes, make = {"data": 2}, (jax_zero, zero_sharding)
        kwargs = {"min_size": 1}
    elif layout == "fsdp":
        sizes, make = {"fsdp": 2}, (jax_fsdp, fsdp_sharding)
        kwargs = {"min_size": 1}
    elif layout == "size1_axis":
        # the declared spec names 'tensor', an axis of size 1 there
        sizes, kwargs = {"data": 2, "tensor": 1}, {}
    else:
        sizes, make = {"data": 1}, (jax_zero, zero_sharding)
        kwargs = {"min_size": 1}
    jmesh, pmesh = _jax_mesh(**sizes), _port_mesh(**sizes)
    if layout == "size1_axis":
        from jax.sharding import NamedSharding as JaxNamed
        from jax.sharding import PartitionSpec as JP
        jspec = jax.tree.map(lambda _: JaxNamed(jmesh, JP("tensor", None)),
                             {"params": {"w": state["params"]["w"]}})
        jspec["opt_state"] = {"mu": {"w": JaxNamed(jmesh, JP("data",
                                                             "tensor"))}}
        state = {"params": {"w": state["params"]["w"]},
                 "opt_state": {"mu": {"w": state["params"]["w"]}}}
        pspec = {"params": {"w": NamedSharding(pmesh, P("tensor", None))},
                 "opt_state": {"mu": {"w": NamedSharding(
                     pmesh, P("data", "tensor"))}}}
    elif layout == "one_device":
        # a 1-device mesh: the declared spelling classifies
        from jax.sharding import NamedSharding as JaxNamed
        from jax.sharding import PartitionSpec as JP
        state = {"params": {"w": state["params"]["w"]},
                 "opt_state": {"mu": {"w": state["params"]["w"]}}}
        jspec = {"params": {"w": JaxNamed(jmesh, JP())},
                 "opt_state": {"mu": {"w": JaxNamed(jmesh, JP("data"))}}}
        pspec = {"params": {"w": NamedSharding(pmesh, P())},
                 "opt_state": {"mu": {"w": NamedSharding(pmesh, P("data"))}}}
    else:
        jspec = make[0](state, jmesh, **kwargs)
        pspec = make[1](state, pmesh, **kwargs)
    want = jax_describe(_jax_placed(state, jspec))
    if layout == "nested":
        want = jax_describe({"state": _jax_placed(state, jspec),
                             "history": []})
        pspec = {"state": pspec, "history": []}
    assert describe_state_sharding(pspec) == want
    assert want["mode"] != "replicated" or layout == "size1_axis"


def test_per_device_bytes_at_two_ways_is_jaxs():
    # rank 0's slices of a zero1 state at data=2 and of an fsdp state at
    # fsdp=2 hold what one of the reference's two devices holds
    from flashy_tpu.parallel import fsdp_sharding as jax_fsdp
    from flashy_tpu.parallel import per_device_bytes as jax_bytes
    from flashy_tpu.parallel import zero_sharding as jax_zero
    from flashy_tpu_torch.parallel import (fsdp_sharding, per_device_bytes,
                                           zero_sharding)
    from flashy_tpu_torch.parallel.sharding import place
    state = _tree()
    for sizes, jmake, pmake in (({"data": 2}, jax_zero, zero_sharding),
                                ({"fsdp": 2}, jax_fsdp, fsdp_sharding)):
        jmesh, pmesh = _jax_mesh(**sizes), _port_mesh(**sizes)
        want = jax_bytes(_jax_placed(state, jmake(state, jmesh,
                                                  min_size=1)))
        placed = place(state, pmake(state, pmesh, min_size=1))
        assert per_device_bytes(placed) == want, sizes
        assert want < jax_bytes(state)
    w = placed["opt_state"]["mu"]["w"]
    assert w.shape == (32, 32) and w.sharding.spec == P("fsdp", None)
    assert torch.equal(w, torch.from_numpy(state["params"]["w"][:32]))


def test_audit_expectations_match_jax():
    from flashy_tpu.parallel.zero import audit_expectations as jax_audit
    from flashy_tpu.parallel import zero_sharding as jax_zero
    from flashy_tpu_torch.parallel import audit_expectations, zero_sharding
    state = _tree()
    jspec = jax_zero(state, _jax_mesh(data=2), min_size=1)
    pspec = zero_sharding(state, _port_mesh(data=2), min_size=1)
    for kwargs in ({}, {"params_bytes": 64 * 32 * 4}):
        assert audit_expectations(pspec, **kwargs) == jax_audit(jspec,
                                                                **kwargs)


def test_collective_stats_names_and_arithmetic_are_the_references():
    from flashy_tpu.parallel.accounting import COLLECTIVE_OPS as JAX_OPS
    from flashy_tpu_torch import distrib
    from flashy_tpu_torch.parallel import (collective_stats,
                                           compare_collective_stats,
                                           count_collectives,
                                           total_collective_bytes)
    from flashy_tpu_torch.parallel.accounting import COLLECTIVE_OPS
    assert COLLECTIVE_OPS == JAX_OPS
    with count_collectives() as record:
        # one process: the collectives are identities and count nothing
        distrib.all_reduce(torch.ones(3))
        distrib.all_gather(torch.ones(3))
        distrib.reduce_scatter(torch.ones(4))
    assert record == []
    record = [("all-gather", 64), ("reduce-scatter", 32),
              ("all-gather", 64)]
    stats = collective_stats(record)
    assert list(stats) == list(JAX_OPS)
    assert stats["all-gather"] == {"count": 2, "bytes": 128}
    assert total_collective_bytes(record) == 160
    assert compare_collective_stats(record, [("all-reduce", 96)]) == {
        "all-gather": {"count": 2, "bytes": 128},
        "all-reduce": {"count": -1, "bytes": -96},
        "reduce-scatter": {"count": 1, "bytes": 32}}


def test_set_state_sharding_refuses_an_unregistered_name_as_jax_does():
    from flashy_tpu.solver import BaseSolver as JaxSolver
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.solver import BaseSolver
    from flashy_tpu_torch.xp import temporary_xp

    for base, xp in ((JaxSolver, jax_xp), (BaseSolver, temporary_xp)):
        class Solver(base):
            def __init__(self):
                super().__init__()
                self.weights = {"w": np.zeros((4, 2), np.float32)}
                self.register_stateful("weights")

            def run(self):
                pass

        with xp():
            solver = Solver()
            with pytest.raises(KeyError, match="not a registered"):
                solver.set_state_sharding("missing", None)
            solver.set_state_sharding("weights", None)


def test_shards_carrying_their_sharding_save_and_load(tmp_path):
    # a rank's shard carries its NamedSharding as `.sharding`; the files
    # hold the tensors alone (weights_only loading refuses other objects)
    from flashy_tpu_torch import checkpoint
    from flashy_tpu_torch.parallel import zero_sharding
    from flashy_tpu_torch.parallel.sharding import place
    state = {"opt_state": {"mu": torch.arange(64.0).reshape(16, 4)},
             "step": 3}
    placed = place(state, zero_sharding(state, _port_mesh(data=2),
                                        min_size=1))
    shard = placed["opt_state"]["mu"]
    assert shard.shape == (8, 4) and shard.sharding.spec == P("data", None)
    checkpoint.save_state(placed, tmp_path / "single.th")
    checkpoint.save_state_sharded(placed, tmp_path / "slots")
    for loaded in (checkpoint.load_state(tmp_path / "single.th"),
                   checkpoint.load_state_sharded(tmp_path / "slots")):
        assert torch.equal(loaded["opt_state"]["mu"], shard)
        assert loaded["step"] == 3

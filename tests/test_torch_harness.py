# The rest of the port's harness core (flashy_tpu_torch: utils.freeze,
# xp.get_xp_from_sig, logging.serve_formatter, the checkpoint's torch
# state-dict interop, info) held against the JAX package on the same
# inputs: formatted strings and printed lines identical, the imported
# checkpoint equal leaf for leaf once its tensors are numpy.
import json
import pickle

import numpy as np
import pytest
import torch


def test_freeze_blocks_gradients_and_shares_values():
    from flashy_tpu_torch.utils import freeze, readonly
    assert readonly is freeze
    weight = torch.randn(3, 4, requires_grad=True)
    bias = torch.randn(4, requires_grad=True)
    tree = {"layer": [weight, (bias, "tag")], "scale": 2.0}
    frozen = freeze(tree)
    assert frozen["scale"] == 2.0 and frozen["layer"][1][1] == "tag"
    assert isinstance(frozen["layer"], list)
    assert isinstance(frozen["layer"][1], tuple)
    w, (b, _) = frozen["layer"][0], frozen["layer"][1]
    assert not w.requires_grad and not b.requires_grad
    # shared, not copied
    assert w.data_ptr() == weight.data_ptr()
    assert b.data_ptr() == bias.data_ptr()
    x = torch.randn(2, 3, requires_grad=True)
    ((x @ w + b).sum() + (x @ weight).sum()).backward()
    # only the live path reaches the parameter
    np.testing.assert_allclose(weight.grad.numpy(),
                               x.detach().sum(0)[:, None].expand(3, 4).numpy(),
                               rtol=1e-6)
    assert bias.grad is None and x.grad is not None


def test_freeze_matches_the_jax_packages_stop_gradient():
    import jax
    import jax.numpy as jnp
    from flashy_tpu.utils import freeze as jax_freeze
    from flashy_tpu_torch.utils import freeze
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    x = rng.standard_normal((2, 3)).astype(np.float32)

    def jax_loss(w):
        return jnp.sum(x @ jax_freeze({"w": w})["w"]) + jnp.sum((x @ w) ** 2)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x)
    ((xt @ freeze({"w": wt})["w"]).sum() + ((xt @ wt) ** 2).sum()).backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metrics", [
    {"ttft_ms_p50": 12.345, "itl_ms_p95": 3.21, "queue_ms": 0.04},
    {"occupancy_p50": 0.4567, "acceptance_rate": 0.8, "queue_depth_p95": 2.5,
     "accepted_per_step_p50": 1.25},
    {"requests": 16, "completed": 15, "rejected": 1, "expired": 0,
     "tokens": 2048, "finish_length": 3, "finish_eos": 12,
     "spec_drafted": 40, "spec_emitted": 31, "tokens_per_sec": 301.25},
])
def test_serve_formatter_renders_as_the_jax_package(metrics):
    from flashy_tpu.logging import serve_formatter as jax_formatter
    from flashy_tpu_torch.logging import serve_formatter
    assert serve_formatter()(metrics) == jax_formatter()(metrics)


def test_get_xp_from_sig_finds_a_port_xp(tmp_path):
    from flashy_tpu_torch import xp as port_xp
    cfg = {"lr": 0.1, "model": {"dim": 8}}
    made = port_xp.create_xp(cfg, root=tmp_path)
    made.link.update_history([{"train": {"loss": 1.5}}])
    found = port_xp.get_xp_from_sig(made.sig, root=tmp_path)
    assert found.sig == made.sig and found.folder == made.folder
    assert found.cfg == cfg and found.link.history == made.link.history
    assert found.cfg.model.dim == 8
    assert not port_xp.is_xp_active()
    with found.enter():
        assert port_xp.is_xp_active() and port_xp.get_xp() is found
    assert not port_xp.is_xp_active()


def test_get_xp_from_sig_unknown_raises_as_the_jax_package(tmp_path):
    from flashy_tpu.xp import get_xp_from_sig as jax_get
    from flashy_tpu_torch.xp import get_xp_from_sig
    with pytest.raises(FileNotFoundError) as jax_error:
        jax_get("deadbeef", root=tmp_path)
    with pytest.raises(FileNotFoundError) as error:
        get_xp_from_sig("deadbeef", root=tmp_path)
    assert str(error.value) == str(jax_error.value)


def test_entry_point_get_xp_from_sig_and_hydra_main(tmp_path):
    from flashy_tpu_torch import xp as port_xp
    assert port_xp.hydra_main is port_xp.main

    @port_xp.hydra_main()
    def entry(cfg):
        return port_xp.get_xp().sig

    entry.dir = tmp_path
    sig = entry(["lr=0.5"])
    assert entry.get_xp_from_sig(sig).cfg == {"lr": 0.5}
    with pytest.raises(FileNotFoundError):
        entry.get_xp_from_sig("00000000")


def _nested_tree():
    rng = np.random.default_rng(1)
    return {"params": {"dense": {"kernel": rng.standard_normal((3, 2)),
                                 "bias": np.zeros(2, np.float32)},
                       "blocks": [{"w": rng.standard_normal(4)},
                                  {"w": rng.standard_normal(4)}]},
            "step": 7, "skip": None}


def test_state_dict_interop_round_trips_and_matches_the_jax_package():
    from flashy_tpu.checkpoint import to_torch_state_dict as jax_flatten
    from flashy_tpu_torch.checkpoint import (from_torch_state_dict,
                                             to_torch_state_dict)
    tree = _nested_tree()
    flat = to_torch_state_dict(tree)
    want = jax_flatten(tree)
    assert list(flat) == list(want)
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(flat[key], value), key
        else:
            assert flat[key] == value
    # tensors stay tensors, and the same objects
    tensors = {"a": {"b": torch.ones(2)}, "c": [torch.zeros(1)]}
    flat_tensors = to_torch_state_dict(tensors, prefix="m")
    assert flat_tensors["m.a.b"] is tensors["a"]["b"]
    assert list(flat_tensors) == ["m.a.b", "m.c.0"]
    # round trip: unflatten then flatten gives the state dict back
    back = from_torch_state_dict(flat)
    assert back["params"]["dense"]["kernel"] is flat["params.dense.kernel"]
    assert to_torch_state_dict(back) == flat


def _flashy_checkpoint(path):
    """A checkpoint as the original flashy writes it: flat module state
    dicts, a nested optimizer state, plain Python objects beside them."""
    rng = np.random.default_rng(2)
    model = {"layers.0.weight": torch.from_numpy(
        rng.standard_normal((4, 3)).astype(np.float32)),
        "layers.0.bias": torch.zeros(4), "norm.scale": torch.ones(3)}
    optimizer = {"state": {0: {"exp_avg": torch.full((4, 3), 0.5),
                               "step": torch.tensor(3.0)}},
                 "param_groups": [{"lr": 1e-3, "params": [0, 1, 2]}]}
    raw = {"model": model, "optimizer": optimizer,
           "history": [{"train": {"loss": 2.5}}],
           "xp.cfg": {"lr": 1e-3, "model": {"dim": 3}}, "xp.sig": "abcd1234",
           "extra": (1, "two")}
    torch.save(raw, path)
    return raw


def test_import_flashy_checkpoint_matches_the_jax_package(tmp_path):
    from flashy_tpu.checkpoint import import_flashy_checkpoint as jax_import
    from flashy_tpu_torch.checkpoint import (from_torch_state_dict,
                                             import_flashy_checkpoint)
    path = tmp_path / "checkpoint.th"
    raw = _flashy_checkpoint(path)
    got = import_flashy_checkpoint(path)
    # module state dicts stay flat, tensors stay CPU tensors
    assert list(got["model"]) == list(raw["model"])
    for key, value in raw["model"].items():
        assert got["model"][key].device.type == "cpu"
        assert torch.equal(got["model"][key], value)
    for key in ("history", "xp.cfg", "xp.sig", "extra"):
        assert got[key] == raw[key]
    # the leaves as numpy and the flat entries unflattened: the JAX
    # package's result
    want = jax_import(path)

    def numpy_leaves(node):
        if isinstance(node, torch.Tensor):
            return node.numpy()
        if isinstance(node, dict):
            return {key: numpy_leaves(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(numpy_leaves(value) for value in node)
        return node

    def unflatten(entry):
        if isinstance(entry, dict) and entry and all(
                isinstance(k, str) for k in entry) and any(
                "." in k for k in entry):
            return from_torch_state_dict(entry)
        return entry

    converted = {name: unflatten(numpy_leaves(entry))
                 for name, entry in got.items()}
    assert converted.keys() == want.keys()
    np.testing.assert_equal(converted, want)


def test_imported_checkpoint_restores_into_the_port_solver(tmp_path):
    from flashy_tpu_torch.checkpoint import import_flashy_checkpoint
    from flashy_tpu_torch.solver import BaseSolver
    from flashy_tpu_torch.xp import temporary_xp
    path = tmp_path / "checkpoint.th"
    raw = _flashy_checkpoint(path)

    class Solver(BaseSolver):
        def __init__(self):
            super().__init__()
            self.model = torch.nn.ModuleDict({
                "layers": torch.nn.ModuleList([torch.nn.Linear(3, 4)]),
                "norm": torch.nn.Module()})
            self.model["norm"].scale = torch.nn.Parameter(torch.zeros(3))
            self.register_stateful("model")

    with temporary_xp():
        solver = Solver()
        imported = import_flashy_checkpoint(path)
        solver.load_state_dict({name: imported[name] for name in (
            "model", "history", "xp.cfg", "xp.sig")})
        state = solver.model.state_dict()
        for key, value in raw["model"].items():
            assert torch.equal(state[key], value), key
        assert solver.history == raw["history"]


def test_import_flashy_checkpoint_missing_file_raises(tmp_path):
    from flashy_tpu_torch.checkpoint import import_flashy_checkpoint
    with pytest.raises(FileNotFoundError):
        import_flashy_checkpoint(tmp_path / "nope.th")


def _populate(root, xp_module, cfg, argv, history, serve=None):
    xp = xp_module.create_xp(cfg, root=root, argv=argv)
    xp.link.update_history(history)
    if serve is not None:
        (xp.folder / "serve.json").write_text(json.dumps(serve))
    return xp


SERVE_STATUS = {"requests": 16, "completed": 15, "rejected": 1,
                "ttft_ms_p50": 12.5, "ttft_ms_p95": 40.25, "itl_ms_p50": 3.0,
                "itl_ms_p99": 9.5, "occupancy_p50": 0.75,
                "cache_layout": "paged", "kv_dtype": "int8",
                "pool_occupancy_p50": 0.5, "prefix_hit_rate": 0.25,
                "state_bytes_per_slot": 786432, "unknown_key": [1, 2]}


@pytest.mark.parametrize("verbose", [False, True])
def test_info_prints_what_the_jax_info_prints(tmp_path, capsys, verbose):
    from flashy_tpu import xp as jax_xp
    from flashy_tpu.info import main as jax_main
    from flashy_tpu_torch import xp as port_xp
    from flashy_tpu_torch.info import main
    history = [{"train": {"loss": 2.0, "grad_norm": 1.25, "ppl": 7.389,
                          "tokens_per_sec": 1000.0, "duration": 1.5},
                "valid": {"loss": 1.98765, "ppl": 7.3}},
               {"train": {"loss": 1.5, "ppl": 4.48}, "note": "text"}]
    flags = ["-v"] if verbose else []
    outputs = []
    for xp_module, entry, folder in ((jax_xp, jax_main, "jax"),
                                     (port_xp, main, "port")):
        root = tmp_path / folder
        _populate(root, xp_module, {"lr": 0.1, "model": {"dim": 8}},
                  ["lr=0.1"], history, serve=SERVE_STATUS)
        _populate(root, xp_module, {"lr": 0.2}, [], [])
        assert entry([str(root)] + flags) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1]
    assert "serve: requests=16" in outputs[1]


def test_info_formatters_match_the_jax_package():
    from flashy_tpu import info as jax_info
    from flashy_tpu_torch import info
    assert info.format_serve_status(SERVE_STATUS) == \
        jax_info.format_serve_status(SERVE_STATUS)
    slo = dict(SERVE_STATUS, acceptance_rate=0.6, accepted_per_step_p50=1.5,
               slo={"alerting": True, "budgets": {"ttft": {"alerting": True},
                                                  "itl": {}}})
    assert info.format_serve_status(slo) == jax_info.format_serve_status(slo)
    assert info.format_serve_status({}) == jax_info.format_serve_status({})
    for meta in ({"mode": "single"}, {"mode": "sharded", "state_sharding": {
            "summary": "zero1(data=8)"}}, {}):
        assert info.format_checkpoint_meta(meta) == \
            jax_info.format_checkpoint_meta(meta)
    report = {"single": [], "slots": {"slot0": [], "slot1": ["bad"]},
              "active": "slot0", "restorable": True}
    topology = {"device_count": 8, "mesh": {"axis_names": ["data", "fsdp"],
                                            "shape": [8, 1]},
                "state_sharding": "zero1(data=8)"}
    for kwargs in ({}, {"topology": topology, "live_devices": 4},
                   {"topology": topology, "live_devices": 8}):
        assert info.format_verify_report("sig", report, **kwargs) == \
            jax_info.format_verify_report("sig", report, **kwargs)
    empty = {"single": None, "slots": {}, "active": None, "restorable": False}
    assert info.format_verify_report("s", empty) == \
        jax_info.format_verify_report("s", empty)


def test_info_empty_root_and_verify_checkpoint(tmp_path, capsys):
    from flashy_tpu_torch import info
    from flashy_tpu_torch.checkpoint import save_state
    from flashy_tpu_torch.xp import create_xp
    assert info.main([str(tmp_path)]) == 1
    assert "no experiments" in capsys.readouterr().out
    assert info.main([str(tmp_path), "--verify-checkpoint"]) == 1
    capsys.readouterr()
    good = create_xp({"a": 1}, root=tmp_path)
    save_state({"step": torch.tensor(3)}, good.folder / "checkpoint.th")
    create_xp({"a": 2}, root=tmp_path)   # no checkpoint: fine
    assert info.main([str(tmp_path), "--verify-checkpoint"]) == 0
    out = capsys.readouterr().out
    assert f"{good.sig}  single=OK  -> restorable" in out
    assert "no checkpoints" in out
    bad = create_xp({"a": 3}, root=tmp_path)
    (bad.folder / "checkpoint.th").write_bytes(b"not a checkpoint")
    assert info.main([str(tmp_path), "--verify-checkpoint"]) == 1
    out = capsys.readouterr().out
    assert f"{bad.sig}  single=CORRUPT  -> NOT RESTORABLE" in out
    # a file that unpickles more than tensors is refused, not run
    hostile = create_xp({"a": 4}, root=tmp_path)
    with open(hostile.folder / "checkpoint.th", "wb") as f:
        pickle.dump({"fn": print}, f)
    report = info.verify_checkpoint(hostile.folder)
    assert not report["restorable"] and report["single"]


def test_info_parts_of_later_items_raise(tmp_path):
    from flashy_tpu_torch import info
    with pytest.raises(NotImplementedError, match="queue A item 12 "):
        info.main(["--faults"])
    # --slo is ported (tests/test_torch_tracing.py renders a report):
    # on a root without experiments it exits 1 as the listing does
    assert info.main([str(tmp_path), "--slo"]) == 1
    with pytest.raises(NotImplementedError, match="queue A item 12 "):
        info.fault_site_report()


def test_format_fleet_status_prints_the_references_line():
    # a reference ServingFleet.status() snapshot (a death, a shed, an
    # alerting engine) renders to the JAX `info` line, and so does an
    # empty one
    from flashy_tpu import info as ref_info
    from flashy_tpu_torch import info
    status = {
        "engines": {
            "engine0": {"role": "both", "healthy": False, "slots": 4,
                        "live": 0, "occupancy": 0.0, "queue_depth": 0,
                        "routed": 3, "pool_occupancy": 0.0,
                        "prefix_hit_rate": 0.0, "slo_alerting": [],
                        "slo_burn": {}},
            "engine1": {"role": "decode", "healthy": True, "slots": 4,
                        "live": 3, "occupancy": 0.75, "queue_depth": 1,
                        "routed": 9, "pool_occupancy": 0.4375,
                        "prefix_hit_rate": 0.3125,
                        "slo_alerting": ["itl_p95"],
                        "slo_burn": {"itl_p95": 3.5}}},
        "policy": "sticky",
        "tenants": {"batch": {"inflight": 2, "max_inflight": 2, "shed": 4},
                    "default": {"inflight": 1, "max_inflight": 8,
                                "shed": 0}},
        "route_reasons": {"slo_redirect": 2, "sticky": 10},
        "reroutes": 3, "deaths": ["engine0"]}
    line = info.format_fleet_status(status)
    assert line == ref_info.format_fleet_status(status)
    assert "deaths[engine0]" in line and "SLO-ALERT[itl_p95]" in line
    assert info.format_fleet_status({"policy": "round_robin"}) == \
        ref_info.format_fleet_status({"policy": "round_robin"})

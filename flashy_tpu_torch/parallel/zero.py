"""ZeRO-1/2 sharded weight update over the data axis: the port of
flashy_tpu/parallel/zero.py.

Between the two extremes of `wrap` (replicated DDP, every rank storing
and updating the full Adam moments; FSDP, the parameters themselves
sharded and gathered around every block), the profitable middle shards
only the *update*: reduce-scatter the gradients so each rank owns 1/N of
them, update only that shard of the optimizer state and parameters, and
all-gather the fresh parameters. Compute stays replicated, the
optimizer's memory drops by the data-axis size, and the wire bytes match
the plain all-reduce (a reduce-scatter plus an all-gather is a ring
all-reduce split around the update).

The JAX package declares the layout as shardings and lets XLA insert the
collectives. The port's ranks are processes, so `wrap(model,
state_sharding=zero_sharding(...))` runs them from hooks and
`zero_update` spells the step out: one reduce-scatter of the gradients,
the optimizer's step over the shards, one all-gather of the parameters.
A layout is a tree of the port's `NamedSharding`s (`sharding.py`), whose
specs equal the reference's for the same tree and mesh;
`describe_state_sharding` reads such a tree, or the tensors `wrap`
shards (each carrying its `.sharding`), as the reference reads its
arrays' shardings.

`python -m flashy_tpu_torch.parallel.zero --workers=2` runs the three
layouts (replicated, zero1, fsdp) over two processes in one start-up and
prints one JSON record (`run_zero_bench`).
"""
import typing as tp

import numpy as np
import torch

from .. import distrib
from .data_parallel import _Layout, _Leaf, axis_leaf_sharding, tree_map
from .mesh import Mesh, default_mesh
from .sharding import NamedSharding, P

# Top-level state keys treated as weight-update (optimizer) state by
# `zero_sharding`'s default and by `describe_state_sharding`'s grouping.
# 'master' covers the ZeRO-2-style fp32 master-params convention.
UPDATE_KEY_MARKERS = ("opt", "master")


def _is_update_key(key: str) -> bool:
    key = key.lower()
    return any(marker in key for marker in UPDATE_KEY_MARKERS)


def zero_sharding(state: tp.Any, mesh: tp.Optional[Mesh] = None, *,
                  axis: str = "data", min_size: int = 2 ** 12,
                  shard_keys: tp.Optional[tp.Sequence[str]] = None) -> tp.Any:
    """Per-leaf NamedShardings for a ZeRO-1/2 sharded weight update.

    When `state` is a mapping (`{'params': ..., 'opt_state': ...}`;
    `model_state(model)` gives a model's), entries whose key names
    optimizer state (contains 'opt' or 'master'; override with an
    explicit `shard_keys` list) get their large leaves sharded over
    `axis` (largest divisible dim, the rule of `fsdp_sharding`; leaves
    under `min_size` elements stay replicated), and every other entry,
    the compute params, stays replicated. A non-mapping `state` is
    treated wholly as optimizer state. Leaves are tensors or numpy
    arrays of the GLOBAL shapes.

    `wrap(model, state_sharding=zero_sharding(model_state(model), mesh))`
    then reduce-scatters the gradients into each rank's shard, lets the
    optimizer update the shard and all-gathers the fresh parameters.
    """
    mesh = mesh or default_mesh()
    shard_leaf = axis_leaf_sharding(mesh, axis, min_size)
    replicated = NamedSharding(mesh, P())
    if not isinstance(state, tp.Mapping):
        return tree_map(shard_leaf, state)
    keys = set(shard_keys) if shard_keys is not None else None

    def for_entry(key: str, entry: tp.Any) -> tp.Any:
        sharded = key in keys if keys is not None else _is_update_key(key)
        rule = shard_leaf if sharded else (lambda _: replicated)
        return tree_map(rule, entry)

    return type(state)({key: for_entry(key, entry)
                        for key, entry in state.items()})


def model_state(model: torch.nn.Module) -> tp.Dict[str, tp.Any]:
    """A model's training state as `zero_sharding` reads it: its
    parameters by name under 'params', and under 'opt_state' the same
    names, for the moments an optimizer keeps (each shaped as its
    parameter)."""
    params = dict(model.named_parameters())
    return {"params": params, "opt_state": dict(params)}


def zero_update(grad_fn: tp.Callable, optimizer: tp.Callable, *,
                mesh: tp.Optional[Mesh] = None, axis: str = "data",
                min_size: int = 2 ** 12) -> tp.Callable:
    """Explicit ZeRO-1 split step: reduce-scatter the gradients, update
    the local shard, all-gather the parameters.

    `grad_fn(model, batch, *rest, **kwargs) -> loss` runs a rank's
    forward and backward, leaving its local gradients in the replicated
    model's `.grad` (the `with_grad_accumulation` convention, so
    microbatch accumulation composes in front: the reduce-scatter then
    runs once a step on the accumulated gradient). `optimizer(params)`
    builds a torch optimizer over the update tensors (e.g.
    `functools.partial(torch.optim.AdamW, lr=1e-3)`): this process's
    shard of each parameter whose update `axis_leaf_sharding(mesh, axis,
    min_size)` shards, the parameter itself where it stays replicated.

    Returns `step(model, batch, *rest, **kwargs) -> {'loss': loss}`. The
    first call builds the shards and the optimizer (`step.optimizer`,
    `step.updates`, `step.shardings` by parameter name); each call then
    runs `grad_fn`, one reduce-scatter (and one all-reduce of the
    replicated leaves' gradients), the optimizer's step over the shards
    and one all-gather of the fresh parameters into `model`.
    """
    mesh = mesh or default_mesh()
    rule = axis_leaf_sharding(mesh, axis, min_size)

    def setup(model: torch.nn.Module) -> None:
        named = list(model.named_parameters())
        shardings = {name: rule(param) for name, param in named}
        leaves = []
        for name, param in named:
            owner_path, _, attr = name.rpartition(".")
            owner = model.get_submodule(owner_path) if owner_path else model
            leaves.append(_Leaf(owner, attr, name, shardings[name],
                                param.shape))
        updates = []
        with torch.no_grad():
            for leaf, (_, param) in zip(leaves, named):
                if leaf.dim is None:
                    updates.append(param)
                    continue
                local = torch.nn.Parameter(
                    leaf.sharding.shard(param.detach()).clone())
                local.sharding = leaf.sharding
                updates.append(local)
        step.model = model
        step.params = [param for _, param in named]
        step.layout = _Layout(mesh, leaves)
        step.updates = updates
        step.shardings = shardings
        step.optimizer = optimizer(updates)

    def step(model: torch.nn.Module, batch: tp.Any, *rest: tp.Any,
             **kwargs: tp.Any) -> tp.Dict[str, torch.Tensor]:
        if getattr(step, "model", None) is not model:
            setup(model)
        for tensor in step.params + step.updates:
            tensor.grad = None
        loss = grad_fn(model, batch, *rest, **kwargs)
        reduced = step.layout.reduce([p.grad for p in step.params])
        for update, grad in zip(step.updates, reduced):
            update.grad = grad
        step.optimizer.step()
        fulls = step.layout.gather(step.updates)
        with torch.no_grad():
            for leaf, param, full in zip(step.layout.leaves, step.params,
                                         fulls):
                if leaf.dim is not None:
                    param.copy_(full)
        return {"loss": loss}

    return step


def _paths(tree: tp.Any, path: tp.Tuple[tp.Any, ...] = ()
           ) -> tp.Iterator[tp.Tuple[tp.Tuple[tp.Any, ...], tp.Any]]:
    """(path of keys, leaf) of dicts, lists and tuples (a spec and a
    namedtuple are leaves), dict keys sorted as `jax.tree_util` sorts
    them (in their own order where they do not sort)."""
    if isinstance(tree, tp.Mapping):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        for key in keys:
            yield from _paths(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for index, value in enumerate(tree):
            yield from _paths(value, path + (index,))
    else:
        yield path, tree


def keystr(path: tp.Sequence[tp.Any]) -> str:
    """`jax.tree_util.keystr` of a path of dict keys and sequence
    indices: `['opt_state']['mu'][0]`."""
    return "".join(f"[{key!r}]" for key in path)


def audit_expectations(state_spec: tp.Any, *,
                       params_bytes: tp.Optional[int] = None
                       ) -> tp.Dict[str, tp.Any]:
    """The FT101 audit contract of a step under this module's shardings,
    derived mechanically from the declared spec (`zero_sharding`'s
    tree): the leaves it shards must stay sharded, those it replicates
    replicated, the gradient reduction must run (a reduce-scatter, or an
    all-reduce where the backend spells it so) and the fresh params must
    be re-gathered; with `params_bytes`, an all-gather moving more than
    1.5x the params is flagged (the optimizer state being gathered). Its
    consumer, the trace audit, waits for ROADMAP.md queue A item 12."""
    sharded: tp.List[str] = []
    replicated: tp.List[str] = []
    for path, sharding in _paths(state_spec):
        spec = getattr(sharding, "spec", ())
        is_sharded = any(part is not None for part in spec)
        (sharded if is_sharded else replicated).append(keystr(path))
    out: tp.Dict[str, tp.Any] = {
        "expect_sharded": tuple(sharded),
        "expect_replicated": tuple(replicated),
        "require_collectives": (("reduce-scatter", "all-reduce"),
                                "all-gather"),
    }
    if params_bytes:
        out["forbid_collectives"] = {"all-gather": int(params_bytes * 1.5)}
    return out


def per_device_bytes(tree: tp.Any) -> int:
    """Bytes this process holds for `tree`: each tensor or numpy leaf's
    own bytes (a rank's shard counts its local size, which is what the
    reference's `shard_shape` gives for a sharded array); other leaves
    count nothing. The memory-side evidence for ZeRO and FSDP: a state
    sharded N ways reports ~1/N of its replicated footprint."""
    total = 0
    for _, leaf in _paths(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, (np.ndarray, np.generic)):
            total += leaf.nbytes
    return total


def _sharding_of(leaf: tp.Any) -> tp.Optional[NamedSharding]:
    return leaf if isinstance(leaf, NamedSharding) \
        else getattr(leaf, "sharding", None)


def _leaf_axes(leaf: tp.Any) -> tp.Tuple[tp.Set[str], tp.Dict[str, int]]:
    """Mesh axes a leaf's sharding spreads it over (+ their sizes)."""
    sharding = _sharding_of(leaf)
    spec = getattr(sharding, "spec", None)
    if spec is None:
        return set(), {}
    axes = set(P(*spec).axes())
    mesh = getattr(sharding, "mesh", None)
    sizes = {name: int(mesh.shape[name]) for name in axes} \
        if mesh is not None else {}
    return axes, sizes


def describe_state_sharding(state: tp.Any) -> tp.Dict[str, tp.Any]:
    """Classify a state tree's layout for logs and checkpoints.

    `state`'s leaves are the port's NamedShardings (a declared layout)
    or tensors carrying one as `.sharding` (what `wrap` shards); other
    leaves are replicated. Returns `{'mode', 'param_axes',
    'update_axes', 'axis_sizes', 'summary'}`, mode one of 'replicated',
    'zero1' (params replicated, optimizer or master state sharded),
    'fsdp' (the parameters themselves sharded over a non-model axis),
    'tensor', 'tensor+zero1' and 'tensor+fsdp', as the reference
    classifies them. Axes of mesh size 1 are ignored (a spec naming a
    size-1 axis IS replication), except on a 1-device mesh, where the
    declared spelling is all there is and classifies. A leaf is update
    state when any key on its path names it (`UPDATE_KEY_MARKERS`).
    `BaseSolver.commit` writes this into `checkpoint_meta.json`, which
    `python -m flashy_tpu_torch.info` shows.
    """
    param_axes: tp.Set[str] = set()
    update_axes: tp.Set[str] = set()
    axis_sizes: tp.Dict[str, int] = {}
    for path, leaf in _paths(state):
        axes, sizes = _leaf_axes(leaf)
        mesh = getattr(_sharding_of(leaf), "mesh", None)
        if mesh is None or mesh.size > 1:
            axes = {name for name in axes if sizes.get(name, 2) != 1}
        if not axes:
            continue
        axis_sizes.update({name: size for name, size in sizes.items()
                           if name in axes})
        is_update = any(_is_update_key(str(key)) for key in path)
        (update_axes if is_update else param_axes).update(axes)
    if "tensor" in (param_axes | update_axes):
        if param_axes - {"tensor", "pipe", "expert", "seq"}:
            mode = "tensor+fsdp"
        elif update_axes - param_axes - {"tensor", "pipe", "expert", "seq"}:
            mode = "tensor+zero1"
        else:
            mode = "tensor"
        axes = param_axes | update_axes
    elif param_axes:
        mode = "fsdp"
        axes = param_axes | update_axes
    elif update_axes:
        mode = "zero1"
        axes = update_axes
    else:
        return {"mode": "replicated", "param_axes": [], "update_axes": [],
                "axis_sizes": {}, "summary": "replicated"}
    detail = ",".join(f"{name}={axis_sizes[name]}" if name in axis_sizes
                      else name for name in sorted(axes))
    return {"mode": mode, "param_axes": sorted(param_axes),
            "update_axes": sorted(update_axes), "axis_sizes": axis_sizes,
            "summary": f"{mode}({detail})"}


# ---------------------------------------------------------------------------
# Measurement harness: `python -m flashy_tpu_torch.parallel.zero` runs this
# over the processes: step time, per-rank optimizer bytes, peak memory and
# the collectives a step for replicated vs ZeRO-1 vs FSDP on one LM.
# ---------------------------------------------------------------------------
def _per_rank(value: float) -> tp.List[float]:
    """Every process's `value`, by rank (one all-reduce)."""
    vector = np.zeros(distrib.world_size(), np.float64)
    vector[distrib.rank()] = value
    return [float(v) for v in np.asarray(distrib.all_reduce(vector))]


def run_zero_bench(steps: int = 3, *, dim: int = 128, num_layers: int = 2,
                   num_heads: int = 4, vocab_size: int = 512,
                   batch: tp.Optional[int] = None, seq: int = 64,
                   min_size: int = 2 ** 10, attention: str = "dense",
                   dtype: tp.Any = None, device: tp.Any = None
                   ) -> tp.Dict[str, tp.Any]:
    """Measure the three weight-update layouts on one LM over the
    processes (`distrib.init()` first; one process runs them too).

    Every layout starts from the same seed-0 weights and takes `steps`
    timed steps after one untimed step, each process on its rows of the
    global batch (AdamW, lr 1e-3, weight decay 1e-4: optax.adamw's
    defaults). Returns a record with, by mode
    (`replicated`/`zero1`/`fsdp`): `step_ms` (the p50 of the timed
    steps), `step_ms_all`, `opt_state_bytes_per_chip` (rank 0's
    `per_device_bytes` of its optimizer state) and `..._by_rank`,
    `peak_bytes_by_rank` (`torch.cuda.max_memory_allocated` over the
    layout's run, CUDA only), `collectives` (`collective_stats` of one
    timed step), `sharding` (`describe_state_sharding`); and
    `opt_bytes_ratio_zero1`, `max_param_delta` (ZeRO-1 against
    replicated parameters after the same steps), `params_bytes`,
    `collective_ms` (an all-reduce, a reduce-scatter and an all-gather of
    the params' f32 bytes alone, the second of two runs) and
    `recompiles` (0: the port keeps no compile cache).
    """
    import gc
    import time

    from ..models.transformer import TransformerConfig, TransformerLM
    from ..utils import resolve_device
    from .accounting import collective_stats, count_collectives
    from .data_parallel import wrap
    from .mesh import make_mesh

    device = resolve_device(device)
    world, rank = distrib.world_size(), distrib.rank()
    if batch is None:
        batch = max(8, 2 * world)
    if batch % world:
        batch += world - batch % world
    config = dict(vocab_size=vocab_size, dim=dim, num_layers=num_layers,
                  num_heads=num_heads, attention=attention)
    if dtype is not None:
        config["dtype"] = dtype
    cfg = TransformerConfig(**config)
    rng = np.random.default_rng(0)
    tokens_host = rng.integers(0, vocab_size, (batch, seq))
    rows = batch // world
    tokens = torch.from_numpy(tokens_host[rank * rows:(rank + 1) * rows]
                              ).long().to(device)
    mesh_data = make_mesh({"data": world})
    mesh_fsdp = make_mesh({"data": 1, "fsdp": world})
    cuda = device.type == "cuda"

    def loss_fn(model: tp.Callable) -> torch.Tensor:
        logits = model(tokens)
        return torch.nn.functional.cross_entropy(
            logits[:, :-1].flatten(0, 1).float(), tokens[:, 1:].flatten())

    def build(mode: str) -> tp.Tuple[tp.Any, tp.Any, torch.nn.Module]:
        model = TransformerLM(cfg, device=device, seed=0)
        if mode == "replicated":
            wrapped = wrap(model, mesh=mesh_data)
        elif mode == "zero1":
            wrapped = wrap(model, mesh=mesh_data, state_sharding=zero_sharding(
                model_state(model), mesh_data, min_size=min_size))
        else:
            wrapped = wrap(model, mesh=mesh_fsdp, fsdp=True)
        optimizer = torch.optim.AdamW(wrapped.parameters(), lr=1e-3,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
        return wrapped, optimizer, model

    def step(wrapped: tp.Any, optimizer: tp.Any) -> None:
        optimizer.zero_grad(set_to_none=True)
        loss_fn(wrapped).backward()
        optimizer.step()

    result: tp.Dict[str, tp.Any] = {
        "n_devices": world, "batch": batch, "seq": seq,
        "dim": dim, "num_layers": num_layers, "dtype": str(cfg.dtype),
        "opt_state_bytes_per_chip": {}, "opt_state_bytes_by_rank": {},
        "peak_bytes_by_rank": {}, "step_ms": {}, "step_ms_all": {},
        "collectives": {}, "sharding": {}}
    final: tp.Dict[str, tp.Dict[str, torch.Tensor]] = {}
    for mode in ("replicated", "zero1", "fsdp"):
        # the previous layout's model, wrapper and optimizer (DDP and the
        # sharded forms hold reference cycles) must not count in this
        # layout's peak
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        wrapped, optimizer, model = build(mode)
        step(wrapped, optimizer)
        times = []
        for index in range(steps):
            distrib.barrier()
            if cuda:
                torch.cuda.synchronize(device)
            begin = time.perf_counter()
            with count_collectives() as record:
                step(wrapped, optimizer)
                if cuda:
                    torch.cuda.synchronize(device)
            times.append((time.perf_counter() - begin) * 1e3)
            if index == 0:
                result["collectives"][mode] = {
                    op: entry for op, entry in collective_stats(record).items()
                    if entry["count"]}
        opt_bytes = per_device_bytes(optimizer.state_dict()["state"])
        result["step_ms_all"][mode] = times
        result["step_ms"][mode] = float(np.percentile(times, 50))
        result["opt_state_bytes_by_rank"][mode] = _per_rank(opt_bytes)
        result["opt_state_bytes_per_chip"][mode] = int(
            result["opt_state_bytes_by_rank"][mode][0])
        if cuda:
            result["peak_bytes_by_rank"][mode] = _per_rank(
                torch.cuda.max_memory_allocated(device))
        state = {"params": dict(model.named_parameters()),
                 "opt_state": dict(wrapped.named_parameters())}
        result["sharding"][mode] = describe_state_sharding(state)["summary"]
        if mode == "replicated":
            result["params_bytes"] = sum(p.numel() * p.element_size()
                                         for p in model.parameters())
        if mode != "fsdp":
            final[mode] = {name: p.detach().float().cpu()
                           for name, p in model.named_parameters()}
        del wrapped, optimizer, model
    # each collective alone at the params' size, f32 (what a step moves
    # through it), twice; its ms the second
    flat = torch.ones(result["params_bytes"] // 4 // world * world,
                      device=device)
    half = torch.ones(flat.numel() // world, device=device)
    result["collective_ms"] = {}
    for op, run in (("all-reduce", lambda: distrib.all_reduce(flat)),
                    ("reduce-scatter", lambda: distrib.reduce_scatter(flat)),
                    ("all-gather", lambda: distrib.all_gather(half))):
        for _ in range(2):
            distrib.barrier()
            if cuda:
                torch.cuda.synchronize(device)
            begin = time.perf_counter()
            run()
            if cuda:
                torch.cuda.synchronize(device)
        result["collective_ms"][op] = (time.perf_counter() - begin) * 1e3
    del flat, half
    result["max_param_delta"] = max(
        float((final["zero1"][name] - value).abs().max())
        for name, value in final["replicated"].items())
    opt = result["opt_state_bytes_per_chip"]
    result["opt_bytes_ratio_zero1"] = round(opt["zero1"] / opt["replicated"],
                                            4)
    result["recompiles"] = 0
    return result


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    """`python -m flashy_tpu_torch.parallel.zero [--workers N] [--steps N]
    ...`: run the three-layout measurement (over N processes with
    `--workers`, two gloo ranks on the host with `--device cpu`) and
    print rank 0's JSON record (and write it to `--json`); exit 1 when
    ZeRO-1 drifts numerically from the replicated path, any recompile
    was reported, or ZeRO-1's optimizer bytes a rank show no shard."""
    import argparse
    import json
    import os
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.parallel.zero",
        description="ZeRO-1 vs replicated vs FSDP weight-update bench.")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--vocab", type=int, default=512)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--attention", default="dense")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default=None, help="the model's compute dtype "
                        "(default: the TransformerConfig's)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--workers", type=int, default=1,
                        help="processes to run the layouts over")
    parser.add_argument("--json", default=None,
                        help="also write rank 0's record to this file")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if args.workers > 1 and "FLASHY_TPU_PROCESS_ID" not in os.environ:
        import subprocess
        from ..xp import _spawn_workers
        try:
            _spawn_workers(args.workers, argv)
        except subprocess.CalledProcessError as exc:
            print(f"zero bench FAILED: {exc}", file=sys.stderr)
            return 1
        return 0
    distrib.init(backend="gloo" if args.device == "cpu" else None)
    result = run_zero_bench(
        steps=args.steps, seq=args.seq, dim=args.dim, num_layers=args.layers,
        num_heads=args.heads, vocab_size=args.vocab, batch=args.batch,
        attention=args.attention, device=args.device,
        dtype=getattr(torch, args.dtype) if args.dtype else None)
    problems = []
    if result["recompiles"]:
        problems.append(f"{result['recompiles']} post-warm-up recompiles")
    if result["max_param_delta"] > 1e-4:
        problems.append(f"ZeRO-1 params drifted from replicated by "
                        f"{result['max_param_delta']:.2e}")
    n = result["n_devices"]
    if n >= 2 and result["opt_bytes_ratio_zero1"] > (1.5 / n + 0.25):
        problems.append(
            f"ZeRO-1 opt-state per chip is {result['opt_bytes_ratio_zero1']}"
            f"x replicated on a {n}-way mesh — the shard did not happen")
    if distrib.is_rank_zero():
        print(json.dumps(result), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(result, f)
        for problem in problems:
            print(f"zero bench FAILED: {problem}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())

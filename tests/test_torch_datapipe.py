# The port's streaming data pipeline (flashy_tpu_torch.datapipe) held
# against the JAX package's on the same shards, written from a numpy
# seed: every stage's items and state_dicts equal to the reference's
# (exact: host-side integers), the mixture's source at every draw, the
# re-split states n -> m -> n, and the cursor's round trip through the
# port's commit() / restore() in every commit mode. The drill on the
# CPU consumes the reference drill's token stream from the same weights
# (params_from_jax); its losses agree at 1e-5 relative, the loss
# tolerance of test_torch_train.py (f32 reduction order, 18 SGD steps).
import json

import numpy as np
import pytest

import flashy_tpu.datapipe as ref
import flashy_tpu_torch.datapipe as port


class ListStream:
    """Minimal in-memory CheckpointableIterator over a doc list."""

    def __init__(self, docs, loop=False):
        self.docs = [np.asarray(d, dtype=np.int32) for d in docs]
        self.loop = loop
        self.i = 0
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= len(self.docs):
            if not self.loop:
                raise StopIteration
            self.i = 0
        doc = self.docs[self.i]
        self.i += 1
        return doc

    def state_dict(self):
        return {"i": self.i}

    def load_state_dict(self, state):
        self.i = state["i"]

    def close(self):
        self.closed = True


def _corpus(root, seed=0, n_jsonl=3, n_npy=2, vocab=1000):
    """Mixed shards from a numpy seed: jsonl token and text records, and
    right-padded .npy shards; document lengths 1..150."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    jsonl, npy = [], []
    for shard in range(n_jsonl):
        path = root / f"a{shard:02d}.jsonl"
        with open(path, "w") as f:
            for doc in range(int(rng.integers(4, 12))):
                if doc % 4 == 3:
                    f.write(json.dumps({"text": "tok %d " % doc * (doc + 1)})
                            + "\n")
                else:
                    n = int(rng.integers(1, 150))
                    f.write(json.dumps({"tokens": [
                        int(t) for t in rng.integers(0, vocab, n)]}) + "\n")
        jsonl.append(path)
    for shard in range(n_npy):
        path = root / f"b{shard:02d}.npy"
        docs = np.full((int(rng.integers(3, 9)), 150), -1, np.int64)
        for row in docs:
            n = int(rng.integers(1, 150))
            row[:n] = rng.integers(0, vocab, n)
        np.save(path, docs)
        npy.append(path)
    return jsonl, npy


def _equal_items(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _equal_items(a[key], b[key])
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _pipes(mod, jsonl, npy, *, loop=True, weights=(0.7, 0.3), seed=0,
           batch=3, max_len=32, stages=3):
    streams = [mod.ShardedTextStream(jsonl, loop=loop),
               mod.ShardedTextStream(npy, loop=loop)]
    pipe = mod.MixtureStream(streams, list(weights), seed=seed)
    if stages >= 2:
        pipe = mod.SequencePacker(pipe, batch, max_len)
    if stages >= 3:
        pipe = mod.prefetch(pipe, size=2)
    return pipe


@pytest.mark.parametrize("shard_index,num_shards,loop",
                         [(0, 1, False), (0, 1, True), (1, 2, True),
                          (2, 3, False)])
def test_stream_docs_and_state_equal_reference(tmp_path, shard_index,
                                               num_shards, loop):
    jsonl, npy = _corpus(tmp_path)
    files = jsonl + npy
    kw = dict(shard_index=shard_index, num_shards=num_shards, loop=loop)
    got = port.ShardedTextStream(files, **kw)
    want = ref.ShardedTextStream(files, **kw)
    for _ in range(80):
        try:
            doc = next(want)
        except StopIteration:
            with pytest.raises(StopIteration):
                next(got)
            break
        _equal_items(next(got), doc)
        assert got.state_dict() == want.state_dict()
    # a directory expands to the same sorted shard list
    assert port.ShardedTextStream(tmp_path).state_dict() == \
        ref.ShardedTextStream(tmp_path).state_dict()


def test_stream_resume_and_layout_checks(tmp_path):
    jsonl, npy = _corpus(tmp_path, seed=1)
    stream = port.ShardedTextStream(jsonl, loop=True)
    for _ in range(17):
        next(stream)
    state = json.loads(json.dumps(stream.state_dict()))
    resumed = port.ShardedTextStream(jsonl, loop=True)
    resumed.load_state_dict(state)
    for _ in range(20):
        _equal_items(next(resumed), next(stream))
    with pytest.raises(ValueError, match="empty shard list"):
        port.ShardedTextStream([])
    with pytest.raises(ValueError, match="shard_index"):
        port.ShardedTextStream(jsonl, shard_index=2, num_shards=2)
    renamed = tmp_path / "z.jsonl"
    jsonl[1].rename(renamed)
    with pytest.raises(ValueError, match="different shard files"):
        port.ShardedTextStream([jsonl[0], renamed, jsonl[2]]
                               ).load_state_dict(state)


@pytest.mark.parametrize("seed,weights", [(0, (0.7, 0.3)),
                                          (7, (0.5, 0.3, 0.2)),
                                          (123, (1.0, 0.0, 3.0, 2.0))])
def test_mixture_picks_the_reference_source_at_every_draw(seed, weights):
    empty = [iter(()) for _ in weights]
    got = port.MixtureStream(empty, list(weights), seed=seed)
    want = ref.MixtureStream(empty, list(weights), seed=seed)
    picks = [got._pick(k) for k in range(300)]
    assert picks == [want._pick(k) for k in range(300)]
    assert len(set(picks)) == sum(w > 0 for w in weights)


def test_mixture_docs_and_state_equal_reference(tmp_path):
    # non-looping streams: sources retire at the same draws
    jsonl, npy = _corpus(tmp_path, seed=2)
    got = _pipes(port, jsonl, npy, loop=False, stages=1)
    want = _pipes(ref, jsonl, npy, loop=False, stages=1)
    got_docs = list(got)
    want_docs = list(want)
    assert len(got_docs) == len(want_docs) > 10
    for a, b in zip(got_docs, want_docs):
        _equal_items(a, b)
    assert got.state_dict() == want.state_dict()
    assert got.state_dict()["alive"] == [False, False]
    with pytest.raises(ValueError, match="changed mixture"):
        _pipes(port, jsonl, npy, seed=1, stages=1).load_state_dict(
            want.state_dict())


@pytest.mark.parametrize("batch,max_len", [(3, 32), (2, 100), (4, 7)])
def test_packer_batches_and_state_equal_reference(tmp_path, batch, max_len):
    jsonl, npy = _corpus(tmp_path, seed=3)
    got = _pipes(port, jsonl, npy, stages=2, batch=batch, max_len=max_len)
    want = _pipes(ref, jsonl, npy, stages=2, batch=batch, max_len=max_len)
    for _ in range(12):
        out = next(got)
        _equal_items(out, next(want))
        assert out["tokens"].shape == (batch, max_len)
        assert out["tokens"].dtype == np.int32
        assert got.state_dict() == want.state_dict()
    # segments are 1-based per row, 0 only on padding, positions restart
    segs, pos = out["segment_ids"], out["positions"]
    assert (pos[segs == 0] == 0).all() and (segs[:, 0] > 0).all()


def test_packer_resume_mid_buffer(tmp_path):
    jsonl, npy = _corpus(tmp_path, seed=4)
    pipe = _pipes(port, jsonl, npy, stages=2, batch=2, max_len=64)
    want = _pipes(ref, jsonl, npy, stages=2, batch=2, max_len=64)
    for _ in range(5):
        next(pipe)
        next(want)
    state = pipe.state_dict()
    assert any(state["row"]) or state["ready"]   # a partial buffer
    resumed = _pipes(port, jsonl, npy, stages=2, batch=2, max_len=64)
    resumed.load_state_dict(json.loads(json.dumps(state)))
    for _ in range(6):
        item = next(resumed)
        _equal_items(item, next(pipe))
        _equal_items(item, next(want))
    with pytest.raises(ValueError, match=">= 1"):
        port.SequencePacker(ListStream([]), 0, 8)


def test_packer_drop_last_and_splits_long_docs():
    docs = [list(range(1, 30)), [5, 6], list(range(40, 43))]
    for mod in (port, ref):
        assert len(list(mod.SequencePacker(ListStream(docs), 2, 8))) == 2
    got = list(port.SequencePacker(ListStream(docs), 2, 8, drop_last=False))
    want = list(ref.SequencePacker(ListStream(docs), 2, 8, drop_last=False))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal_items(a, b)


def test_prefetch_batches_and_state_equal_reference(tmp_path):
    jsonl, npy = _corpus(tmp_path, seed=5)
    got = _pipes(port, jsonl, npy)
    want = _pipes(ref, jsonl, npy)
    try:
        for _ in range(10):
            _equal_items(next(got), next(want))
            assert got.state_dict() == want.state_dict()
        stats = got.stats()
        assert stats["batches"] == 10.0 and stats["tokens"] == 10 * 3 * 32
        # the state is the consumed cursor, not the read-ahead
        resumed = _pipes(port, jsonl, npy)
        resumed.load_state_dict(got.state_dict())
        for _ in range(4):
            _equal_items(next(resumed), next(want))
        resumed.close()
    finally:
        got.close()
        want.close()


def test_prefetch_close_rewinds_readahead_and_closes_source():
    docs = [[i, i] for i in range(100)]
    source = ListStream(docs)
    pipe = port.prefetch(port.SequencePacker(source, 1, 2), size=3)
    consumed = [int(next(pipe)["tokens"][0, 0]) for _ in range(2)]
    pipe.close()
    assert source.closed and pipe._thread is None
    consumed += [int(next(pipe)["tokens"][0, 0]) for _ in range(3)]
    pipe.close()
    assert consumed == [0, 1, 2, 3, 4]   # no silent gap at the close
    with pytest.raises(ValueError, match="prefetch size"):
        port.prefetch(ListStream([]), size=0)


def test_prefetch_propagates_exhaustion_and_errors():
    pipe = port.prefetch(port.SequencePacker(ListStream([[1, 2, 3]] * 4),
                                             2, 4))
    assert len(list(pipe)) == 2
    with pytest.raises(StopIteration):
        next(pipe)
    pipe.close()

    class Broken(ListStream):
        def __next__(self):
            raise RuntimeError("boom")

    bad = port.prefetch(Broken([[1]]))
    with pytest.raises(RuntimeError, match="boom"):
        next(bad)
    with pytest.raises(StopIteration):
        next(bad)
    bad.close()
    stream = ListStream([[1]])
    assert isinstance(stream, port.CheckpointableIterator)
    assert isinstance(port.SequencePacker(stream, 1, 2),
                      port.CheckpointableIterator)


# ---------------------------------------------------------------------------
# elastic re-split
# ---------------------------------------------------------------------------
def _uniform_corpus(root, n_files=8, docs_per_file=12):
    files = []
    for f in range(n_files):
        path = root / f"uni{f:02d}.jsonl"
        with open(path, "w") as fh:
            for d in range(docs_per_file):
                fh.write(json.dumps({"tokens": [f, d, f * 100 + d, 7]})
                         + "\n")
        files.append(path)
    return files


def _canon(docs):
    return sorted((tuple(int(x) for x in d) for d in docs),
                  key=lambda t: (t[1], t[0]))


def _group(mod, files, world):
    return mod.ElasticCursorGroup([
        mod.ShardedTextStream(files, shard_index=r, num_shards=world)
        for r in range(world)])


def _consume(group, steps):
    out = []
    for _ in range(steps):
        out.extend(next(group))
    return out


@pytest.mark.parametrize("n,m", [(1, 2), (2, 4), (4, 2), (8, 1), (2, 8)])
def test_resplit_n_to_m_to_n_equals_reference(tmp_path, n, m):
    K = 8
    files = _uniform_corpus(tmp_path, n_files=K)
    oracle = [next(s) for s in [port.ShardedTextStream(files)]
              for _ in range(7 * K)]
    g1 = _group(port, files, n)
    phase1 = _consume(g1, 2 * K // n)
    state1 = g1.state_dict()
    assert port.resplit_states(state1["per_rank"], m) == \
        ref.resplit_states(state1["per_rank"], m)
    g2 = _group(port, files, m)
    g2.load_state_dict(state1)
    phase2 = _consume(g2, 3 * K // m)
    state2 = g2.state_dict()
    assert port.resplit_states(state2["per_rank"], n) == \
        ref.resplit_states(state2["per_rank"], n)
    g3 = _group(port, files, n)
    g3.load_state_dict(state2)
    phase3 = _consume(g3, 2 * K // n)
    assert _canon(phase1) + _canon(phase2) + _canon(phase3) == (
        _canon(oracle[:2 * K]) + _canon(oracle[2 * K:5 * K])
        + _canon(oracle[5 * K:7 * K]))


def test_resplit_mixture_packer_prefetch_equal_reference(tmp_path):
    files = _uniform_corpus(tmp_path, n_files=4, docs_per_file=20)

    def mixtures(mod, world):
        return [mod.MixtureStream(
            [mod.ShardedTextStream(files[:2], shard_index=r % 2,
                                   num_shards=min(world, 2)),
             mod.ShardedTextStream(files, shard_index=r, num_shards=world)],
            [0.5, 0.5], seed=3) for r in range(world)]

    old = mixtures(port, 2)
    for _ in range(5):
        for mix in old:
            next(mix)
    states = [mix.state_dict() for mix in old]
    # the first source is one file set per rank: build it per world
    states_b = [{"draws": s["draws"], "alive": s["alive"], "seed": 3,
                 "weights": s["weights"], "sources": [s["sources"][1]]}
                for s in states]
    assert port.resplit_mixture_states(states_b, 4) == \
        ref.resplit_mixture_states(states_b, 4)
    stream_states = [s["sources"][1] for s in states]
    packer = [{"source": st, "ready": [], "row": ([], [], []), "seg": 0,
               "exhausted": False} for st in stream_states]
    prefetched = [{"source": st} for st in packer]
    assert port.resplit_states(prefetched, 4) == \
        ref.resplit_states(prefetched, 4)
    blocked = [dict(packer[0], row=([1], [1], [0])), packer[1]]
    for mod in (port, ref):
        with pytest.raises(ValueError, match="partially packed"):
            mod.resplit_packer_states(blocked, 4)
    draws = [dict(states_b[0], draws=states_b[0]["draws"] + 1), states_b[1]]
    with pytest.raises(ValueError, match="draw counter"):
        port.resplit_mixture_states(draws, 4)
    with pytest.raises(ValueError, match="unrecognized"):
        port.resplit_states([{"x": 1}], 2)


def test_elastic_group_retries_the_resplit_fault(tmp_path):
    from flashy_tpu_torch.resilience import chaos
    files = _uniform_corpus(tmp_path, n_files=4)
    g1 = _group(port, files, 4)
    first = _consume(g1, 1)
    state = g1.state_dict()
    injector = chaos.install(strict=True)
    injector.fail_at("datapipe.resplit", call=1)
    try:
        g2 = _group(port, files, 2)
        g2.load_state_dict(state)
        assert injector.hits("datapipe.resplit", kind="fail") == 1
        second = _consume(g2, 2)
    finally:
        chaos.uninstall()
    assert _canon(first + second) == _canon(
        [next(s) for s in [port.ShardedTextStream(files)] for _ in range(8)])
    # a single stream re-split from a world-1 cursor, through the same
    # retried, fault-pointed path
    whole = port.ShardedTextStream(files)
    for _ in range(4):
        next(whole)
    half = port.ShardedTextStream(files, shard_index=1, num_shards=2)
    half.load_state_dict(whole.state_dict())
    assert [int(next(half)[0]) for _ in range(2)] == [1, 3]


# ---------------------------------------------------------------------------
# the solver: the cursor through commit() / restore(), the preemption exit
# ---------------------------------------------------------------------------
def _stream_solver(mode, jsonl, npy, log, steps=3):
    from flashy_tpu_torch.solver import BaseSolver

    class StreamSolver(BaseSolver):
        checkpoint_mode = "single" if mode == "single" else "sharded"
        checkpoint_async = mode == "async"

        def __init__(self):
            super().__init__()
            self.pipe = _pipes(port, jsonl, npy, batch=2, max_len=16)
            self.register_stateful("pipe")

        def train_stage(self):
            for _ in range(steps):
                log.append(next(self.pipe)["tokens"])
            return {}

    return StreamSolver


@pytest.mark.parametrize("mode", ["single", "sharded", "async"])
def test_cursor_round_trip_through_commit_restore(tmp_path, mode):
    from flashy_tpu_torch.xp import Config, create_xp
    jsonl, npy = _corpus(tmp_path / "corpus", seed=6)
    first: list = []
    cfg = Config({"t": f"datapipe-{mode}"})
    with create_xp(cfg, root=tmp_path).enter():
        solver = _stream_solver(mode, jsonl, npy, first)()
        solver.run_stage("train", solver.train_stage)
        solver.commit()
        # consumed past the commit (while an async save is in flight):
        # the slot must hold the cursor as it was at commit()
        solver.run_stage("train", solver.train_stage)
        solver.finalize_checkpoints()
        solver.pipe.close()
        if mode != "single":
            assert not solver.checkpoint_path.exists()
            assert solver.sharded_checkpoint_path.exists()
    second: list = []
    with create_xp(cfg, root=tmp_path).enter():
        resumed = _stream_solver(mode, jsonl, npy, second)()
        assert resumed.restore() and resumed.epoch == 2
        resumed.run_stage("train", resumed.train_stage)
        resumed.pipe.close()
    assert len(second) == 3
    for want, got in zip(first[3:], second):
        assert np.array_equal(want, got)


def test_preempt_exit_closes_registered_pipes(tmp_path):
    from flashy_tpu_torch import resilience
    from flashy_tpu_torch.solver import BaseSolver
    from flashy_tpu_torch.xp import Config, create_xp

    source = ListStream([[1, 2, 3]] * 50, loop=True)

    class Solver(BaseSolver):
        def __init__(self):
            super().__init__()
            self.pipe = port.prefetch(port.SequencePacker(source, 1, 4))
            self.other = [1, 2]
            self.register_stateful("pipe", "other")

    with create_xp(Config({"t": "datapipe-close"}), root=tmp_path).enter():
        solver = Solver()
        assert [name for name, _ in solver._registered_datapipes()] == \
            ["pipe"]
        next(solver.pipe)
        assert solver.pipe._thread is not None
        guard = solver.enable_preemption_guard(install=False)
        try:
            guard.simulate_signal()
            with pytest.raises(SystemExit) as exc:
                solver._maybe_preempt("test boundary")
        finally:
            resilience.disable_preemption_guard()
        assert exc.value.code == resilience.EXIT_PREEMPTED
        assert solver.pipe._thread is None and source.closed
        assert (solver.folder / "preempted.json").exists()


# ---------------------------------------------------------------------------
# the drill
# ---------------------------------------------------------------------------
def test_drill_on_cpu_consumes_the_reference_drills_stream(tmp_path):
    import jax
    from flashy_tpu.datapipe import __main__ as jax_drill
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import create_xp as jax_create_xp
    from flashy_tpu_torch.datapipe import __main__ as drill
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.xp import Config, create_xp

    corpus = drill.make_corpus(tmp_path / "port_corpus")
    jax_corpus = jax_drill.make_corpus(tmp_path / "jax_corpus")
    for a, b in zip(corpus["jsonl"] + corpus["npy"],
                    jax_corpus["jsonl"] + jax_corpus["npy"]):
        assert a.read_bytes() == b.read_bytes()
    epochs, steps, batch, seq = 3, 6, 4, 64
    with jax_create_xp(JaxConfig({"d": "jax"}), root=tmp_path).enter():
        want = jax_drill._solver_class()(jax_corpus, epochs, steps, batch,
                                         seq)
        state = params_from_jax(jax.tree.map(np.asarray,
                                             {"params": want.params}),
                                drill.drill_config(seq))
        want.run()
    with create_xp(Config({"d": "port"}), root=tmp_path).enter():
        got = drill._solver_class()(corpus, epochs, steps, batch, seq,
                                    device="cpu")
        got.model.load_state_dict(state)
        got.run()
    assert len(got.consumed) == len(want.consumed) == epochs * steps
    for a, b in zip(got.consumed, want.consumed):
        assert np.array_equal(a["tokens"], np.asarray(b))
    for a, b in zip(got.history, want.history):
        np.testing.assert_allclose(a["train"]["loss"], b["train"]["loss"],
                                   rtol=1e-5)
    # the kill / resume drill itself
    assert drill.run_drill(root=str(tmp_path / "drill"), device="cpu") == 0
    assert drill.main(["--device", "cpu", "-e", "2", "-s", "3",
                       "--dir", str(tmp_path / "cli")]) == 0
    with pytest.raises(ValueError, match="kill_epoch"):
        drill.run_drill(kill_epoch=1, device="cpu")
    bench = drill.run_packing_bench(batches=5, batch_size=2, seq_len=64,
                                    root=str(tmp_path / "bench"))
    assert bench["batch_shape"] == [2, 64]
    assert 0.0 < bench["packing_efficiency"] <= 1.0


def test_drill_without_device_raises_when_cuda_is_absent(monkeypatch):
    import torch
    from flashy_tpu_torch.datapipe import __main__ as drill
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drill.run_drill()

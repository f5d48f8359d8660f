"""BaseSolver: inherit, register stateful attributes, implement run() (the
port of flashy_tpu/solver.py, on one process).

A solver owns the experiment (`self.xp`), a registry of stateful
attributes (`register_stateful`) and a result logger. Time is organized
in epochs of named stages; `commit()` appends the epoch's stage metrics
to the history and writes the checkpoint, both atomically, so an
interrupted run resumes exactly at the last committed epoch. Results
(metrics, hyperparameters, text, audio, images) fan out to the XP
folder and, once `init_tensorboard` / `init_wandb` attached them, to
TensorBoard and wandb.

`enable_telemetry` turns the runtime telemetry on (host spans, the
data-wait / host / device split of every step, the recompile watchdog,
heartbeats and, when asked for, the roofline); `enable_profiling` wraps
the selected stages in `torch.profiler` and writes a Chrome trace of
each into `<xp>/profiles/`.

Fault tolerance (`flashy_tpu_torch.resilience`): `checkpoint_mode`
picks one file ('single'), A/B slots ('sharded') or either by size
('auto'); `checkpoint_async` writes slots in the background;
`enable_preemption_guard` turns SIGTERM / SIGINT into a stop at the next
stage or commit boundary with exit code 75; `enable_hang_watchdog`
aborts a run whose heartbeat stalls with exit code 70.

State across ranks: a model in FSDP form, an optimizer over its shards
(or over a ZeRO model's), and attributes declared with
`set_state_sharding` hold rank-local shards, whose NamedShardings make
the state's layout. A sharded layout saves slots on every rank (each
rank its shards, rank 0 the rest), a single file gathered collectively
and written by rank 0, and `checkpoint_meta.json` records it
(`describe_state_sharding`); a restore places each rank's shards.
Resharding onto another world size or layout raises, naming ROADMAP.md
queue A item 8e.
"""
import json
import logging
import time
import typing as tp
from pathlib import Path

from . import checkpoint as _checkpoint
from . import distrib
from .distrib import is_rank_zero
from .formatter import Formatter
from .info import CHECKPOINT_META_NAME
from .logging import LogProgressBar, ResultLogger
from .resilience.preemption import PreemptionInterrupt
from .state import AttributeWrapper, StateManager
from .utils import write_and_rename
from .xp import get_xp

logger = logging.getLogger(__name__)



class BaseSolver:
    """Base class for training solvers. Subclasses implement `run()`,
    typically::

        def run(self):
            self.restore()
            for epoch in range(self.epoch, self.cfg.epochs + 1):
                self.run_stage('train', self.do_train)
                self.run_stage('valid', self.do_valid)
                self.commit()
    """

    checkpoint_name = "checkpoint.th"
    # How commit() persists state: 'single' = one file; 'sharded' = two
    # alternating slots under `<name>.sharded` (a crash mid-save keeps
    # the previous slot, a corrupt slot falls back to its sibling);
    # 'auto' = 'sharded' once the state's tensors reach
    # `sharded_checkpoint_min_bytes`. The port's default stays 'single'.
    checkpoint_mode = "single"
    sharded_checkpoint_min_bytes = 1 << 30
    # With slots, write them in the background: commit() returns once
    # the tensors are snapshotted to host memory; the slot becomes
    # active at the next commit or restore, `finalize_checkpoints()` or
    # a clean interpreter exit (atexit).
    checkpoint_async = False

    def __init__(self) -> None:
        self.stateful = StateManager()
        self.xp = get_xp()
        self.register_stateful("history")
        self.register_stateful("xp.cfg", "xp.sig", write_only=True)
        self.logger = logger
        self.result_logger = ResultLogger(self.logger)
        self._current_stage: tp.Optional[str] = None
        self._current_formatter: tp.Optional[Formatter] = None
        self._pending_metrics: tp.Dict[str, tp.Any] = {}
        self._profile_folder: tp.Optional[Path] = None
        self._profile_stages: tp.Optional[tp.Set[str]] = None
        self._step_timers: tp.Dict[str, tp.Any] = {}
        self._recompiles_reported = 0
        self._async_checkpointer: tp.Optional[
            _checkpoint.AsyncShardedCheckpointer] = None
        # how many history entries the in-flight asynchronous save covers
        # and the last finalized one covered: a deferred write failure
        # rolls the history back to the last durable epoch
        self._async_pending_epochs: tp.Optional[int] = None
        self._async_durable_epochs: tp.Optional[int] = None
        self._preemption_guard: tp.Optional[tp.Any] = None
        self._preemption_mode = "finish_stage"
        self._hang_watchdog: tp.Optional[tp.Any] = None
        # registered name -> its declared NamedSharding tree
        self._state_shardings: tp.Dict[str, tp.Any] = {}

    @property
    def checkpoint_path(self) -> Path:
        return self.folder / self.checkpoint_name

    @property
    def sharded_checkpoint_path(self) -> Path:
        """The directory of the A/B slot checkpoints."""
        return self.folder / (self.checkpoint_name + ".sharded")

    @property
    def history(self) -> tp.List[tp.Dict[str, tp.Any]]:
        """Per-epoch list of {stage_name: metrics} dicts."""
        return self.xp.link.history

    @property
    def folder(self) -> Path:
        return self.xp.folder

    @property
    def epoch(self) -> int:
        """Current epoch, starting at 1; resumes from the history length."""
        return len(self.history) + 1

    # ------------------------------------------------------------------
    # logging
    # ------------------------------------------------------------------
    def init_tensorboard(self, **kwargs: tp.Any) -> None:
        self.result_logger.init_tensorboard(**kwargs)

    def init_wandb(self, **kwargs: tp.Any) -> None:
        self.result_logger.init_wandb(**kwargs)

    def _check_in_stage(self) -> None:
        if self._current_stage is None:
            raise RuntimeError(
                "No stage is active: call this from within run_stage().")

    def log_hyperparams(self, params: dict,
                        metrics: tp.Optional[dict] = None) -> None:
        self.result_logger.log_hyperparams(params, metrics)

    def log_progress(self, stage_name: str, iterable: tp.Iterable,
                     total: tp.Optional[int] = None, updates: int = 5,
                     **kwargs: tp.Any) -> LogProgressBar:
        """Wrap an iterable in a progress-logging iterator for this stage.

        With telemetry enabled the bar also drives a `StepTimer`: every
        iteration is split into data-wait / host / device time, journaled
        per step, and the summary lands in the stage metrics when the
        stage ends. Call `progress.observe(outputs)` with the step's
        outputs to bound the device time.
        """
        from . import observability
        telemetry = observability.get_telemetry()
        if telemetry is not None and "step_timer" not in kwargs:
            previous = self._step_timers.get(stage_name)
            if previous is not None:
                # a second loader in the same stage: journal the first
                # loader's in-flight step before handing over the slot
                previous.finish()
            timer = telemetry.step_timer(stage_name)
            self._step_timers[stage_name] = timer
            kwargs["step_timer"] = timer
        return self.result_logger.get_log_progress_bar(
            stage_name, iterable, total=total, updates=updates,
            step=self.epoch, step_name="epoch", formatter=self.formatter,
            **kwargs)

    def log_metrics(self, stage_name: str, metrics: dict,
                    formatter: tp.Optional[Formatter] = None) -> None:
        """Log metrics for a stage of the current epoch (once per stage
        and epoch). Outside a stage, pass `formatter` explicitly."""
        if stage_name in self._pending_metrics:
            raise RuntimeError(
                f"Metrics for stage {stage_name!r} were already logged "
                f"during epoch {self.epoch}; each stage may be logged once "
                f"per epoch.")
        self._pending_metrics[stage_name] = metrics
        if formatter is None:
            formatter = self.formatter
        self.result_logger.log_metrics(stage_name, metrics, step=self.epoch,
                                       step_name="epoch", formatter=formatter)

    def log_audio(self, stage_name: str, key: str, audio: tp.Any,
                  sample_rate: int, **kwargs: tp.Any) -> None:
        self.result_logger.log_audio(stage_name, key, audio, sample_rate,
                                     self.epoch, **kwargs)

    def log_image(self, stage_name: str, key: str, image: tp.Any,
                  **kwargs: tp.Any) -> None:
        self.result_logger.log_image(stage_name, key, image, self.epoch,
                                     **kwargs)

    def log_text(self, stage_name: str, key: str, text: str,
                 **kwargs: tp.Any) -> None:
        self.result_logger.log_text(stage_name, key, text, self.epoch,
                                    **kwargs)

    # ------------------------------------------------------------------
    # state / checkpointing
    # ------------------------------------------------------------------
    def register_stateful(self, *args: str, write_only: bool = False) -> None:
        """Track attributes (dotted paths allowed) in the checkpoint:
        `nn.Module`s, optimizers and anything with state_dict /
        load_state_dict, lists, dicts or plain values. `write_only=True`
        records the value but never restores it (`xp.cfg`, `xp.sig`).

        Registering the outermost stage of a `flashy_tpu_torch.datapipe`
        pipeline (the stages implement the same protocol) makes
        `commit()` persist the exact input cursor, so a preempted run
        resumes token-exact mid-epoch; the preemption exit also closes
        it (`_registered_datapipes`)."""
        for name in args:
            owner = self
            *path, leaf = name.split(".")
            for part in path:
                owner = getattr(owner, part)
            self.stateful.register(name, AttributeWrapper(owner, leaf),
                                   write_only)

    def _registered_datapipes(self) -> tp.List[tp.Tuple[str, tp.Any]]:
        """Registered stateful attributes that are datapipe iterators
        (the CheckpointableIterator protocol: a cursor and close()).
        Their cursors ride the normal commit / restore path; this lookup
        lets the preemption exit also close them, so background prefetch
        threads stop before the emergency finalize of the checkpoint."""
        from .datapipe import CheckpointableIterator
        pipes = []
        for name, source in self.stateful.sources.items():
            if isinstance(source, AttributeWrapper):
                value = getattr(source.owner, source.name, None)
                if isinstance(value, CheckpointableIterator):
                    pipes.append((name, value))
        return pipes

    def set_state_sharding(self, name: str, shardings: tp.Any) -> None:
        """Declare the layout of the registered attribute `name`: a tree
        of NamedShardings matching its state (e.g. `zero_sharding` of
        its full-shaped value), or one NamedSharding for every leaf. The
        attribute then holds, on each rank, the rank's shard of each
        sharded leaf (`sharding.place` gives them): the checkpoint saves
        and restores them as shards, `checkpoint_mode='auto'` picks the
        slots, and `checkpoint_meta.json` records the layout."""
        from .parallel.data_parallel import tree_map
        from .parallel.sharding import NamedSharding
        if name not in self.stateful.sources:
            raise KeyError(f"set_state_sharding: {name!r} is not a "
                           f"registered stateful attribute (registered: "
                           f"{self.stateful.names()})")
        if isinstance(shardings, NamedSharding):
            single = shardings
            shardings = tree_map(lambda _: single,
                                 self.stateful.sources[name].state_dict())
        self._state_shardings[name] = shardings

    def state_layout(self, state: tp.Any = None) -> tp.Dict[str, tp.Any]:
        """The state's layout, a tree over the registered names whose
        leaves are NamedShardings: each declared attribute's tree
        (`set_state_sharding`) laid over the live one (the shardings of a
        sharded model's parameters and of an optimizer's state over
        them, or of tensors carrying a `.sharding`); None where a leaf
        has none. An optimizer's entries follow the tensors of `state`
        (a state dict being restored) where given, else its live state:
        each state tensor of a sharded parameter's rank follows the
        parameter."""
        import torch
        from .parallel.data_parallel import sharded_state, tree_map
        layout: tp.Dict[str, tp.Any] = {}
        for name, source in self.stateful.sources.items():
            if name in self._state_shardings:
                layout[name] = self._state_shardings[name]
                continue
            if not isinstance(source, AttributeWrapper):
                continue
            value = getattr(source.owner, source.name, None)
            if isinstance(value, torch.nn.Module):
                sharded = sharded_state(value)
                if sharded is not None:
                    layout[name] = dict(sharded.shardings)
            elif isinstance(value, torch.optim.Optimizer):
                params = [p for group in value.param_groups
                          for p in group["params"]]
                entries = (state[name] if state is not None and name in state
                           else value.state_dict())["state"]
                opt: tp.Dict[int, tp.Any] = {}
                for index, entry in entries.items():
                    sharding = getattr(params[index], "sharding", None)
                    if sharding is None:
                        continue
                    opt[index] = {key: sharding for key, item in entry.items()
                                  if isinstance(item, torch.Tensor)
                                  and item.dim() == params[index].dim()}
                if opt:
                    layout[name] = {"state": opt}
            elif isinstance(value, (dict, list, tuple)):
                tree = tree_map(lambda leaf: getattr(leaf, "sharding", None),
                                value)
                if any(leaf is not None
                       for leaf in distrib._flatten(tree)[0]):
                    layout[name] = tree
        return layout

    def _flat_layout(self, layout: tp.Optional[tp.Dict[str, tp.Any]] = None
                     ) -> tp.Dict[str, tp.Any]:
        """The layout by tensor key (`checkpoint`'s keys), the sharded
        leaves only."""
        from .parallel.zero import _paths, keystr
        layout = self.state_layout() if layout is None else layout
        return {keystr(path): sharding for path, sharding in _paths(layout)
                if sharding is not None
                and not getattr(sharding, "is_replicated", True)}

    def state_dict(self) -> tp.Any:
        return self.stateful.state_dict()

    def load_state_dict(self, state: tp.Any) -> None:
        self.stateful.load_state_dict(state)

    def _resolve_checkpoint_mode(self, state: tp.Any) -> str:
        if self.checkpoint_mode not in ("single", "sharded", "auto"):
            raise ValueError(f"unknown checkpoint_mode "
                             f"{self.checkpoint_mode!r}; expected 'single', "
                             f"'sharded' or 'auto'")
        if self.checkpoint_mode != "auto":
            return self.checkpoint_mode
        if self._flat_layout():
            # a declared or live layout that shards anything: each rank
            # writes its shards, nothing is gathered to one process
            return "sharded"
        return ("sharded" if _checkpoint.tensor_bytes(state)
                >= self.sharded_checkpoint_min_bytes else "single")

    def commit(self, save_checkpoint: bool = True) -> None:
        """Close the epoch: append the pending metrics to the history,
        write the checkpoint, then persist the history, both atomically.

        A failed save rolls the history append back (and `history.json`
        is only written after the save): `epoch` never runs ahead of what
        is restorable. The previous epoch's asynchronous save lands
        first; its failure rolls back the epochs it covered. With a
        preemption guard, a committed epoch is also the preferred stop:
        the boundary check here exits with the requeue code.
        """
        pending = self._pending_metrics
        if save_checkpoint and self._async_checkpointer is not None:
            self._finalize_async_attributed()
        self.history.append(pending)
        self._pending_metrics = {}
        try:
            if save_checkpoint:
                # the snapshot follows the append, so the checkpointed
                # history includes the epoch being committed; every rank
                # calls the save (rank 0 writes what is replicated)
                self._save_checkpoint(self.state_dict())
        except BaseException:
            self.history.pop()
            self._pending_metrics = pending
            raise
        if is_rank_zero():
            self.xp.link.update_history(self.history)
        self._maybe_preempt(
            f"commit boundary (epoch {len(self.history)} committed)")

    def _save_checkpoint(self, state: tp.Any) -> None:
        """Write `state` in the resolved mode, every rank calling. The
        other form is dropped only once the new save is durable and
        active: a crash between the two always leaves something
        restorable. A single file of a sharded state is gathered first
        (collectively) and written by rank 0; slots are written on every
        rank, each its shards."""
        mode = self._resolve_checkpoint_mode(state)
        layout = self._flat_layout()
        if mode == "single":
            full = _checkpoint.gather_state(state, layout)

            def write_single() -> None:
                _checkpoint.save_state(full, self.checkpoint_path)
                self._drop_slots()
                self._write_checkpoint_meta(mode)

            _checkpoint.run_on_rank_zero(write_single,
                                         "to save the checkpoint")
        else:
            def on_commit() -> None:
                # the meta only once the save is durable and active
                self._drop_single_file()
                self._write_checkpoint_meta(mode)

            if self.checkpoint_async:
                if self._async_checkpointer is None:
                    self._async_checkpointer = \
                        _checkpoint.AsyncShardedCheckpointer()
                    # a clean exit must not drop the last epoch's save
                    import atexit
                    atexit.register(self.finalize_checkpoints)
                self._async_checkpointer.save(
                    state, self.sharded_checkpoint_path, on_commit=on_commit,
                    layout=layout)
                self._async_pending_epochs = len(self.history)
            else:
                _checkpoint.save_state_sharded(
                    state, self.sharded_checkpoint_path, layout=layout,
                    on_commit=on_commit)
        self.logger.debug("Checkpoint saved (%s mode) under %s", mode,
                          self.folder)

    def _drop_single_file(self) -> None:
        for path in (self.checkpoint_path,
                     _checkpoint.sidecar_path(self.checkpoint_path)):
            if path.exists():
                path.unlink()

    def _drop_slots(self) -> None:
        if self.sharded_checkpoint_path.exists():
            import shutil
            shutil.rmtree(self.sharded_checkpoint_path, ignore_errors=True)

    def _write_checkpoint_meta(self, mode: str) -> None:
        """`checkpoint_meta.json`: the save mode and the state's layout
        (`describe_state_sharding` of `state_layout()`), which `python -m
        flashy_tpu_torch.info` shows. Best-effort: a failure here never
        fails the commit the checkpoint already survived."""
        from .parallel.zero import _paths, describe_state_sharding
        world = distrib.world_size()
        layout = self.state_layout()
        description = describe_state_sharding(layout)
        # the reference's topology record of the mesh
        mesh = next(({"axis_names": list(sharding.mesh.shape),
                      "shape": [int(size) for size
                                in sharding.mesh.shape.values()]}
                     for _, sharding in _paths(layout)
                     if sharding is not None), None)
        meta = {"mode": mode, "time": time.time(),
                "state_sharding": description,
                "topology": {"version": 1, "device_count": world,
                             "world_size": world, "mesh": mesh,
                             "state_sharding": description["summary"]}}
        try:
            with write_and_rename(self.folder / CHECKPOINT_META_NAME,
                                  "w") as f:
                json.dump(meta, f, indent=2)
        except OSError:
            self.logger.exception("could not write %s", CHECKPOINT_META_NAME)

    def finalize_checkpoints(self) -> None:
        """Block until any in-flight asynchronous save is durable and
        active. commit() and restore() also finalize the previous save,
        and an atexit hook finalizes the last one."""
        if self._async_checkpointer is not None:
            self._finalize_async_attributed()

    def _finalize_async_attributed(self) -> None:
        """`finalize_pending`, a failure attributed to the epochs the
        save covered: every history entry past the last durable save is
        rolled back (in memory and in `history.json`) before re-raising,
        so `epoch` never runs ahead of what `restore()` can deliver."""
        assert self._async_checkpointer is not None
        try:
            self._async_checkpointer.finalize_pending()
        except BaseException:
            durable = self._async_durable_epochs or 0
            if self._async_pending_epochs is not None \
                    and len(self.history) > durable:
                self.logger.warning(
                    "async checkpoint failed: rolling history back from "
                    "%d to the last durable epoch %d.",
                    len(self.history), durable)
                del self.history[durable:]
                if is_rank_zero():
                    try:
                        self.xp.link.update_history(self.history)
                    except OSError:
                        self.logger.exception(
                            "could not re-sync history.json after the "
                            "failed async checkpoint; restore() recovers "
                            "the consistent history from the last durable "
                            "checkpoint.")
            self._async_pending_epochs = None
            raise
        if self._async_pending_epochs is not None:
            self._async_durable_epochs = self._async_pending_epochs
            self._async_pending_epochs = None

    def _detect_checkpoint(self) -> int:
        """0 = none, 1 = single file, 2 = slots (preferred when both)."""
        self.finalize_checkpoints()
        if _checkpoint.sharded_checkpoint_exists(
                self.sharded_checkpoint_path):
            return 2
        if self.checkpoint_path.exists():
            return 1
        return 0

    def restore(self) -> bool:
        """Load the checkpoint if one exists (slots before a single
        file). Returns True on success. On several ranks every rank must
        see the checkpoint rank 0 sees (a folder on a filesystem they
        share): a rank that restored nothing while rank 0 resumed epoch N
        would wait in the next collective for ever, so a mismatch raises;
        then every rank loads the file."""
        kind = self._detect_checkpoint()
        if distrib.is_distributed():
            kind_on_zero = distrib.broadcast_object(kind)
            if kind_on_zero != kind:
                raise RuntimeError(
                    f"Checkpoint mismatch across hosts: process 0 sees "
                    f"checkpoint kind {kind_on_zero}, process "
                    f"{distrib.rank()} sees {kind} (0=none, 1=single, "
                    f"2=sharded). Checkpoints must live on a filesystem "
                    f"shared by all hosts.")
        if kind == 0:
            return False
        if kind == 2:
            # a solver's `mesh`, where it has one, must be the saved one
            state = _checkpoint.load_state_sharded(
                self.sharded_checkpoint_path, layout=self._flat_layout(),
                mesh=getattr(self, "mesh", None))
        else:
            # a single file holds full tensors: each rank takes its shards
            full = _checkpoint.load_state(self.checkpoint_path)
            state = _checkpoint.shard_state(
                full, self._flat_layout(self.state_layout(full)))
        self.load_state_dict(state)
        self.logger.debug("Checkpoint restored (kind %d) from %s", kind,
                          self.folder)
        return True

    # ------------------------------------------------------------------
    # telemetry and profiling
    # ------------------------------------------------------------------
    def enable_profiling(self, folder: tp.Optional[tp.Union[str, Path]]
                         = None,
                         stages: tp.Optional[tp.Sequence[str]] = None
                         ) -> None:
        """Profile each (selected) stage with `torch.profiler` (host and,
        with CUDA, device activity) and write its Chrome trace into
        `<xp.folder>/profiles/` (or `folder`) on rank 0, one file per
        stage and epoch. Call once before `run()`."""
        self._profile_folder = Path(folder) if folder \
            else self.folder / "profiles"
        self._profile_stages = set(stages) if stages else None

    def _should_profile(self, stage_name: str) -> bool:
        if self._profile_folder is None or not is_rank_zero():
            return False
        return self._profile_stages is None \
            or stage_name in self._profile_stages

    def enable_telemetry(self, **kwargs: tp.Any) -> tp.Any:
        """Turn runtime telemetry on for this run (host spans, the per-step
        data-wait / host / device split, the recompile watchdog, per-rank
        heartbeats; `roofline=True` adds the roofline profiler). The
        artifacts land in the XP folder: `trace.json` (Perfetto),
        `telemetry.jsonl` and `heartbeats/`. Call once before `run()`;
        returns the `observability.Telemetry`."""
        from . import observability
        kwargs.setdefault("folder", self.folder)
        return observability.enable_telemetry(**kwargs)

    # ------------------------------------------------------------------
    # fault tolerance (flashy_tpu_torch.resilience)
    # ------------------------------------------------------------------
    def enable_preemption_guard(self, mode: str = "finish_stage",
                                **kwargs: tp.Any) -> tp.Any:
        """Stop cooperatively on SIGTERM / SIGINT.

        Once a signal lands, the run stops at the next stage or commit
        boundary: it finalizes any asynchronous checkpoint, writes
        `preempted.json` and exits with `resilience.EXIT_PREEMPTED` (75,
        EX_TEMPFAIL). The epoch in flight is never half-committed, so
        the run resumes exactly at the last committed epoch.

        `mode`: 'finish_stage' (the default) lets the stage in flight
        finish; 'abandon_stage' also makes `check_preemption()` raise
        inside the stage, abandoning it. Other kwargs go to
        `resilience.enable_preemption_guard` (`install=False` skips the
        real signal handlers). Call once before `run()`; returns the
        guard.
        """
        if mode not in ("finish_stage", "abandon_stage"):
            raise ValueError(f"unknown preemption mode {mode!r}; expected "
                             "'finish_stage' or 'abandon_stage'")
        from . import resilience
        self._preemption_guard = resilience.enable_preemption_guard(**kwargs)
        self._preemption_mode = mode
        return self._preemption_guard

    def check_preemption(self, every: int = 1) -> bool:
        """The in-stage preemption check of a step loop (collective when
        it syncs: every rank calls it as often; `every=N` throttles by
        call count). In 'abandon_stage' mode it raises
        `PreemptionInterrupt` once the stop is agreed; in
        'finish_stage' mode it returns the verdict."""
        guard = self._preemption_guard
        if guard is None:
            return False
        agreed = guard.check(every=every)
        if (agreed and self._preemption_mode == "abandon_stage"
                and self._current_stage is not None):
            raise PreemptionInterrupt(
                f"preemption agreed mid-stage {self._current_stage!r} "
                f"(epoch {self.epoch})")
        return agreed

    def _maybe_preempt(self, where: str) -> None:
        """The stage and commit boundary check: agreement, then the
        emergency exit."""
        if self._preemption_guard is not None \
                and self._preemption_guard.should_stop():
            self._preempt_exit(where)

    def _preempt_exit(self, where: str) -> tp.NoReturn:
        """Make everything already committed durable and active (finalize
        the in-flight asynchronous save), flush telemetry, leave
        `preempted.json` and exit with the requeue code. Never commits a
        partial epoch: that is what keeps resume exact."""
        guard = self._preemption_guard
        assert guard is not None
        committed = len(self.history)
        for name, pipe in self._registered_datapipes():
            # freeze the input pipeline first: its cursor was captured at
            # the last commit, and prefetch workers streaming on would
            # only contend with the checkpoint finalize
            try:
                pipe.close()
            except Exception:
                self.logger.exception("could not close datapipe %r", name)
        self.logger.warning(
            "preemption (%s): stopping at %s; last committed epoch is %d; "
            "exiting with code %d — requeue and rerun to resume.",
            guard.signal_name or "requested", where, committed,
            guard.exit_code)
        try:
            self.finalize_checkpoints()
        finally:
            from . import observability
            telemetry = observability.get_telemetry()
            if telemetry is not None:
                telemetry.heartbeat.beat(epoch=self.epoch, stage="preempted",
                                         force=True)
                telemetry.record({"type": "preempted", "where": where,
                                  "epoch": self.epoch,
                                  "committed_epochs": committed,
                                  "signal": guard.signal_name})
                telemetry.export()
            if is_rank_zero():
                with write_and_rename(self.folder / "preempted.json",
                                      "w") as f:
                    json.dump({"time": time.time(), "where": where,
                               "committed_epochs": committed,
                               "signal": guard.signal_name,
                               "exit_code": guard.exit_code}, f, indent=2)
        raise SystemExit(guard.exit_code)

    def enable_hang_watchdog(self, warn_after: float = 120.0,
                             abort_after: tp.Optional[float] = None,
                             **kwargs: tp.Any) -> tp.Any:
        """Start a `resilience.HangWatchdog` over this XP's heartbeat
        files on a background thread: it WARNs with a straggler report
        when a rank's heartbeat stalls past `warn_after` seconds and,
        with `abort_after`, exits with `resilience.EXIT_HUNG` (70) past
        it. Needs `enable_telemetry()` (the heartbeats are its
        artifact). Returns the started watchdog."""
        from .resilience import HangWatchdog
        from .xp import HEARTBEAT_DIR_NAME
        if self._hang_watchdog is not None:
            self._hang_watchdog.stop()
        self._hang_watchdog = HangWatchdog(
            self.folder / HEARTBEAT_DIR_NAME, warn_after=warn_after,
            abort_after=abort_after, **kwargs)
        return self._hang_watchdog.start()

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def get_formatter(self, stage_name: str) -> Formatter:
        """Override to customize metric display per stage."""
        return Formatter()

    @property
    def formatter(self) -> Formatter:
        self._check_in_stage()
        assert self._current_formatter is not None
        return self._current_formatter

    @property
    def current_stage(self) -> str:
        self._check_in_stage()
        assert self._current_stage is not None
        return self._current_stage

    def run_stage(self, stage_name: str, method: tp.Callable,
                  *args: tp.Any, **kwargs: tp.Any) -> tp.Dict[str, tp.Any]:
        """Run one named stage of the current epoch. The returned metrics
        (or {}) get a `duration` entry and are logged under
        `stage_name`; a failed stage's metrics are never committed.

        With telemetry enabled the stage beats the heartbeat at both
        edges (forced), runs inside a `stage/<name>` span, and its metrics
        take the step timer's summary, the roofline's stage summary (when
        the roofline is on) and the recompiles since the previous stage.
        With profiling on for this stage it runs under `torch.profiler`.
        With a preemption guard the boundary before the stage is where a
        pending stop exits, and a stage abandoned by `check_preemption()`
        takes the same exit; its metrics are never committed.
        """
        if self._current_stage is not None:
            raise RuntimeError("stages cannot nest")
        self._maybe_preempt(f"boundary before stage {stage_name!r} "
                            f"(epoch {self.epoch})")
        self._current_stage = stage_name
        self._current_formatter = self.get_formatter(stage_name)

        from . import observability
        telemetry = observability.get_telemetry()
        begin = time.time()
        # call-count snapshot: the roofline's stage summary prices only
        # this stage's calls
        roofline_mark = (telemetry.roofline.mark()
                         if telemetry is not None
                         and telemetry.roofline.enabled else None)
        try:
            if telemetry is not None:
                telemetry.heartbeat.beat(epoch=self.epoch, stage=stage_name,
                                         force=True)
            if self._should_profile(stage_name):
                metrics = self._run_stage_profiled(telemetry, stage_name,
                                                   method, *args, **kwargs)
            else:
                metrics = self._run_stage_traced(telemetry, stage_name,
                                                 method, *args, **kwargs)
            if metrics is None:
                metrics = {}
            if telemetry is not None:
                timer = self._step_timers.pop(stage_name, None)
                if timer is not None:
                    timer.finish()
                    for key, value in timer.summary().items():
                        metrics.setdefault(key, value)
                    if roofline_mark is not None:
                        # realized TFLOP/s and MFU over the stage: this
                        # stage's priced calls over its steps' summed wall
                        # clock (the device share is only the backlog at
                        # each step's end, see observability.steptimer)
                        wall = sum(r["total"] for r in timer.records)
                        for key, value in telemetry.roofline.stage_summary(
                                wall, since=roofline_mark).items():
                            metrics.setdefault(key, value)
                # the delta since the previous stage, not the run's total
                recompiles = sum(telemetry.watchdog.summary().values())
                if recompiles > self._recompiles_reported:
                    metrics.setdefault(
                        "recompiles", recompiles - self._recompiles_reported)
                self._recompiles_reported = recompiles
            metrics["duration"] = time.time() - begin
            self.log_metrics(stage_name, metrics)
        except PreemptionInterrupt:
            # 'abandon_stage': the finally below still journals, then the
            # emergency exit; this stage's metrics are never committed
            self.logger.warning("stage %r abandoned mid-flight on "
                                "preemption.", stage_name)
            self._preempt_exit(f"mid-stage {stage_name!r} abandoned "
                               f"(epoch {self.epoch})")
        finally:
            self._current_stage = None
            self._current_formatter = None
            if telemetry is not None:
                # on a raising stage: journal the crashing step before the
                # export (a no-op on success, the timer was popped above)
                timer = self._step_timers.pop(stage_name, None)
                if timer is not None:
                    timer.finish()
                telemetry.heartbeat.beat(epoch=self.epoch, stage=stage_name,
                                         force=True)
                telemetry.record({"type": "stage", "stage": stage_name,
                                  "epoch": self.epoch,
                                  "duration": time.time() - begin})
                telemetry.export()
        return metrics

    def _run_stage_traced(self, telemetry: tp.Any, stage_name: str,
                          method: tp.Callable, *args: tp.Any,
                          **kwargs: tp.Any) -> tp.Any:
        if telemetry is None:
            return method(*args, **kwargs)
        with telemetry.span(f"stage/{stage_name}", epoch=self.epoch):
            return method(*args, **kwargs)

    def _run_stage_profiled(self, telemetry: tp.Any, stage_name: str,
                            method: tp.Callable, *args: tp.Any,
                            **kwargs: tp.Any) -> tp.Any:
        import torch
        from torch.profiler import ProfilerActivity, profile
        assert self._profile_folder is not None
        self._profile_folder.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            metrics = self._run_stage_traced(telemetry, stage_name, method,
                                             *args, **kwargs)
        prof.export_chrome_trace(str(
            self._profile_folder / f"{stage_name}-epoch{self.epoch}.json"))
        return metrics

    def run(self) -> None:
        raise NotImplementedError()

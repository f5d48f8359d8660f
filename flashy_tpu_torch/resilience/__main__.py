"""`python -m flashy_tpu_torch.resilience`: the chaos drill (the port of
flashy_tpu/resilience/__main__.py), the acceptance gate of the fault
tolerance.

It runs one tiny deterministic training job twice: once clean, once
under injected faults: a transient IO failure on a history write (to be
absorbed by retry), a simulated SIGTERM mid-stage (to stop the run at a
boundary with the requeue exit code 75) and a corrupted active
checkpoint slot (restore must fall back to the sibling A/B slot). Then
it resumes and demands the history (without `duration`) and the
final state be identical to the uninterrupted run's. Exit 1 unless
resume is exact and every injected fault fired and was recovered.

The drill touches no device. `--campaign` runs the registry-driven
chaos campaign (`resilience.campaign`) over a subset of its ported
scenarios (`--scenarios train,datapipe,serve,fleet`); `--replay`
re-executes a minimized reproducer. The full sweep and the elastic
drill (`--elastic`) raise NotImplementedError naming their ROADMAP
entries.
"""
import argparse
import logging
import shutil
import sys
import tempfile
import typing as tp
from pathlib import Path

import numpy as np

logger = logging.getLogger("flashy_tpu_torch.resilience.drill")

DRILL_STEPS = 4  # fault-injectable steps per train stage

TODO_ELASTIC = ("ROADMAP.md queue A items 5 and 8 (several processes and "
                "state across ranks, ported; item 8e's resharding "
                "restore, not yet), then item 9's elastic drill")


def _drill_solver_class():
    from ..solver import BaseSolver
    from . import chaos

    class DrillSolver(BaseSolver):
        """Tiny deterministic solver: numpy state, arithmetic updates.

        Every metric is a pure function of the committed state and the
        epoch, so two runs that resume from the same committed epoch give
        identical histories. `checkpoint_mode='sharded'` forces the A/B
        slot and manifest path.
        """

        checkpoint_mode = "sharded"

        def __init__(self, epochs: int):
            super().__init__()
            self.epochs = epochs
            self.w = np.zeros(8)
            self.register_stateful("w")

        def train_stage(self):
            for step in range(DRILL_STEPS):
                chaos.fault_point("drill.step", epoch=self.epoch, step=step)
                self.w = self.w * 0.9 + 0.1 * self.epoch
            return {"loss": float(np.sum(self.w))}

        def valid_stage(self):
            return {"score": float(np.mean(self.w) * self.epoch)}

        def run(self):
            self.restore()
            for _ in range(self.epoch, self.epochs + 1):
                self.run_stage("train", self.train_stage)
                self.run_stage("valid", self.valid_stage)
                self.commit()

    return DrillSolver


def _strip_wallclock(history: tp.List[dict]) -> tp.List[dict]:
    """The history without `duration`, which never matches across runs;
    everything else must match."""
    return [{stage: {k: v for k, v in metrics.items() if k != "duration"}
             for stage, metrics in epoch.items()} for epoch in history]


def run_drill(epochs: int = 5, root: tp.Optional[str] = None,
              preempt_epoch: int = 3, keep: bool = False,
              log: tp.Optional[logging.Logger] = None) -> int:
    """Run the chaos drill; returns 0 when every check passes.

    Phase A: the uninterrupted baseline. Phase B: the same job with a
    transient history-write fault (epoch 2), a simulated SIGTERM
    mid-train of `preempt_epoch`, then a corrupted active slot. Phase C:
    resume and compare with the baseline exactly.
    """
    from .. import resilience
    from ..xp import Config, create_xp
    from . import chaos

    log = log or logger
    if not 2 < preempt_epoch <= epochs:
        # two commits must land before the preemption so both slots hold
        # a checkpoint: corrupting the active one then proves the fallback
        raise ValueError(f"preempt_epoch must be in (2, {epochs}], "
                         f"got {preempt_epoch}")
    workdir = Path(root) if root else Path(
        tempfile.mkdtemp(prefix="flashy_torch_chaos_"))
    DrillSolver = _drill_solver_class()
    failures: tp.List[str] = []

    def check(ok: bool, what: str) -> None:
        if ok:
            log.info("PASS: %s", what)
        else:
            log.error("FAIL: %s", what)
            failures.append(what)

    try:
        log.info("phase A: uninterrupted baseline (%d epochs)", epochs)
        xp = create_xp(Config({"drill": "baseline"}), root=workdir)
        with xp.enter():
            baseline = DrillSolver(epochs)
            baseline.run()
        base_history = _strip_wallclock(baseline.history)
        base_w = baseline.w.copy()

        log.info("phase B: chaos run — transient IO fault at the epoch-2 "
                 "history write, simulated SIGTERM mid-train of epoch %d",
                 preempt_epoch)
        # strict: uninstall() raises if an armed rule never fired
        injector = chaos.install(strict=True)
        injector.fail_at("history.write", call=2)
        injector.preempt_at(
            "drill.step", call=(preempt_epoch - 1) * DRILL_STEPS + 2)
        chaos_cfg = Config({"drill": "chaos"})
        xp = create_xp(chaos_cfg, root=workdir)
        exit_code: tp.Optional[tp.Any] = None
        with xp.enter():
            solver = DrillSolver(epochs)
            solver.enable_preemption_guard(install=False)
            try:
                solver.run()
            except SystemExit as exc:
                exit_code = exc.code
        check(exit_code == resilience.EXIT_PREEMPTED,
              f"preempted run exited with the requeue code "
              f"{resilience.EXIT_PREEMPTED} (got {exit_code})")
        check(len(solver.history) == preempt_epoch - 1,
              f"preemption stopped at the boundary with exactly "
              f"{preempt_epoch - 1} committed epochs "
              f"(got {len(solver.history)})")
        check(injector.hits("history.write", kind="fail") == 1,
              "transient history-write fault fired and was absorbed by "
              "retry (zero training failures)")
        check(injector.hits("drill.step", kind="preempt") == 1,
              "simulated mid-stage SIGTERM fired")

        slot = chaos.corrupt_active_slot(solver.sharded_checkpoint_path)
        log.info("phase B: corrupted active checkpoint slot %r", slot)

        log.info("phase C: resume in the same XP (restore must fall back "
                 "to the sibling slot)")
        chaos.uninstall()
        resilience.disable_preemption_guard()
        xp = create_xp(chaos_cfg, root=workdir)  # same cfg, same folder
        with xp.enter():
            resumed = DrillSolver(epochs)
            resumed.run()
        check(_strip_wallclock(resumed.history) == base_history,
              "resumed history/metrics identical to the uninterrupted run "
              f"({len(resumed.history)} epochs)")
        check(bool(np.array_equal(resumed.w, base_w)),
              "resumed final model state bit-identical to the "
              "uninterrupted run")
        report = resilience.verify_checkpoint(resumed.folder)
        check(report["restorable"],
              "post-drill checkpoint verifies as restorable")
    finally:
        # verify=False: a strict raise here would mask the original error
        chaos.uninstall(verify=False)
        resilience.disable_preemption_guard()
        if not keep and root is None:
            shutil.rmtree(workdir, ignore_errors=True)
        elif keep:
            log.info("artifacts kept under %s", workdir)

    if failures:
        log.error("chaos drill FAILED %d checks:\n  %s", len(failures),
                  "\n  ".join(failures))
        return 1
    log.info("chaos drill passed: preemption, retry and corrupted-slot "
             "fallback all recovered; resume was exact.")
    return 0


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.resilience",
        description="Chaos drill: inject preemption, IO and corruption "
                    "faults and prove resume-exactness. With --campaign, "
                    "the registry-driven chaos campaign instead.")
    parser.add_argument("-e", "--epochs", type=int, default=5)
    parser.add_argument("--preempt-epoch", type=int, default=3,
                        help="epoch whose train stage takes the simulated "
                             "SIGTERM (must be > 2 so both A/B slots exist)")
    parser.add_argument("--elastic", action="store_true",
                        help="the elastic world-size drill (not ported "
                             "yet)")
    parser.add_argument("--campaign", action="store_true",
                        help="run the registry-driven chaos campaign: "
                             "every fault site x kind swept under seeded "
                             "schedules, failures ddmin-shrunk to a JSON "
                             "reproducer")
    parser.add_argument("--replay", metavar="ARTIFACT", default=None,
                        help="with --campaign: replay a minimized "
                             "reproducer artifact instead of sweeping "
                             "(exit 1 = reproduced)")
    parser.add_argument("--budget", type=int, default=None,
                        help="with --campaign: cap on fault schedules; "
                             "below base coverage drops schedules LOUDLY "
                             "(and fails the coverage gate), above it adds "
                             "seeded multi-fault schedules")
    parser.add_argument("--seed", type=int, default=0,
                        help="with --campaign: schedule-generation seed")
    parser.add_argument("--scenarios", default=None,
                        help="with --campaign: comma-separated scenario "
                             "subset (narrows the coverage gate); the "
                             "full sweep is not ported yet")
    parser.add_argument("--seeded-defect", default=None,
                        help="with --campaign: activate a registered "
                             "defect to prove the engine catches and "
                             "shrinks it (exit 1 + artifact expected)")
    parser.add_argument("--artifact", default=None,
                        help="with --campaign: where to write the "
                             "minimized reproducer on failure")
    parser.add_argument("--device", default=None,
                        help="with --campaign: where the datapipe, serve "
                             "and fleet scenarios run (default: cuda; "
                             "'cpu' for the host)")
    parser.add_argument("--dir", default=None,
                        help="work directory (default: a fresh temp dir)")
    parser.add_argument("--keep", action="store_true",
                        help="keep the XP folders for inspection")
    args = parser.parse_args(argv)

    if args.elastic:
        raise NotImplementedError(
            f"the elastic drill is not ported yet: {TODO_ELASTIC}")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="[%(levelname)s] %(message)s")
    if args.campaign or args.replay:
        from .campaign import replay_artifact, run_campaign
        if args.replay:
            return replay_artifact(args.replay, root=args.dir,
                                   keep=args.keep, device=args.device)
        scenarios = (args.scenarios.split(",")
                     if args.scenarios else None)
        return run_campaign(seed=args.seed, budget=args.budget,
                            scenarios=scenarios,
                            defect=args.seeded_defect, root=args.dir,
                            keep=args.keep, artifact=args.artifact,
                            device=args.device)
    return run_drill(epochs=args.epochs, root=args.dir,
                     preempt_epoch=args.preempt_epoch, keep=args.keep)


if __name__ == "__main__":
    raise SystemExit(main())

"""One-command multi-host launching (the port of flashy_tpu/launch.py).

Brings up every host of a multi-host run with one command:

  * ssh mode: any cluster reachable by hostname; each host gets the
    FLASHY_TPU_COORDINATOR / NUM_PROCESSES / PROCESS_ID environment that
    `flashy_tpu_torch.distrib` reads, the first host the coordinator;
  * tpu-pod mode: the one `gcloud compute tpus tpu-vm ssh --worker=all`
    command that starts a command on every worker of a Cloud TPU pod
    slice (kept as it is, a pure argv planner, so both packages plan the
    same command lines).

The planning functions are pure (host, env, argv) planners, testable
without ssh or a pod. A run of several processes still needs
`distrib.init` on torch.distributed (ROADMAP.md queue A item 5): until
then the port's `distrib.init` raises for a world size above 1.
"""
import argparse
import dataclasses
import shlex
import subprocess
import sys
import typing as tp

DEFAULT_PORT = 29400


@dataclasses.dataclass(frozen=True)
class HostCommand:
    """One host's launch recipe: run `argv` on `host` with `env` set."""

    host: str
    env: tp.Dict[str, str]
    argv: tp.List[str]

    def shell_line(self) -> str:
        """The `env K=V ... cmd` line executed on the remote host."""
        pairs = " ".join(f"{k}={shlex.quote(v)}"
                         for k, v in sorted(self.env.items()))
        return f"env {pairs} {shlex.join(self.argv)}"


def plan_ssh(argv: tp.Sequence[str], hosts: tp.Sequence[str], *,
             port: int = DEFAULT_PORT,
             extra_env: tp.Optional[tp.Mapping[str, str]] = None
             ) -> tp.List[HostCommand]:
    """Build the per-host commands for an ssh-reachable cluster.

    The first host is the rendezvous coordinator; every process i gets
    the launcher env that `distrib.rank()` / `distrib.world_size()`
    read.
    """
    if not hosts:
        raise ValueError("need at least one host")
    coordinator = f"{hosts[0]}:{port}"
    plan = []
    for index, host in enumerate(hosts):
        env = {
            "FLASHY_TPU_COORDINATOR": coordinator,
            "FLASHY_TPU_NUM_PROCESSES": str(len(hosts)),
            "FLASHY_TPU_PROCESS_ID": str(index),
        }
        if extra_env:
            env.update(extra_env)
        plan.append(HostCommand(host=host, env=env, argv=list(argv)))
    return plan


def ssh_argv(cmd: HostCommand, ssh_bin: str = "ssh") -> tp.List[str]:
    """The local argv that executes `cmd` on its host."""
    return [ssh_bin, cmd.host, cmd.shell_line()]


def gcloud_tpu_pod_argv(argv: tp.Sequence[str], *, name: str, zone: str,
                        project: tp.Optional[str] = None) -> tp.List[str]:
    """The single gcloud command that starts `argv` on ALL workers of a
    Cloud TPU pod slice (the same command line runs unmodified on every
    worker, which finds the pod's topology itself)."""
    out = ["gcloud", "compute", "tpus", "tpu-vm", "ssh", name,
           "--zone", zone, "--worker=all"]
    if project:
        out += ["--project", project]
    return out + ["--command", shlex.join(argv)]


def run_plan(plan: tp.Sequence[HostCommand], *, ssh_bin: str = "ssh",
             stream: tp.TextIO = sys.stderr) -> int:
    """Start every host command, stream-tag their output, wait for all.

    Each host's pipe is drained by its own thread: draining sequentially
    would let a chatty host fill its 64KiB pipe and block inside a
    training collective, wedging the whole run.

    Returns the first non-zero exit code (0 when every host succeeded).
    A failing host does not kill the others mid-epoch — like the
    reference's restart-based recovery posture, partial failure surfaces
    as a non-zero exit for the scheduler/retry layer to act on.
    """
    import threading

    procs = []
    for cmd in plan:
        proc = subprocess.Popen(ssh_argv(cmd, ssh_bin), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

        def drain(cmd=cmd, proc=proc):
            assert proc.stdout is not None
            for line in proc.stdout:
                print(f"[{cmd.host}] {line}", end="", file=stream)

        thread = threading.Thread(target=drain, daemon=True)
        thread.start()
        procs.append((proc, thread))
    code = 0
    for proc, thread in procs:
        proc.wait()
        thread.join()
        if proc.returncode and not code:
            code = proc.returncode
    return code


def split_command(argv: tp.Sequence[str]
                  ) -> tp.Tuple[tp.List[str], tp.List[str]]:
    """Split a CLI argv at the first '--' into (own_args, command)."""
    argv = list(argv)
    if "--" in argv:
        split = argv.index("--")
        return argv[:split], argv[split + 1:]
    return argv, []


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.launch",
        description="Start a training command on every host of a cluster "
                    "or TPU pod. Everything after '--' is the command.")
    sub = parser.add_subparsers(dest="mode", required=True)

    ssh_p = sub.add_parser("ssh", help="ssh-reachable hosts")
    ssh_p.add_argument("--hosts", required=True,
                       help="comma-separated host list; first = coordinator")
    ssh_p.add_argument("--port", type=int, default=DEFAULT_PORT)
    ssh_p.add_argument("--dry-run", action="store_true",
                       help="print the per-host commands, run nothing")

    pod_p = sub.add_parser("tpu-pod", help="Cloud TPU pod slice via gcloud")
    pod_p.add_argument("--name", required=True)
    pod_p.add_argument("--zone", required=True)
    pod_p.add_argument("--project", default=None)
    pod_p.add_argument("--dry-run", action="store_true")

    argv, command = split_command(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if not command:
        parser.error("no command given; put it after '--'")

    if args.mode == "ssh":
        hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
        plan = plan_ssh(command, hosts, port=args.port)
        if args.dry_run:
            for cmd in plan:
                print(shlex.join(ssh_argv(cmd)))
            return 0
        return run_plan(plan)

    pod_argv = gcloud_tpu_pod_argv(command, name=args.name, zone=args.zone,
                                   project=args.project)
    if args.dry_run:
        print(shlex.join(pod_argv))
        return 0
    return subprocess.call(pod_argv)


if __name__ == "__main__":
    sys.exit(main())

# The port's launch and sweep helpers (flashy_tpu_torch.launch, .sweep)
# held against the JAX package's for the same argv: the per-host plans,
# the ssh and gcloud argv, the '--' split, the grid expansion and the
# two CLIs' --dry-run output, all equal; the planned env is what the
# port's distrib reads; the plans execute (a fake ssh) with the env set.
import io
import stat
import subprocess
import sys

import pytest

import flashy_tpu.launch as ref_launch
import flashy_tpu.sweep as ref_sweep
import flashy_tpu_torch.launch as launch
import flashy_tpu_torch.sweep as sweep

ARGVS = [["python", "train.py", "lr=0.1"],
         ["python", "-m", "x", "--name", "it's a test", "a b=c d"],
         ["sh", "-c", "echo $HOME; exit 3"]]


@pytest.mark.parametrize("argv", ARGVS)
@pytest.mark.parametrize("hosts,port,extra", [
    (["h0"], launch.DEFAULT_PORT, None),
    (["10.0.0.1", "10.0.0.2", "node-3"], 1234, {"NCCL_DEBUG": "INFO"})])
def test_plans_and_argv_equal_reference(argv, hosts, port, extra):
    got = launch.plan_ssh(argv, hosts, port=port, extra_env=extra)
    want = ref_launch.plan_ssh(argv, hosts, port=port, extra_env=extra)
    assert [(c.host, c.env, c.argv, c.shell_line()) for c in got] == \
        [(c.host, c.env, c.argv, c.shell_line()) for c in want]
    for a, b in zip(got, want):
        assert launch.ssh_argv(a) == ref_launch.ssh_argv(b)
        assert launch.ssh_argv(a, "myssh") == ref_launch.ssh_argv(b, "myssh")
    for project in (None, "proj"):
        assert launch.gcloud_tpu_pod_argv(
            argv, name="pod", zone="z", project=project) == \
            ref_launch.gcloud_tpu_pod_argv(argv, name="pod", zone="z",
                                           project=project)
    with pytest.raises(ValueError, match="at least one host"):
        launch.plan_ssh(argv, [])


@pytest.mark.parametrize("argv", [["a", "--", "b", "--", "c"], ["a", "b"],
                                  ["--"], []])
def test_split_command_equals_reference(argv):
    assert launch.split_command(argv) == ref_launch.split_command(argv)


@pytest.mark.parametrize("overrides", [
    ["lr=0.1,0.3", "dim=256,512", "tag=x"], ["layers=[1,2,3]"],
    ["a=1,2,3", "b=,4,", "c=x=y"], []])
def test_expand_grid_equals_reference(overrides):
    assert sweep.expand_grid(overrides) == ref_sweep.expand_grid(overrides)
    with pytest.raises(ValueError):
        sweep.expand_grid(["nonsense"])


@pytest.mark.parametrize("args", [
    ["ssh", "--hosts", "a,b", "--dry-run", "--", "python", "train.py"],
    ["ssh", "--hosts", " a, b ,c", "--port", "9", "--dry-run", "--",
     "python", "t.py", "x=it's"],
    ["tpu-pod", "--name", "p", "--zone", "z", "--dry-run", "--", "python",
     "train.py"],
    ["tpu-pod", "--name", "p", "--zone", "z", "--project", "q",
     "--dry-run", "--", "python", "train.py", "lr=1"]])
def test_launch_cli_dry_run_equals_reference(capsys, args):
    assert launch.main(args) == 0
    got = capsys.readouterr().out
    assert ref_launch.main(args) == 0
    assert got == capsys.readouterr().out and got


def test_sweep_cli_dry_run_equals_reference(capsys):
    args = ["--dry-run", "a=1,2", "b=x,y", "--", "python", "t.py"]
    assert sweep.main(args) == 0
    got = capsys.readouterr().out
    assert ref_sweep.main(args) == 0
    assert got == capsys.readouterr().out
    assert got.splitlines()[0] == "python t.py a=1 b=x"
    for main in (launch.main, sweep.main):
        with pytest.raises(SystemExit):
            main(["ssh", "--hosts", "a"] if main is launch.main else ["a=1"])


def test_planned_env_is_what_distrib_reads(monkeypatch):
    from flashy_tpu_torch import distrib
    plan = launch.plan_ssh(["true"], ["h0", "h1", "h2"])
    for index, cmd in enumerate(plan):
        for key, value in cmd.env.items():
            monkeypatch.setenv(key, value)
        assert distrib.rank() == index and distrib.world_size() == 3


def test_plans_execute_and_run_plan_collects_exit_codes(tmp_path):
    out = tmp_path / "out.txt"
    plan = launch.plan_ssh(["sh", "-c", f"echo $FLASHY_TPU_PROCESS_ID >> "
                                        f"{out}"], ["h0", "h1"])
    for cmd in plan:
        result = subprocess.run(["/bin/sh", "-c", cmd.shell_line()],
                                capture_output=True, text=True)
        assert result.returncode == 0, result.stderr
    assert sorted(out.read_text().split()) == ["0", "1"]
    # a fake ssh: drop the hostname, run the remote line locally
    shim = tmp_path / "fake_ssh"
    shim.write_text("#!/bin/sh\nshift\nexec /bin/sh -c \"$1\"\n")
    shim.chmod(shim.stat().st_mode | stat.S_IXUSR)
    stream = io.StringIO()
    plan = launch.plan_ssh(
        ["sh", "-c", "echo rank $FLASHY_TPU_PROCESS_ID; "
                     "exit $FLASHY_TPU_PROCESS_ID"], ["hostA", "hostB"])
    assert launch.run_plan(plan, ssh_bin=str(shim), stream=stream) == 1
    text = stream.getvalue()
    assert "[hostA] rank 0" in text and "[hostB] rank 1" in text


def test_sweep_cli_runs_each_point(tmp_path):
    marker = tmp_path / "calls.txt"
    code = sweep.main(
        ["a=1,2", "--", sys.executable, "-c",
         f"import sys; open(r'{marker}', 'a').write(sys.argv[-1] + chr(10))"])
    assert code == 0
    assert sorted(marker.read_text().split()) == ["a=1", "a=2"]
    code = sweep.main(["--keep-going", "a=1,2", "--", sys.executable, "-c",
                       "raise SystemExit(4)"])
    assert code == 4

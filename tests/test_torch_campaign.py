# The port's chaos campaign (flashy_tpu_torch.resilience.campaign) held
# against the JAX package's: FaultSpec / Schedule JSON, the seeded
# schedules (base and extra) equal for the same seed and counts, ddmin's
# results, the static coverage and the registry copy equal; the
# scenarios the port does not run yet raise naming their ROADMAP items;
# the train and datapipe campaigns pass on the CPU (each a few seconds,
# so neither is marked slow); a seeded defect is caught, shrunk to a
# reproducer and replayed.
import contextlib
import json
import random

import pytest

import flashy_tpu.resilience.campaign as ref
import flashy_tpu_torch.resilience.campaign as campaign
from flashy_tpu_torch.resilience.campaign import (
    FaultSpec, Schedule, ddmin, run_campaign)


def test_fault_spec_and_schedule_json_round_trip():
    spec = FaultSpec("fleet.wal_append", "fatal", call=4, times=3)
    assert FaultSpec.from_dict(json.loads(json.dumps(spec.to_dict()))) \
        == spec
    assert spec.to_dict() == ref.FaultSpec(
        "fleet.wal_append", "fatal", call=4, times=3).to_dict()
    assert str(spec) == "fatal@fleet.wal_append#4x3"
    assert str(FaultSpec("drill.step", "transient")) == \
        "transient@drill.step#1"
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("drill.step", "gamma_ray")
    schedule = Schedule("fleet", 7, (
        FaultSpec("fleet.wal_append", "transient", call=2),
        FaultSpec("serve.step", "delay", call=3)))
    payload = json.loads(json.dumps(schedule.to_dict()))
    assert Schedule.from_dict(payload) == schedule
    assert ref.Schedule.from_dict(payload).to_dict() == schedule.to_dict()
    assert schedule.describe() == \
        "fleet: transient@fleet.wal_append#2, delay@serve.step#3"
    assert Schedule("train", 0).describe() == "train: clean"
    err = campaign.CampaignFailure(["a broke", "b broke"])
    assert err.failures == ["a broke", "b broke"] and "a broke" in str(err)


def _scenario_pairs():
    ported = {s.name: s for s in campaign.builtin_scenarios("cpu")}
    return [(ported[s.name], s) for s in ref.builtin_scenarios()]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_schedules_equal_the_references(seed):
    pairs = _scenario_pairs()
    assert [p.name for p, _ in pairs] == [r.name for _, r in pairs]
    for got, want in pairs:
        assert got.sites() == want.sites(), got.name
        counts = {site: 3 + 5 * i
                  for i, site in enumerate(sorted(want.sites()))}
        assert [s.to_dict() for s in
                campaign._base_schedules(got, counts, seed)] == \
            [s.to_dict() for s in ref._base_schedules(want, counts, seed)]
        for site in want.sites():
            for kind in ref.KINDS:
                assert got.fault_times(site, kind) == \
                    want.fault_times(site, kind)
        rng_a, rng_b = (random.Random(f"{seed}:extras") for _ in "ab")
        for _ in range(4):
            a = campaign._extra_schedule(got, counts, rng_a)
            b = ref._extra_schedule(want, counts, rng_b)
            assert (a and a.to_dict()) == (b and b.to_dict())


def _specs(n):
    return [FaultSpec(f"site.{i}", "transient", call=i + 1)
            for i in range(n)]


@pytest.mark.parametrize("n,culprits", [(8, {5}), (6, {1, 4}), (4, None),
                                        (5, {0, 2, 3}), (1, {0})])
def test_ddmin_equals_the_references(n, culprits):
    specs = _specs(n)
    if culprits is None:        # breaks even the clean path -> []
        def fails(subset):
            return True
    else:
        bad = {specs[i] for i in culprits}

        def fails(subset):
            return bad <= set(subset)
    calls = []

    def counted(subset):
        calls.append(tuple(subset))
        return fails(subset)

    got = ddmin(specs, counted)
    ref_specs = [ref.FaultSpec(s.site, s.kind, s.call) for s in specs]
    want = ref.ddmin(ref_specs, lambda sub: fails(
        [FaultSpec(s.site, s.kind, s.call) for s in sub]))
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert set(got) == (set() if culprits is None else
                        {specs[i] for i in culprits})
    assert len(calls) < 2 ** n + 2


def test_static_coverage_and_registry_equal_the_references():
    from flashy_tpu.analysis import registry as ref_registry
    from flashy_tpu_torch.analysis import registry
    assert registry.FAULT_SITES == ref_registry.FAULT_SITES
    assert registry.FAULT_SITE_PREFIXES == ref_registry.FAULT_SITE_PREFIXES
    assert campaign.static_coverage() == ref.static_coverage()
    assert campaign.NOQA_SITES == ref.NOQA_SITES
    assert campaign.KINDS == ref.KINDS
    assert campaign.RUN_FAULT_SITE == ref.RUN_FAULT_SITE
    for site in registry.FAULT_SITES:
        assert site in campaign.static_coverage(), site


@pytest.mark.parametrize("name,item", [
    ("serve", "item 10"), ("fleet", "item 10"), ("pipeline", "item 8"),
    ("tensor", "item 8"), ("elastic", "items 5 and 8")])
def test_waiting_scenarios_raise_naming_their_items(tmp_path, name, item):
    scenario = {s.name: s for s in campaign.builtin_scenarios()}[name]
    assert scenario.sites()
    with pytest.raises(NotImplementedError, match=item):
        scenario.execute(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        run_campaign(scenarios=["train", name], root=str(tmp_path))
    artifact = tmp_path / "repro.json"
    artifact.write_text(json.dumps({"scenario": name, "seed": 0,
                                    "faults": [], "failure": ["x"]}))
    with pytest.raises(NotImplementedError, match=item):
        campaign.replay_artifact(str(artifact), root=str(tmp_path))


def test_full_sweep_and_the_cli_raise_naming_items_5_8_10(tmp_path):
    from flashy_tpu_torch.resilience.__main__ import main
    for call in (lambda: run_campaign(root=str(tmp_path)),
                 lambda: main(["--campaign", "--dir", str(tmp_path)])):
        with pytest.raises(NotImplementedError) as exc:
            call()
        for item in ("item 10", "item 8", "items 5 and 8"):
            assert item in str(exc.value)
    with pytest.raises(NotImplementedError, match="item 10"):
        with campaign.apply_defect("wal_skip_dedup"):
            pass
    with pytest.raises(ValueError, match="unknown seeded defect"):
        with campaign.apply_defect("not_a_defect"):
            pass
    with pytest.raises(ValueError, match="unknown scenarios"):
        run_campaign(scenarios=["train", "nope"], root=str(tmp_path))


@pytest.mark.parametrize("scenario", ["train", "datapipe"])
def test_campaign_passes_on_the_cpu(tmp_path, scenario):
    assert run_campaign(seed=0, scenarios=[scenario], root=str(tmp_path),
                        device="cpu") == 0


def test_cli_runs_the_datapipe_campaign_by_default_device(tmp_path):
    # the host only when asked for: `--device cpu`
    from flashy_tpu_torch.resilience.__main__ import main
    assert main(["--campaign", "--scenarios", "datapipe", "--seed", "1",
                 "--device", "cpu", "--dir", str(tmp_path)]) == 0


def test_campaign_without_device_raises_when_cuda_is_absent(tmp_path,
                                                           monkeypatch):
    # as the datapipe drill does: no quiet fallback to the host, and the
    # raise comes before any schedule runs (not turned into a finding)
    import torch
    from flashy_tpu_torch.resilience.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--campaign", "--scenarios", "datapipe", "--seed", "1",
              "--dir", str(tmp_path)])
    assert not (tmp_path / "datapipe").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_campaign(seed=0, scenarios=["train", "datapipe"],
                     root=str(tmp_path))


@contextlib.contextmanager
def _skip_a_doc_on_resume():
    """A seeded bug: every restored stream cursor skips one document, so
    a run resumed after a kill consumes a different token stream."""
    from flashy_tpu_torch.datapipe.stream import ShardedTextStream
    original = ShardedTextStream.load_state_dict

    def broken(self, state):
        original(self, state)
        self._cursors[self._rr] += 1

    ShardedTextStream.load_state_dict = broken
    try:
        yield
    finally:
        ShardedTextStream.load_state_dict = original


def test_seeded_defect_is_caught_shrunk_and_replayed(tmp_path,
                                                     monkeypatch):
    monkeypatch.setitem(campaign.DEFECTS, "skip_doc", _skip_a_doc_on_resume)
    steps = campaign.DatapipeScenario.STEPS
    total = {"datapipe.batch": campaign.DatapipeScenario.EPOCHS * steps}
    # a seed whose kill lands in epoch 1, so the resume consumes batches
    seed = next(s for s in range(100) if all(
        f.call <= steps for sch in campaign._base_schedules(
            campaign.DatapipeScenario(), total, s)
        for f in sch.faults if f.kind == "fatal"))
    artifact = tmp_path / "repro.json"
    assert run_campaign(seed=seed, scenarios=["datapipe"], defect="skip_doc",
                        root=str(tmp_path / "run"), artifact=str(artifact),
                        device="cpu") == 1
    payload = json.loads(artifact.read_text())
    assert payload["scenario"] == "datapipe" and payload["defect"] == \
        "skip_doc"
    assert [f["kind"] for f in payload["faults"]] == ["fatal"]
    assert "consumed token stream diverged" in " ".join(payload["failure"])
    assert campaign.replay_artifact(str(artifact), root=str(tmp_path / "a"),
                                    device="cpu") == 1
    payload["defect"] = None
    artifact.write_text(json.dumps(payload))
    assert campaign.replay_artifact(str(artifact), root=str(tmp_path / "b"),
                                    device="cpu") == 0

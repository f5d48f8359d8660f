# The port's logger backends (flashy_tpu_torch/loggers: localfs,
# tensorboard, wandb, utils) and the fan-out of ResultLogger / BaseSolver
# (log_hyperparams, log_audio, log_image) held against the JAX package's
# for the same calls: the local files byte for byte, the TensorBoard
# events read back (tags, steps, values), wandb against a fake module as
# tests/test_logging.py does; a backend whose package is missing raises
# ImportError naming it.
import json
import sys
import types

import numpy as np
import pytest
import torch


def _helpers():
    from flashy_tpu.loggers import utils as jax_utils
    from flashy_tpu_torch.loggers import utils
    return utils, jax_utils


@pytest.mark.parametrize("params", [
    {"lr": np.float64(0.1), "name": "x", "fn": len, "none": None,
     "nested": {"a": {"b": 1, "c": [1, 2]}, "empty": {}}},
    {"flag": True, "step": np.int32(3), "t": torch.tensor(2.5)},
])
def test_param_helpers_match_the_jax_package(params):
    utils, jax_utils = _helpers()
    assert utils.sanitize_params(utils.flatten_dict(
        utils.convert_params(params))) == jax_utils.sanitize_params(
            jax_utils.flatten_dict(jax_utils.convert_params(params)))
    assert utils.add_prefix({"loss": 1}, ["train", "gen"]) == \
        jax_utils.add_prefix({"loss": 1}, ["train", "gen"])
    assert utils.join_prefix("train") == jax_utils.join_prefix("train")
    assert np.array_equal(utils.to_numpy_media(torch.ones(2, 3)),
                          jax_utils.to_numpy_media(torch.ones(2, 3)))


def _media(seed=0):
    rng = np.random.default_rng(seed)
    audio = np.sin(np.linspace(0, 40, 800, dtype=np.float32))[None].repeat(
        2, 0) * 0.5
    image = rng.random((3, 8, 6)).astype(np.float32)
    return audio, image


def test_localfs_writes_the_jax_packages_files(tmp_path):
    from flashy_tpu.loggers.localfs import LocalFSLogger as JaxLocal
    from flashy_tpu_torch.loggers.localfs import LocalFSLogger
    audio, image = _media()
    outputs = {}
    for name, cls, as_input in (("jax", JaxLocal, np.asarray),
                                ("port", LocalFSLogger, torch.from_numpy)):
        backend = cls(str(tmp_path / name))
        backend.log_hyperparams({"lr": 0.1, "model": {"dim": 8}})
        backend.log_audio("valid", "wave", as_input(audio), 16000, step=2)
        backend.log_image(["valid", "gen"], "picture", as_input(image),
                          step=2)
        backend.log_text("train", "sample", "1 2 3", step=1)
        backend.log_metrics("train", {"loss": 1.0}, step=1)
        files = sorted(p for p in (tmp_path / name).rglob("*") if p.is_file())
        outputs[name] = {str(p.relative_to(tmp_path / name)): p.read_bytes()
                         for p in files}
    assert list(outputs["port"]) == ["hyperparams.json",
                                     "train_1/sample.txt",
                                     "valid_2/wave.wav",
                                     "valid_gen_2/picture.png"]
    assert outputs["port"] == outputs["jax"]
    silent = LocalFSLogger(str(tmp_path / "silent"), with_media_logging=False)
    silent.log_text("train", "sample", "x", step=1)
    assert not (tmp_path / "silent" / "train_1").exists()


def _tensorboard_calls(backend, as_input):
    audio, image = _media(1)
    backend.log_hyperparams({"lr": 0.1, "model": {"dim": 8}}, {"loss": 2.0})
    for step in range(3):
        backend.log_metrics("train", {"loss": 1.0 / (1 + step),
                                      "grad_norm": np.float32(step)},
                            step=step)
    backend.log_metrics(["valid", "ema"], {"loss": torch.tensor(0.25)},
                        step=2)
    backend.log_text("generate", "sample", "1 2 3", step=2)
    backend.log_audio("valid", "wave", as_input(audio), 8000, step=2)
    backend.log_image("valid", "picture", as_input(image), step=2)
    backend._writer.close()


def _read_events(folder):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    out = {}
    runs = sorted({p.parent for p in folder.rglob("events.out.tfevents.*")})
    for run in runs:
        acc = EventAccumulator(str(run), size_guidance={"scalars": 0,
                                                        "tensors": 0})
        acc.Reload()
        tags = acc.Tags()
        scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                   for tag in tags["scalars"]}
        tensors = {tag: [(e.step, e.tensor_proto.SerializeToString())
                         for e in acc.Tensors(tag)]
                   for tag in tags["tensors"]}
        images = {tag: [(e.step, e.width, e.height) for e in acc.Images(tag)]
                  for tag in tags["images"]}
        audio = {tag: [(e.step, e.sample_rate, e.length_frames)
                       for e in acc.Audio(tag)] for tag in tags["audio"]}
        # add_hparams writes a run of its own, named by the wall time
        name = str(run.relative_to(folder))
        out["." if name == "." else "hparams"] = (scalars, tensors, images,
                                                  audio)
    return out


def test_tensorboard_events_match_the_jax_loggers(tmp_path):
    from flashy_tpu.loggers.tensorboard import (
        TensorboardLogger as JaxTensorboard)
    from flashy_tpu_torch.loggers.tensorboard import TensorboardLogger
    _tensorboard_calls(JaxTensorboard(str(tmp_path / "jax"),
                                      with_media_logging=True), np.asarray)
    _tensorboard_calls(TensorboardLogger(str(tmp_path / "port"),
                                         with_media_logging=True),
                       torch.from_numpy)
    want, got = (_read_events(tmp_path / name) for name in ("jax", "port"))
    assert got.keys() == want.keys()
    main = got["."]
    assert main[0]["train/loss"] == [(0, 1.0), (1, 0.5),
                                     (2, pytest.approx(1 / 3))]
    assert "valid/ema/loss" in main[0]
    assert set(main[2]) == {"valid/picture"}
    assert set(main[3]) == {"valid/wave"}
    assert any(tag.startswith("generate/sample") for tag in main[1])
    assert set(got) == {".", "hparams"}
    for run in want:
        scalars, tensors, images, audio = got[run]
        assert scalars == want[run][0], run
        assert images == want[run][2] and audio == want[run][3], run
        assert tensors.keys() == want[run][1].keys(), run


def test_result_logger_fans_out_and_solver_logs_media(tmp_path):
    from flashy_tpu_torch.solver import BaseSolver
    from flashy_tpu_torch.xp import create_xp
    audio, image = _media(2)
    xp = create_xp({"lr": 0.1}, root=tmp_path)

    class Solver(BaseSolver):
        def run(self):
            pass

    with xp.enter():
        solver = Solver()
        solver.init_tensorboard()
        solver.log_hyperparams({"lr": 0.1})
        solver.run_stage("valid", lambda: {"loss": 0.5})
        solver.log_audio("valid", "wave", torch.from_numpy(audio), 8000)
        solver.log_image("valid", "picture", torch.from_numpy(image))
        solver.log_text("valid", "sample", "a b")
        solver.result_logger._experiment_loggers["tensorboard"]._writer.close()
    outputs = xp.folder / "outputs"
    assert json.loads((outputs / "hyperparams.json").read_text()) == \
        {"lr": 0.1}
    assert sorted(p.name for p in (outputs / "valid_1").iterdir()) == \
        ["picture.png", "sample.txt", "wave.wav"]
    events = _read_events(xp.folder / "tensorboard")["."]
    assert events[0]["valid/loss"] == [(1, 0.5)]
    assert set(events[2]) == {"valid/picture"}


def test_backends_raise_where_their_package_is_missing(tmp_path,
                                                       monkeypatch):
    from flashy_tpu_torch.logging import ResultLogger
    from flashy_tpu_torch.loggers import tensorboard, wandb
    from flashy_tpu_torch.xp import create_xp
    for name in ("torch.utils.tensorboard", "tensorboardX", "wandb"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="tensorboard"):
        tensorboard.TensorboardLogger(str(tmp_path / "tb"))
    with pytest.raises(ImportError, match="wandb"):
        wandb.WandbLogger(str(tmp_path))
    with create_xp({"a": 1}, root=tmp_path).enter():
        results = ResultLogger(__import__("logging").getLogger("x"))
        with pytest.raises(ImportError, match="tensorboard"):
            results.init_tensorboard()
        with pytest.raises(ImportError, match="wandb"):
            results.init_wandb(project="p")
        assert list(results._experiment_loggers) == ["local"]


class _FakeRun:
    def __init__(self):
        self.logged = []
        self.config_updates = []
        self.config = types.SimpleNamespace(
            update=lambda params, **kw: self.config_updates.append(params))

    def log(self, data, step=None):
        self.logged.append((data, step))


def _fake_wandb(init_calls, prior=None, paths=None):
    module = types.ModuleType("wandb")

    def init(**kwargs):
        init_calls.append(kwargs)
        return _FakeRun()

    class Api:
        default_entity = "my-team"
        settings = {"project": "default-proj"}

        def run(self, path):
            if paths is not None:
                paths.append(path)
            if prior is None:
                raise RuntimeError("no such run")
            return prior

    module.init = init
    module.Api = Api
    module.Audio = lambda data, sample_rate: ("audio", data.shape,
                                              sample_rate)
    module.Image = lambda data: ("image", data.shape)
    module.Html = lambda text: ("html", text)
    return module


def test_wandb_resumes_the_prior_run_as_the_jax_backend(tmp_path,
                                                        monkeypatch):
    from flashy_tpu.loggers import wandb as jax_wandb
    from flashy_tpu_torch.loggers.wandb import WandbLogger
    from flashy_tpu_torch.xp import create_xp
    prior = types.SimpleNamespace(group="prior-group", name="prior-name",
                                  config={"lr": 0.25})
    calls = {}
    for name in ("jax", "port"):
        xp_module = __import__(f"flashy_{'tpu' if name == 'jax' else 'tpu_torch'}"
                               ".xp", fromlist=["create_xp"])
        xp = (xp_module.create_xp if name == "jax" else create_xp)(
            {"lr": 0.25}, root=tmp_path / name)
        (xp.folder / "wandb_flag").touch()
        init_calls, paths = [], []
        fake = _fake_wandb(init_calls, prior, paths)
        if name == "jax":
            monkeypatch.setattr(jax_wandb, "wandb", fake)
            monkeypatch.setattr(jax_wandb, "_WANDB_AVAILABLE", True)
            with xp.enter():
                jax_wandb.WandbLogger.from_xp(project="proj")
        else:
            monkeypatch.setitem(sys.modules, "wandb", fake)
            with xp.enter():
                backend = WandbLogger.from_xp(project="proj")
            assert backend._run is not None
        (call,) = init_calls
        assert paths == [f"my-team/proj/{xp.sig}"]
        calls[name] = {key: value for key, value in call.items()
                       if key != "dir"}
    assert calls["port"] == calls["jax"]
    assert calls["port"]["id"] and calls["port"]["group"] == "prior-group"
    assert calls["port"]["resume"] == "allow"
    assert calls["port"]["config"] == {"lr": 0.25}


def test_wandb_logs_as_the_jax_backend(tmp_path, monkeypatch):
    from flashy_tpu.loggers import wandb as jax_wandb
    from flashy_tpu_torch.loggers.wandb import WandbLogger
    audio, image = _media(3)
    runs = {}
    for name in ("jax", "port"):
        init_calls = []
        fake = _fake_wandb(init_calls)
        if name == "jax":
            monkeypatch.setattr(jax_wandb, "wandb", fake)
            monkeypatch.setattr(jax_wandb, "_WANDB_AVAILABLE", True)
            backend = jax_wandb.WandbLogger(str(tmp_path / name), run_id="s")
            as_input = np.asarray
        else:
            monkeypatch.setitem(sys.modules, "wandb", fake)
            backend = WandbLogger(str(tmp_path / name), run_id="s")
            as_input = torch.from_numpy
        assert init_calls[0]["resume"] is None
        backend.log_hyperparams({"lr": 0.1, "model": {"dim": 8}},
                                {"final": 1.0})
        backend.log_metrics("train", {"loss": np.float32(0.5)}, step=3)
        backend.log_audio("valid", "wave", as_input(audio), 8000, step=3)
        backend.log_image("valid", "pic", as_input(image), step=3)
        backend.log_text("generate", "sample", "1 2", step=3)
        runs[name] = backend._run
    assert runs["port"].config_updates == runs["jax"].config_updates
    assert runs["port"].logged == runs["jax"].logged
    assert (tmp_path / "port" / "wandb_flag").exists()


def test_wandb_prior_run_lookup_failure_is_tolerated(tmp_path, monkeypatch):
    from flashy_tpu_torch.loggers.wandb import WandbLogger
    paths = []
    monkeypatch.setitem(sys.modules, "wandb", _fake_wandb([], None, paths))
    assert WandbLogger._lookup_prior_run("abc", None) is None
    assert paths == ["my-team/default-proj/abc"]

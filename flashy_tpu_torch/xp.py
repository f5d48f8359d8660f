"""Experiment management: configs, signatures, folders, history (the
port of flashy_tpu/xp.py).

An *XP* is identified by its *signature*, a stable hash of its resolved
configuration minus excluded keys; `compute_sig` is the JAX package's,
so one config has one signature in both packages. All artifacts of a run
(checkpoint, logs, metric history) live in ``<root>/xps/<sig>/``;
re-running the same config resumes the same XP. The port's XPs root in
`./outputs_torch` unless the config names another `dora.dir` / `xp.dir`,
so a port run and a JAX run of one config never share a folder.
"""
import hashlib
import json
import sys
import tempfile
import typing as tp
from contextlib import contextmanager
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from pathlib import Path

import yaml

from .utils import AnyPath, write_and_rename

TODO_WORKERS = ("ROADMAP.md queue A item 5 (multi-process launch on "
                "torch.distributed)")
DEFAULT_ROOT = "./outputs_torch"

# Config sections that configure XP management itself; excluded from the
# signature (`dora.*` is an alias of `xp.*`).
_META_SECTIONS = ("xp", "dora")

HISTORY_NAME = "history.json"
CONFIG_SNAPSHOT_NAME = "config.json"
RUN_INFO_NAME = "run.json"


class Config(dict):
    """A nested dict with attribute access, the config object solvers see
    (`cfg.epochs`, `cfg.model.dim`); plain dict semantics otherwise."""

    def __init__(self, data: tp.Optional[tp.Mapping] = None):
        super().__init__()
        if data:
            for key, value in data.items():
                self[key] = value

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)


def flatten_config(cfg: tp.Mapping, prefix: str = "") -> tp.Dict[str, tp.Any]:
    """Flatten nested config into dotted keys: {'optim.lr': 0.1, ...}."""
    out: tp.Dict[str, tp.Any] = {}
    for key, value in cfg.items():
        dotted = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_config(value, prefix=dotted + "."))
        else:
            out[dotted] = value
    return out


def set_by_path(cfg: Config, dotted: str, value: tp.Any) -> None:
    """Set `cfg[a][b][c] = value` given the dotted path 'a.b.c'."""
    *path, leaf = dotted.split(".")
    node = cfg
    for part in path:
        if part not in node or not isinstance(node[part], dict):
            node[part] = Config()
        node = node[part]
    node[leaf] = value


def parse_overrides(argv: tp.Sequence[str]) -> tp.Dict[str, tp.Any]:
    """Parse `key=value` CLI overrides; values go through YAML typing
    (`lr=1e-3` is a float, `layers=[2,2]` a list). A leading `+` is
    accepted and stripped."""
    overrides: tp.Dict[str, tp.Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"Expected key=value override, got: {arg!r}")
        key, raw = arg.split("=", 1)
        key = key.lstrip("+")
        value = yaml.safe_load(raw) if raw != "" else None
        if isinstance(value, str):
            # YAML 1.1 misses bare scientific notation ('1e-3'); users
            # mean the number.
            try:
                value = int(value)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    pass
        overrides[key] = value
    return overrides


def compute_sig(cfg: tp.Mapping, exclude: tp.Sequence[str] = ()) -> str:
    """Stable signature of a resolved config: flatten to dotted keys, drop
    the XP-meta sections and keys matching an `exclude` pattern (shell
    wildcards), hash the canonical JSON. Identical to the JAX
    package's."""
    flat = flatten_config(cfg)
    kept = {}
    for key, value in sorted(flat.items()):
        if any(key == section or key.startswith(section + ".")
               for section in _META_SECTIONS):
            continue
        if any(fnmatchcase(key, pattern) for pattern in exclude):
            continue
        kept[key] = value
    payload = json.dumps(kept, sort_keys=True, default=str)
    return hashlib.sha1(payload.encode()).hexdigest()[:8]


class Link:
    """The metric history of an XP, persisted as `history.json`: a list
    of per-epoch {stage_name: metrics} dicts, written atomically."""

    def __init__(self, folder: Path):
        self.folder = folder
        self.history: tp.List[tp.Dict[str, tp.Any]] = []

    @property
    def history_path(self) -> Path:
        return self.folder / HISTORY_NAME

    def load(self) -> tp.List[tp.Dict[str, tp.Any]]:
        if self.history_path.exists():
            with open(self.history_path) as f:
                self.history = json.load(f)
        return self.history

    def update_history(self, history: tp.List[tp.Dict[str, tp.Any]]) -> None:
        self.history = list(history)
        with write_and_rename(self.history_path, "w") as f:
            json.dump(self.history, f, indent=2, default=float)


@dataclass
class XP:
    """One experiment: a signature, its config, and its folder."""

    sig: str
    cfg: Config
    folder: Path
    link: Link = field(init=False)
    argv: tp.List[str] = field(default_factory=list)

    def __post_init__(self):
        self.folder.mkdir(parents=True, exist_ok=True)
        self.link = Link(self.folder)
        self.link.load()

    def save_config_snapshot(self) -> None:
        from .distrib import is_rank_zero
        if not is_rank_zero():
            return
        with write_and_rename(self.folder / CONFIG_SNAPSHOT_NAME, "w",
                              pid=True) as f:
            json.dump(self.cfg, f, indent=2, default=str)
        with write_and_rename(self.folder / RUN_INFO_NAME, "w",
                              pid=True) as f:
            json.dump({"argv": self.argv}, f, indent=2)

    @contextmanager
    def enter(self):
        """Make this XP the current one for `get_xp()` lookups."""
        global _current_xp
        previous = _current_xp
        _current_xp = self
        try:
            yield self
        finally:
            _current_xp = previous


_current_xp: tp.Optional[XP] = None


def get_xp() -> XP:
    """The currently active XP. Raises if called outside `XP.enter()`."""
    if _current_xp is None:
        raise RuntimeError(
            "No experiment is active. Use the `flashy_tpu_torch.main` "
            "decorator for your entry point, or `xp.enter()` explicitly.")
    return _current_xp


def is_xp_active() -> bool:
    """Whether an XP is active (`get_xp()` would return one)."""
    return _current_xp is not None


def create_xp(cfg: tp.Mapping, root: tp.Optional[AnyPath] = None,
              argv: tp.Optional[tp.List[str]] = None) -> XP:
    """Build an XP from a resolved config. Its root is `root`, else
    `cfg.xp.dir` / `cfg.dora.dir`, else `./outputs_torch`; exclude
    patterns come from `cfg.xp.exclude` / `cfg.dora.exclude`."""
    cfg = Config(cfg)
    meta: tp.Dict[str, tp.Any] = {}
    for section in _META_SECTIONS:
        if section in cfg and isinstance(cfg[section], dict):
            meta.update(cfg[section])
    folder_root = Path(root or meta.get("dir") or DEFAULT_ROOT)
    sig = compute_sig(cfg, meta.get("exclude") or [])
    xp = XP(sig=sig, cfg=cfg, folder=folder_root / "xps" / sig,
            argv=list(argv or []))
    xp.save_config_snapshot()
    return xp


def get_xp_from_sig(sig: str, root: tp.Optional[AnyPath] = None) -> XP:
    """Re-attach to an existing XP by its signature (notebooks, eval
    scripts): its config is the snapshot its first run saved. The root
    is `root`, else `./outputs_torch`; a signature with no snapshot
    there raises FileNotFoundError."""
    folder_root = Path(root or DEFAULT_ROOT)
    folder = folder_root / "xps" / sig
    snapshot = folder / CONFIG_SNAPSHOT_NAME
    if not snapshot.exists():
        raise FileNotFoundError(f"No XP with sig {sig} under {folder_root}")
    with open(snapshot) as f:
        cfg = Config(json.load(f))
    return XP(sig=sig, cfg=cfg, folder=folder)


class _EntryPoint:
    """What the `main` decorator returns: the script entry point, which
    also offers `get_xp(argv)`, `get_xp_from_sig(sig)` and a `.dir`
    override of the XP root."""

    def __init__(self, fn: tp.Callable, config_path: tp.Optional[str],
                 config_name: str):
        self.fn = fn
        self.config_name = config_name
        module_file = sys.modules[fn.__module__].__file__
        base = Path(module_file).parent if module_file else Path.cwd()
        self.config_path = (base / config_path) if config_path else None
        self.dir: tp.Optional[AnyPath] = None
        self.__name__ = fn.__name__
        self.__doc__ = fn.__doc__

    def _resolve(self, argv: tp.Sequence[str]
                 ) -> tp.Tuple[Config, tp.List[str]]:
        flags = [a for a in argv if a.startswith("-")]
        overrides = [a for a in argv if not a.startswith("-")]
        cfg = Config()
        if self.config_path is not None:
            with open(self.config_path / f"{self.config_name}.yaml") as f:
                cfg = Config(yaml.safe_load(f) or {})
        for key, value in parse_overrides(overrides).items():
            set_by_path(cfg, key, value)
        return cfg, flags

    def _usage(self) -> str:
        lines = [f"usage: {sys.argv[0]} [--clear] [key=value ...]", "",
                 "  key=value      override a config key (YAML-typed; "
                 "nested via dots)",
                 "  --clear        delete this config's XP folder and "
                 "start fresh"]
        if self.config_path is not None:
            lines.append(f"  config: {self.config_path / (self.config_name + '.yaml')}")
        if self.fn.__doc__:
            lines = [self.fn.__doc__.strip(), ""] + lines
        return "\n".join(lines)

    def get_xp(self, argv: tp.Optional[tp.Sequence[str]] = None) -> XP:
        cfg, _ = self._resolve(list(argv or []))
        return create_xp(cfg, root=self.dir, argv=list(argv or []))

    def get_xp_from_sig(self, sig: str) -> XP:
        return get_xp_from_sig(sig, root=self.dir)

    def __call__(self, argv: tp.Optional[tp.Sequence[str]] = None):
        argv = list(sys.argv[1:] if argv is None else argv)
        if "--help" in argv or "-h" in argv:
            print(self._usage())
            return None
        cfg, flags = self._resolve(argv)
        for flag in flags:
            if flag.startswith(("--workers=", "--ddp_workers=")):
                raise NotImplementedError(
                    f"{flag}: multi-process launch is not ported yet: "
                    f"{TODO_WORKERS}")
        xp = create_xp(cfg, root=self.dir, argv=argv)
        if "--clear" in flags:
            import shutil
            shutil.rmtree(xp.folder, ignore_errors=True)
            xp = create_xp(cfg, root=self.dir, argv=argv)
        with xp.enter():
            return self.fn(xp.cfg)


def main(config_path: tp.Optional[str] = None, config_name: str = "config"
         ) -> tp.Callable[[tp.Callable], _EntryPoint]:
    """Entry-point decorator: the config is `<config_path>/<config_name>
    .yaml` beside the decorated function's module, overridden by
    `key=value` arguments; `--clear` starts the XP afresh. The decorated
    function gets the resolved config and runs inside its XP; what it
    returns, the call returns."""

    def decorator(fn: tp.Callable) -> _EntryPoint:
        return _EntryPoint(fn, config_path, config_name)

    return decorator


# the reference's entry-point name
hydra_main = main


@contextmanager
def temporary_xp(cfg: tp.Optional[tp.Mapping] = None):
    """Create and enter a throwaway XP in a temp dir (tests, notebooks)."""
    with tempfile.TemporaryDirectory() as tmp:
        xp = create_xp(Config(cfg or {}), root=tmp)
        with xp.enter():
            yield xp

"""Experiment logger backends: the local filesystem one (always on), and
TensorBoard and wandb, each importing its package when a logger is built
(`ResultLogger.init_tensorboard` / `init_wandb`)."""
from .base import ExperimentLogger  # noqa: F401
from .localfs import LocalFSLogger  # noqa: F401

"""Experiment logger backends: the local filesystem one. TensorBoard and
wandb are not ported yet (`ResultLogger.init_tensorboard` /
`init_wandb` raise)."""
from .base import ExperimentLogger  # noqa: F401
from .localfs import LocalFSLogger  # noqa: F401

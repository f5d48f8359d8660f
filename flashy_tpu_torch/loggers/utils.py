"""Helpers shared by the logger backends: prefix joining, params
conversion, dict flattening and sanitization of values trackers do not
take (the port of flashy_tpu/loggers/utils.py)."""
from argparse import Namespace
import typing as tp

import numpy as np

Prefix = tp.Union[str, tp.List[str]]


def join_prefix(prefix: Prefix, name: str = "", separator: str = "/") -> str:
    """Join prefix group(s) and a trailing name into a metric path.

    >>> join_prefix(['train', 'gen'], 'loss')
    'train/gen/loss'
    """
    parts = [prefix] if isinstance(prefix, str) else list(prefix)
    if name:
        parts.append(name)
    return separator.join(part for part in parts if part)


def add_prefix(metrics: tp.Dict[str, tp.Any], prefix: Prefix,
               separator: str = "/") -> tp.Dict[str, tp.Any]:
    """Prefix every metric key: {'loss': 1} -> {'train/loss': 1}."""
    return {join_prefix(prefix, key, separator): value
            for key, value in metrics.items()}


def convert_params(params: tp.Union[tp.Dict[str, tp.Any], Namespace, None]
                   ) -> tp.Dict[str, tp.Any]:
    """Accept a dict or argparse Namespace; always return a dict."""
    if params is None:
        return {}
    if isinstance(params, Namespace):
        return vars(params)
    return dict(params)


def flatten_dict(params: tp.Dict[str, tp.Any], delimiter: str = "/"
                 ) -> tp.Dict[str, tp.Any]:
    """Flatten nested dicts into delimiter-joined keys.

    >>> flatten_dict({'a': {'b': 1, 'c': {'d': 2}}})
    {'a/b': 1, 'a/c/d': 2}
    """
    out: tp.Dict[str, tp.Any] = {}
    for key, value in params.items():
        if isinstance(value, dict) and value:
            for sub_key, sub_value in flatten_dict(value, delimiter).items():
                out[f"{key}{delimiter}{sub_key}"] = sub_value
        else:
            out[str(key)] = value
    return out


def sanitize_params(params: tp.Dict[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """Coerce values to types experiment trackers accept: zero-dim
    tensors and numpy scalars become Python scalars; bools, numbers,
    strings and None pass through; everything else is stringified."""
    out: tp.Dict[str, tp.Any] = {}
    for key, value in params.items():
        if hasattr(value, "item") and callable(value.item) \
                and np.ndim(value) == 0:
            out[key] = value.item()
        elif isinstance(value, (bool, int, float, str)) or value is None:
            out[key] = value
        else:
            out[key] = str(value)
    return out


def to_numpy_media(value: tp.Any) -> np.ndarray:
    """A tensor (on any device), array or list as a numpy array."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)

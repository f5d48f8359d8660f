"""Formatter: decides which metrics are displayed and how they are
formatted. The port of flashy_tpu/formatter.py, unchanged: pattern-based
(shell wildcard) format specs, include/exclude with whitelist/blacklist
semantics, implicit include of explicitly-formatted keys."""
import typing as tp
from fnmatch import fnmatchcase


class Formatter:
    """Formatting rules for metric display in logs.

    Every argument is pattern based: `'acc*'` matches all metrics whose
    name starts with `acc`. Calling the formatter on a dict of metrics
    returns the relevant subset, formatted as strings.

    Args:
        formats: mapping pattern -> format spec (as given to `format()`)
            OR a callable `value -> str` for renderings a format spec
            cannot express (percentages, unit suffixes).
            The first matching pattern wins.
        default_format: spec applied to metrics matching no pattern.
        exclude_keys: patterns to hide. If only `exclude_keys` is given
            this acts as a blacklist. If both lists are given, keys are
            first excluded then included back.
        include_keys: patterns to show. If only `include_keys` is given,
            everything else is hidden (whitelist).
        include_formatted: when True (default), any key with an explicit
            entry in `formats` counts as included.
    """

    def __init__(self, formats: tp.Optional[tp.Dict[str, str]] = None,
                 default_format: str = ".3f",
                 exclude_keys: tp.Sequence[str] = (),
                 include_keys: tp.Sequence[str] = (),
                 include_formatted: bool = True):
        self.formats = dict(formats or {})
        self.default_format = default_format
        self.exclude_keys = list(exclude_keys)
        self.include_keys = list(include_keys)
        self.include_formatted = include_formatted

    def _matches_any(self, key: str, patterns: tp.Sequence[str]) -> bool:
        return any(fnmatchcase(key, pattern) for pattern in patterns)

    def _is_included(self, key: str) -> bool:
        patterns = list(self.include_keys)
        if self.include_formatted:
            patterns += list(self.formats.keys())
        return self._matches_any(key, patterns)

    def _format_spec(self, key: str) -> str:
        for pattern, spec in self.formats.items():
            if fnmatchcase(key, pattern):
                return spec
        return self.default_format

    def get_relevant_metrics(self, metrics: dict) -> dict:
        def keep(key: str) -> bool:
            if self.exclude_keys:
                # blacklist first, then include back whitelisted keys
                return not self._matches_any(key, self.exclude_keys) or self._is_included(key)
            if self.include_keys:
                return self._is_included(key)
            return True

        return {k: v for k, v in metrics.items() if keep(k)}

    def __call__(self, metrics: dict) -> tp.Dict[str, str]:
        relevant = self.get_relevant_metrics(metrics)
        out = {}
        for k, v in relevant.items():
            spec = self._format_spec(k)
            out[k] = str(spec(v)) if callable(spec) else format(v, spec)
        return out

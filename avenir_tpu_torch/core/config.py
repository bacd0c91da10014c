"""Job configuration — Java-properties-compatible key/value config.

The reference drives every job from a ``.properties`` file passed as
``-Dconf.path=...`` and loaded into the Hadoop ``Configuration``
(chombo ``Utility.setConfiguration``, called in every job ``run()``, e.g.
bayesian/BayesianDistribution.java:68). Keys are dotted names with optional
system prefixes; values are strings with typed getters and defaults (chombo
``ConfigUtility``).

This module keeps that two-artifact contract (properties + JSON feature
schema) so a reference user's config carries over: the same property names are
honored by the jobs (``field.delim.regex``, ``stream.chunk.rows``,
``feature.schema.file.path``, ...).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional


class ConfigError(ValueError):
    """A deterministic configuration/schema error: the same inputs will
    fail the same way."""


class JobConfig:
    """Parsed properties file with typed getters.

    ``prefix`` mirrors the reference's behavior of accepting keys both bare
    and namespaced (``avenir.some.key`` == ``some.key``).
    """

    def __init__(self, props: Optional[Dict[str, str]] = None, prefix: str = "avenir"):
        self.props: Dict[str, str] = dict(props or {})
        self.prefix = prefix

    # -- construction --------------------------------------------------------
    @classmethod
    def from_file(cls, path: str, prefix: str = "avenir") -> "JobConfig":
        with open(path, "r") as fh:
            return cls.from_lines(fh, prefix=prefix)

    @classmethod
    def from_lines(cls, lines: Iterable[str], prefix: str = "avenir") -> "JobConfig":
        props: Dict[str, str] = {}
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("!"):
                continue
            # Java Properties rule: split at the FIRST '=' or ':' in the line
            cut = min((i for i in (line.find("="), line.find(":")) if i >= 0), default=-1)
            if cut >= 0:
                props[line[:cut].strip()] = line[cut + 1:].strip()
        return cls(props, prefix=prefix)

    # -- lookup --------------------------------------------------------------
    def _lookup(self, key: str) -> Optional[str]:
        if key in self.props:
            return self.props[key]
        pref = f"{self.prefix}.{key}"
        if pref in self.props:
            return self.props[pref]
        if key.startswith(f"{self.prefix}.") and key[len(self.prefix) + 1:] in self.props:
            return self.props[key[len(self.prefix) + 1:]]
        return None

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        val = self._lookup(key)
        return default if val is None else val

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        val = self._lookup(key)
        return default if val is None or val == "" else int(val)

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        val = self._lookup(key)
        return default if val is None or val == "" else float(val)

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self._lookup(key)
        if val is None or val == "":
            return default
        return val.strip().lower() in ("true", "1", "yes", "on")

    def get_list(self, key: str, default: Optional[List[str]] = None, delim: str = ",") -> Optional[List[str]]:
        val = self._lookup(key)
        if val is None or val == "":
            return default
        return [v.strip() for v in val.split(delim)]

    def get_int_list(self, key: str, default: Optional[List[int]] = None, delim: str = ",") -> Optional[List[int]]:
        vals = self.get_list(key, None, delim)
        return default if vals is None else [int(v) for v in vals]

    def get_float_list(self, key: str, default: Optional[List[float]] = None, delim: str = ",") -> Optional[List[float]]:
        vals = self.get_list(key, None, delim)
        return default if vals is None else [float(v) for v in vals]

    def set(self, key: str, value: Any) -> "JobConfig":
        self.props[key] = str(value)
        return self

    # -- common keys ---------------------------------------------------------
    @property
    def field_delim(self) -> str:
        return self.get("field.delim", ",")

    @property
    def field_delim_regex(self) -> str:
        return self.get("field.delim.regex", ",")

"""Typed parameter maps — the config backbone.

Reference: include/core_api/params.h `paraMap_t` (SURVEY §5.6): string-keyed
tagged-union dicts; every factory validates/defaults its own keys; unknown
params warn + default, renders never hard-fail.  The XML schema and the flat
API both funnel into these maps, so keeping this one class authoritative
keeps XML / CLI / Python API in lockstep.
"""
from __future__ import annotations

import logging
from typing import Any, Iterable

log = logging.getLogger("libyafaray_tpu_torch")


class ParamMap(dict):
    """String->value map with typed getters that warn-and-default.

    Values: int, float, bool, str, 3/4-tuple color, 3-tuple point,
    16-float matrix (as tuple), or list (for shader-node list params).
    """

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self._get(key, default, (int, float, bool)))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self._get(key, default, (int, float, bool)))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._get(key, default, (bool, int, str))
        if isinstance(v, str):
            return v.lower() in ("true", "1", "yes", "on")
        return bool(v)

    def get_str(self, key: str, default: str = "") -> str:
        return str(self._get(key, default, (str,)))

    def get_color(self, key: str, default=(0.0, 0.0, 0.0, 1.0)):
        v = self._get(key, default, (tuple, list))
        v = tuple(float(x) for x in v)
        if len(v) == 3:
            v = v + (1.0,)
        return v[:4]

    def get_rgb(self, key: str, default=(0.0, 0.0, 0.0)):
        return self.get_color(key, tuple(default) + (1.0,))[:3]

    def get_point(self, key: str, default=(0.0, 0.0, 0.0)):
        v = self._get(key, default, (tuple, list))
        return tuple(float(x) for x in v)[:3]

    def get_matrix(self, key: str, default=None):
        if default is None:
            default = tuple(
                1.0 if i % 5 == 0 else 0.0 for i in range(16)
            )  # identity
        v = self._get(key, default, (tuple, list))
        return tuple(float(x) for x in v)[:16]

    def get_list(self, key: str, default: Iterable | None = None) -> list:
        v = self._get(key, list(default or []), (list, tuple))
        return list(v)

    def _get(self, key: str, default: Any, types) -> Any:
        if key not in self:
            return default
        v = self[key]
        if types and not isinstance(v, types):
            log.warning("param %r has unexpected type %s; using default %r",
                        key, type(v).__name__, default)
            return default
        return v

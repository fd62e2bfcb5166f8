"""Typed graph-unit parameters: ``Parameter{name, value, type}`` lists
parsed by declared type, as the JAX package's
``contract/parameters.py``
does."""

from __future__ import annotations

from typing import Any

_PARSERS = {
    "STRING": str,
    "INT": int,
    "FLOAT": float,
    "DOUBLE": float,
    "BOOL": lambda v: str(v).lower() in ("true", "1", "yes"),
}


class ParameterError(ValueError):
    pass


def parse_parameters(params: list[dict[str, Any]] | None) -> dict[str, Any]:
    """``[{"name": .., "value": .., "type": ..}]`` -> ``{name: typed_value}``."""
    out: dict[str, Any] = {}
    for p in params or []:
        name = p.get("name")
        if not name:
            raise ParameterError(f"parameter missing name: {p!r}")
        ptype = p.get("type", "STRING")
        parser = _PARSERS.get(ptype)
        if parser is None:
            raise ParameterError(f"unknown parameter type {ptype!r} for {name!r}")
        try:
            out[name] = parser(p.get("value"))
        except (TypeError, ValueError) as e:
            raise ParameterError(f"cannot parse {name!r} as {ptype}: {e}") from e
    return out

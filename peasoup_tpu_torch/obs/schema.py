"""JSON Schema validation without a jsonschema dependency: the port's copy
of the JAX package's obs/schema.py (the small draft-07 subset its schemas
use: ``type`` with union lists, ``const``, ``enum``, ``minimum``,
``required``, ``properties``, ``additionalProperties`` and ``items``). The
telemetry manifest (:func:`validate_manifest`, against the port's copy of
the JAX package's ``manifest.schema.json``), the metrics samples, the sift
report and the rank model artifact are checked with it.
"""

from __future__ import annotations

import json
import os

SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "manifest.schema.json")

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "number": (int, float),
    "boolean": bool,
    "null": type(None),
}


class SchemaError(ValueError):
    """A document violated its schema."""


def _type_ok(value, name: str) -> bool:
    py = _TYPES.get(name)
    if py is None:
        raise SchemaError(f"schema uses unsupported type {name!r}")
    if isinstance(value, bool) and name in ("integer", "number"):
        return False  # bool is an int subclass; JSON types disagree
    return isinstance(value, py)


def validate(instance, schema: dict, path: str = "$") -> None:
    """Validate ``instance`` against the supported draft-07 subset,
    raising :class:`SchemaError` (with a JSON path) on the first
    violation."""
    if "const" in schema and instance != schema["const"]:
        raise SchemaError(
            f"{path}: expected const {schema['const']!r}, "
            f"got {instance!r}"
        )
    if "enum" in schema and instance not in schema["enum"]:
        raise SchemaError(
            f"{path}: {instance!r} not one of {schema['enum']!r}"
        )
    t = schema.get("type")
    if t is not None:
        names = t if isinstance(t, list) else [t]
        if not any(_type_ok(instance, n) for n in names):
            raise SchemaError(
                f"{path}: expected type {'/'.join(names)}, "
                f"got {type(instance).__name__}"
            )
    if isinstance(instance, (int, float)) and not isinstance(
        instance, bool
    ):
        if "minimum" in schema and instance < schema["minimum"]:
            raise SchemaError(
                f"{path}: {instance!r} < minimum {schema['minimum']!r}"
            )
    if isinstance(instance, dict):
        for key in schema.get("required", ()):
            if key not in instance:
                raise SchemaError(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in instance:
                validate(instance[key], sub, f"{path}.{key}")
        extra = schema.get("additionalProperties")
        if extra is False:
            unknown = set(instance) - set(props)
            if unknown:
                raise SchemaError(
                    f"{path}: unexpected keys {sorted(unknown)!r}"
                )
        elif isinstance(extra, dict):
            for key, val in instance.items():
                if key not in props:
                    validate(val, extra, f"{path}.{key}")
    if isinstance(instance, list):
        items = schema.get("items")
        if isinstance(items, dict):
            for i, val in enumerate(instance):
                validate(val, items, f"{path}[{i}]")


def load_schema() -> dict:
    with open(SCHEMA_PATH) as f:
        return json.load(f)


def validate_manifest(man: dict) -> None:
    """Validate a telemetry manifest dict against the port's copy of the
    manifest schema (raises :class:`SchemaError` on violation)."""
    validate(man, load_schema())

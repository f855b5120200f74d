"""Validate telemetry artifacts against the schemas in this package.

``python -m repro_torch.obs.validate <path>...``: ``*.jsonl`` files validate
line by line against ``event_schema.json``, ``*.json`` files against
``manifest_schema.json``.  Exit status 0 iff everything conforms.

The validator is a deliberate *subset* of JSON Schema in ~80 lines, so it
needs no ``jsonschema`` package: ``type`` (string or list), ``required``,
``properties``, ``items``, ``enum``, and ``allOf`` branches guarded by the
custom ``if_kind`` keyword (the branch applies when the instance's
``"kind"`` equals it).  Unknown keys in instances are allowed: events are
open for extension; the schema pins the invariants, not the universe.

The event schema is the JAX package's, byte for byte; the manifest schema
differs in a session's ``environment`` block only, which describes a
PyTorch process (``torch_version``, ``cuda_version``, ``power_limit_w``).
"""
from __future__ import annotations

import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
EVENT_SCHEMA_PATH = os.path.join(_HERE, "event_schema.json")
MANIFEST_SCHEMA_PATH = os.path.join(_HERE, "manifest_schema.json")

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value, tname: str) -> bool:
    if tname == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if tname == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    return isinstance(value, _TYPES[tname])


def check(instance, schema: dict, path: str = "$") -> list:
    """All violations of ``schema`` by ``instance`` (empty list = valid)."""
    errors = []
    typ = schema.get("type")
    if typ is not None:
        names = typ if isinstance(typ, list) else [typ]
        if not any(_type_ok(instance, t) for t in names):
            return [f"{path}: expected type {typ}, got "
                    f"{type(instance).__name__}"]
    enum = schema.get("enum")
    if enum is not None and instance not in enum:
        errors.append(f"{path}: {instance!r} not in {enum}")
    if isinstance(instance, dict):
        for key in schema.get("required", ()):
            if key not in instance:
                errors.append(f"{path}: missing required key {key!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in instance:
                errors.extend(check(instance[key], sub, f"{path}.{key}"))
    if isinstance(instance, list):
        items = schema.get("items")
        if items is not None:
            for i, v in enumerate(instance):
                errors.extend(check(v, items, f"{path}[{i}]"))
    for branch in schema.get("allOf", ()):
        guard = branch.get("if_kind")
        if guard is not None and (not isinstance(instance, dict)
                                  or instance.get("kind") != guard):
            continue
        sub = {k: v for k, v in branch.items() if k != "if_kind"}
        errors.extend(check(instance, sub, path))
    return errors


def _load_schema(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate_events(path: str) -> list:
    """Violations across every line of a JSONL event file."""
    schema = _load_schema(EVENT_SCHEMA_PATH)
    errors = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"{path}:{lineno}: not JSON ({e})")
                continue
            errors.extend(f"{path}:{lineno}: {e}"
                          for e in check(event, schema))
    return errors


def validate_manifest(path: str) -> list:
    schema = _load_schema(MANIFEST_SCHEMA_PATH)
    try:
        with open(path) as f:
            data = json.load(f)
    except json.JSONDecodeError as e:
        return [f"{path}: not JSON ({e})"]
    return [f"{path}: {e}" for e in check(data, schema)]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro_torch.obs.validate <events.jsonl|"
              "run_manifest.json>...", file=sys.stderr)
        return 2
    errors = []
    for path in argv:
        if path.endswith(".jsonl"):
            errors.extend(validate_events(path))
        else:
            errors.extend(validate_manifest(path))
    for e in errors:
        print(e, file=sys.stderr)
    print(f"{'FAIL' if errors else 'ok'}: {len(argv)} file(s), "
          f"{len(errors)} violation(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

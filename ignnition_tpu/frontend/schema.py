"""Structural (JSON-Schema) validation of a model description.

Re-expresses the DSL grammar the reference validates via
`code/utils/schema.json` (draft-07, 491 lines): entities, message_passing
stages, readout pipeline, neural_networks, learning_options. Authored fresh
as a Python dict; semantics match the reference's constraints (same enums,
same conditional requirements) so any model description accepted there is
accepted here. `validate_structure` checks it with a small built-in
validator covering exactly the draft-07 keywords MODEL_SCHEMA uses, so the
package needs no JSON-Schema library.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional

_STRING = {"type": "string"}
_POSITIVE_NUMBER = {"type": "number", "exclusiveMinimum": 0}

_FEATURE = {
    "type": "object",
    "properties": {
        "name": _STRING,
        "normalization": _STRING,
    },
    "required": ["name"],
}

_ENTITY = {
    "type": "object",
    "properties": {
        "name": _STRING,
        "hidden_state_dimension": _POSITIVE_NUMBER,
        "features": {"type": "array", "items": _FEATURE},
    },
    "required": ["name", "hidden_state_dimension", "features"],
}

_MESSAGE_OP = {
    "type": "object",
    "properties": {
        "type": {"type": "string", "enum": ["neural_network", "direct_assignation"]},
        "nn_name": _STRING,
        "input": {"type": "array", "items": _STRING},
        "output_name": _STRING,
    },
    "required": ["type"],
    "if": {"properties": {"type": {"const": "neural_network"}}},
    "then": {"required": ["nn_name", "input"]},
}

_SOURCE_ENTITY = {
    "type": "object",
    "properties": {
        "name": _STRING,
        "adj_vector": _STRING,
        "message": {"type": "array", "items": _MESSAGE_OP},
    },
    "required": ["name", "adj_vector", "message"],
}

_AGGREGATION = {
    "type": "object",
    "properties": {
        "type": {
            "type": "string",
            "enum": ["sum", "ordered", "attention", "concat", "interleave", "convolution"],
        },
        "concat_axis": {"type": "integer", "enum": [1, 2]},
        "interleave_definition": _STRING,
        "activation_function": _STRING,
    },
    "allOf": [
        {
            "if": {"properties": {"type": {"const": "interleave"}}},
            "then": {"required": ["interleave_definition"]},
        },
        {
            "if": {"properties": {"type": {"const": "concat"}}},
            "then": {"required": ["concat_axis"]},
        },
    ],
    "required": ["type"],
}

_UPDATE = {
    "type": "object",
    "properties": {
        "type": {
            "type": "string",
            "enum": ["neural_network", "recurrent_neural_network"],
        },
        "nn_name": _STRING,
    },
    "required": ["type", "nn_name"],
}

_MESSAGE_PASSING = {
    "type": "object",
    "properties": {
        "destination_entity": _STRING,
        "source_entities": {"type": "array", "items": _SOURCE_ENTITY, "minItems": 1},
        "aggregation": _AGGREGATION,
        "update": _UPDATE,
    },
    "required": ["source_entities", "destination_entity", "aggregation", "update"],
}

_STAGE = {
    "type": "object",
    "properties": {
        "stage_name": _STRING,
        "stage_mp": {"type": "array", "items": _MESSAGE_PASSING, "minItems": 1},
    },
    "required": ["stage_name", "stage_mp"],
}

_READOUT_OP = {
    "type": "object",
    "properties": {
        "type": {
            "type": "string",
            "enum": ["predict", "pooling", "product", "neural_network", "extend_adjacencies"],
        },
        "type_pooling": {"type": "string", "enum": ["sum", "max", "mean"]},
        "type_product": {"type": "string", "enum": ["dot_product", "element_wise"]},
        "input": {"type": "array", "items": _STRING},
        "label": _STRING,
        "label_normalization": _STRING,
        "label_denormalization": _STRING,
        "nn_name": _STRING,
        "output_name": _STRING,
        "output_name_src": _STRING,
        "output_name_dst": _STRING,
        "adj_list": _STRING,
    },
    "allOf": [
        {
            "if": {"properties": {"type": {"const": "predict"}}},
            "then": {"required": ["nn_name", "label"]},
        },
        {
            "if": {"properties": {"type": {"const": "pooling"}}},
            "then": {"required": ["type_pooling", "output_name"]},
        },
        {
            "if": {"properties": {"type": {"const": "product"}}},
            "then": {"required": ["type_product", "output_name"]},
        },
        {
            "if": {"properties": {"type": {"const": "neural_network"}}},
            "then": {"required": ["nn_name", "output_name"]},
        },
        {
            "if": {"properties": {"type": {"const": "extend_adjacencies"}}},
            "then": {"required": ["adj_list", "output_name_src", "output_name_dst"]},
        },
    ],
    "required": ["input", "type"],
}

_NN_LAYER = {
    "type": "object",
    "properties": {
        "type_layer": _STRING,
        "name": _STRING,
    },
    "required": ["type_layer"],
}

_NEURAL_NETWORK = {
    "type": "object",
    "properties": {
        "nn_name": _STRING,
        "nn_type": {
            "type": "string",
            "enum": ["feed_forward", "recurrent_neural_network"],
        },
        "recurrent_type": {"type": "string", "enum": ["GRU", "LSTM"]},
        "nn_architecture": {"type": "array", "items": _NN_LAYER},
    },
    "required": ["nn_name", "nn_type"],
    "if": {"properties": {"nn_type": {"const": "feed_forward"}}},
    "then": {"required": ["nn_architecture"]},
    "else": {"required": ["recurrent_type"]},
}

_LEARNING_OPTIONS = {
    "type": "object",
    "properties": {
        "loss": _STRING,
        "optimizer": {
            "type": "object",
            "properties": {
                "type": _STRING,
                "schedule": {
                    "type": "object",
                    "properties": {"type": _STRING},
                },
            },
        },
    },
    "required": ["loss", "optimizer"],
}

MODEL_SCHEMA: Mapping[str, Any] = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "title": "ignnition_tpu model description",
    "type": "object",
    "properties": {
        "entities": {"type": "array", "items": _ENTITY, "minItems": 1},
        "message_passing": {
            "type": "object",
            "properties": {
                "num_iterations": _POSITIVE_NUMBER,
                "stages": {"type": "array", "items": _STAGE, "minItems": 1},
            },
            "required": ["num_iterations", "stages"],
        },
        "readout": {"type": "array", "items": _READOUT_OP, "minItems": 1},
        "neural_networks": {"type": "array", "items": _NEURAL_NETWORK},
        "learning_options": _LEARNING_OPTIONS,
    },
    "required": ["entities", "message_passing", "readout", "neural_networks", "learning_options"],
}


class ModelDescriptionError(ValueError):
    """A user-facing model-description error (schema or semantic).

    Replaces the reference's `IGNNITION: ...` + sys.exit(1) pattern
    (json_operations.py:243-245) with a raised exception carrying the same
    friendly message.
    """


class _SchemaViolation(Exception):
    def __init__(self, message: str, path: List[Any]):
        super().__init__(message)
        self.message = message
        self.path = path


def _is_type(instance: Any, kind: str) -> bool:
    if kind == "object":
        return isinstance(instance, Mapping)
    if kind == "array":
        return isinstance(instance, list)
    if kind == "string":
        return isinstance(instance, str)
    if kind == "boolean":
        return isinstance(instance, bool)
    if isinstance(instance, bool):  # JSON booleans are not numbers
        return False
    if kind == "number":
        return isinstance(instance, (int, float))
    if kind == "integer":
        return isinstance(instance, int) or (
            isinstance(instance, float) and instance.is_integer()
        )
    raise ValueError(f"unsupported schema type '{kind}'")


def _first_violation(
    instance: Any, schema: Mapping[str, Any], path: List[Any]
) -> Optional[_SchemaViolation]:
    """The first draft-07 violation of `schema` by `instance` (messages in
    the jsonschema library's wording), or None. Covers the keywords
    MODEL_SCHEMA uses: type, properties, required, enum, const, items,
    minItems, exclusiveMinimum, allOf and if/then/else."""
    kind = schema.get("type")
    if kind is not None and not _is_type(instance, kind):
        return _SchemaViolation(f"{instance!r} is not of type {kind!r}", path)
    if "const" in schema and instance != schema["const"]:
        return _SchemaViolation(f"{schema['const']!r} was expected", path)
    if "enum" in schema and instance not in schema["enum"]:
        return _SchemaViolation(
            f"{instance!r} is not one of {list(schema['enum'])!r}", path
        )
    if "exclusiveMinimum" in schema and _is_type(instance, "number"):
        lo = schema["exclusiveMinimum"]
        if instance <= lo:
            return _SchemaViolation(
                f"{instance!r} is less than or equal to the minimum of {lo!r}",
                path,
            )
    if isinstance(instance, list):
        n_min = schema.get("minItems")
        if n_min is not None and len(instance) < n_min:
            msg = (
                f"{instance!r} should be non-empty" if n_min == 1
                else f"{instance!r} is too short"
            )
            return _SchemaViolation(msg, path)
        if "items" in schema:
            for i, item in enumerate(instance):
                v = _first_violation(item, schema["items"], path + [i])
                if v is not None:
                    return v
    if isinstance(instance, Mapping):
        for key in schema.get("required", ()):
            if key not in instance:
                return _SchemaViolation(f"{key!r} is a required property", path)
        for key, sub in schema.get("properties", {}).items():
            if key in instance:
                v = _first_violation(instance[key], sub, path + [key])
                if v is not None:
                    return v
    for sub in schema.get("allOf", ()):
        v = _first_violation(instance, sub, path)
        if v is not None:
            return v
    if "if" in schema:
        branch = (
            schema.get("then")
            if _first_violation(instance, schema["if"], path) is None
            else schema.get("else")
        )
        if branch is not None:
            return _first_violation(instance, branch, path)
    return None


def validate_structure(data: Mapping[str, Any]) -> None:
    v = _first_violation(data, MODEL_SCHEMA, [])
    if v is not None:
        path = "/".join(str(p) for p in v.path)
        raise ModelDescriptionError(
            f"model description failed schema validation at '{path}': {v.message}"
        )

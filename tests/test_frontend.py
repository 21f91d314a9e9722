import pytest

from ignnition_tpu.frontend import parser
from ignnition_tpu.frontend.schema import ModelDescriptionError

from helpers import routenet_description, qsize_description


def test_parse_routenet():
    ir = parser.parse_model_description(
        routenet_description(), dimensions={"link_capacity": 1, "traffic": 1}
    )
    assert ir.entity_names == ("link", "path")
    assert ir.num_iterations == 4
    assert len(ir.stages) == 2
    mp1 = ir.stages[0].passes[0]
    assert mp1.destination == "path"
    assert mp1.aggregation.kind == "ordered"
    assert mp1.update.kind == "recurrent"
    assert mp1.update.rnn.cell_type == "GRU"
    info = ir.adjacency_info()
    assert [(a.name, a.src, a.dst) for a in info] == [
        ("adj_links_paths", "link", "path"),
        ("adj_paths_links", "path", "link"),
    ]
    label, norm, denorm = ir.output_info()
    assert label == "delay" and norm == "log" and denorm is None
    assert ir.learning.loss == "MeanSquaredError"
    assert ir.learning.optimizer.kind == "Adam"
    assert ir.learning.optimizer.schedule.kind == "ExponentialDecay"


def test_parse_qsize_interleave():
    ir = parser.parse_model_description(qsize_description())
    assert ir.interleave_specs() == (("path_interleave", "path"),)
    assert set(ir.interleave_sources()) == {("link", "path"), ("node", "path")}


def test_unknown_entity_rejected():
    d = routenet_description()
    d["message_passing"]["stages"][0]["stage_mp"][0]["destination_entity"] = "nope"
    with pytest.raises(ModelDescriptionError, match="nope"):
        parser.parse_model_description(d)


def test_unknown_nn_rejected():
    d = routenet_description()
    d["message_passing"]["stages"][0]["stage_mp"][0]["update"]["nn_name"] = "ghost"
    with pytest.raises(ModelDescriptionError, match="ghost"):
        parser.parse_model_description(d)


def test_schema_rejects_bad_aggregation():
    d = routenet_description()
    d["message_passing"]["stages"][0]["stage_mp"][0]["aggregation"]["type"] = "median"
    with pytest.raises(ModelDescriptionError):
        parser.parse_model_description(d)


def test_message_input_must_be_produced():
    d = routenet_description()
    d["neural_networks"].append(
        {
            "nn_name": "msg_nn",
            "nn_type": "feed_forward",
            "nn_architecture": [{"type_layer": "Dense", "units": 8}],
        }
    )
    d["message_passing"]["stages"][0]["stage_mp"][0]["source_entities"][0][
        "message"
    ] = [{"type": "neural_network", "nn_name": "msg_nn", "input": ["undefined_thing"]}]
    with pytest.raises(ModelDescriptionError, match="undefined_thing"):
        parser.parse_model_description(d)


def test_exactly_one_predict():
    d = routenet_description()
    d["readout"].append(dict(d["readout"][0]))
    with pytest.raises(ModelDescriptionError, match="predict"):
        parser.parse_model_description(d)


def test_additional_inputs_empty_for_routenet():
    ir = parser.parse_model_description(routenet_description())
    assert ir.additional_inputs() == ()


def test_direct_assignation_output_name_is_friendly_error():
    """Review regression: an output_name on a direct_assignation op used to
    pass validation (registered as produced) and crash in the builder with
    a raw KeyError when consumed; the reference runtime never executes it
    either (g_m.py:440-475 runs only feed_forward ops)."""
    desc = routenet_description()
    mp = desc["message_passing"]["stages"][0]["stage_mp"][0]
    mp["source_entities"][0]["message"] = [
        {"type": "direct_assignation", "output_name": "m0"},
    ]
    with pytest.raises(
        parser.ModelDescriptionError, match="direct_assignation"
    ):
        parser.parse_model_description(
            desc, {"link_capacity": 1, "traffic": 1}
        )


# one case per JSON-Schema keyword the built-in validator covers
# (frontend/schema.py _first_violation): (schema, valid, invalid, message)
_KEYWORD_CASES = {
    "type": ({"type": "integer"}, 3, True, "True is not of type 'integer'"),
    "properties": (
        {"type": "object", "properties": {"a": {"type": "string"}}},
        {"a": "x", "b": 1}, {"a": 1}, "1 is not of type 'string'",
    ),
    "required": (
        {"type": "object", "required": ["a"]}, {"a": 1}, {"b": 1},
        "'a' is a required property",
    ),
    "enum": ({"enum": ["sum", "ordered"]}, "sum", "median",
             "'median' is not one of ['sum', 'ordered']"),
    "const": ({"const": "GRU"}, "GRU", "LSTM", "'GRU' was expected"),
    "items": ({"type": "array", "items": {"type": "number"}}, [1, 2.5],
              [1, "x"], "'x' is not of type 'number'"),
    "minItems": ({"type": "array", "minItems": 1}, [0], [],
                 "[] should be non-empty"),
    "exclusiveMinimum": ({"type": "number", "exclusiveMinimum": 0}, 0.5, 0,
                         "0 is less than or equal to the minimum of 0"),
    "allOf": ({"allOf": [{"type": "integer"}, {"enum": [1, 2]}]}, 2, 3,
              "3 is not one of [1, 2]"),
    "if_then": (
        {"if": {"properties": {"t": {"const": "c"}}},
         "then": {"required": ["axis"]}},
        {"t": "c", "axis": 1}, {"t": "c"}, "'axis' is a required property",
    ),
    "if_else": (
        {"if": {"properties": {"t": {"const": "c"}}},
         "then": {"required": ["axis"]}, "else": {"required": ["r"]}},
        {"t": "d", "r": 1}, {"t": "d"}, "'r' is a required property",
    ),
}


@pytest.mark.parametrize("keyword", sorted(_KEYWORD_CASES))
def test_schema_validator_keyword(keyword):
    from ignnition_tpu.frontend.schema import _first_violation

    schema, valid, invalid, message = _KEYWORD_CASES[keyword]
    assert _first_violation(valid, schema, []) is None
    v = _first_violation(invalid, schema, [])
    assert v is not None and v.message == message


def test_schema_error_names_the_path():
    """The error keeps the `at '<path>': <message>` format, path from the
    document root, list indices included."""
    d = routenet_description()
    d["message_passing"]["stages"][0]["stage_mp"][0]["aggregation"].pop("type")
    with pytest.raises(
        ModelDescriptionError,
        match=r"schema validation at 'message_passing/stages/0/stage_mp/0/"
        r"aggregation': 'type' is a required property",
    ):
        parser.parse_model_description(d)


def test_yaml_description_without_pyyaml_is_a_friendly_error(tmp_path,
                                                            monkeypatch):
    import sys

    path = tmp_path / "model_description.yaml"
    path.write_text("entities: []\n")
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    with pytest.raises(ModelDescriptionError, match="PyYAML"):
        parser.load_description(str(path))

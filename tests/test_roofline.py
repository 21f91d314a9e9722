"""Speed-of-light accounting (utils/roofline.py): the itemized bytes/FLOPs
model behind bench.py's sol_pct field, and the peaks table."""

from __future__ import annotations

import copy

import pytest

from ignnition_tpu.data import SampleSpec, build_batch, convert_sample
from ignnition_tpu.frontend import parser
from ignnition_tpu.utils.roofline import (
    PEAKS, peaks_for, roofline_report, train_step_cost,
)

from helpers import routenet_description

H100 = "NVIDIA H100 80GB HBM3"
DIMS = {"link_capacity": 1, "traffic": 1,
        "adj_links_paths": 0, "adj_paths_links": 0}


def _meta(desc):
    ir = parser.parse_model_description(copy.deepcopy(desc), dict(DIMS))
    sample = {
        "entities": {"l0": "link", "l1": "link", "p0": "path", "p1": "path"},
        "link_capacity": [1.0, 2.0], "traffic": [0.5, 0.6],
        "delay": [0.1, 0.2],
        "adj_links_paths": {"p0": ["l0", "l1"], "p1": ["l1"]},
        "adj_paths_links": {"l0": ["p0"], "l1": ["p0", "p1"]},
    }
    _, meta = build_batch([convert_sample(sample, SampleSpec.from_ir(ir))], ir)
    return ir, meta


def test_itemization_sums_and_bounds():
    ir, meta = _meta(routenet_description(num_iterations=4, hs=16))
    c = train_step_cost(ir, meta)
    assert c.total_bytes == pytest.approx(sum(c.bytes_by.values()))
    assert c.total_flops == pytest.approx(sum(c.flops_by.values()))
    assert c.total_bytes > 0 and c.total_flops > 0 and c.gather_rows > 0
    # ordered stage1 consumes a per-slot sequence through its GRU scan;
    # direct sum stage2 streams node tables
    assert "seq_stream" in c.bytes_by and "rnn_update" in c.flops_by
    assert "node_tables" in c.bytes_by
    b = c.bound_seconds(peaks_for(H100))
    assert b["sol_ms"] == pytest.approx(
        max(b["t_bytes_ms"], b["t_flops_ms"])
    )


def test_iterations_scale_iteration_rate_items():
    d2 = routenet_description(num_iterations=2, hs=16)
    d4 = routenet_description(num_iterations=4, hs=16)
    ir2, meta2 = _meta(d2)
    ir4, meta4 = _meta(d4)
    c2, c4 = train_step_cost(ir2, meta2), train_step_cost(ir4, meta4)
    # iteration-rate items scale with iterations
    for item in ("seq_stream", "node_tables", "state_tables"):
        assert c4.bytes_by[item] == pytest.approx(2 * c2.bytes_by[item])
    assert c4.flops_by["rnn_update"] == pytest.approx(
        2 * c2.flops_by["rnn_update"]
    )
    assert c4.gather_rows == pytest.approx(2 * c2.gather_rows)
    # readout runs once per step regardless of iterations
    assert c4.flops_by["readout"] == pytest.approx(c2.flops_by["readout"])


def test_per_edge_messages_cost_more_than_direct():
    base = routenet_description(num_iterations=4, hs=16)
    peredge = copy.deepcopy(base)
    peredge["neural_networks"].append({
        "nn_name": "msg", "nn_type": "feed_forward",
        "nn_architecture": [
            {"type_layer": "Dense", "units": 16, "activation": "relu"},
            {"type_layer": "Dense", "units": 16, "activation": "None"},
        ],
    })
    for stage in peredge["message_passing"]["stages"]:
        for mp in stage["stage_mp"]:
            for se in mp["source_entities"]:
                se["message"] = [{"type": "neural_network", "nn_name": "msg",
                                  "input": ["hs_source", "hs_dest"]}]
    cb = train_step_cost(*_meta(base))
    cp = train_step_cost(*_meta(peredge))
    assert cp.total_bytes > cb.total_bytes
    assert cp.total_flops > cb.total_flops
    assert cp.gather_rows > cb.gather_rows
    assert "message_mlp" in cp.flops_by and "edge_stream" in cp.bytes_by


def test_report_fields_and_percentages():
    ir, meta = _meta(routenet_description(num_iterations=4, hs=16))
    rep = roofline_report(ir, meta, measured_ms=10.0, device_kind=H100)
    for k in ("sol_ms", "sol_pct", "binding", "peaks",
              "bytes_items_mb", "flops_items_g", "gather_rows_m"):
        assert k in rep
    assert rep["sol_pct"] == pytest.approx(100 * rep["sol_ms"] / 10.0, rel=1e-3)


def test_peaks_table():
    """Peaks come from one table keyed by device_kind, with their source;
    a device that is not in it is an error, never a default."""
    p = peaks_for(H100)
    assert (p.hbm_gbps, p.bf16_tflops) == (3350.0, 989.0)
    assert all(v.source for v in PEAKS.values())
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("cpu")
    ir, meta = _meta(routenet_description(num_iterations=2, hs=16))
    with pytest.raises(KeyError):
        roofline_report(ir, meta, measured_ms=1.0, device_kind="unknown accelerator")

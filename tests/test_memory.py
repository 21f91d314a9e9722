"""Device-memory footprint estimator (utils/memory.py): the
fits-on-one-device statement behind edgeshard v2."""

import copy
import logging

import pytest

from ignnition_tpu.data.graph import BatchMeta
from ignnition_tpu.frontend import parser
from ignnition_tpu.utils.memory import (
    estimate_train_hbm, maybe_warn_capacity, recommended_shards,
)

from helpers import routenet_description

DIMS = {"link_capacity": 1, "traffic": 1}


def _ir():
    return parser.parse_model_description(
        copy.deepcopy(routenet_description(num_iterations=8, hs=32)), dict(DIMS)
    )


def _meta(x):
    n_links, n_paths, e = 2048 * x, 16384 * x, 131072 * x
    return BatchMeta(
        num_graphs=1,
        node_pad=(("link", n_links), ("path", n_paths)),
        edge_pad=(("adj_links_paths", e), ("adj_paths_links", e)),
        max_len=(("adj_links_paths", 8), ("adj_paths_links", 96)),
        label_pad=n_paths,
    )


def test_estimate_scales_and_itemizes():
    ir = _ir()
    small = estimate_train_hbm(ir, _meta(1))
    big = estimate_train_hbm(ir, _meta(16))
    assert set(small) == {
        "params_bytes", "batch_bytes", "residual_bytes", "dense_inc_bytes",
        "workspace_bytes", "total_bytes",
    }
    assert small["total_bytes"] == pytest.approx(
        sum(v for k, v in small.items() if k != "total_bytes")
    )
    # residuals dominate at scale and grow ~linearly with the graph
    assert big["residual_bytes"] > 10 * small["residual_bytes"]
    assert big["total_bytes"] > small["total_bytes"]


def test_recommended_shards():
    assert recommended_shards(1e9, 16e9) == 1
    assert recommended_shards(20e9, 16e9) == 2
    assert recommended_shards(40e9, 16e9) == 4
    # the capacity is the allocator's own limit: exactly full still fits
    assert recommended_shards(16e9, 16e9) == 1
    assert recommended_shards(16.1e9, 16e9) == 2


def test_capacity_warning_fires_only_when_too_big(caplog):
    ir = _ir()
    log = logging.getLogger("test_capacity")
    with caplog.at_level(logging.WARNING, logger="test_capacity"):
        m_small = maybe_warn_capacity(ir, _meta(1), log=log,
                                      capacity_bytes=16e9)
    assert m_small == 1 and not caplog.records
    with caplog.at_level(logging.WARNING, logger="test_capacity"):
        m_big = maybe_warn_capacity(ir, _meta(128), log=log,
                                    capacity_bytes=16e9)
    assert m_big > 1
    assert any("dest_shard" in r.getMessage() for r in caplog.records)


def test_capacity_comes_from_the_device(caplog):
    """The CPU reports no allocator limit: no capacity, never a warning."""
    from ignnition_tpu.utils.memory import device_capacity_bytes

    assert device_capacity_bytes() is None
    log = logging.getLogger("test_capacity")
    with caplog.at_level(logging.WARNING, logger="test_capacity"):
        assert maybe_warn_capacity(_ir(), _meta(128), log=log) == 1
    assert not caplog.records

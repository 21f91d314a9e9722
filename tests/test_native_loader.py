"""Native (C++) loader parity with the pure-python conversion path."""

import os

import numpy as np
import pytest

from ignnition_tpu.data import SampleSpec, dataset as ds
from ignnition_tpu.data import native_loader
from ignnition_tpu.data.synthetic import write_dataset
from ignnition_tpu.frontend import parser

from helpers import routenet_description, qsize_description

# the session fixture builds the library (make -C native) first
pytestmark = pytest.mark.usefixtures("native_loader")


def _compare(sample_a, sample_b):
    assert sample_a.num_nodes == sample_b.num_nodes
    for k in sample_a.features:
        np.testing.assert_allclose(sample_a.features[k], sample_b.features[k])
    for k in sample_a.adjacencies:
        a, b = sample_a.adjacencies[k], sample_b.adjacencies[k]
        np.testing.assert_array_equal(a.src_idx, b.src_idx)
        np.testing.assert_array_equal(a.dst_idx, b.dst_idx)
        np.testing.assert_array_equal(a.seq, b.seq)
        if a.params is not None or b.params is not None:
            np.testing.assert_allclose(a.params, b.params)
    if sample_a.label is not None:
        np.testing.assert_allclose(sample_a.label, sample_b.label)
    assert set(sample_a.interleave) == set(sample_b.interleave)
    for k in sample_a.interleave:
        np.testing.assert_array_equal(sample_a.interleave[k], sample_b.interleave[k])


def test_native_matches_python_routenet(tmp_path):
    write_dataset(str(tmp_path), 1, 6, seed=9, n_links=14, n_paths=9)
    ir = parser.parse_model_description(
        routenet_description(), {"link_capacity": 1, "traffic": 1}
    )
    spec = SampleSpec.from_ir(ir)
    native = list(ds.iter_samples(str(tmp_path), spec, use_native="auto"))
    python = list(ds.iter_samples(str(tmp_path), spec, use_native="never"))
    assert len(native) == len(python) == 6
    for a, b in zip(native, python):
        _compare(a, b)


def test_native_matches_python_qsize_interleave(tmp_path):
    write_dataset(str(tmp_path), 1, 4, seed=10, n_links=10, n_paths=6, with_nodes=True)
    ir = parser.parse_model_description(
        qsize_description(), {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
    )
    spec = SampleSpec.from_ir(ir)
    native = list(ds.iter_samples(str(tmp_path), spec, use_native="auto"))
    python = list(ds.iter_samples(str(tmp_path), spec, use_native="never"))
    for a, b in zip(native, python):
        _compare(a, b)


def test_native_falls_back_on_bad_sample(tmp_path):
    # a sample referencing a wrong entity type must surface python's
    # friendly DatasetError (archive skipped), not a native crash
    import json, tarfile
    from io import BytesIO

    bad = {
        "entities": {"l0": "link", "p0": "path"},
        "link_capacity": [1.0],
        "traffic": [1.0],
        "delay": [0.1],
        "adj_links_paths": {"l0": ["l0"]},  # dst is a link, not a path
        "adj_paths_links": {"l0": ["p0"]},
    }
    payload = json.dumps([bad]).encode()
    with tarfile.open(tmp_path / "x.tar.gz", "w:gz") as tar:
        info = tarfile.TarInfo("data.json")
        info.size = len(payload)
        tar.addfile(info, BytesIO(payload))
    ir = parser.parse_model_description(
        routenet_description(), {"link_capacity": 1, "traffic": 1}
    )
    spec = SampleSpec.from_ir(ir)
    out = list(ds.iter_samples(str(tmp_path), spec))
    assert out == []  # archive skipped with a logged error


def test_native_preserves_adjacency_insertion_order(tmp_path):
    """Edge-domain labels are listed in the adjacency dict's insertion
    order, so the native JSON parser must preserve document key order —
    the linkpred generator inserts destinations in SHUFFLED order."""
    from ignnition_tpu.data.synthetic import write_linkpred_dataset
    import json

    write_linkpred_dataset(str(tmp_path), 1, 5, seed=21)
    desc = json.load(
        open(os.path.join(os.path.dirname(__file__), "..", "examples",
                          "linkpred", "model_description.json"))
    )
    ir = parser.parse_model_description(desc, {"x": 1})
    spec = SampleSpec.from_ir(ir)
    native = list(ds.iter_samples(str(tmp_path), spec, use_native="auto"))
    python = list(ds.iter_samples(str(tmp_path), spec, use_native="never"))
    assert len(native) == len(python) == 5
    for a, b in zip(native, python):
        adj, badj = a.adjacencies["adj_nodes_nodes"], b.adjacencies["adj_nodes_nodes"]
        np.testing.assert_array_equal(adj.src_idx, badj.src_idx)
        np.testing.assert_array_equal(adj.dst_idx, badj.dst_idx)
        np.testing.assert_allclose(a.label, b.label)


def test_native_params_branch_rejects_wrong_entity(tmp_path):
    """Review regression: the native [src, params] branch skipped the
    source-entity check and silently emitted a wrong-entity node's index;
    now it returns -1 so the python path raises the friendly DatasetError
    — and both paths agree."""
    import copy
    import json
    import tarfile
    from io import BytesIO

    desc = routenet_description()
    ir = parser.parse_model_description(
        copy.deepcopy(desc),
        {"link_capacity": 1, "traffic": 1,
         "adj_links_paths": 1, "adj_paths_links": 1},
    )
    spec = SampleSpec.from_ir(ir)
    sample = {
        "entities": {"l0": "link", "l1": "link", "p0": "path"},
        "link_capacity": [1.0, 2.0],
        "traffic": [0.5],
        "delay": [0.1],
        # wrong-entity source in [src, params] form: p0 is a path
        "adj_links_paths": {"p0": [["p0", [1.0]]]},
        "adj_paths_links": {"l0": [["p0", [1.0]]]},
    }
    payload = json.dumps([sample]).encode()
    path = tmp_path / "bad.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        info = tarfile.TarInfo("data.json")
        info.size = len(payload)
        tar.addfile(info, BytesIO(payload))

    # the skip-and-log resilience swallows the archive in both modes —
    # the point is NEITHER path yields a silently-corrupt sample
    assert list(ds.iter_samples(str(tmp_path), spec, use_native="auto")) == []
    assert list(ds.iter_samples(str(tmp_path), spec, use_native="never")) == []

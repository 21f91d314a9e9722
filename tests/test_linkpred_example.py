"""Edge-domain labels end-to-end: the link-prediction example.

The dataset's adjacency dicts are inserted in SHUFFLED destination order
(ignnition_tpu.data.synthetic.make_linkpred_sample), while merged batches
destination-sort their edge lists — these tests pin the label/prediction
alignment across that reordering, the original-order predict contract,
training signal, and the serving path.
"""

import os

import jax
import numpy as np
import pytest
import json

import ignnition_tpu as ig
from ignnition_tpu.config import RunConfig
from ignnition_tpu.data import SampleSpec, build_batch, iter_samples
from ignnition_tpu.data.synthetic import make_linkpred_sample, write_linkpred_dataset
from ignnition_tpu.frontend import parser
from ignnition_tpu.model import build

HERE = os.path.dirname(os.path.abspath(__file__))
DESC = os.path.join(HERE, "..", "examples", "linkpred", "model_description.json")


def description():
    with open(DESC) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("linkpred")
    write_linkpred_dataset(str(d), num_archives=2, samples_per_archive=8, seed=5)
    return str(d)


@pytest.fixture(scope="module")
def model_ir():
    return parser.parse_model_description(description(), {"x": 1})


def test_edge_label_alignment(model_ir):
    """With a noise-free generator, the batch label at sorted edge i must
    equal the generating function of (src_i, dst_i) — catches any
    label-vs-edge-order misalignment under the destination sort."""
    rng = np.random.default_rng(3)
    samples_raw = [make_linkpred_sample(rng, n_nodes=15, noise=0.0) for _ in range(3)]
    import json, tarfile, tempfile
    from io import BytesIO

    d = tempfile.mkdtemp()
    payload = json.dumps(samples_raw).encode()
    with tarfile.open(os.path.join(d, "s.tar.gz"), "w:gz") as tar:
        info = tarfile.TarInfo("data.json")
        info.size = len(payload)
        tar.addfile(info, BytesIO(payload))

    spec = SampleSpec.from_ir(model_ir)
    samples = list(iter_samples(d, spec))
    arrays, meta = build_batch(samples, model_ir, training=True)

    # merged x table (node offsets follow sample order)
    xs, off = [], []
    pos = 0
    for s in samples:
        xs.append(s.features["x"].reshape(-1))
        off.append(pos)
        pos += s.num_nodes["node"]
    x = np.concatenate(xs)

    src = arrays["src_adj_nodes_nodes"]
    dst = arrays["dst_adj_nodes_nodes"]
    emask = arrays["edge_mask_adj_nodes_nodes"] > 0
    # node padding: real node rows of sample g occupy a known offset range,
    # but src/dst already point into the PADDED merged table — rebuild the
    # padded x table the way the batch does
    x_pad = np.asarray(arrays["x"]).reshape(-1)
    want = x_pad[src] * x_pad[dst] + 0.3 * (x_pad[src] + x_pad[dst])
    np.testing.assert_allclose(
        np.asarray(arrays["label"])[emask], want[emask], rtol=1e-5, atol=1e-6
    )
    assert np.all(np.asarray(arrays["label_mask"])[emask] == 1.0)


def test_predict_returns_original_edge_order(dataset, model_ir, tmp_path):
    """Runner.predict emits per-sample edge scores in the sample's original
    (insertion-order) edge order — the order of the dataset's label list."""
    desc = description()
    cfg = RunConfig(
        train_dataset=dataset, eval_dataset=dataset, predict_dataset=dataset,
        model_dir=str(tmp_path / "m"), batch_size=2, train_steps=2,
        eval_samples=2,
    )
    model = ig.Model(ir=model_ir, config=cfg)
    runner = ig.Runner(model)
    state = runner.trainer.init_state(jax.random.PRNGKey(0))
    preds = runner.predict(state)

    spec = SampleSpec.from_ir(model_ir, training=False)
    samples = list(iter_samples(dataset, spec))
    assert len(preds) == len(samples)
    gnn = runner.gnn
    for s, p in zip(samples, preds):
        arrays, meta = build_batch([s], model_ir, training=False)
        out = np.asarray(gnn.apply(state.params, arrays, meta))
        n = len(s.adjacencies["adj_nodes_nodes"].src_idx)
        # sorted-order predictions mapped back through the permutation
        perm = np.asarray(arrays["label_perm"])
        np.testing.assert_allclose(p, out[perm][:n], rtol=1e-6, atol=1e-6)
        assert len(p) == n


def test_linkpred_trains(dataset, model_ir):
    from ignnition_tpu.training import Trainer

    trainer = Trainer(build(model_ir))
    state = trainer.init_state(jax.random.PRNGKey(0))
    losses = []
    for i, (arrays, meta) in enumerate(
        trainer.batches(dataset, 4, shuffle=True, seed=0, repeat=True)
    ):
        if i >= 60:
            break
        step = trainer.train_step_fn(meta)
        params, opt_state, logs = step(
            state.params, state.opt_state, arrays, jax.random.PRNGKey(i)
        )
        from ignnition_tpu.training.trainer import TrainState

        state = TrainState(params, opt_state, state.step + 1)
        losses.append(float(logs["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.5, losses


def test_linkpred_serving_edge_domain(dataset, model_ir, tmp_path):
    """Edge-domain model exports and serves; predict_samples returns scores
    in original edge order matching the direct forward pass."""
    from ignnition_tpu.serving import export_serving, load_serving

    gnn = build(model_ir)
    params = gnn.init(jax.random.PRNGKey(1))
    spec = SampleSpec.from_ir(model_ir, training=False)
    samples = list(iter_samples(dataset, spec))
    arrays, meta = build_batch(samples[:2], model_ir, training=False)
    out = export_serving(
        gnn, params, meta, arrays, str(tmp_path / "artifact"),
        description=description(),
    )
    sm = load_serving(out)
    assert sm.label_domain == ("edge", "adj_nodes_nodes")
    served = sm.predict_samples(samples[:2], denormalize=False)
    # the external three-step flow must match (build_batch keeps label_perm)
    ext = sm.build_batch(samples[:2])
    np.testing.assert_allclose(
        sm.trim(sm.predict(ext, denormalize=False), ext), served,
        rtol=1e-6, atol=1e-6,
    )
    direct = np.asarray(gnn.apply(params, arrays, meta))
    perm = np.asarray(arrays["label_perm"])
    n = sum(len(s.adjacencies["adj_nodes_nodes"].src_idx) for s in samples[:2])
    np.testing.assert_allclose(served, direct[perm][:n], rtol=1e-6, atol=1e-6)

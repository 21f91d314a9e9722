"""The graphprop example family: same-entity message passing, pooled
graph-domain prediction, and end-to-end convergence on its synthetic task.

This is the model-family coverage the RouteNet/Q-size examples don't touch:
attention + feed-forward update and convolution + GRU over a homogeneous
`node` entity, with a graph-level label (reference analog: any
model_description whose predict input is a pooled output, schema.json:253-376).
"""

import os

import jax
import numpy as np
import pytest
import json

import ignnition_tpu as ig
from ignnition_tpu.data.graph import PaddingConfig
from ignnition_tpu.data.synthetic import write_graphprop_dataset
from ignnition_tpu.training import Trainer
from ignnition_tpu.training.metrics import MetricAccumulator
from ignnition_tpu.training.trainer import TrainState

HERE = os.path.dirname(os.path.abspath(__file__))
DESC_PATH = os.path.join(HERE, "..", "examples", "graphprop", "model_description.json")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("gp")
    write_graphprop_dataset(str(d), num_archives=2, samples_per_archive=20, seed=5)
    return str(d)


@pytest.fixture(scope="module")
def model_ir(dataset):
    with open(DESC_PATH) as f:
        desc = json.load(f)
    return ig.parse_model_description(desc, ig.find_dataset_dimensions(dataset))


def test_forward_and_merged_batch_invariant(dataset, model_ir):
    spec = ig.SampleSpec.from_ir(model_ir)
    samples = list(ig.iter_samples(dataset, spec))
    model = ig.build(model_ir)
    params = model.init(jax.random.PRNGKey(0))
    b1, m1 = ig.build_batch(samples[:1], model_ir)
    b3, m3 = ig.build_batch(samples[:3], model_ir)
    p1 = np.asarray(model.apply(params, b1, m1))
    p3 = np.asarray(model.apply(params, b3, m3))
    assert np.isfinite(p3).all()
    # one prediction per graph; graph 0 unchanged by merging
    np.testing.assert_allclose(p3[0], p1[0], rtol=1e-4, atol=1e-6)


def test_trains_to_high_r2(dataset, model_ir):
    trainer = Trainer(ig.build(model_ir), padding=PaddingConfig(min_size=16))
    state = trainer.init_state(jax.random.PRNGKey(0))
    for i, (arrays, meta) in enumerate(trainer.batches(dataset, 8, repeat=True)):
        if i >= 250:
            break
        step = trainer.train_step_fn(meta)
        params, opt_state, logs = step(
            state.params, state.opt_state, arrays, jax.random.PRNGKey(i)
        )
        state = TrainState(params, opt_state, state.step + 1)
    out = trainer.evaluate(state, dataset, num_batches=5, batch_size=8)
    assert out["r-squared"] > 0.8, out


def test_pooled_r2_single_label_batches():
    """Graph-level labels arrive one per graph; per-batch R² would be
    undefined for batch_size=1 — the pooled form must still work."""
    acc = MetricAccumulator()
    rng = np.random.default_rng(0)
    labels = rng.normal(size=32)
    preds = labels + rng.normal(scale=0.1, size=32)
    for l, p in zip(labels, preds):
        acc.update(np.array([l]), np.array([p]), np.array([1.0]))
    got = acc.result()["r-squared"]
    want = 1.0 - ((labels - preds) ** 2).sum() / ((labels - labels.mean()) ** 2).sum()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert got > 0.9

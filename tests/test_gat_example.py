"""The GAT example end-to-end: attention aggregation from the JSON DSL.

The synthetic label is a softmax mean of neighbor signals weighted by the
neighbors' own importance — GATv1-representable, NOT uniform-aggregation-
representable; the attention model must beat a sum-aggregation ablation on
held-out R² (real signal, not memorization)."""

from __future__ import annotations

import copy
import os

import jax
import numpy as np
import pytest
import json

import ignnition_tpu as ig
from ignnition_tpu.data import SampleSpec, build_batch, iter_samples
from ignnition_tpu.data.synthetic import write_gat_dataset
from ignnition_tpu.frontend import parser
from ignnition_tpu.model import build

HERE = os.path.dirname(os.path.abspath(__file__))
DESC = os.path.join(HERE, "..", "examples", "gat", "model_description.json")
DIMS = {"signal": 1, "importance": 1, "adj_nodes_nodes": 0}


def description():
    with open(DESC) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("gat")
    write_gat_dataset(str(d), num_archives=2, samples_per_archive=10, seed=5)
    return str(d)


def _train(ir, dataset, steps=500, seed=0):
    import optax

    from ignnition_tpu.training import build_optimizer, get_loss

    model = build(ir)
    params = model.init(jax.random.PRNGKey(seed))
    optimizer = build_optimizer(ir.learning.optimizer)
    opt_state = optimizer.init(params)
    loss_fn = get_loss(ir.learning.loss)
    spec = SampleSpec.from_ir(ir)
    samples = list(iter_samples(dataset, spec))
    train, held = samples[:14], samples[14:]
    arrays, meta = build_batch(train, ir)

    @jax.jit
    def step(params, opt_state):
        def loss(p):
            preds = model.apply(p, arrays, meta, training=True)
            return loss_fn(arrays["label"], preds, arrays["label_mask"])

        l, grads = jax.value_and_grad(loss)(params)
        updates, opt_state2 = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, l

    for _ in range(steps):
        params, opt_state, l = step(params, opt_state)

    ev_arrays, ev_meta = build_batch(held, ir)
    preds = np.asarray(model.apply(params, ev_arrays, ev_meta))
    mask = np.asarray(ev_arrays["label_mask"]).reshape(-1).astype(bool)
    y = np.asarray(ev_arrays["label"]).reshape(-1)[mask]
    p = preds.reshape(-1)[mask]
    ss_res = float(((y - p) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return 1.0 - ss_res / ss_tot, float(l)


def test_attention_learns_and_beats_sum_ablation(dataset):
    ir_attn = parser.parse_model_description(description(), dict(DIMS))
    r2_attn, loss_attn = _train(ir_attn, dataset)
    assert np.isfinite(loss_attn)
    assert r2_attn > 0.8, r2_attn

    abl = copy.deepcopy(description())
    abl["message_passing"]["stages"][0]["stage_mp"][0]["aggregation"] = {
        "type": "sum"
    }
    ir_sum = parser.parse_model_description(abl, dict(DIMS))
    r2_sum, _ = _train(ir_sum, dataset)
    # the importance weighting is invisible to a uniform aggregation
    assert r2_attn > r2_sum + 0.05, (r2_attn, r2_sum)


def test_merged_equals_per_graph_predictions(dataset):
    ir = parser.parse_model_description(description(), dict(DIMS))
    model = build(ir)
    params = model.init(jax.random.PRNGKey(1))
    spec = SampleSpec.from_ir(ir)
    samples = list(iter_samples(dataset, spec))[:4]
    arrays, meta = build_batch(samples, ir)
    merged = np.asarray(model.apply(params, arrays, meta))
    mask = np.asarray(arrays["label_mask"]).reshape(-1).astype(bool)
    merged = merged.reshape(-1)[mask]
    singles = []
    for s in samples:
        a1, m1 = build_batch([s], ir)
        p1 = np.asarray(model.apply(params, a1, m1)).reshape(-1)
        singles.append(p1[np.asarray(a1["label_mask"]).reshape(-1) > 0])
    np.testing.assert_allclose(
        merged, np.concatenate(singles), rtol=2e-4, atol=1e-5
    )


def test_runner_end_to_end(dataset, tmp_path):
    from ignnition_tpu.config import RunConfig

    cfg = RunConfig(
        train_dataset=dataset,
        eval_dataset=dataset,
        predict_dataset=dataset,
        json_path=DESC,
        model_dir=str(tmp_path / "ckpt"),
        batch_size=4,
        train_steps=20,
        eval_samples=4,
        log_every=0,
    )
    model = ig.create_model(cfg)
    state = ig.train_and_evaluate(model)
    runner = ig.Runner(model)
    metrics = runner.evaluate(state)
    assert np.isfinite(metrics["loss"])
    preds = runner.predict(state)
    assert len(preds) > 0 and all(np.isfinite(p).all() for p in preds)

"""Coverage for smaller parity surfaces: dropout/activation layers, extra
losses, additional dataset inputs in readout, distributed helpers."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ignnition_tpu.data import SampleSpec, build_batch, convert_sample
from ignnition_tpu.frontend import parser
from ignnition_tpu.model import build
from ignnition_tpu.training.losses import get_loss

from helpers import TINY_SAMPLE, routenet_description, dense


def test_dropout_and_activation_layers():
    d = routenet_description(num_iterations=1, hs=8)
    d["neural_networks"][0]["nn_architecture"] = [
        dense(16, "relu"),
        {"type_layer": "Dropout", "rate": 0.5},
        {"type_layer": "Activation", "activation": "tanh"},
        dense(1, "None"),
    ]
    ir = parser.parse_model_description(d, {"link_capacity": 1, "traffic": 1})
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    spec = SampleSpec.from_ir(ir)
    arrays, meta = build_batch([convert_sample(TINY_SAMPLE, spec)], ir)
    # deterministic: dropout off
    p1 = model.apply(params, arrays, meta)
    p2 = model.apply(params, arrays, meta)
    np.testing.assert_allclose(p1, p2)
    # training: dropout active, rng-dependent
    t1 = model.apply(params, arrays, meta, training=True, rng=jax.random.PRNGKey(1))
    t2 = model.apply(params, arrays, meta, training=True, rng=jax.random.PRNGKey(2))
    assert not np.allclose(np.asarray(t1)[:2], np.asarray(t2)[:2])


def test_losses_match_formulas():
    l = np.array([1.0, 2.0], np.float32)
    p = np.array([1.5, 1.0], np.float32)
    m = np.ones(2, np.float32)
    np.testing.assert_allclose(
        float(get_loss("MeanAbsoluteError")(l, p, m)), 0.75, rtol=1e-6
    )
    np.testing.assert_allclose(
        float(get_loss("MeanAbsolutePercentageError")(l, p, m)),
        100 * (0.5 / 1 + 1 / 2) / 2,
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        float(get_loss("Huber")(l, p, m)),
        np.mean([0.5 * 0.25, 0.5]),
        rtol=1e-6,
    )


def test_extra_losses_match_formulas():
    m = np.ones(2, np.float32)
    l = np.array([1.0, 2.0], np.float32)
    p = np.array([1.5, 1.0], np.float32)
    np.testing.assert_allclose(
        float(get_loss("Poisson")(l, p, m)),
        np.mean(p - l * np.log(p + 1e-7)),
        rtol=1e-6,
    )
    # KL over clipped distributions: keras SUMS over the support (the
    # feature axis) — ground-truthed in tests/test_keras_training_parity.py
    lq = np.array([0.4, 0.6], np.float32)
    pq = np.array([0.5, 0.5], np.float32)
    np.testing.assert_allclose(
        float(get_loss("KLDivergence")(lq, pq, m)),
        np.sum(lq * np.log(lq / pq)),
        rtol=1e-5,
    )
    # hinge: {0,1} labels map to {-1,1}
    lh = np.array([0.0, 1.0], np.float32)
    ph = np.array([0.3, 0.8], np.float32)
    np.testing.assert_allclose(
        float(get_loss("Hinge")(lh, ph, m)),
        np.mean([max(0.0, 1 + 0.3), max(0.0, 1 - 0.8)]),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(get_loss("SquaredHinge")(lh, ph, m)),
        np.mean([max(0.0, 1 + 0.3) ** 2, max(0.0, 1 - 0.8) ** 2]),
        rtol=1e-6,
    )
    # masked rows are excluded
    mm = np.array([1.0, 0.0], np.float32)
    np.testing.assert_allclose(
        float(get_loss("Poisson")(l, p, mm)),
        p[0] - l[0] * np.log(p[0] + 1e-7),
        rtol=1e-6,
    )


def test_additional_dataset_input_in_readout():
    """A readout product against a raw dataset vector (the reference's
    additional_input path, json_operations.py:458-475)."""
    d = routenet_description(num_iterations=1, hs=8)
    d["readout"] = [
        {
            "type": "product",
            "type_product": "element_wise",
            "input": ["path", "path_weights"],
            "output_name": "weighted",
        },
        {
            "type": "predict",
            "input": ["path"],
            "label": "delay",
            "label_normalization": "log",
            "nn_name": "readout_model",
        },
    ]
    ir = parser.parse_model_description(d, {"link_capacity": 1, "traffic": 1})
    assert ir.additional_inputs() == ("path_weights",)
    sample = dict(TINY_SAMPLE, path_weights=[2, 3])
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(sample, spec)
    assert "path_weights" in s.extras
    arrays, meta = build_batch([s], ir)
    assert "path_weights" in arrays
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    preds = model.apply(params, arrays, meta)
    assert np.isfinite(np.asarray(preds)).all()


def test_host_shard_iter():
    from ignnition_tpu.parallel.distributed import host_shard_iter

    items = list(range(10))
    got0 = list(host_shard_iter(iter(items), process_id=0, num_processes=3))
    got1 = list(host_shard_iter(iter(items), process_id=1, num_processes=3))
    assert got0 == [0, 3, 6, 9]
    assert got1 == [1, 4, 7]


def test_make_pod_mesh_virtual():
    from ignnition_tpu.parallel.distributed import make_pod_mesh

    if len(jax.devices()) < 8:
        return
    mesh = make_pod_mesh(model_axis_per_host=2)
    assert mesh.shape["model"] == 2
    assert mesh.shape["data"] * 2 == len(jax.devices())


def test_bfloat16_compute_dtype():
    import jax.numpy as jnp
    from ignnition_tpu.data import build_batch as bb

    ir = parser.parse_model_description(
        routenet_description(num_iterations=3, hs=16),
        {"link_capacity": 1, "traffic": 1},
    )
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    spec = SampleSpec.from_ir(ir)
    arrays, meta = bb([convert_sample(TINY_SAMPLE, spec)], ir)
    p32 = np.asarray(model.apply(params, arrays, meta))
    p16 = np.asarray(model.apply(params, arrays, meta, compute_dtype=jnp.bfloat16))
    assert p16.dtype == np.float32
    # bf16 compute tracks f32 within bf16 tolerance
    np.testing.assert_allclose(p16[:2], p32[:2], rtol=0.05, atol=0.05)

    # gradients flow and are finite in mixed precision
    def loss(p):
        preds = model.apply(p, arrays, meta, compute_dtype=jnp.bfloat16)
        return jnp.sum((preds * arrays["label_mask"]) ** 2)

    g = jax.grad(loss)(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf, dtype=np.float32)).all()
        assert leaf.dtype == jnp.float32  # master-weight grads stay f32


def test_sorted_segment_softmax_matches_generic():
    from ignnition_tpu.ops import segment as seg
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    E, N = 500, 40
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    scores = rng.normal(size=E).astype(np.float32) * 5
    mask = (rng.random(E) > 0.1).astype(np.float32)
    w1 = np.asarray(seg.segment_softmax(jnp.asarray(scores), jnp.asarray(dst), N, jnp.asarray(mask)))
    w2 = np.asarray(
        seg.sorted_segment_softmax(
            jnp.asarray(scores), jnp.asarray(dst), N, jnp.asarray(mask)
        )
    )
    np.testing.assert_allclose(w1, w2, rtol=1e-5, atol=1e-6)

    # gradients agree too (gather_by_dst custom VJP)
    def f1(s):
        return jnp.sum(seg.segment_softmax(s, jnp.asarray(dst), N, jnp.asarray(mask)) ** 2)

    def f2(s):
        return jnp.sum(
            seg.sorted_segment_softmax(
                s, jnp.asarray(dst), N, jnp.asarray(mask)
            )
            ** 2
        )

    g1 = np.asarray(jax.grad(f1)(jnp.asarray(scores)))
    g2 = np.asarray(jax.grad(f2)(jnp.asarray(scores)))
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-6)


def test_additional_input_follows_per_graph_block_layout():
    """An entity-shaped additional input (one row per path) must sit at the
    entity's block offsets under per-graph padding — merged predictions
    equal per-sample predictions."""
    from ignnition_tpu.data.graph import PaddingConfig

    d = routenet_description(num_iterations=1, hs=8)
    d["readout"] = [
        {
            "type": "product",
            "type_product": "element_wise",
            "input": ["path", "path_weights"],
            "output_name": "weighted",
        },
        {
            "type": "predict",
            "input": ["weighted"],
            "label": "delay",
            "label_normalization": "log",
            "nn_name": "readout_model",
        },
    ]
    ir = parser.parse_model_description(d, {"link_capacity": 1, "traffic": 1})
    spec = SampleSpec.from_ir(ir)
    s1 = convert_sample(dict(TINY_SAMPLE, path_weights=[2, 3]), spec)
    bigger = dict(
        TINY_SAMPLE,
        entities={**TINY_SAMPLE["entities"], "p2": "path"},
        traffic=[1.0, 2.0, 0.5],
        delay=[0.5, 0.25, 0.75],
        path_weights=[4, 5, 6],
        adj_links_paths={**TINY_SAMPLE["adj_links_paths"], "p2": ["l0"]},
        adj_paths_links={"l0": ["p0", "p2"], "l1": ["p0", "p1"], "l2": ["p1"]},
    )
    s2 = convert_sample(bigger, spec)

    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    merged, meta = build_batch([s1, s2], ir, PaddingConfig(per_graph=True))
    got = np.asarray(model.apply(params, merged, meta))[
        np.asarray(merged["node_mask_path"]) > 0
    ]
    want = []
    for s in (s1, s2):
        a1, m1 = build_batch([s], ir)
        p = np.asarray(model.apply(params, a1, m1))
        want.append(p[np.asarray(a1["node_mask_path"]) > 0])
    np.testing.assert_allclose(got, np.concatenate(want), rtol=1e-5, atol=1e-6)


def test_register_custom_layer_end_to_end():
    """A user-registered layer kind flows from the model description through
    init/apply/training-gradients (the open surface replacing the reference's
    tf.keras.layers reflection, a_c.py:839-865)."""
    from ignnition_tpu import register_layer
    from ignnition_tpu.nn import layers as L

    def scale_init(rng, layer, in_dim):
        g = float(layer.extra.get("gain", 1.0))
        return {"scale": jnp.full((in_dim,), g, jnp.float32)}, in_dim

    def scale_apply(layer, params, x, *, deterministic, rng):
        return x * params["scale"]

    register_layer("ParamScale", scale_init, scale_apply)
    try:
        d = routenet_description(num_iterations=1, hs=8)
        d["neural_networks"][0]["nn_architecture"] = [
            dense(16, "relu"),
            {"type_layer": "ParamScale", "gain": 2.0},
            dense(1, "None"),
        ]
        ir = parser.parse_model_description(d, {"link_capacity": 1, "traffic": 1})
        model = build(ir)
        params = model.init(jax.random.PRNGKey(0))
        p = params["readout"]["op0"]["layers"][1]
        assert np.allclose(np.asarray(p["scale"]), 2.0)

        spec = SampleSpec.from_ir(ir)
        arrays, meta = build_batch([convert_sample(TINY_SAMPLE, spec)], ir)
        preds = model.apply(params, arrays, meta)
        assert np.isfinite(np.asarray(preds)).all()

        # the custom layer's params receive gradients
        def loss(ps):
            return jnp.sum(model.apply(ps, arrays, meta) ** 2)

        g = jax.grad(loss)(params)
        gs = np.asarray(g["readout"]["op0"]["layers"][1]["scale"])
        assert np.abs(gs).max() > 0
    finally:
        L.CUSTOM_LAYERS.pop("ParamScale", None)


def test_unknown_layer_error_lists_extensions():
    from ignnition_tpu.nn import layers as L
    from ignnition_tpu.nn import mlp as M

    d = routenet_description(num_iterations=1, hs=8)
    d["neural_networks"][0]["nn_architecture"] = [
        {"type_layer": "Conv1D", "units": 4}, dense(1, "None")
    ]
    ir = parser.parse_model_description(d, {"link_capacity": 1, "traffic": 1})
    model = build(ir)
    with pytest.raises(ValueError, match="Conv1D.*built-ins"):
        model.init(jax.random.PRNGKey(0))

    L.register_layer("MyKind", lambda r, l, d_: ({}, d_),
                     lambda l, p, x, **kw: x)
    try:
        with pytest.raises(ValueError, match="registered extensions: MyKind"):
            model.init(jax.random.PRNGKey(0))
    finally:
        L.CUSTOM_LAYERS.pop("MyKind", None)


def test_batchnorm_trains_but_moving_stats_frozen():
    d = routenet_description(num_iterations=1, hs=8)
    d["neural_networks"][0]["nn_architecture"] = [
        dense(16, "relu"),
        {"type_layer": "BatchNormalization"},
        dense(1, "None"),
    ]
    ir = parser.parse_model_description(d, {"link_capacity": 1, "traffic": 1})
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    spec = SampleSpec.from_ir(ir)
    arrays, meta = build_batch([convert_sample(TINY_SAMPLE, spec)], ir)

    def loss(ps):
        return jnp.sum(model.apply(ps, arrays, meta) ** 2)

    g = jax.grad(loss)(params)
    bn = g["readout"]["op0"]["layers"][1]
    assert np.abs(np.asarray(bn["gamma"])).max() > 0
    assert np.abs(np.asarray(bn["beta"])).max() > 0
    assert np.asarray(bn["moving_mean"]).max() == 0  # stop_gradient'ed
    assert np.asarray(bn["moving_variance"]).max() == 0


def test_sorted_softmax_grads_finite_with_rogue_masked_score():
    """Review regression: exp was evaluated on UNmasked scores, so a
    padding-edge score ~88 nats above the real max overflowed to inf and
    the where-VJP's 0*inf turned the whole score gradient NaN. The
    double-where guard keeps gradients finite and values unchanged."""
    from ignnition_tpu.ops import segment as seg

    dst = jnp.asarray([0, 0, 1], jnp.int32)
    mask = jnp.asarray([1.0, 1.0, 0.0])

    def f(scores):
        return jnp.sum(
            seg.sorted_segment_softmax(scores, dst, 2, mask)
        )

    g = jax.grad(f)(jnp.asarray([0.0, 1.0, 200.0]))
    assert np.all(np.isfinite(np.asarray(g)))
    assert abs(float(g[2])) == 0.0  # masked edge gets no gradient

    def f2(scores):
        msgs = jnp.ones((3, 4))
        return jnp.sum(
            seg.sorted_softmax_aggregate(msgs, scores, dst, 2, mask)
        )

    g2 = jax.grad(f2)(jnp.asarray([0.0, 1.0, 200.0]))
    assert np.all(np.isfinite(np.asarray(g2)))


def test_graph_pool_max_fully_masked_segment_is_zero():
    """Review regression: a graph whose pooled entity has zero REAL rows
    (all masked) maxed the finite finfo.min fill to -3.4e38 instead of the
    documented 0 for empty segments."""
    from ignnition_tpu.ops import segment as seg

    x = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    gid = jnp.asarray([0, 0], jnp.int32)  # graph 1 has no rows at all
    mask = jnp.asarray([0.0, 0.0])  # and graph 0's rows are all masked
    out = seg.graph_pool(x, gid, 2, mask, kind="max")
    np.testing.assert_array_equal(np.asarray(out), 0.0)


def test_sharded_training_supports_dropout():
    """Review regression: the sharded train steps dropped the rng, so any
    model with a Dropout layer crashed at trace time under a mesh."""
    from jax.sharding import Mesh

    from ignnition_tpu.data.graph import PaddingConfig
    from ignnition_tpu.training.trainer import Trainer

    desc = routenet_description(num_iterations=1, hs=8)
    for nn in desc["neural_networks"]:
        if nn["nn_name"] == "readout_model":
            nn["nn_architecture"].insert(
                1, {"type_layer": "Dropout", "rate": 0.3}
            )
    ir = parser.parse_model_description(
        copy.deepcopy(desc), {"link_capacity": 1, "traffic": 1}
    )
    model = build(ir)
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    batch, meta = build_batch([s], ir)

    from ignnition_tpu.parallel import (
        make_edgeshard_train_step, make_parallel_train_step, partition_batch,
        stack_batches,
    )
    import optax

    opt = optax.sgd(1e-2)
    params = model.init(jax.random.PRNGKey(0))
    loss_fn = get_loss(ir.learning.loss)

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    with Mesh(devs, ("data", "model")):
        mesh = Mesh(devs, ("data", "model"))
        # v1 replicated + edge sharding
        step = make_parallel_train_step(model, opt, loss_fn, meta, mesh)
        stacked, _ = stack_batches([(batch, meta), (batch, meta)], ir)
        p1, _, loss1 = step(params, opt.init(params), stacked,
                            jax.random.PRNGKey(7))
        assert np.isfinite(float(loss1))
        # v2 destination sharding
        part, lmeta = partition_batch(batch, meta, ir, 2)
        stacked2 = {k: np.stack([v, v], 0) for k, v in part.items()}
        step2 = make_edgeshard_train_step(model, opt, loss_fn, lmeta, mesh)
        p2, _, loss2 = step2(params, opt.init(params), stacked2,
                             jax.random.PRNGKey(7))
        assert np.isfinite(float(loss2))


def test_abandoned_batches_generator_releases_threads():
    """Review regression: producer threads blocked forever on q.put when a
    consumer abandoned batches() early (evaluate() always does), leaking a
    thread + prefetched batches per call."""
    import threading
    import time

    from ignnition_tpu.data.synthetic import write_dataset
    from ignnition_tpu.training.trainer import Trainer

    import tempfile

    ir = parser.parse_model_description(
        copy.deepcopy(routenet_description(num_iterations=1, hs=8)),
        {"link_capacity": 1, "traffic": 1},
    )
    trainer = Trainer(build(ir))
    with tempfile.TemporaryDirectory() as d:
        write_dataset(d, 2, 10, seed=0, n_links=6, n_paths=8)
        before = threading.active_count()
        for _ in range(3):
            it = trainer.batches(d, 2, repeat=True, prefetch=2)
            next(it)
            it.close()  # abandon early
        deadline = time.time() + 10
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.1)
        assert threading.active_count() <= before, (
            f"{threading.active_count() - before} producer threads leaked"
        )


def test_accumulate_steps_with_mesh_raises():
    """Review regression: an explicit accumulate_steps>1 was silently
    ignored under a mesh (effective batch shrank with no warning)."""
    from jax.sharding import Mesh

    from ignnition_tpu.training.trainer import Trainer, TrainState

    ir = parser.parse_model_description(
        copy.deepcopy(routenet_description(num_iterations=1, hs=8)),
        {"link_capacity": 1, "traffic": 1},
    )
    trainer = Trainer(build(ir))
    state = trainer.init_state(jax.random.PRNGKey(0))
    devs = np.array(jax.devices()[:2]).reshape(2, 1)
    with pytest.raises(ValueError, match="accumulate_steps"):
        trainer.train(
            state, "/nonexistent", max_steps=1,
            mesh=Mesh(devs, ("data", "model")), accumulate_steps=4,
        )


def test_omitted_rng_with_dropout_warns():
    """Advisor-found (r4): omitting rng in the sharded train steps silently
    fell back to a CONSTANT PRNGKey(0) — dropout degraded to a static mask.
    A stochastic model must warn; a deterministic one must not."""
    import warnings as _warnings

    from jax.sharding import Mesh

    desc = routenet_description(num_iterations=1, hs=8)
    for nn in desc["neural_networks"]:
        if nn["nn_name"] == "readout_model":
            nn["nn_architecture"].insert(
                1, {"type_layer": "Dropout", "rate": 0.3}
            )
    ir = parser.parse_model_description(
        copy.deepcopy(desc), {"link_capacity": 1, "traffic": 1}
    )
    assert ir.stochastic_layer_kinds() == ("Dropout",)

    plain = parser.parse_model_description(
        copy.deepcopy(routenet_description(num_iterations=1, hs=8)),
        {"link_capacity": 1, "traffic": 1},
    )
    assert plain.stochastic_layer_kinds() == ()

    model = build(ir)
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    batch, meta = build_batch([s], ir)

    from ignnition_tpu.parallel import make_parallel_train_step, stack_batches
    from ignnition_tpu.training import get_loss
    import optax

    opt = optax.sgd(1e-2)
    params = model.init(jax.random.PRNGKey(0))
    loss_fn = get_loss(ir.learning.loss)
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("data", "model"))
    step = make_parallel_train_step(model, opt, loss_fn, meta, mesh)
    stacked, _ = stack_batches([(batch, meta), (batch, meta)], ir)
    with _warnings.catch_warnings(record=True) as caught:
        _warnings.simplefilter("always")
        step(params, opt.init(params), stacked)  # rng omitted
    assert any("CONSTANT PRNGKey(0)" in str(w.message) for w in caught)

    # deterministic model: no warning
    from ignnition_tpu.parallel.steps import _warn_constant_rng

    class _M:
        pass

    m = _M()
    m.ir = plain
    with _warnings.catch_warnings(record=True) as caught2:
        _warnings.simplefilter("always")
        _warn_constant_rng(m)
    assert not caught2

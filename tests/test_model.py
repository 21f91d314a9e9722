"""End-to-end forward-pass parity: the padded/merged/scanned
implementation vs a dense numpy oracle that follows the reference execution
order (generate_model.py:384-658) literally, graph by graph."""

import jax
import jax.numpy as jnp
import numpy as np

from ignnition_tpu.data import SampleSpec, build_batch, convert_sample
from ignnition_tpu.data.graph import PaddingConfig
from ignnition_tpu.frontend import parser
from ignnition_tpu.model import build

from helpers import TINY_SAMPLE, routenet_description

HS = 8


def _setup(num_iterations=2):
    ir = parser.parse_model_description(
        routenet_description(num_iterations=num_iterations, hs=HS),
        {"link_capacity": 1, "traffic": 1},
    )
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    return ir, model, params


def _np(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _gru(p, x, h):
    xw = x @ p["kernel"] + p["bias"][0]
    hw = h @ p["recurrent_kernel"] + p["bias"][1]
    xz, xr, xh = np.split(xw, 3, -1)
    hz, hr, hh = np.split(hw, 3, -1)
    z = 1 / (1 + np.exp(-(xz + hz)))
    r = 1 / (1 + np.exp(-(xr + hr)))
    return z * h + (1 - z) * np.tanh(xh + r * hh)


def _selu(x):
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    return scale * np.where(x > 0, x, alpha * (np.exp(x) - 1))


def _readout_mlp(p, x):
    h = _selu(x @ p["layers"][0]["kernel"] + p["layers"][0]["bias"])
    return h @ p["layers"][1]["kernel"] + p["layers"][1]["bias"]


def oracle_routenet(params, sample, num_iterations):
    """Reference-order dense computation for one graph of the RouteNet model."""
    p = _np(params)
    cap = np.asarray(sample["link_capacity"], np.float32).reshape(-1, 1)
    traf = np.asarray(sample["traffic"], np.float32).reshape(-1, 1)
    n_link, n_path = len(cap), len(traf)
    link = np.concatenate([cap, np.zeros((n_link, HS - 1), np.float32)], 1)
    path = np.concatenate([traf, np.zeros((n_path, HS - 1), np.float32)], 1)

    paths = {int(k[1:]): [int(l[1:]) for l in v] for k, v in sample["adj_links_paths"].items()}
    links_to_paths = {int(k[1:]): [int(x[1:]) for x in v] for k, v in sample["adj_paths_links"].items()}

    gru_path = p["update"]["path_update"]
    gru_link = p["update"]["link_update"]
    for _ in range(num_iterations):
        # stage1: ordered link->path, GRU over the link sequence
        new_path = path.copy()
        for pi in range(n_path):
            h = path[pi : pi + 1]
            for li in paths[pi]:
                h = _gru(gru_path, link[li : li + 1], h)
            new_path[pi] = h[0]
        path = new_path
        # stage2: sum path->link, single GRU step
        new_link = link.copy()
        for li in range(n_link):
            agg = np.zeros((1, HS), np.float32)
            for pi in links_to_paths.get(li, []):
                agg += path[pi : pi + 1]
            new_link[li] = _gru(gru_link, agg, link[li : li + 1])[0]
        link = new_link

    preds = _readout_mlp(p["readout"]["op0"], path)
    return preds[:, 0], link, path


def test_forward_matches_oracle():
    ir, model, params = _setup(num_iterations=2)
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    arrays, meta = build_batch([s], ir)
    preds, states = model.apply(params, arrays, meta, return_states=True)
    want_preds, want_link, want_path = oracle_routenet(params, TINY_SAMPLE, 2)
    np.testing.assert_allclose(preds[:2], want_preds, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(states["link"][:3], want_link, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(states["path"][:2], want_path, rtol=1e-4, atol=1e-5)


def test_padding_invariance():
    ir, model, params = _setup()
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    a1, m1 = build_batch([s], ir, PaddingConfig(mode="pow2", min_size=8))
    a2, m2 = build_batch([s], ir, PaddingConfig(mode="multiple", multiple=50, min_size=50))
    p1 = model.apply(params, a1, m1)
    p2 = model.apply(params, a2, m2)
    np.testing.assert_allclose(p1[:2], p2[:2], rtol=1e-4, atol=1e-6)


def test_merged_batch_equals_per_graph():
    ir, model, params = _setup()
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    single, m1 = build_batch([s], ir)
    double, m2 = build_batch([s, s], ir)
    p1 = model.apply(params, single, m1)
    p2 = model.apply(params, double, m2)
    np.testing.assert_allclose(p2[:2], p1[:2], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p2[2:4], p1[:2], rtol=1e-4, atol=1e-6)


def test_apply_is_jittable():
    ir, model, params = _setup()
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    arrays, meta = build_batch([s], ir)
    fn = jax.jit(lambda p, b: model.apply(p, b, meta))
    out = fn(params, {k: jnp.asarray(v) for k, v in arrays.items()})
    ref = model.apply(params, arrays, meta)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_grad_flows():
    ir, model, params = _setup()
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    arrays, meta = build_batch([s], ir)

    def loss(p):
        preds = model.apply(p, arrays, meta)
        return jnp.sum((preds * arrays["label_mask"]) ** 2)

    g = jax.grad(loss)(params)
    total = sum(
        float(jnp.abs(x).sum()) for x in jax.tree_util.tree_leaves(g)
    )
    assert total > 0


def test_fast_ordered_path_matches_scatter_path():
    """The gather-based ordered update (host CSR + custom-VJP time slices)
    must match the reference-shaped padded-scatter path in both values and
    gradients."""
    ir, model, params = _setup(num_iterations=3)
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    arrays, meta = build_batch([s], ir)
    _aux = ("row_ptr_", "lens_", "src_perm_", "src_row_ptr_", "src_sorted_",
            "dst_in_src_order_", "emask_src_order_", "slice_src_", "slice_sort_")
    slow = {
        k: v for k, v in arrays.items() if not any(k.startswith(p) for p in _aux)
    }

    p_fast = model.apply(params, arrays, meta)
    p_slow = model.apply(params, slow, meta)
    np.testing.assert_allclose(p_fast, p_slow, rtol=1e-5, atol=1e-6)

    def loss(p, b):
        preds = model.apply(p, b, meta)
        return jnp.sum((preds * b["label_mask"] - b["label"] * b["label_mask"]) ** 2)

    g_fast = jax.grad(loss)(params, arrays)
    g_slow = jax.grad(loss)(params, slow)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_fast), jax.tree_util.tree_leaves(g_slow)
    ):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_shared_adjacency_two_widths_builds():
    """One adjacency feeding two message passings with DIFFERENT message
    widths (review regression: message dims were keyed per adjacency, so the
    earlier MP's attention kernels were built at the later MP's width and
    apply crashed at trace time)."""
    import copy

    desc = routenet_description(num_iterations=2, hs=HS)
    for name, units in (("m8", HS), ("m16", 2 * HS)):
        desc["neural_networks"].append({
            "nn_name": name, "nn_type": "feed_forward",
            "nn_architecture": [
                {"type_layer": "Dense", "units": units, "activation": "relu"}
            ],
        })
    desc["neural_networks"].append({
        "nn_name": "upd_nn", "nn_type": "feed_forward",
        "nn_architecture": [
            {"type_layer": "Dense", "units": HS, "activation": "relu"}
        ],
    })
    stages = desc["message_passing"]["stages"]
    mp1 = stages[0]["stage_mp"][0]
    mp1["source_entities"][0]["message"] = [
        {"type": "neural_network", "nn_name": "m8", "input": ["hs_source"]}
    ]
    mp1["aggregation"] = {"type": "attention"}
    stages[1]["stage_mp"].append({
        "destination_entity": "path",
        "source_entities": [{
            "name": "link", "adj_vector": "adj_links_paths",
            "message": [{"type": "neural_network", "nn_name": "m16",
                         "input": ["hs_source"]}],
        }],
        "aggregation": {"type": "sum"},
        "update": {"type": "neural_network", "nn_name": "upd_nn"},
    })
    ir = parser.parse_model_description(
        copy.deepcopy(desc), {"link_capacity": 1, "traffic": 1}
    )
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    assert params["aggregation"]["s0/m0"]["kernel1"].shape == (HS, HS)
    spec = SampleSpec.from_ir(ir)
    s = convert_sample(TINY_SAMPLE, spec)
    batch, meta = build_batch([s], ir)
    model.apply(params, batch, meta)  # traced without dim mismatch


def test_shared_ff_update_l2_counted_once():
    """The per-destination feed-forward update is one shared parameter set;
    its l2 penalty must be counted once, like Keras model.losses counts one
    loss per layer (review regression: it was added once per message
    passing)."""
    import copy

    from ignnition_tpu.nn import mlp as MLP

    desc = routenet_description(num_iterations=1, hs=HS)
    desc["neural_networks"].append({
        "nn_name": "ff_upd", "nn_type": "feed_forward",
        "nn_architecture": [
            {"type_layer": "Dense", "units": HS, "activation": "relu",
             "kernel_regularizer": 0.5}
        ],
    })
    stages = desc["message_passing"]["stages"]
    # both stages update 'path' from the same adjacency with the SAME
    # shared ff update
    for st in stages:
        st["stage_mp"] = [{
            "destination_entity": "path",
            "source_entities": [{
                "name": "link", "adj_vector": "adj_links_paths",
                "message": [{"type": "direct_assignation"}],
            }],
            "aggregation": {"type": "sum"},
            "update": {"type": "neural_network", "nn_name": "ff_upd"},
        }]
    ir = parser.parse_model_description(
        copy.deepcopy(desc), {"link_capacity": 1, "traffic": 1}
    )
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    upd_spec = ir.stages[0].passes[0].update.mlp
    expected = MLP.l2_loss(upd_spec, params["update"]["path_ff_update"])
    for op in ir.readout:
        if op.kind in ("predict", "neural_network"):
            i = ir.readout.index(op)
            expected = expected + MLP.l2_loss(
                op.mlp, params["readout"][f"op{i}"]
            )
    np.testing.assert_allclose(
        float(model.regularization_loss(params)), float(expected), rtol=1e-6
    )

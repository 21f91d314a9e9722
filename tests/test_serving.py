"""Serving export/reload: the frozen StableHLO artifact reproduces
model.apply exactly, checks input signatures, applies denormalization, and
round-trips through Runner.export_serving."""

import json
import os

import jax
import numpy as np
import pytest

from ignnition_tpu.config import RunConfig
from ignnition_tpu.data import SampleSpec, build_batch, iter_samples
from ignnition_tpu.data.graph import PaddingConfig
from ignnition_tpu.data.synthetic import write_dataset
from ignnition_tpu.frontend import parser
from ignnition_tpu.model import build
from ignnition_tpu.serving import export_serving, load_serving

from helpers import routenet_description


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_ds")
    write_dataset(str(d), num_archives=2, samples_per_archive=6, seed=11)
    return str(d)


@pytest.fixture(scope="module")
def setup(dataset):
    desc = routenet_description(num_iterations=2, hs=8)
    for op in desc["readout"]:
        if op["type"] == "predict":
            op["label_denormalization"] = "exp"
    ir = parser.parse_model_description(
        desc, {"link_capacity": 1, "traffic": 1}
    )
    model = build(ir)
    params = model.init(jax.random.PRNGKey(0))
    spec = SampleSpec.from_ir(ir, training=False)
    samples = [s for s in iter_samples(dataset, spec)]
    arrays, meta = build_batch(
        samples[:4], ir, padding=PaddingConfig(min_size=16)
    )
    return ir, model, params, spec, samples, arrays, meta


def test_export_reload_matches_apply(setup, tmp_path):
    ir, model, params, spec, samples, arrays, meta = setup
    out = export_serving(
        model, params, meta, arrays, str(tmp_path / "artifact")
    )
    sm = load_serving(out)

    want = np.asarray(model.apply(params, arrays, meta))
    got = sm.predict(arrays, denormalize=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    # denormalization by registered name ("exp" inverts the log label norm)
    de = sm.predict(arrays)
    np.testing.assert_allclose(de, np.exp(want), rtol=1e-5)

    # trimming drops padded prediction rows
    trimmed = sm.trim(got, arrays)
    n_real = int(np.sum(arrays["node_mask_path"] > 0))
    assert trimmed.shape[0] == n_real

    # manifest records the input signature and label info
    man = json.load(open(os.path.join(out, "MANIFEST.json")))
    assert man["label_name"] == "delay"
    assert "label" not in man["inputs"] and "label_mask" not in man["inputs"]


def test_exported_program_round_trip(tmp_path):
    """forward.bin + forward.json rebuild the jax.export.Exported field for
    field, and the rebuilt program computes what the original does."""
    from jax import export as jax_export

    from ignnition_tpu.serving import _load_exported, _save_exported

    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": None}
    inputs = {"x": np.ones((4, 2), np.float32)}

    def fwd(p, batch):
        return batch["x"] @ p["w"]

    specs = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), (params, inputs)
    )
    exported = jax_export.export(jax.jit(fwd), disabled_checks=[
        jax_export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton"),
    ])(*specs)
    _save_exported(exported, str(tmp_path))
    back = _load_exported(str(tmp_path), params, {"x": 0})
    for field in ("fun_name", "in_tree", "in_avals", "out_tree", "out_avals",
                  "platforms", "disabled_safety_checks", "nr_devices",
                  "calling_convention_version", "module_kept_var_idx",
                  "uses_global_constants", "mlir_module_serialized"):
        assert getattr(back, field) == getattr(exported, field), field
    np.testing.assert_array_equal(
        np.asarray(back.call(params, inputs)), inputs["x"] @ params["w"]
    )


def test_older_artifact_format_is_refused(setup, tmp_path):
    """An artifact of format 1 (jax.export's flatbuffers blob) fails the
    version check with its own message, not later on a missing file."""
    ir, model, params, spec, samples, arrays, meta = setup
    out = export_serving(
        model, params, meta, arrays, str(tmp_path / "artifact")
    )
    path = os.path.join(out, "MANIFEST.json")
    manifest = json.load(open(path))
    assert manifest["format"] == 2
    manifest["format"] = 1
    json.dump(manifest, open(path, "w"))
    with pytest.raises(ValueError, match="unsupported serving artifact "
                                         "format 1"):
        load_serving(out)


def test_serving_input_checks(setup, tmp_path):
    ir, model, params, spec, samples, arrays, meta = setup
    out = export_serving(
        model, params, meta, arrays, str(tmp_path / "artifact")
    )
    sm = load_serving(out)

    bad = dict(arrays)
    bad.pop("traffic")
    with pytest.raises(ValueError, match="missing input 'traffic'"):
        sm.predict(bad)

    bad = dict(arrays)
    bad["traffic"] = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError, match="exported for"):
        sm.predict(bad)


def test_serving_smaller_samples_pinned_batch(setup, tmp_path):
    """Smaller new samples batch directly to the exported shapes via
    build_batch(target=meta) and serve correctly (matching direct apply on
    the same pinned arrays)."""
    ir, model, params, spec, samples, arrays, meta = setup
    out = export_serving(
        model,
        params,
        meta,
        arrays,
        str(tmp_path / "artifact"),
        description=routenet_description(num_iterations=2, hs=8),
    )
    sm = load_serving(out)

    # same graph count (serving batch size is fixed), smaller graphs —
    # would bucket to smaller pads without pinning
    small_dir = tmp_path / "small_ds"
    write_dataset(
        str(small_dir), num_archives=1, samples_per_archive=4, seed=5,
        n_links=8, n_paths=6,
    )
    small_samples = list(iter_samples(str(small_dir), spec))
    pinned_arrays, pinned_meta = build_batch(
        small_samples[:4], ir, training=False, target=meta
    )
    assert pinned_meta == meta
    got = sm.predict(pinned_arrays, denormalize=False)
    want = np.asarray(model.apply(params, pinned_arrays, meta))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    # pinned batching must match an unpinned batch's predictions sample-
    # for-sample (padding is semantics-free)
    free_arrays, free_meta = build_batch(small_samples[:4], ir, training=False)
    free_preds = np.asarray(model.apply(params, free_arrays, free_meta))
    mask_p = np.asarray(pinned_arrays["node_mask_path"]) > 0
    mask_f = np.asarray(free_arrays["node_mask_path"]) > 0
    np.testing.assert_allclose(
        got[mask_p], free_preds[mask_f], rtol=1e-5, atol=1e-6
    )

    # the self-contained path: raw samples in, trimmed predictions out
    served = sm.predict_samples(small_samples[:4], denormalize=False)
    np.testing.assert_allclose(served, got[mask_p], rtol=1e-6, atol=1e-6)

    # a batch that cannot fit raises a friendly error
    small_target = build_batch(small_samples[:4], ir, training=False)[1]
    with pytest.raises(ValueError, match="does not fit the target meta"):
        build_batch(samples[:4], ir, training=False, target=small_target)
    with pytest.raises(ValueError, match="graphs per batch"):
        build_batch(samples[:2], ir, training=False, target=meta)


def test_serving_qsize_interleave(tmp_path):
    """Full-DSL surface through the artifact: Q-size (3 entities, interleave
    aggregation) exports, reloads, and serves raw samples."""
    from helpers import qsize_description

    d = tmp_path / "qsize_ds"
    write_dataset(str(d), num_archives=1, samples_per_archive=6, seed=13,
                  with_nodes=True)
    desc = qsize_description(num_iterations=2, hs=8)
    ir = parser.parse_model_description(
        desc, {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
    )
    model = build(ir)
    params = model.init(jax.random.PRNGKey(2))
    spec = SampleSpec.from_ir(ir, training=False)
    samples = list(iter_samples(str(d), spec))
    arrays, meta = build_batch(samples[:3], ir, training=False)

    out = export_serving(
        model, params, meta, arrays, str(tmp_path / "artifact"),
        description=desc,
    )
    sm = load_serving(out)
    want = np.asarray(model.apply(params, arrays, meta))
    got = sm.predict(_strip(arrays), denormalize=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    served = sm.predict_samples(samples[3:6], denormalize=False)
    direct_arrays, direct_meta = build_batch(
        samples[3:6], ir, training=False, target=meta
    )
    direct = np.asarray(model.apply(params, direct_arrays, direct_meta))
    np.testing.assert_allclose(
        served,
        direct[np.asarray(direct_arrays[f"node_mask_{sm.label_domain[1]}"]) > 0],
        rtol=1e-6,
        atol=1e-6,
    )


def _strip(arrays):
    return {k: v for k, v in arrays.items() if k not in ("label", "label_mask")}


def test_runner_export_serving(dataset, tmp_path):
    import ignnition_tpu as ig

    json_path = tmp_path / "model_description.json"
    json_path.write_text(
        json.dumps(routenet_description(num_iterations=2, hs=8))
    )
    cfg = RunConfig(
        train_dataset=dataset,
        eval_dataset=dataset,
        predict_dataset=dataset,
        json_path=str(json_path),
        model_dir=str(tmp_path / "ckpts"),
        debug_dir=str(tmp_path / "debug"),
        batch_size=2,
        train_steps=2,
        eval_samples=1,
        save_checkpoints_secs=10_000,
        throttle_secs=10_000,
    )
    model = ig.create_model(cfg)
    runner = ig.Runner(model, padding=PaddingConfig(min_size=16))
    state = runner.train_and_evaluate()
    out = runner.export_serving(str(tmp_path / "artifact"), state=state)
    sm = ig.load_serving(out)

    # serve the first predict batch; compare against Runner.predict
    arrays, meta = next(
        iter(
            runner.trainer.batches(
                dataset, 2, shuffle=False, repeat=False, training=False
            )
        )
    )
    preds = sm.trim(sm.predict(arrays), arrays)
    ref = runner.predict(state)[0]
    np.testing.assert_allclose(
        preds[: len(ref)], ref, rtol=1e-5, atol=1e-6
    )

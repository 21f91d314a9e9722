"""Training-loop integration: loss decreases on synthetic data, checkpoints
round-trip, evaluation metrics behave, the full api verbs run."""

import logging
import os

import jax
import numpy as np
import pytest

from ignnition_tpu.config import RunConfig
from ignnition_tpu.data.graph import PaddingConfig
from ignnition_tpu.data.synthetic import write_dataset
from ignnition_tpu.frontend import parser
from ignnition_tpu.model import build
from ignnition_tpu.training import Trainer, build_optimizer, build_schedule, get_loss
from ignnition_tpu.frontend.ir import OptimizerSpec, ScheduleSpec

from helpers import routenet_description


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    write_dataset(str(d), num_archives=2, samples_per_archive=6, seed=3,
                  n_links=12, n_paths=8, max_path_len=4)
    return str(d)


@pytest.fixture(scope="module")
def trainer():
    ir = parser.parse_model_description(
        routenet_description(num_iterations=3, hs=12),
        {"link_capacity": 1, "traffic": 1},
    )
    return Trainer(build(ir), padding=PaddingConfig(min_size=16))


def test_schedule_exponential_decay():
    s = build_schedule(
        ScheduleSpec(
            "ExponentialDecay",
            {"initial_learning_rate": 0.1, "decay_steps": 10, "decay_rate": 0.5},
        )
    )
    np.testing.assert_allclose(float(s(0)), 0.1, rtol=1e-6)
    np.testing.assert_allclose(float(s(10)), 0.05, rtol=1e-6)
    # staircase as a string, as the Q-size example writes it
    s2 = build_schedule(
        ScheduleSpec(
            "ExponentialDecay",
            {
                "initial_learning_rate": 0.1,
                "decay_steps": 10,
                "decay_rate": 0.5,
                "staircase": "True",
            },
        )
    )
    np.testing.assert_allclose(float(s2(9)), 0.1, rtol=1e-6)


def test_optimizer_names():
    for kind in ["Adam", "SGD", "RMSprop", "Adagrad", "Adamax", "Nadam", "AdamW"]:
        opt = build_optimizer(OptimizerSpec(kind, {"learning_rate": 0.01}))
        assert opt.init is not None


def test_masked_loss_matches_dense():
    fn = get_loss("MeanSquaredError")
    labels = np.array([1.0, 2.0, 0.0, 0.0], np.float32)
    preds = np.array([1.5, 1.0, 9.0, 9.0], np.float32)
    mask = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    got = float(fn(labels, preds, mask))
    want = np.mean([(1.5 - 1.0) ** 2, (1.0 - 2.0) ** 2])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_loss_decreases(dataset, trainer):
    state = trainer.init_state(jax.random.PRNGKey(0))
    losses = []
    for i, (arrays, meta) in enumerate(trainer.batches(dataset, 4, repeat=True)):
        if i >= 30:
            break
        step = trainer.train_step_fn(meta)
        params, opt_state, logs = step(
            state.params, state.opt_state, arrays, jax.random.PRNGKey(i)
        )
        from ignnition_tpu.training.trainer import TrainState

        state = TrainState(params, opt_state, state.step + 1)
        losses.append(float(logs["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses


def test_evaluate_metrics(dataset, trainer):
    state = trainer.init_state(jax.random.PRNGKey(0))
    out = trainer.evaluate(state, dataset, num_batches=3, batch_size=2)
    for k in ("label/mean", "prediction/mean", "mae", "mre", "r-squared", "loss"):
        assert k in out
        assert np.isfinite(out[k])


def test_checkpoint_roundtrip(dataset, trainer, tmp_path):
    from ignnition_tpu.training.trainer import (
        _make_checkpoint_manager,
        restore_checkpoint,
        save_checkpoint,
        warm_start,
    )

    state = trainer.init_state(jax.random.PRNGKey(1))
    mgr = _make_checkpoint_manager(str(tmp_path / "ckpt"), keep_max=3)
    save_checkpoint(mgr, state)

    state2 = trainer.init_state(jax.random.PRNGKey(2))
    restored = restore_checkpoint(mgr, state2)
    l1 = jax.tree_util.tree_leaves(state.params)
    l2 = jax.tree_util.tree_leaves(restored.params)
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(a, b)

    warm = warm_start(state2, str(tmp_path / "ckpt"))
    for a, b in zip(l1, jax.tree_util.tree_leaves(warm.params)):
        np.testing.assert_allclose(a, b)
    assert warm.step == 0  # warm start does not restore the step


def test_checkpoint_keep_max_and_atomic_layout(trainer, tmp_path):
    """Only the newest keep_max checkpoints survive; each is a complete
    ckpt_<step>/ directory (npz leaves + JSON trees) and no temporary
    directory is left behind; re-saving a step replaces it."""
    from ignnition_tpu.training.trainer import (
        CheckpointManager, TrainState, restore_checkpoint, save_checkpoint,
    )

    state = trainer.init_state(jax.random.PRNGKey(3))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_max=2)
    for step in (1, 2, 3, 3):
        save_checkpoint(mgr, TrainState(state.params, state.opt_state, step))
    assert mgr.steps() == [2, 3]
    assert sorted(os.listdir(mgr.directory)) == ["ckpt_2", "ckpt_3"]
    assert sorted(os.listdir(os.path.join(mgr.directory, "ckpt_3"))) == [
        "opt_state.npz", "opt_state_tree.json", "params.npz",
        "params_tree.json",
    ]
    restored = restore_checkpoint(mgr, trainer.init_state(jax.random.PRNGKey(4)))
    assert restored.step == 3
    # the optimizer state keeps its container types (optax named tuples)
    assert jax.tree_util.tree_structure(restored.opt_state) == (
        jax.tree_util.tree_structure(state.opt_state)
    )
    for a, b in zip(jax.tree_util.tree_leaves(state.opt_state),
                    jax.tree_util.tree_leaves(restored.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_warm_start_and_resume(dataset, trainer, tmp_path):
    """Training resumes from the latest checkpoint in its directory; warm
    start restores parameters only; a mismatched model is refused."""
    from ignnition_tpu.training.trainer import CheckpointManager, warm_start

    ckpt = str(tmp_path / "run")
    state = trainer.train(trainer.init_state(jax.random.PRNGKey(5)), dataset,
                          max_steps=2, batch_size=2, log_every=0,
                          checkpoint_dir=ckpt)
    assert CheckpointManager(ckpt).steps() == [2]
    resumed = trainer.train(trainer.init_state(jax.random.PRNGKey(6)),
                            dataset, max_steps=3, batch_size=2, log_every=0,
                            checkpoint_dir=ckpt)
    assert resumed.step == 3 and CheckpointManager(ckpt).steps() == [2, 3]

    fresh = trainer.init_state(jax.random.PRNGKey(7))
    warm = warm_start(fresh, ckpt)
    assert warm.step == 0 and warm.opt_state is fresh.opt_state
    for a, b in zip(jax.tree_util.tree_leaves(resumed.params),
                    jax.tree_util.tree_leaves(warm.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(FileNotFoundError):
        warm_start(fresh, str(tmp_path / "missing"))

    other = Trainer(build(parser.parse_model_description(
        routenet_description(num_iterations=2, hs=8),
        {"link_capacity": 1, "traffic": 1},
    )))
    with pytest.raises(ValueError, match="does not match"):
        warm_start(other.init_state(jax.random.PRNGKey(0)), ckpt)


def test_api_verbs_end_to_end(dataset, tmp_path, caplog):
    import json

    from helpers import routenet_description
    import ignnition_tpu as ig

    json_path = tmp_path / "model_description.json"
    json_path.write_text(json.dumps(routenet_description(num_iterations=2, hs=8)))
    cfg = RunConfig(
        train_dataset=dataset,
        eval_dataset=dataset,
        predict_dataset=dataset,
        json_path=str(json_path),
        model_dir=str(tmp_path / "ckpts"),
        debug_dir=str(tmp_path / "debug"),
        batch_size=2,
        train_steps=5,
        eval_samples=2,
        save_checkpoints_secs=10_000,
        throttle_secs=10_000,
    )
    model = ig.create_model(cfg)
    runner = ig.Runner(model, padding=PaddingConfig(min_size=16))
    state = runner.train_and_evaluate()
    assert state.step == 5

    preds = runner.predict(state)
    assert len(preds) > 0
    assert all(np.isfinite(p).all() for p in preds)

    out_dir = ig.debug(model)
    assert os.path.exists(os.path.join(out_dir, "structure.txt"))
    assert os.path.exists(os.path.join(out_dir, "params.txt"))
    assert os.path.exists(os.path.join(out_dir, "model.hlo.txt"))
    text = open(os.path.join(out_dir, "structure.txt")).read()
    assert "message_passing" in text and "readout" in text


def test_grad_accumulation_matches_single_step(dataset, trainer):
    """Accumulating two identical microbatches == one plain step on that
    batch (grad mean of identical grads)."""
    import jax.numpy as jnp
    from ignnition_tpu.data import SampleSpec, build_batch, iter_samples

    spec = SampleSpec.from_ir(trainer.ir)
    samples = list(iter_samples(dataset, spec))[:4]
    arrays, meta = build_batch(samples, trainer.ir, trainer.padding)

    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(7)

    p1, o1, logs1 = trainer.train_step_fn(meta)(
        state.params, state.opt_state, arrays, rng
    )
    stacked = jax.tree.map(lambda a: np.stack([a, a], axis=0), arrays)
    p2, o2, logs2 = trainer.accum_train_step_fn(meta, 2)(
        state.params, state.opt_state, stacked, rng
    )
    np.testing.assert_allclose(
        float(logs1["loss"]), float(logs2["loss"]), rtol=1e-5
    )
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5
        )


def test_grad_accumulation_sum_reduction_loss(dataset):
    """For SUM-reduction losses (keras KLDivergence) accumulation must SUM
    microbatch gradients (minus the extra reg copies), equalling one step on
    the merged concatenation — exact even for unequal microbatch sizes
    (review-found: the mean combiner was applied to every loss)."""
    from ignnition_tpu.data import SampleSpec, build_batch, iter_samples

    desc = routenet_description(num_iterations=2, hs=8)
    desc["learning_options"]["loss"] = "KLDivergence"
    del desc["readout"][0]["label_normalization"]
    ir = parser.parse_model_description(desc, {"link_capacity": 1, "traffic": 1})
    tr = Trainer(build(ir), padding=PaddingConfig(min_size=16))

    spec = SampleSpec.from_ir(ir)
    samples = list(iter_samples(dataset, spec))[:2]
    a1, m1 = build_batch([samples[0]], ir, tr.padding)
    a2, m2 = build_batch([samples[1]], ir, tr.padding)
    assert m1 == m2, "need one shape for stacking"
    from ignnition_tpu.data.graph import merge_metas  # noqa: F401

    big, mb = build_batch(samples, ir, tr.padding)

    state = tr.init_state(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(7)
    p_big, _, logs_big = tr.train_step_fn(mb)(
        state.params, state.opt_state, big, rng
    )
    stacked = jax.tree.map(lambda x, y: np.stack([x, y], 0), a1, a2)
    p_acc, _, logs_acc = tr.accum_train_step_fn(m1, 2)(
        state.params, state.opt_state, stacked, rng
    )
    np.testing.assert_allclose(
        float(logs_acc["loss"]), float(logs_big["loss"]), rtol=1e-5
    )
    for a, b in zip(jax.tree.leaves(p_acc), jax.tree.leaves(p_big)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_train_loop_with_accumulation(dataset, trainer):
    state = trainer.init_state(jax.random.PRNGKey(1))
    state = trainer.train(
        state, dataset, max_steps=3, batch_size=2, accumulate_steps=2,
        log_every=0,
    )
    assert state.step == 3
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(state.params))


def test_multi_worker_batches_complete_and_valid(dataset, trainer):
    """workers>1 yields every SAMPLE exactly once; batch composition is
    nondeterministic (parallel archive readers interleave samples)."""
    one = list(trainer.batches(dataset, batch_size=4, repeat=False))
    many = list(trainer.batches(dataset, batch_size=4, repeat=False, workers=3))
    assert len(many) == len(one)

    def labels(batches):
        out = []
        for arrays, _ in batches:
            m = np.asarray(arrays["label_mask"]) > 0
            out.extend(np.round(np.asarray(arrays["label"])[m], 5).tolist())
        return sorted(out)

    assert labels(many) == labels(one)


def test_cached_batches_cycle_and_reshuffle(dataset, trainer):
    one_epoch = list(trainer.batches(dataset, batch_size=4, repeat=False))
    it = trainer.batches(dataset, batch_size=4, shuffle=True, seed=2,
                         repeat=True, cache=True)
    n = len(one_epoch)
    first = [next(it) for _ in range(n)]
    second = [next(it) for _ in range(n)]
    key = lambda b: tuple(sorted((k, float(np.sum(v))) for k, v in b[0].items()))
    # same batch SET each epoch (composition frozen), order reshuffled
    assert sorted(key(b) for b in first) == sorted(key(b) for b in second)
    # covers the whole dataset (same number of batches as a plain epoch)
    assert len(first) == len(one_epoch)


def test_resume_within_run_from_latest_checkpoint(dataset, trainer, tmp_path):
    """A second train() over the same checkpoint_dir resumes at the saved
    step instead of restarting (reference: estimator model_dir behavior)."""
    ckpt = str(tmp_path / "run")
    s1 = trainer.train(
        trainer.init_state(), dataset, max_steps=4, batch_size=4,
        checkpoint_dir=ckpt, save_secs=0,
    )
    assert s1.step == 4
    # fresh state; the checkpoint should take over
    s2 = trainer.train(
        trainer.init_state(jax.random.PRNGKey(9)), dataset, max_steps=7,
        batch_size=4, checkpoint_dir=ckpt, save_secs=10**9,
    )
    assert s2.step == 7
    # a third call with max_steps already reached trains zero steps and
    # returns the checkpointed state
    s3 = trainer.train(
        trainer.init_state(jax.random.PRNGKey(3)), dataset, max_steps=7,
        batch_size=4, checkpoint_dir=ckpt, save_secs=10**9,
    )
    assert s3.step == 7
    for a, b in zip(jax.tree.leaves(s2.params), jax.tree.leaves(s3.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_runconfig_ini_pipeline_keys(tmp_path):
    ini = tmp_path / "train_options.ini"
    ini.write_text(
        "[PATHS]\ntrain_dataset = /tmp/x\njson_path = m.json\n"
        "[TRAINING_OPTIONS]\nbatch_size = 5\ninput_workers = 3\n"
        "cache_batches = True\naccumulate_steps = 2\n"
    )
    cfg = RunConfig.from_ini(str(ini))
    assert cfg.batch_size == 5
    assert cfg.input_workers == 3
    assert cfg.cache_batches is True
    assert cfg.accumulate_steps == 2


def test_packed_transfer_roundtrip_and_step_parity(dataset, trainer):
    """pack/unpack round-trips every dtype (incl. extension dtypes) and the
    packed jit step is bit-identical to the per-array step."""
    import ml_dtypes

    from ignnition_tpu.data import SampleSpec, build_batch, iter_samples
    from ignnition_tpu.training.packing import (
        pack_arrays, pack_layout, unpack_arrays,
    )

    # round-trip, mixed dtypes
    arrs = {
        "a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "b": np.arange(5, dtype=np.int32),
        "c": np.array([[1, 0], [0, 1]], dtype=bool),
        "d": np.arange(6, dtype=ml_dtypes.bfloat16).reshape(2, 3),
    }
    layout = pack_layout(arrs)
    back = unpack_arrays(pack_arrays(arrs, layout), layout)
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(np.asarray(back[k]), v)

    # jit-step parity on a real batch
    spec = SampleSpec.from_ir(trainer.ir)
    samples = list(iter_samples(dataset, spec))[:3]
    arrays, meta = build_batch(samples, trainer.ir, trainer.padding)
    layout = pack_layout(arrays)
    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(5)
    p1, o1, l1 = trainer.train_step_fn(meta)(
        state.params, state.opt_state, arrays, rng
    )
    p2, o2, l2 = trainer.train_step_fn(meta, layout=layout)(
        state.params, state.opt_state, pack_arrays(arrays, layout), rng
    )
    np.testing.assert_array_equal(float(l1["loss"]), float(l2["loss"]))
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_loop_packed_vs_unpacked(dataset, trainer):
    """Trainer.train with pack_transfer on/off walks the same parameter
    trajectory (same batches, same rngs)."""
    kw = dict(
        max_steps=3, batch_size=2, shuffle=False, log_every=0,
        device_prefetch=0, rng=jax.random.PRNGKey(11),
    )
    s1 = trainer.train(
        trainer.init_state(jax.random.PRNGKey(4)), dataset,
        pack_transfer=False, **kw,
    )
    s2 = trainer.train(
        trainer.init_state(jax.random.PRNGKey(4)), dataset,
        pack_transfer=True, **kw,
    )
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_loop_device_cached_batches(dataset, trainer):
    """cache_batches="device" trains identically to host batches (same
    batches, same rngs) with zero steady-state transfers."""
    kw = dict(
        max_steps=4, batch_size=2, shuffle=False, log_every=0,
        rng=jax.random.PRNGKey(11),
    )
    s1 = trainer.train(trainer.init_state(jax.random.PRNGKey(4)), dataset, **kw)
    s2 = trainer.train(
        trainer.init_state(jax.random.PRNGKey(4)), dataset,
        cache_batches="device", **kw,
    )
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_runconfig_ini_cache_device(tmp_path):
    ini = tmp_path / "train_options.ini"
    ini.write_text(
        "[PATHS]\ntrain_dataset = /tmp/x\njson_path = m.json\n"
        "[TRAINING_OPTIONS]\ncache_batches = device\ndevice_prefetch = 3\n"
    )
    cfg = RunConfig.from_ini(str(ini))
    assert cfg.cache_batches == "device"
    assert cfg.device_prefetch == 3


def test_device_cache_downgrades_for_accumulation(dataset, trainer):
    """cache_batches='device' + accumulate_steps>1 must not bounce device
    arrays back through np.stack — it downgrades to host caching."""
    state = trainer.train(
        trainer.init_state(jax.random.PRNGKey(1)), dataset, max_steps=2,
        batch_size=2, accumulate_steps=2, cache_batches="device",
        log_every=0,
    )
    assert state.step == 2


def test_evaluate_cache_reuses_batches(dataset, trainer):
    state = trainer.init_state(jax.random.PRNGKey(0))
    r1 = trainer.evaluate(state, dataset, num_batches=3, cache=True)
    assert len(trainer._eval_batches) == 1
    r2 = trainer.evaluate(state, dataset, num_batches=3, cache=True)
    assert r1 == r2
    r3 = trainer.evaluate(state, dataset, num_batches=3)
    for k in ("mae", "loss"):
        np.testing.assert_allclose(r1[k], r3[k], rtol=1e-6)


def test_auto_accumulate_strategy(tmp_path):
    """'auto' splits large-graph batches into accumulation microbatches and
    leaves small-graph workloads on plain merged batches
    (Trainer._auto_accumulate; PERF.md 'Large effective batches')."""
    from ignnition_tpu.data.synthetic import write_dataset
    from ignnition_tpu.frontend import parser as P
    from ignnition_tpu.model import build as build_model
    from ignnition_tpu.training.trainer import Trainer

    d = str(tmp_path / "small")
    write_dataset(d, 1, 6, seed=0)
    ir = P.parse_model_description(
        routenet_description(num_iterations=1, hs=8),
        {"link_capacity": 1, "traffic": 1},
    )
    tr = Trainer(build_model(ir))
    k, micro = tr._auto_accumulate(d, 4)
    assert (k, micro) == (1, 4)  # tiny graphs: plain merged batch

    # pretend the dataset's graphs are flagship-sized: the target splits
    tr._TARGET_MICROBATCH_EDGES = 10  # with ~30-edge graphs -> micro=1
    k, micro = tr._auto_accumulate(d, 4)
    assert k == 4 and micro == 1


def test_auto_accumulate_respects_per_graph_blocks(tmp_path):
    """With per-graph block padding the merged-blocks path is the measured
    fastest large-batch mode — auto accumulation must not split it."""
    from ignnition_tpu.data.graph import PaddingConfig
    from ignnition_tpu.data.synthetic import write_dataset
    from ignnition_tpu.frontend import parser as P
    from ignnition_tpu.model import build as build_model
    from ignnition_tpu.training.trainer import Trainer

    d = str(tmp_path / "ds")
    write_dataset(d, 1, 4, seed=0)
    ir = P.parse_model_description(
        routenet_description(num_iterations=1, hs=8),
        {"link_capacity": 1, "traffic": 1},
    )
    tr = Trainer(build_model(ir), padding=PaddingConfig(per_graph=True))
    tr._TARGET_MICROBATCH_EDGES = 10  # would otherwise force a split
    assert tr._auto_accumulate(d, 4) == (1, 4)

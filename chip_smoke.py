"""Smoke test of the whole system on the GPU, in one process.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # phase 5 alone, on four cards

Phases (one card):
  0  set-up: build the native loader (make -C native) and write a seeded
     reference-format RouteNet dataset at flagship width (2048 links,
     16384 paths, path length <= 8);
  1  train the flagship RouteNet (hs=32, 8 iterations, GRU updates on an
     ordered and a sum stage, 256-256-1 readout) through RunConfig ->
     create_model -> train_and_evaluate at bf16 compute, with a checkpoint
     written and read back, then predict; the f32 data loss over the four
     training graphs, evaluated after every step, must have a median over
     the second half of training below its value before training;
  2  the same with stage 2's aggregation set to attention: a [2048, 16384]
     int8 incidence matrix on the flash-GAT kernels;
  3  serve both models: export_serving -> load_serving -> predict_samples
     on a few request batches, compared with jitted direct apply;
  4  kernel parity: the flash-GAT kernels against the plain float32 XLA
     reference at [2048, 16384], D=32, forward and gradients, bf16 and f32
     (bf16 also with messages that share a component, against XLA's own
     bf16 error); and the attention model's data-loss gradient through the
     flash kernels against the float32 reference.
Phase 5 (--four-cards): a destination-sharded (model=4) and a
data-parallel (data=4) flagship train step, each against the single-card
step on the same batch.

Every phase prints compile seconds, steady milliseconds (host clock around
block_until_ready) and the process's peak device memory so far; every
parity error is printed beside its tolerance. Any failure raises, so the
process exits non-zero; it also refuses to run without a GPU. The last
line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import ignnition_tpu as ig  # noqa: E402  (fails outside a checkout)
from __graft_entry__ import flagship_description, make_flagship_sample  # noqa: E402
from bench import card_info  # noqa: E402
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

N_LINKS, N_PATHS, MAX_PATH_LEN = 2048, 16384, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes():
    """The process's peak device memory so far (none on the CPU)."""
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def timed(fn, *args, iters: int = 10):
    """(compile seconds, steady ms per call, last output) of jit(fn)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = compiled(*args)
    jax.block_until_ready(out)
    return compile_s, (time.perf_counter() - t0) / iters * 1e3, out


def report(phase: str, compile_s: float, step_ms: float, what: str) -> None:
    log(f"[{phase}] compile {compile_s:.2f} s, steady {step_ms:.3f} ms "
        f"per {what}, peak device memory {peak_bytes()} bytes")


def check_err(name: str, got, want, tol: float, reason: str) -> None:
    """Max abs and relative error (relative to max |want|) against `tol`
    on the relative error; raises when it is exceeded."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape} "
                             f"or non-finite values")
    err = float(np.max(np.abs(got - want)))
    rel = err / max(float(np.max(np.abs(want))), 1e-30)
    ok = rel <= tol
    log(f"  parity {name}: max abs err {err:.3e}, rel err {rel:.3e} "
        f"(tolerance {tol:.0e}: {reason}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {tol:.0e}")


# --------------------------------------------------------------------------
# phase 0
# --------------------------------------------------------------------------


def setup(work: str, n_links: int, n_paths: int) -> dict:
    from ignnition_tpu.data.synthetic import write_dataset

    t0 = time.perf_counter()
    subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "native")],
                   check=True)
    from ignnition_tpu.data import native_loader

    if not native_loader.available():
        raise RuntimeError("native loader did not build")
    dirs = {k: os.path.join(work, k) for k in ("train", "eval")}
    write_dataset(dirs["train"], num_archives=2, samples_per_archive=2,
                  seed=0, n_links=n_links, n_paths=n_paths,
                  max_path_len=MAX_PATH_LEN)
    write_dataset(dirs["eval"], num_archives=1, samples_per_archive=2,
                  seed=1, n_links=n_links, n_paths=n_paths,
                  max_path_len=MAX_PATH_LEN)
    log(f"[setup] native loader built, datasets written "
        f"({n_links} links x {n_paths} paths) in "
        f"{time.perf_counter() - t0:.1f} s")
    return dirs


# --------------------------------------------------------------------------
# phases 1 and 2
# --------------------------------------------------------------------------


def _attention(description):
    description["message_passing"]["stages"][1]["stage_mp"][0][
        "aggregation"] = {"type": "attention"}


class _TrainSetLosses(logging.Handler):
    """Collects the loss of the trainer's periodic evaluation, which the
    smoke points at the training graphs and runs after every step."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.values = []

    def emit(self, record):
        if record.msg.startswith("eval @ step"):
            self.values.append(float(record.args[1]["loss"]))


N_TRAIN_GRAPHS = 4  # setup: 2 archives x 2 graphs


def train_phase(phase: str, work: str, dirs: dict, steps: int,
                mutate=None, expect_flash: bool = False):
    """create_model -> train_and_evaluate -> checkpoint read-back ->
    predict, then a timed train step. Returns (model, runner, state)."""
    import jax
    import jax.numpy as jnp

    from ignnition_tpu.api import Runner
    from ignnition_tpu.training.trainer import (
        CheckpointManager, restore_checkpoint,
    )

    path = os.path.join(work, f"{phase}.json")
    with open(path, "w") as f:
        json.dump(flagship_description(8, 32, mutate), f)
    # the trainer's own periodic evaluation, pointed at the training graphs
    # and run after every step, traces the f32 data loss of the graphs the
    # model trains on; shuffle off, so every pass visits them in one order
    cfg = ig.RunConfig(
        json_path=path, train_dataset=dirs["train"],
        eval_dataset=dirs["train"], predict_dataset=dirs["eval"],
        model_dir=os.path.join(work, f"{phase}_model"), batch_size=1,
        train_steps=steps, eval_samples=N_TRAIN_GRAPHS, log_every=1,
        save_checkpoints_secs=10**6, throttle_secs=0,
        accumulate_steps=1, shuffle_train_samples=False,
    )
    model = ig.create_model(cfg)
    runner = Runner(model, compute_dtype=jnp.bfloat16)
    trainer = runner.trainer

    def data_loss(st):
        """Mean data loss (float32 forward) over the training graphs and
        over the eval graphs."""
        return (trainer.evaluate(st, dirs["train"], N_TRAIN_GRAPHS)["loss"],
                trainer.evaluate(st, dirs["eval"], 2)["loss"])

    # train_and_evaluate starts from the Runner's seed, 0
    before = data_loss(trainer.init_state(jax.random.PRNGKey(0)))
    run_dir = os.path.join(cfg.model_dir, "run")
    losses = _TrainSetLosses()
    logging.getLogger("ignnition_tpu").addHandler(losses)
    t0 = time.perf_counter()
    try:
        state = ig.train_and_evaluate(model, run_dir,
                                      compute_dtype=jnp.bfloat16)
    finally:
        logging.getLogger("ignnition_tpu").removeHandler(losses)
    wall = time.perf_counter() - t0
    v = losses.values
    if len(v) != steps or not np.all(np.isfinite(v)):
        raise AssertionError(f"{phase}: training-set losses {v}")
    after = data_loss(state)
    # at flagship width one Adam step can multiply a graph's loss several
    # times over (PERF.md), so the check reads the median of the second
    # half of training, not the last step
    late = float(np.median(v[steps // 2:]))
    log(f"[{phase}] train_and_evaluate: {steps} steps in {wall:.1f} s "
        f"(compile and an evaluation after every step included); f32 data "
        f"loss over the {N_TRAIN_GRAPHS} training graphs: {before[0]:.4f} "
        f"before, after each step {np.round(v, 3).tolist()}")
    log(f"[{phase}] training-set loss {before[0]:.4f} -> median of the "
        f"second half {late:.4f}, last {after[0]:.4f}; eval graphs "
        f"{before[1]:.4f} -> {after[1]:.4f}")
    if not late < before[0]:
        raise AssertionError(f"{phase}: the training graphs' data loss did "
                             f"not fall ({before[0]} -> {late})")

    # the checkpoint written at the end of training reads back exactly
    template = trainer.init_state(jax.random.PRNGKey(1))
    manager = CheckpointManager(run_dir)
    restored = restore_checkpoint(manager, template)
    if restored.step != steps:
        raise AssertionError(f"{phase}: checkpoint step {restored.step}")
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    log(f"[{phase}] checkpoint step {restored.step} written to "
        f"{manager.directory} and read back exactly")

    preds = ig.predict(model, restored)
    n = sum(p.size for p in preds)
    if not preds or not all(np.all(np.isfinite(p)) for p in preds):
        raise AssertionError(f"{phase}: predictions not finite")
    log(f"[{phase}] predict: {len(preds)} graphs, {n} finite predictions")

    # steady train step at the trained shapes
    arrays, meta = next(iter(trainer.batches(
        dirs["train"], 1, shuffle=False, repeat=False)))
    batch = jax.device_put(arrays)
    step = trainer.train_step_fn(meta)
    key = jax.random.PRNGKey(0)
    lowered = step.lower(state.params, state.opt_state, batch, key)
    hlo = lowered.as_text()
    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    p, o = state.params, state.opt_state
    p, o, logs = compiled(p, o, batch, key)
    jax.block_until_ready(p)
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        p, o, logs = compiled(p, o, batch, key)
    jax.block_until_ready(p)
    report(phase, compile_s, (time.perf_counter() - t0) / iters * 1e3,
           "train step")
    flash = "flash_gat_fwd" in hlo and "flash_gat_bwd_src" in hlo
    log(f"[{phase}] flash-GAT kernels in the compiled step: {flash}")
    if flash != expect_flash:
        raise AssertionError(f"{phase}: flash kernels present={flash}, "
                             f"expected {expect_flash}")
    return model, runner, state


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------


def serve_phase(name: str, work: str, dirs: dict, runner, state,
                n_requests: int = 3):
    """Export at the shapes of the eval set's two graphs merged, then serve
    requests of both graphs in turn."""
    import jax
    import jax.numpy as jnp

    from ignnition_tpu.data import SampleSpec, iter_samples

    out = os.path.join(work, f"serving_{name}")
    t0 = time.perf_counter()
    runner.export_serving(out, state=state, dataset=dirs["eval"],
                          batch_size=2, compute_dtype=jnp.bfloat16)
    sm = ig.load_serving(out)
    export_s = time.perf_counter() - t0
    samples = list(iter_samples(dirs["eval"],
                                SampleSpec.from_ir(runner.model.ir)))
    direct = jax.jit(lambda p, b: runner.gnn.apply(
        p, b, sm.meta, compute_dtype=jnp.bfloat16))
    times = []
    for i in range(n_requests):
        request = samples[i % 2:] + samples[:i % 2]
        t0 = time.perf_counter()
        served = sm.predict_samples(request, denormalize=False)
        times.append((time.perf_counter() - t0) * 1e3)
        arrays = sm.build_batch(request)
        want = sm.trim(np.asarray(direct(state.params, {
            k: v for k, v in arrays.items() if k in sm.manifest["inputs"]
        }), np.float32), arrays)
        # same bf16 program, compiled twice: only fusion choices differ
        check_err(f"serving {name} request {i}", served, want, 2e-2,
                  "bf16 forward, artifact vs jitted direct apply")
    report(f"serve_{name}", export_s, float(np.median(times[1:])),
           "2-graph request (predict_samples, host batching included; "
           "compile = export + load)")


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------


def kernel_phase(n_dst: int = N_LINKS, n_src: int = N_PATHS, d: int = 32,
                 interpret: bool = False):
    """Flash-GAT custom VJP vs the XLA dense path as the float32 reference
    at "highest" matmul precision, forward and gradients."""
    import jax
    import jax.numpy as jnp

    from ignnition_tpu.ops import segment as seg

    rng = np.random.default_rng(0)
    m = np.zeros((n_dst, n_src), np.int8)
    for s in range(n_src):  # RouteNet-like: each path crosses <= 8 links
        np.add.at(m[:, s], rng.integers(0, n_dst, MAX_PATH_LEN), 1)
    m = jax.device_put(jnp.asarray(m))
    ct = jnp.asarray(rng.standard_normal((n_dst, d)), jnp.float32)
    flash_fn = functools.partial(seg._flash_masked_softmax_matmul,
                                 interpret=interpret)

    def fwd_bwd(fn, ssrc, sdst, x):
        def loss(a, b, c):
            out = fn(a, b, c, m)
            return jnp.sum(out.astype(jnp.float32) * ct), out

        (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(ssrc, sdst, x)
        return (out,) + g

    base = [rng.standard_normal(n_src), rng.standard_normal(n_dst),
            rng.standard_normal((n_src, d))]
    # bf16: inputs rounded, z/a tiles cast to bf16 for the dots (8-bit
    # mantissa, ~4e-3 per element); f32: IEEE f32 dots, sums reordered
    tols = {jnp.bfloat16: (3e-2, "bf16 inputs and dot operands"),
            jnp.float32: (1e-4, "f32, summation order differs")}
    for dtype, (tol, reason) in tols.items():
        args = [jnp.asarray(a, dtype) for a in base]
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(functools.partial(
                fwd_bwd, seg._dense_masked_softmax_matmul))(
                *[a.astype(jnp.float32) for a in args])
        c_s, ms, got = timed(functools.partial(fwd_bwd, flash_fn), *args)
        name = jnp.dtype(dtype).name
        report(f"kernel flash-GAT {name}", c_s, ms, "forward+backward")
        for part, g, r in zip(("out", "d_ssrc", "d_sdst", "d_table"),
                              got, ref):
            check_err(f"flash-GAT {name} {part}", g, r, tol, reason)
        c_x, ms_x, _ = timed(functools.partial(
            fwd_bwd, seg._dense_masked_softmax_matmul), *args)
        report(f"kernel XLA dense {name}", c_x, ms_x, "forward+backward")

    # bf16 with messages that share a component, as hidden states do: the
    # score gradients are then small differences, and a rounding slip in
    # the kernels' softmax statistic shows (one cost d_sdst 3x XLA's error)
    args = [jnp.asarray(a, jnp.bfloat16)
            for a in (base[0], base[1], 3.0 + base[2])]
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(functools.partial(
            fwd_bwd, seg._dense_masked_softmax_matmul))(
            *[a.astype(jnp.float32) for a in args])
    got = jax.jit(functools.partial(fwd_bwd, flash_fn))(*args)
    xla = jax.jit(functools.partial(
        fwd_bwd, seg._dense_masked_softmax_matmul))(*args)

    def l2_rel(g, r):
        r = np.asarray(r, np.float64)
        return float(np.linalg.norm(np.asarray(g, np.float64) - r)
                     / np.linalg.norm(r))

    for part, g, x, r in zip(("out", "d_ssrc", "d_sdst", "d_table"),
                             got, xla, ref):
        e_f, e_x = l2_rel(g, r), l2_rel(x, r)
        ok = e_f <= 2 * e_x
        log(f"  parity flash-GAT bfloat16 {part}, offset messages: "
            f"||err||/||ref|| flash {e_f:.3e}, XLA dense {e_x:.3e} "
            f"(tolerance: flash within 2x of XLA in bf16) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"flash-GAT bf16 {part}: {e_f} vs {e_x}")


@contextlib.contextmanager
def attention_lowering(flash: bool, interpret: bool = False):
    """Traces the attention aggregation through the flash kernels (for any
    table dtype their tiles fit) or through XLA's dense path. Yields the
    list of the dispatch's answers while tracing."""
    from ignnition_tpu.ops import segment as seg
    from ignnition_tpu.ops.pallas.attention_kernels import pick_tiles

    use, kernel = seg.use_flash_attn, seg._flash_masked_softmax_matmul
    answers = []

    def choose(inc, table):
        answers.append(flash and (
            pick_tiles(*inc.shape, table.shape[1]) is not None))
        return answers[-1]

    seg.use_flash_attn = choose
    if interpret:
        seg._flash_masked_softmax_matmul = (
            lambda *a: kernel(*a, interpret=True))
    try:
        yield answers
    finally:
        seg.use_flash_attn, seg._flash_masked_softmax_matmul = use, kernel


def model_grad_phase(runner, state, dirs, interpret: bool = False):
    """The attention model's data-loss gradient, every parameter, on one
    training graph, against the float32 reference (XLA's dense path at
    "highest" precision). f32 through the flash kernels must match it to
    summation order; bf16 through the flash kernels must be within 2x of
    bf16 through XLA's dense path. A leaf's error is ||g - g_ref|| over
    ||g_ref||; each line names the worst leaves."""
    import jax
    import jax.numpy as jnp

    trainer = runner.trainer
    arrays, meta = next(iter(trainer.batches(
        dirs["train"], 1, shuffle=False, repeat=False)))
    batch = jax.device_put(arrays)

    def grads(dtype, flash):
        def data_loss(p):
            preds = runner.gnn.apply(p, batch, meta, training=True,
                                     compute_dtype=dtype)
            return trainer.loss_fn(batch["label"], preds, batch["label_mask"])

        with jax.default_matmul_precision(
                "highest" if dtype == jnp.float32 else "default"):
            with attention_lowering(flash, interpret) as answers:
                g = jax.block_until_ready(
                    jax.jit(jax.grad(data_loss))(state.params))
        if not answers or set(answers) != {flash}:
            raise AssertionError(f"attention lowering: flash={flash} asked, "
                                 f"dispatch said {answers}")
        return g

    ref = grads(jnp.float32, False)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(ref)]

    def leaf_errors(g):
        errs = []
        for path, a, b in zip(paths, jax.tree_util.tree_leaves(g),
                              jax.tree_util.tree_leaves(ref)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"model gradient {path}: non-finite")
            norm = float(np.linalg.norm(b))
            errs.append((float(np.linalg.norm(a - b)) / norm if norm
                         else float(np.linalg.norm(a)), path))
        return sorted(errs, reverse=True)

    def show(errs):
        return ", ".join(f"{p} {e:.2e}" for e, p in errs[:3])

    e32 = leaf_errors(grads(jnp.float32, True))
    tol = 1e-3
    ok = e32[0][0] <= tol
    log(f"  parity model gradient float32 flash vs reference, {len(paths)} "
        f"leaves: worst {show(e32)} (tolerance {tol:.0e}: f32, summation "
        f"order differs) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"model gradient f32: {e32[0]}")

    e_flash = leaf_errors(grads(jnp.bfloat16, True))
    e_xla = leaf_errors(grads(jnp.bfloat16, False))
    ok = e_flash[0][0] <= 2 * e_xla[0][0]
    log(f"  parity model gradient bfloat16 vs reference: flash worst "
        f"{show(e_flash)}; XLA dense worst {show(e_xla)} (tolerance: flash "
        f"within 2x of XLA in the same precision) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"model gradient bf16: flash {e_flash[0]} vs "
                             f"XLA {e_xla[0]}")


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------


def four_card_phase(n_links: int = N_LINKS, n_paths: int = N_PATHS,
                    n_cards: int = 4) -> None:
    """Destination-sharded (model=n) and data-parallel (data=n) flagship
    train steps vs the single-card step, float32 at "highest" precision.
    SGD with rate 1 makes each step's parameter change its gradient."""
    import jax
    import optax

    from ignnition_tpu.data import build_batch
    from ignnition_tpu.model import build
    from ignnition_tpu.parallel import (
        make_edgeshard_train_step, make_mesh, make_parallel_train_step,
        partition_batch, stack_batches,
    )
    from ignnition_tpu.training import get_loss

    ir = ig.parse_model_description(
        flagship_description(8, 32), {"link_capacity": 1, "traffic": 1})
    gnn = build(ir)
    params = gnn.init(jax.random.PRNGKey(0))
    loss_fn = get_loss(ir.learning.loss)
    sgd = optax.sgd(1.0)
    devices = jax.devices()[:n_cards]
    batches = [build_batch([make_flagship_sample(
        "random", n_links, n_paths, MAX_PATH_LEN, seed=i)], ir)
        for i in range(n_cards)]

    def serial_grads(batch_list):
        def loss(p):
            total = 0.0
            for arrays, meta in batch_list:
                preds = gnn.apply(p, arrays, meta, training=True)
                total += loss_fn(arrays["label"], preds, arrays["label_mask"])
            return total / len(batch_list) + gnn.regularization_loss(p)

        return jax.jit(jax.value_and_grad(loss))(params)

    def compare(name, loss, new_params, ref_loss, ref_grads):
        leaves = jax.tree_util.tree_leaves(new_params)
        spread = {len(x.sharding.device_set) for x in leaves + [loss]}
        log(f"  {name}: outputs on {sorted(spread)} devices")
        if spread != {n_cards}:
            raise AssertionError(f"{name}: outputs not on all {n_cards} cards")
        grads = jax.tree.map(lambda p, q: np.asarray(p) - np.asarray(q),
                             params, new_params)
        check_err(f"{name} loss", [float(loss)], [float(ref_loss)], 1e-4,
                  "f32, cross-card reductions reorder sums")
        check_err(f"{name} gradients",
                  np.concatenate([g.ravel() for g in
                                  jax.tree_util.tree_leaves(grads)]),
                  np.concatenate([np.asarray(g).ravel() for g in
                                  jax.tree_util.tree_leaves(ref_grads)]),
                  1e-3, "f32, cross-card reductions reorder sums")

    with jax.default_matmul_precision("highest"):
        # destination-sharded: one graph split over the cards
        arrays, meta = batches[0]
        t0 = time.perf_counter()
        ref_loss, ref_grads = serial_grads([batches[0]])
        jax.block_until_ready(ref_grads)
        log(f"[four_cards] single-card reference step "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
        reg = float(gnn.regularization_loss(params))
        stacked, local_meta = partition_batch(arrays, meta, ir, n_cards)
        mesh = make_mesh(data=1, model=n_cards, devices=devices)
        step = make_edgeshard_train_step(gnn, sgd, loss_fn, local_meta, mesh)
        t0 = time.perf_counter()
        p_new, _, loss = step(params, sgd.init(params),
                              {k: v[None] for k, v in stacked.items()},
                              jax.random.PRNGKey(0))
        jax.block_until_ready(p_new)
        log(f"[four_cards] dest_shard (model={n_cards}) step "
            f"{time.perf_counter() - t0:.1f} s (compile included), "
            f"peak {peak_bytes()} bytes on card 0")
        compare(f"dest_shard model={n_cards}", loss, p_new,
                float(ref_loss) - reg, ref_grads)

        # data-parallel: one graph per card
        ref_loss, ref_grads = serial_grads(batches)
        stacked, _ = stack_batches(batches, ir)
        mesh = make_mesh(data=n_cards, model=1, devices=devices)
        _, dp_meta = stack_batches(batches, ir)
        step = make_parallel_train_step(gnn, sgd, loss_fn, dp_meta, mesh)
        t0 = time.perf_counter()
        p_new, _, loss = step(params, sgd.init(params), stacked,
                              jax.random.PRNGKey(0))
        jax.block_until_ready(p_new)
        log(f"[four_cards] data-parallel (data={n_cards}) step "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
        compare(f"data-parallel data={n_cards}", loss, p_new,
                float(ref_loss) - reg, ref_grads)


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    log(f"card: {card_info()}")
    log(f"compile cache: {enable_compilation_cache()}")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev}")
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        raise SystemExit(f"needs {want} GPUs, found {len(jax.devices())}")
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")

    if args.four_cards:
        four_card_phase()
    else:
        work = tempfile.mkdtemp(prefix="ignnition_smoke_")
        try:
            dirs = setup(work, N_LINKS, N_PATHS)
            _, r1, s1 = train_phase("train_flagship", work, dirs, steps=40)
            _, r2, s2 = train_phase("train_attention", work, dirs, steps=40,
                                    mutate=_attention, expect_flash=True)
            serve_phase("flagship", work, dirs, r1, s1)
            serve_phase("attention", work, dirs, r2, s2)
            kernel_phase()
            model_grad_phase(r2, s2, dirs)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

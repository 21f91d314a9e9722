"""Training loop: jitted steps, streaming input, checkpoints, evaluation.

JAX replacement for the reference's tf.estimator glue
(framework_operations.py:108-166 + generate_model.py:697-830):

  * one jitted `train_step` per padded-batch shape (BatchMeta), cached — the
    bucketed padding keeps the number of distinct shapes tiny;
  * optax optimizer/schedule built from the IR's learning_options;
  * loss = model loss + l2 regularization (reference sums `model.losses`);
  * .npz checkpoints on a wall-clock interval with keep-max, warm-start
    restore of matching parameters (reference WarmStartSettings restores
    kernel.*/recurrent_kernel.*/bias.*, f_o.py:126-132);
  * evaluation with the reference metric set and optional label
    denormalization.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..data import SampleSpec, build_batch, iter_samples
from ..data.graph import BatchMeta, PaddingConfig
from ..model.builder import GnnModel
from .losses import get_loss, loss_reduction
from .metrics import MetricAccumulator
from .optimizers import build_optimizer
from .packing import pack_arrays, pack_layout, unpack_arrays

log = logging.getLogger("ignnition_tpu")


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


class Trainer:
    def __init__(
        self,
        model: GnnModel,
        padding: Optional[PaddingConfig] = None,
        normalizations: Optional[Mapping[str, Callable]] = None,
        compute_dtype=None,
    ):
        """compute_dtype: e.g. jnp.bfloat16 for mixed-precision training
        (float32 master weights, bf16 compute)."""
        self.model = model
        self.ir = model.ir
        self.padding = padding or PaddingConfig()
        self.normalizations = normalizations
        self.compute_dtype = compute_dtype
        self.loss_fn = get_loss(self.ir.learning.loss)
        self.optimizer = build_optimizer(self.ir.learning.optimizer)
        self._train_steps: Dict[BatchMeta, Callable] = {}
        self._accum_steps: Dict[Tuple[BatchMeta, int], Callable] = {}
        self._eval_steps: Dict[BatchMeta, Callable] = {}
        self._eval_batches: Dict[Any, list] = {}

    # ------------------------------------------------------------------

    def init_state(self, rng: Optional[jax.Array] = None) -> TrainState:
        rng = rng if rng is not None else jax.random.PRNGKey(0)
        params = self.model.init(rng)
        return TrainState(params, self.optimizer.init(params), 0)

    # ------------------------------------------------------------------

    def _loss(self, params, batch, meta, rng):
        preds = self.model.apply(
            params, batch, meta, training=True, rng=rng,
            compute_dtype=self.compute_dtype,
        )
        loss = self.loss_fn(batch["label"], preds, batch["label_mask"])
        reg = self.model.regularization_loss(params)
        return loss + reg, (loss, reg)

    def train_step_fn(self, meta: BatchMeta, layout=None) -> Callable:
        """layout: optional packed-transfer layout (training.packing) — the
        step then takes the packed per-dtype buffers instead of the batch
        dict and unpacks with static slices inside the jit (free on device;
        cuts the per-array H2D dispatch cost for streaming batches)."""
        key = (meta, layout)
        if key not in self._train_steps:
            # single-device capacity check: warn BEFORE the first compile
            # when the estimated footprint (params + batch + AD residuals)
            # likely exceeds the device's memory, pointing at dest_shard
            # (utils/memory.py)
            from ..utils.memory import maybe_warn_capacity

            maybe_warn_capacity(self.ir, meta, log=log)

            @jax.jit
            def step(params, opt_state, batch, rng):
                if layout is not None:
                    batch = unpack_arrays(batch, layout)
                (total, (loss, reg)), grads = jax.value_and_grad(
                    self._loss, has_aux=True
                )(params, batch, meta, rng)
                updates, opt_state = self.optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return params, opt_state, {"loss": loss, "reg": reg, "total": total}

            self._train_steps[key] = step
        return self._train_steps[key]

    def accum_train_step_fn(
        self, meta: BatchMeta, n_accum: int, layout=None
    ) -> Callable:
        """One optimizer step over `n_accum` microbatches stacked on a
        leading axis (gradient accumulation).

        Numerically equivalent to a batch `n_accum`x larger, but each
        microbatch runs at its own (smaller) shape — where the per-edge
        throughput of the training step degrades with merged-graph size,
        running large effective batches as a scan over optimally-sized
        microbatches beats one giant merged graph."""
        key = (meta, n_accum, layout)
        if key not in self._accum_steps:

            @jax.jit
            def step(params, opt_state, stacked, rng):
                if layout is not None:
                    stacked = unpack_arrays(stacked, layout)
                keys = jax.random.split(rng, n_accum)

                def micro(carry, xs):
                    gsum, lsum, rsum = carry
                    batch, k = xs
                    (_, (loss, reg)), grads = jax.value_and_grad(
                        self._loss, has_aux=True
                    )(params, batch, meta, k)
                    return (
                        jax.tree.map(jnp.add, gsum, grads),
                        lsum + loss,
                        rsum + reg,
                    ), None

                zero = jax.tree.map(jnp.zeros_like, params)
                (gsum, lsum, rsum), _ = jax.lax.scan(
                    micro, (zero, jnp.float32(0.0), jnp.float32(0.0)), (stacked, keys)
                )
                # mean-reduction losses: microbatch mean ~= big-batch mean
                # (exact for equal real counts) -> average the gradients.
                # sum-reduction losses (loss_reduction == 'sum', keras
                # KLDivergence): the big-batch loss is the SUM of microbatch
                # sums -> keep the gradient sum, but the l2 regularization
                # entered every microbatch, so subtract the extra
                # (n_accum - 1) copies of its gradient
                if loss_reduction(self.loss_fn) == "sum":
                    reg_grads = jax.grad(self.model.regularization_loss)(params)
                    grads = jax.tree.map(
                        lambda g, rg: g - (n_accum - 1) * rg, gsum, reg_grads
                    )
                    loss = lsum
                    reg = rsum / n_accum
                else:
                    grads = jax.tree.map(lambda g: g / n_accum, gsum)
                    loss = lsum / n_accum
                    reg = rsum / n_accum
                updates, opt_state = self.optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return params, opt_state, {
                    "loss": loss,
                    "reg": reg,
                    "total": loss + reg,
                }

            self._accum_steps[key] = step
        return self._accum_steps[key]

    def eval_step_fn(self, meta: BatchMeta) -> Callable:
        if meta not in self._eval_steps:

            @jax.jit
            def step(params, batch):
                preds = self.model.apply(params, batch, meta)
                loss = self.loss_fn(batch["label"], preds, batch["label_mask"])
                return preds, loss

            self._eval_steps[meta] = step
        return self._eval_steps[meta]

    # ------------------------------------------------------------------
    # input pipeline
    # ------------------------------------------------------------------

    def batches(
        self,
        data_dir: str,
        batch_size: int,
        shuffle: bool = False,
        repeat: bool = True,
        training: bool = True,
        seed: Optional[int] = None,
        prefetch: int = 4,
        workers: int = 1,
        cache: bool = False,
        sample_transform: Optional[Callable] = None,
    ) -> Iterator[Tuple[Dict[str, np.ndarray], BatchMeta]]:
        """Stream (arrays, meta) merged batches, built on background threads
        (the reference prefetches 10 batches through tf.data,
        generate_model.py:188-198).

        workers > 1 parallelizes archive reading (iter_samples readers —
        the gunzip and native JSON parse release the GIL) AND batch
        construction; batch order and composition then become
        nondeterministic — use with shuffle. Every sample still appears
        exactly once per epoch.

        cache=True materializes every built batch during the first epoch
        and cycles the cached list afterwards (reshuffled per epoch) —
        host batch construction then costs one epoch total, making steady-
        state training compute-bound. Trades host RAM for throughput;
        batch composition is frozen after epoch one.

        cache="device" additionally places every cached batch on the
        device, so steady-state steps pay NO host->device transfer at all
        (the per-step dispatch cost of a host-resident batch dominates
        small-graph streaming — PERF.md 'Streaming H2D'). Trades device
        device memory for throughput: dataset_bytes must fit alongside the model.

        sample_transform: per-sample GraphSample -> GraphSample hook applied
        before batch construction (the locality renumbering rides it)."""
        if cache:
            if not repeat:
                raise ValueError("cache=True requires repeat=True")
            built = list(
                self.batches(
                    data_dir, batch_size, shuffle=shuffle, repeat=False,
                    training=training, seed=seed, prefetch=prefetch,
                    workers=workers, sample_transform=sample_transform,
                )
            )
            if cache == "device":
                built = [(jax.device_put(a), m) for a, m in built]
            rng = np.random.default_rng(seed)
            while True:
                order = (
                    rng.permutation(len(built)) if shuffle else range(len(built))
                )
                for i in order:
                    yield built[i]

        spec = SampleSpec.from_ir(self.ir, training=training)

        def make(group):
            if sample_transform is not None:
                group = [sample_transform(s) for s in group]
            return build_batch(
                group,
                self.ir,
                self.padding,
                training=training,
                normalizations=self.normalizations,
            )

        def groups():
            group = []
            for s in iter_samples(
                data_dir, spec, shuffle=shuffle, seed=seed, repeat=repeat,
                readers=max(1, workers),  # archive parse is the host bottleneck
            ):
                group.append(s)
                if len(group) == batch_size:
                    yield group
                    group = []
            if group:
                yield group

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        # consumers may abandon this generator early (evaluate() stops after
        # num_batches); without a stop signal the producer threads block on
        # q.put forever, leaking a thread + `prefetch` built batches per
        # abandoned call (review-found — periodic in-training evals
        # accumulated them without bound). Same pattern as _device_prefetch.
        stop = threading.Event()

        def put_guarded(target_q, item) -> bool:
            while not stop.is_set():
                try:
                    target_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        if workers <= 1:

            def producer():
                try:
                    for g in groups():
                        if not put_guarded(q, make(g)):
                            return
                except BaseException as e:  # surface errors to the consumer
                    put_guarded(q, e)
                put_guarded(q, None)

            threading.Thread(target=producer, daemon=True).start()
            sentinels_expected = 1
        else:
            gq: queue.Queue = queue.Queue(maxsize=workers * 2)

            def reader():
                try:
                    for g in groups():
                        if not put_guarded(gq, g):
                            return
                except BaseException as e:
                    put_guarded(q, e)
                for _ in range(workers):
                    put_guarded(gq, None)

            def builder():
                try:
                    while True:
                        try:
                            g = gq.get(timeout=0.2)
                        except queue.Empty:
                            if stop.is_set():
                                return
                            continue
                        if g is None:
                            break
                        if not put_guarded(q, make(g)):
                            return
                except BaseException as e:
                    put_guarded(q, e)
                put_guarded(q, None)

            threading.Thread(target=reader, daemon=True).start()
            for _ in range(workers):
                threading.Thread(target=builder, daemon=True).start()
            sentinels_expected = workers

        try:
            done = 0
            while done < sentinels_expected:
                item = q.get()
                if item is None:
                    done += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    @staticmethod
    def _device_prefetch(batch_iter, size: int = 2):
        """Stage upcoming batches onto the device from a background thread.

        Host batches are numpy; dispatching a step on them pays the H2D
        transfer synchronously inside the step. Staging `size` batches
        ahead through `jax.device_put` on a worker thread overlaps the
        transfer with the running step — the device-side half of the
        reference's tf.data prefetch (generate_model.py:188-198)."""
        q: queue.Queue = queue.Queue(maxsize=size)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for arrays, meta in batch_iter:
                    if not put((jax.device_put(arrays), meta)):
                        return  # consumer gone — drop staged batches
            except BaseException as e:  # surface errors to the consumer
                put(e)
            put(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # consumer closed early (train loop hit max_steps): release the
            # worker and the device memory its staged batches pin
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    # microbatch scale: one flagship-sized merged graph (~262k real edges);
    # larger effective batches accumulate gradients over microbatches of
    # this size (numerically identical). Not yet re-measured on the GPU.
    _TARGET_MICROBATCH_EDGES = 262144

    def _auto_accumulate(
        self, data_dir: str, batch_size: int
    ) -> Tuple[int, int]:
        """Pick (accumulate_steps, microbatch_graphs) for an effective batch
        of `batch_size` graphs per optimizer step, from the dataset's
        average edges/graph vs the measured optimum microbatch scale.

        Small-graph workloads resolve to (1, batch_size) — plain merged
        batches; large-graph workloads split so each microbatch stays near
        the per-edge throughput peak instead of degrading super-linearly in
        one giant merged graph."""
        if self.padding.per_graph:
            # uniform per-graph blocks ride the block-diagonal incidence
            # matmuls, so the merged batch stays whole
            return 1, batch_size
        spec = SampleSpec.from_ir(self.ir)
        tot, n = 0, 0
        for s in iter_samples(data_dir, spec):
            tot += sum(len(a.src_idx) for a in s.adjacencies.values())
            n += 1
            if n >= max(batch_size, 8):
                break
        if n == 0 or batch_size <= 1:
            return 1, batch_size
        per_graph = max(tot / n, 1.0)
        micro = max(1, int(self._TARGET_MICROBATCH_EDGES // per_graph))
        if micro >= batch_size:
            return 1, batch_size
        k = -(-batch_size // micro)  # ceil
        micro = -(-batch_size // k)  # even split
        log.info(
            "auto batch strategy: ~%d edges/graph -> %d-way gradient "
            "accumulation over %d-graph microbatches (effective batch "
            "%d%s)",
            int(per_graph), k, micro, k * micro,
            "" if k * micro == batch_size
            else f", rounded up from the requested {batch_size}",
        )
        return k, micro

    def train(
        self,
        state: TrainState,
        data_dir: str,
        max_steps: int,
        batch_size: int = 3,
        shuffle: bool = True,
        log_every: int = 10,
        checkpoint_dir: Optional[str] = None,
        save_secs: int = 300,
        keep_max: int = 20,
        eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
        eval_secs: int = 300,
        rng: Optional[jax.Array] = None,
        mesh=None,
        model_strategy: str = "replicated",
        accumulate_steps=1,
        input_workers: int = 1,
        cache_batches=False,
        device_prefetch: int = 0,
        pack_transfer: bool = False,
        tensorboard_dir: Optional[str] = None,
        histogram_every: int = 0,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (10, 15),
        locality_reorder="auto",
    ) -> TrainState:
        """Run the training loop.

        locality_reorder: renumber each sample's nodes to minimize the
        destination-sharding edge cut before partitioning (parallel/
        locality.py). "auto" (default) = on exactly when dest_shard is
        active; True/False force it. A pure permutation — losses and
        gradients are unchanged; halo traffic shrinks with the recovered
        cut (docs/scaling.md 'Locality-aware partitioner').

        mesh: a jax Mesh with ('data','model') axes for SPMD training — each
        step consumes mesh.shape['data'] merged batches (stacked, re-padded
        to a common bucket) and runs the shard_map parallel step; without a
        mesh, single-device jitted steps.
        model_strategy: how the mesh's 'model' axis is used —
        "replicated" (v1: edges shard, node tables replicate, aggregations
        psum; parallel/steps.py) or "dest_shard" (v2: destination-sharded
        node state + all_to_all halo; parallel/edgeshard.py — comm scales
        with the edge cut, memory/compute with the axis).
        accumulate_steps: gradient accumulation — each optimizer step
        consumes this many merged batches (stacked and scanned on device);
        numerically a batch `accumulate_steps`x larger, but faster than one
        giant merged graph (see accum_train_step_fn). "auto" measures the
        dataset's edges/graph and picks the split so each microbatch stays
        near the per-edge throughput peak (_auto_accumulate) — batch_size
        then means graphs per OPTIMIZER step, exactly the reference's
        semantics.
        tensorboard_dir: write loss scalars (and parameter histograms every
        `histogram_every` steps, if > 0) — the reference logs the same set
        via tf.summary (generate_model.py:754-756, 792-793).
        cache_batches: True caches built batches host-side after epoch one;
        "device" also keeps them device-resident (steps then pay zero
        host->device cost — the fastest streaming mode when the dataset
        fits in device memory).
        device_prefetch / pack_transfer: opt-in transfer tuning for
        host-resident streams — stage batches onto the device from a
        background thread / ship one buffer per dtype instead of ~40
        arrays. Off by default; their effect on the GPU is not measured.
        """
        if accumulate_steps == "auto":
            if mesh is not None:
                accumulate_steps = 1  # the mesh's data axis owns batching
            else:
                accumulate_steps, batch_size = self._auto_accumulate(
                    data_dir, batch_size
                )
        elif mesh is not None and accumulate_steps > 1:
            # review-found: this used to be silently ignored, training with
            # an effective batch accumulate_steps-x smaller than requested
            raise ValueError(
                "accumulate_steps > 1 is not supported together with a "
                "mesh (the mesh's data axis owns batching) — raise "
                "batch_size or the data-axis size instead"
            )
        rng = rng if rng is not None else jax.random.PRNGKey(42)
        manager = None
        if checkpoint_dir:
            manager = _make_checkpoint_manager(checkpoint_dir, keep_max)
            # resume-within-run: continue from the latest checkpoint in this
            # directory if one exists (the reference inherits this from
            # tf.estimator's model_dir behavior, SURVEY.md §5.4)
            restored = restore_checkpoint(manager, state)
            if restored.step > state.step:
                log.info(
                    "resuming from checkpoint step %d in %s",
                    restored.step,
                    checkpoint_dir,
                )
                state = restored
        writer = None
        if tensorboard_dir:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(tensorboard_dir)
        last_save = time.time()
        last_eval = time.time()

        if cache_batches == "device" and (
            mesh is not None or accumulate_steps > 1
        ):
            # stacked/sharded steps re-assemble batches host-side
            # (np.stack / global-array placement) — device-cached batches
            # would bounce back to the host every step; host caching keeps
            # the win that's actually available here
            log.info(
                "cache_batches='device' downgraded to host caching "
                "(stacked/sharded steps assemble batches host-side)"
            )
            cache_batches = True
        dest_shard = (
            mesh is not None
            and model_strategy == "dest_shard"
            and mesh.shape.get("model", 1) > 1
        )
        if dest_shard:
            transform = None
            on = dest_shard if locality_reorder == "auto" else locality_reorder
            if on:
                # renumber each sample for the exact shard count before the
                # contiguous-block partition — the cut (halo volume) is a
                # pure function of row order, and the renumbering is an
                # exactness-preserving permutation (parallel/locality.py;
                # losses/gradients identical, tests/test_locality.py)
                transform = self._locality_transform(
                    mesh.shape["model"], batch_size
                )
            batch_iter = self._destshard_batch_iter(
                data_dir, batch_size, mesh, shuffle,
                workers=input_workers, cache=cache_batches,
                sample_transform=transform,
            )
            step_cache: Dict[Any, Callable] = {}
        elif mesh is not None:
            batch_iter = self._sharded_batch_iter(
                data_dir, batch_size, mesh, shuffle,
                workers=input_workers, cache=cache_batches,
            )
            step_cache = {}
        elif accumulate_steps > 1:
            batch_iter = self._stacked_batch_iter(
                data_dir, batch_size, accumulate_steps, shuffle,
                workers=input_workers, cache=cache_batches,
            )
        else:
            batch_iter = self.batches(
                data_dir, batch_size, shuffle=shuffle, repeat=True,
                workers=input_workers, cache=cache_batches,
            )
        layouts: Dict[BatchMeta, Any] = {}
        on_device = cache_batches == "device"  # nothing left to transfer
        if mesh is None and pack_transfer and not on_device:
            # ship each batch as one buffer per dtype instead of ~40 arrays
            # (per-array H2D dispatch dominates at streaming sizes; the jit
            # step unpacks with static slices — see training/packing.py)
            def _packed(it):
                for arrays, meta in it:
                    lay = layouts.get(meta)
                    if lay is None:
                        lay = layouts[meta] = pack_layout(arrays)
                    yield pack_arrays(arrays, lay), meta

            batch_iter = _packed(batch_iter)
        if mesh is None and device_prefetch > 0 and not on_device:
            # mesh batches need sharding-aware placement (the parallel step
            # handles it); single-device batches stage ahead onto the chip
            batch_iter = self._device_prefetch(batch_iter, device_prefetch)

        trace_active = False
        for arrays, meta in batch_iter:
            if state.step >= max_steps:
                break
            if profile_dir and state.step == profile_steps[0]:
                jax.profiler.start_trace(profile_dir)
                trace_active = True
            if profile_dir and trace_active and state.step >= profile_steps[1]:
                jax.profiler.stop_trace()
                trace_active = False
            if mesh is not None:
                if meta not in step_cache:
                    if dest_shard:
                        from ..parallel import make_edgeshard_train_step

                        step_cache[meta] = make_edgeshard_train_step(
                            self.model, self.optimizer, self.loss_fn,
                            meta, mesh,
                        )
                    else:
                        from ..parallel import make_parallel_train_step

                        step_cache[meta] = make_parallel_train_step(
                            self.model, self.optimizer, self.loss_fn, meta, mesh
                        )
                rng, key = jax.random.split(rng)
                params, opt_state, loss = step_cache[meta](
                    state.params, state.opt_state, arrays, key
                )
                logs = {"loss": loss, "reg": 0.0, "total": loss}
            else:
                lay = layouts.get(meta)
                step_fn = (
                    self.accum_train_step_fn(meta, accumulate_steps, layout=lay)
                    if accumulate_steps > 1
                    else self.train_step_fn(meta, layout=lay)
                )
                rng, key = jax.random.split(rng)
                params, opt_state, logs = step_fn(
                    state.params, state.opt_state, arrays, key
                )
            state = TrainState(params, opt_state, state.step + 1)
            if log_every and state.step % log_every == 0:
                log.info(
                    "step %d  loss=%.6f  reg=%.6f  total=%.6f",
                    state.step,
                    float(logs["loss"]),
                    float(logs["reg"]),
                    float(logs["total"]),
                )
            if writer is not None and log_every and state.step % log_every == 0:
                writer.add_scalar("loss", float(logs["loss"]), state.step)
                writer.add_scalar("regularization_loss", float(logs["reg"]), state.step)
                writer.add_scalar("total_loss", float(logs["total"]), state.step)
            if (
                writer is not None
                and histogram_every
                and state.step % histogram_every == 0
            ):
                flat, _ = jax.tree_util.tree_flatten_with_path(state.params)
                for path, leaf in flat:
                    name = "/".join(
                        str(getattr(pp, "key", getattr(pp, "idx", pp)))
                        for pp in path
                    )
                    writer.add_histogram(name, np.asarray(leaf), state.step)
            now = time.time()
            if manager is not None and (now - last_save >= save_secs):
                save_checkpoint(manager, state)
                last_save = now
            if eval_fn is not None and (now - last_eval >= eval_secs):
                results = eval_fn(state)
                log.info("eval @ step %d: %s", state.step, results)
                last_eval = now

        if trace_active:
            # the loop ended (max_steps / dataset end) before reaching
            # profile_steps[1] — close the trace so it is usable and the
            # profiler stops collecting (review-found dangling trace)
            jax.profiler.stop_trace()
        if manager is not None:
            save_checkpoint(manager, state)
        if writer is not None:
            writer.close()
        return state

    def _stacked_batch_iter(
        self, data_dir, batch_size, n_accum, shuffle, workers=1, cache=False
    ):
        """Group `n_accum` merged batches per optimizer step, stacked on a
        leading axis (re-padded to a common bucket)."""
        from ..parallel import stack_batches

        group = []
        for item in self.batches(
            data_dir, batch_size, shuffle=shuffle, repeat=True, workers=workers,
            cache=cache,
        ):
            group.append(item)
            if len(group) == n_accum:
                yield stack_batches(group, self.ir)
                group = []

    def _locality_transform(self, n_model: int, batch_size: int) -> Callable:
        """Per-sample locality renumbering with a content-keyed memo: epochs
        re-yield the SAME samples as fresh objects, and the O(E) ordering
        pipeline is a pure function of (adjacencies, n_model) — recomputing
        it every epoch would tax the input threads for nothing. For
        single-sample batches the entity pad sizes are forwarded so block
        refinement splits exactly where partition_batch's padded ceil-split
        will; merged multi-graph batches pass no node_pad (their block
        boundaries depend on the merge, and mostly align with graph
        boundaries anyway)."""
        import hashlib

        from ..parallel.locality import locality_order, reorder_sample

        memo: Dict[bytes, Dict[str, np.ndarray]] = {}

        def key_of(s) -> bytes:
            h = hashlib.blake2b(digest_size=16)
            for name in sorted(s.adjacencies):
                arrs = s.adjacencies[name]
                h.update(name.encode())
                h.update(np.ascontiguousarray(arrs.src_idx).tobytes())
                h.update(np.ascontiguousarray(arrs.dst_idx).tobytes())
            for ent in sorted(s.num_nodes):
                h.update(f"{ent}={s.num_nodes[ent]};".encode())
            return h.digest()

        def transform(s):
            k = key_of(s)
            orders = memo.get(k)
            if orders is None:
                node_pad = None
                if batch_size == 1:
                    node_pad = {
                        ent: self.padding.pad_size(n)
                        for ent, n in s.num_nodes.items()
                    }
                orders = locality_order(
                    s, self.ir, n_model=n_model, node_pad=node_pad
                )
                if len(memo) < 4096:  # bound host memory on huge datasets
                    memo[k] = orders
            return reorder_sample(s, self.ir, orders=orders)[0]

        return transform

    def _sharded_batch_iter(
        self, data_dir, batch_size, mesh, shuffle, workers=1, cache=False,
        sample_transform=None,
    ):
        """Group this process's share of the mesh's 'data' axis per step and
        stack it on the leading axis (re-padded to a common bucket).

        Multi-host: each process groups n_data/process_count batches (its
        local slice — make_parallel_train_step assembles the global arrays)
        and shuffles with a process-specific seed so hosts feed DISTINCT
        data. NOTE: multi-host runs should use a fixed-bucket PaddingConfig
        (mode='multiple' with a generous min_size) so every host picks the
        same padded meta — bucket divergence across hosts would make them
        compile different programs and deadlock."""
        from ..parallel import stack_batches

        n_procs = jax.process_count()
        n_data = mesh.shape["data"]
        if n_data % n_procs != 0:
            raise ValueError(
                f"mesh data axis ({n_data}) must be a multiple of the "
                f"process count ({n_procs})"
            )
        n_local = n_data // n_procs
        seed = None if n_procs == 1 else 1_000_003 * (jax.process_index() + 1)
        group = []
        for item in self.batches(
            data_dir, batch_size, shuffle=shuffle, repeat=True, seed=seed,
            workers=workers, cache=cache, sample_transform=sample_transform,
        ):
            group.append(item)
            if len(group) == n_local:
                yield stack_batches(group, self.ir)
                group = []

    def _destshard_batch_iter(
        self, data_dir, batch_size, mesh, shuffle, workers=1, cache=False,
        sample_transform=None,
    ):
        """v2 destination sharding: group the mesh's data axis, partition
        each merged batch over the model axis (parallel/edgeshard.py), and
        stack to [n_data, n_model, ...]. Shape-defining partition dims
        (halo heights, local edge pads) grow monotonically via `pad_to` so
        a stream of batches converges to ONE jitted program.

        With cache=True the per-item partition is memoized on the cached
        batch object + the current pad_to (review-found: the O(E*n_model)
        host partition used to re-run every epoch, defeating the cache) —
        once pad_to stabilizes, steady-state epochs reuse the partitioned
        arrays at zero host cost (at the price of holding the partitioned
        copies alongside the cached batches)."""
        from ..data.graph import merge_metas, repad_to_meta
        from ..parallel import partition_batch
        from ..parallel.edgeshard import partition_dims

        n_model = mesh.shape["model"]
        n_procs = jax.process_count()
        n_data = mesh.shape["data"]
        if n_data % n_procs != 0:
            raise ValueError(
                f"mesh data axis ({n_data}) must be a multiple of the "
                f"process count ({n_procs})"
            )
        n_local = n_data // n_procs
        seed = None if n_procs == 1 else 1_000_003 * (jax.process_index() + 1)
        pad_to: Dict[str, Dict[str, int]] = {"halo": {}, "edges": {}}
        memo: Dict[int, Tuple[Any, Tuple]] = {}

        def pad_key():
            return (
                tuple(sorted(pad_to["halo"].items())),
                tuple(sorted(pad_to["edges"].items())),
            )

        def partition_item(arrays, meta, memoize=True):
            # memoize=False for TRANSIENT dicts (the repad_to_meta copies in
            # the mixed-meta branch): id() of a freed dict can be reused by a
            # later fresh dict, so memoizing them could silently return a
            # DIFFERENT batch's partition once pad_key stabilizes
            # (advisor-found, r4). Only long-lived cached batch objects — whose
            # ids are pinned by the batch cache — may key the memo.
            if cache and memoize:
                hit = memo.get(id(arrays))
                if hit is not None and hit[0] == pad_key():
                    return hit[1]
            part = partition_batch(arrays, meta, self.ir, n_model, pad_to=pad_to)
            if cache and memoize:
                memo[id(arrays)] = (pad_key(), part)
            return part

        group: list = []
        for item in self.batches(
            data_dir, batch_size, shuffle=shuffle, repeat=True, seed=seed,
            workers=workers, cache=cache, sample_transform=sample_transform,
        ):
            group.append(item)
            if len(group) < n_local:
                continue
            items, group = group, []
            memoize = True
            if len({m for _, m in items}) > 1:
                # rare with bucketed padding: grow to a common meta first
                # (these fresh arrays are transient — they MUST NOT enter the
                # id-keyed memo; same content as the previous
                # stack_batches-then-unstack route)
                target = merge_metas([m for _, m in items], self.ir)
                items = [
                    (repad_to_meta(a, m, target, self.ir), target)
                    for a, m in items
                ]
                memoize = False
            while True:
                parts = [partition_item(a, m, memoize) for a, m in items]
                dims = [partition_dims(p[0]) for p in parts]
                grown = False
                for d in dims:
                    for grp in ("halo", "edges"):
                        for adj, v in d[grp].items():
                            if v > pad_to[grp].get(adj, 0):
                                pad_to[grp][adj] = v
                                grown = True
                if not grown or all(d == dims[0] for d in dims):
                    break  # stable (or uniform) — no repartition needed
            metas = {p[1] for p in parts}
            if len(metas) != 1:
                continue  # grew mid-group; next iteration is stable
            out = {
                k: np.stack([p[0][k] for p in parts], 0) for k in parts[0][0]
            }
            yield out, parts[0][1]

    def evaluate(
        self,
        state: TrainState,
        data_dir: str,
        num_batches: int = 100,
        batch_size: int = 1,
        denormalization: Optional[Callable] = None,
        label_name: str = "label",
        cache: bool = False,
        shuffle: bool = False,
        seed: Optional[int] = None,
    ) -> Dict[str, float]:
        """cache=True memoizes the built eval batches on the Trainer, so the
        periodic in-training evals (throttle_secs) pay the host build cost
        once instead of re-reading the archives every time.

        shuffle=True evaluates a shuffled stream (the reference's
        shuffle_eval_samples, framework_operations.py:162): with fewer
        num_batches than the dataset holds, each call draws a different
        subset. Combined with cache=True a POOL of up to 8x num_batches is
        built once (bounded — a huge eval directory must not become
        resident host memory) and a fresh permutation of the pool is drawn
        per call (same semantics at batch_size=1 — which samples land in
        the evaluated prefix — without re-reading archives)."""
        acc = MetricAccumulator()
        total_loss, n = 0.0, 0
        if seed is None:
            seed = int(np.random.default_rng().integers(2**31)) if shuffle else 0
        if cache:
            pool = 8 * num_batches if shuffle else num_batches
            key = (data_dir, batch_size, pool)
            if key not in self._eval_batches:
                built = []
                for item in self.batches(
                    data_dir, batch_size, shuffle=False, repeat=False
                ):
                    built.append(item)
                    if len(built) >= pool:
                        break
                self._eval_batches[key] = built
            cached = self._eval_batches[key]
            if shuffle:
                order = np.random.default_rng(seed).permutation(len(cached))
                batch_iter = iter([cached[i] for i in order])
            else:
                batch_iter = iter(cached)
        else:
            batch_iter = self.batches(
                data_dir, batch_size, shuffle=shuffle, repeat=False,
                seed=seed if shuffle else None,
            )
        for arrays, meta in batch_iter:
            if n >= num_batches:
                break
            preds, loss = self.eval_step_fn(meta)(state.params, arrays)
            labels = np.asarray(arrays["label"])
            preds = np.asarray(preds)
            mask = np.asarray(arrays["label_mask"]) > 0
            if denormalization is not None:
                labels = np.where(mask, denormalization(labels, label_name), labels)
                preds = np.where(mask, denormalization(preds, label_name), preds)
            acc.update(labels, preds, mask)
            total_loss += float(loss)
            n += 1
        out = acc.result()
        out["loss"] = total_loss / max(n, 1)
        return out

    def predict(
        self,
        state_or_params,
        data_dir: str,
        batch_size: int = 1,
        denormalization: Optional[Callable] = None,
        label_name: str = "label",
    ):
        """Yield per-sample prediction arrays (denormalized when a function is
        provided — reference predict path, framework_operations.py:209-213)."""
        params = getattr(state_or_params, "params", state_or_params)
        for arrays, meta in self.batches(
            data_dir, batch_size, shuffle=False, repeat=False, training=False
        ):
            preds = np.asarray(self._predict_fn(meta)(params, arrays))
            if denormalization is not None:
                preds = denormalization(preds, label_name)
            yield preds, arrays

    def _predict_fn(self, meta):
        key = ("predict", meta)
        if key not in self._eval_steps:
            self._eval_steps[key] = jax.jit(
                lambda p, b: self.model.apply(p, b, meta)
            )
        return self._eval_steps[key]


# --------------------------------------------------------------------------
# checkpointing: one directory per step, each tree as .npz leaves plus a
# JSON structure (the serving artifact's encoding, serving.py)
# --------------------------------------------------------------------------

_CKPT_PREFIX = "ckpt_"
_CKPT_PARTS = ("params", "opt_state")


class CheckpointManager:
    """Checkpoints under one directory: `ckpt_<step>/` holds
    `<part>.npz` + `<part>_tree.json` for params and opt_state. A checkpoint
    is written into a temporary directory and renamed into place, so no
    reader sees a partial one; all but the newest `keep_max` are deleted."""

    def __init__(self, directory: str, keep_max: int = 20):
        self.directory = os.path.abspath(directory)
        self.keep_max = keep_max
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            suffix = name[len(_CKPT_PREFIX):]
            if name.startswith(_CKPT_PREFIX) and suffix.isdigit():
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_CKPT_PREFIX}{step}")

    def save(self, state: TrainState) -> None:
        import json
        import shutil
        import tempfile

        from ..serving import _encode_tree

        tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=self.directory)
        try:
            for part in _CKPT_PARTS:
                leaves: list = []
                tree = _encode_tree(
                    jax.tree.map(np.asarray, getattr(state, part)), leaves
                )
                np.savez(
                    os.path.join(tmp, f"{part}.npz"),
                    **{f"p{i:05d}": a for i, a in enumerate(leaves)},
                )
                with open(os.path.join(tmp, f"{part}_tree.json"), "w") as f:
                    json.dump(tree, f)
            final = self._path(state.step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for step in self.steps()[: -self.keep_max or None]:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def restore(self, step: int, part: str, template):
        """The checkpoint's `part` laid out as `template` (same leaf count and
        shapes; container types, e.g. optax's named tuples, come from the
        template)."""
        import json

        from ..serving import _decode_tree

        path = self._path(step)
        with np.load(os.path.join(path, f"{part}.npz")) as z:
            leaves = [z[f"p{i:05d}"] for i in range(len(z.files))]
        with open(os.path.join(path, f"{part}_tree.json")) as f:
            saved = jax.tree_util.tree_leaves(_decode_tree(json.load(f), leaves))
        want, treedef = jax.tree_util.tree_flatten(template)
        if len(saved) != len(want) or any(
            np.shape(a) != np.shape(b) for a, b in zip(saved, want)
        ):
            raise ValueError(
                f"checkpoint {path} ({part}) does not match this model: "
                f"{[np.shape(a) for a in saved]} vs "
                f"{[np.shape(b) for b in want]}"
            )
        return jax.tree_util.tree_unflatten(
            treedef,
            [jnp.asarray(a, dtype=jnp.asarray(b).dtype)
             for a, b in zip(saved, want)],
        )


def _make_checkpoint_manager(directory: str, keep_max: int) -> CheckpointManager:
    return CheckpointManager(directory, keep_max)


def save_checkpoint(manager: CheckpointManager, state: TrainState) -> None:
    manager.save(state)


def restore_checkpoint(manager: CheckpointManager, state: TrainState) -> TrainState:
    """The latest checkpoint in `manager`'s directory, or `state` if none."""
    step = manager.latest_step()
    if step is None:
        return state
    return TrainState(
        manager.restore(step, "params", state.params),
        manager.restore(step, "opt_state", state.opt_state),
        step,
    )


def warm_start(state: TrainState, checkpoint_dir: str) -> TrainState:
    """Restore parameters (not optimizer state / step) from the latest
    checkpoint under `checkpoint_dir` — the reference's warm start restores
    only kernel/recurrent_kernel/bias variables (f_o.py:126-132); our params
    tree contains exactly those."""
    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint found under '{checkpoint_dir}'")
    manager = CheckpointManager(checkpoint_dir)
    step = manager.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under '{checkpoint_dir}'")
    return TrainState(
        manager.restore(step, "params", state.params), state.opt_state,
        state.step,
    )

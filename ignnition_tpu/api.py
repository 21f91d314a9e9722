"""The four user-facing verbs.

Mirrors the reference API surface (framework_operations.py):
`create_model` (f_o.py:42), `train_and_evaluate` (f_o.py:108), `predict`
(f_o.py:169), `debug` (f_o.py:239). A `Model` bundle (IR + config) replaces
the reference's module-global `model_info` handle (generate_model.py:34-43).
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

import jax
import numpy as np

from .config import RunConfig
from .data import find_dataset_dimensions
from .data.graph import PaddingConfig
from .frontend import parse_model_file
from .frontend.ir import ModelIR
from .model import build
from .training.trainer import Trainer, TrainState, warm_start
from .utils.registry import normalizations

log = logging.getLogger("ignnition_tpu")
if not log.handlers:  # configure only our logger, never the root logger
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(levelname)s ignnition_tpu: %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)
    log.propagate = False


@dataclass
class Model:
    """What `create_model` returns: the parsed IR plus the run config."""

    ir: ModelIR
    config: RunConfig


def _enable_compilation_cache(cfg: RunConfig) -> None:
    """Point JAX's persistent compilation cache at the configured directory
    (no-op when unset; JAX_COMPILATION_CACHE_DIR, where set, wins —
    utils/cache.py). Restarted processes then reuse compiled executables
    instead of repaying the full XLA compile."""
    d = getattr(cfg, "compilation_cache_dir", None)
    if d:
        from .utils.cache import enable_compilation_cache

        enable_compilation_cache(d)


def create_model(config: str | RunConfig = "./train_options.ini") -> Model:
    """Parse and validate the model description named by the config
    (reference create_model, f_o.py:42-47): infers dataset dimensions from
    the first training archive, then builds the IR."""
    cfg = config if isinstance(config, RunConfig) else RunConfig.from_ini(config)
    _enable_compilation_cache(cfg)
    dims = find_dataset_dimensions(cfg.train_dataset)
    model_ir = parse_model_file(cfg.json_path, dims)
    return Model(ir=model_ir, config=cfg)


class Runner:
    """Programmatic driver around Trainer for one Model."""

    def __init__(
        self,
        model: Model,
        padding: Optional[PaddingConfig] = None,
        seed: int = 0,
        mesh=None,
        model_strategy: str = "replicated",
        tensorboard_dir: Optional[str] = None,
        compute_dtype=None,
    ):
        """mesh: optional jax Mesh ('data','model') — train_and_evaluate then
        runs the SPMD parallel step, consuming mesh.shape['data'] merged
        batches per step (graph-batch data parallelism x edge partitioning).
        model_strategy: 'replicated' (v1 psum) or 'dest_shard' (v2
        destination-sharded halo exchange) for the mesh's model axis — see
        docs/scaling.md. compute_dtype: e.g. jnp.bfloat16 for mixed-precision
        training steps (float32 master weights)."""
        self.model = model
        _enable_compilation_cache(model.config)  # programmatic-config path
        self.gnn = build(model.ir)
        if padding is None and getattr(model.config, "per_graph_padding", False):
            padding = PaddingConfig(per_graph=True)
        self.trainer = Trainer(
            self.gnn, padding=padding, compute_dtype=compute_dtype
        )
        self.seed = seed
        self.mesh = mesh
        self.model_strategy = model_strategy
        self.tensorboard_dir = tensorboard_dir

    def _denorm_fn(self) -> Optional[Callable]:
        _, _, denorm = self.model.ir.output_info()
        if denorm is None:
            log.warning(
                "a denormalization function for the output was not defined; "
                "outputs and eval statistics use normalized values"
            )
            return None
        fn = normalizations().get(denorm)
        if fn is None:
            # review-found: a declared-but-unregistered name used to fall
            # through silently, emitting normalized values with NO signal
            log.warning(
                "label_denormalization '%s' is declared in the model "
                "description but no function with that name is registered "
                "(ig.register_normalization) — outputs and eval statistics "
                "use normalized values",
                denorm,
            )
        return fn

    def train_and_evaluate(self, run_dir: Optional[str] = None) -> TrainState:
        """Train with periodic eval/checkpointing (reference
        train_and_evaluate, framework_operations.py:108-166).

        run_dir: checkpoint directory override. Default mints a fresh
        timestamped `experiment_<now>` under model_dir (reference
        f_o.py:123-124); pass a previous run's directory to RESUME it from
        its latest checkpoint."""
        cfg = self.model.config
        state = self.trainer.init_state(jax.random.PRNGKey(self.seed))
        if cfg.warm_start_path:
            state = warm_start(state, cfg.warm_start_path)
            log.info("warm-started parameters from %s", cfg.warm_start_path)
        run_dir = run_dir or os.path.join(
            cfg.model_dir,
            "experiment_" + datetime.datetime.now().strftime("%Y%m%d_%H%M%S"),
        )
        label_name = self.model.ir.output_info()[0]
        denorm = self._denorm_fn()

        def eval_fn(st):
            return self.trainer.evaluate(
                st,
                cfg.eval_dataset,
                num_batches=cfg.eval_samples,
                batch_size=cfg.eval_batch_size,
                denormalization=denorm,
                label_name=label_name,
                cache=True,  # periodic evals reuse the built batches
                shuffle=cfg.shuffle_eval_samples,
            )

        return self.trainer.train(
            state,
            cfg.train_dataset,
            max_steps=cfg.train_steps,
            batch_size=cfg.batch_size,
            shuffle=cfg.shuffle_train_samples,
            log_every=cfg.log_every,
            checkpoint_dir=run_dir,
            save_secs=cfg.save_checkpoints_secs,
            keep_max=cfg.keep_checkpoint_max,
            eval_fn=eval_fn,
            eval_secs=cfg.throttle_secs,
            mesh=self.mesh,
            model_strategy=self.model_strategy,
            accumulate_steps=cfg.accumulate_steps,
            input_workers=cfg.input_workers,
            cache_batches=cfg.cache_batches,
            device_prefetch=cfg.device_prefetch,
            tensorboard_dir=self.tensorboard_dir,
        )

    def evaluate(self, state: TrainState) -> Dict[str, float]:
        cfg = self.model.config
        return self.trainer.evaluate(
            state,
            cfg.eval_dataset,
            num_batches=cfg.eval_samples,
            batch_size=cfg.eval_batch_size,
            denormalization=self._denorm_fn(),
            label_name=self.model.ir.output_info()[0],
            shuffle=cfg.shuffle_eval_samples,
        )

    def predict(self, state: Optional[TrainState] = None) -> List[np.ndarray]:
        cfg = self.model.config
        if cfg.predict_dataset is None:
            raise ValueError(
                "the path of the dataset to use for prediction is unspecified; "
                "add predict_dataset to the config"
            )
        if state is None:
            if not cfg.warm_start_path:
                raise ValueError(
                    "the path of the model to use for predictions is unspecified; "
                    "add warm_start_path to the config"
                )
            state = self.trainer.init_state(jax.random.PRNGKey(self.seed))
            state = warm_start(state, cfg.warm_start_path)
        label_name = self.model.ir.output_info()[0]
        denorm = self._denorm_fn()
        outputs: List[np.ndarray] = []
        from .data.graph import infer_label_domain

        domain = infer_label_domain(self.model.ir)
        for preds, arrays in self.trainer.predict(
            state,
            cfg.predict_dataset,
            denormalization=denorm,
            label_name=label_name,
        ):
            if domain[0] == "entity":
                mask = arrays[f"node_mask_{domain[1]}"] > 0
                outputs.append(preds[mask])
            elif domain[0] == "edge":
                # back to the sample's original (insertion-order) edge order
                # — the merged batch destination-sorts edge lists
                perm = arrays.get("label_perm")
                p = preds[np.asarray(perm)] if perm is not None else preds
                n = int(np.sum(np.asarray(arrays[f"edge_mask_{domain[1]}"]) > 0))
                outputs.append(p[:n])
            else:
                outputs.append(preds)
        return outputs


    def export_serving(
        self,
        out_dir: str,
        state: Optional[TrainState] = None,
        dataset: Optional[str] = None,
        batch_size: Optional[int] = None,
        compute_dtype=None,
        platforms=None,
    ) -> str:
        """Freeze the forward pass into a reloadable serving artifact
        (serving.export_serving). Shapes come from the first batch of
        `dataset` (default: predict_dataset, else train_dataset) at
        `batch_size` (default: config batch_size); params from `state` or
        the config's warm_start_path."""
        cfg = self.model.config
        dataset = dataset or cfg.predict_dataset or cfg.train_dataset
        batch_size = batch_size or cfg.batch_size
        if state is None:
            if not cfg.warm_start_path:
                raise ValueError(
                    "the path of the model to export is unspecified; pass a "
                    "TrainState or add warm_start_path to the config"
                )
            state = self.trainer.init_state(jax.random.PRNGKey(self.seed))
            state = warm_start(state, cfg.warm_start_path)
        arrays, meta = next(
            iter(
                self.trainer.batches(
                    dataset, batch_size, shuffle=False, repeat=False,
                    training=False,
                )
            )
        )
        from .frontend import load_description
        from .serving import export_serving as _export

        path = _export(
            self.gnn, state.params, meta, arrays, out_dir,
            compute_dtype=compute_dtype, platforms=platforms,
            description=load_description(cfg.json_path),
        )
        log.info("serving artifact written to %s", path)
        return path


# --------------------------------------------------------------------------
# module-level verbs (reference-style)
# --------------------------------------------------------------------------


def train_and_evaluate(
    model: Model, run_dir: Optional[str] = None, **runner_kw
) -> TrainState:
    """run_dir: pass a previous run's experiment directory to RESUME it
    (review-found: this knob used to be reachable only through the Runner
    method, not the reference-style module verb)."""
    log.info(
        "starting the training and evaluation process\n"
        + "-" * 75
    )
    return Runner(model, **runner_kw).train_and_evaluate(run_dir)


def predict(model: Model, state: Optional[TrainState] = None, **runner_kw):
    log.info("starting to make the predictions\n" + "-" * 55)
    return Runner(model, **runner_kw).predict(state)


def debug(model: Model, **runner_kw) -> str:
    """Emit the debug artifact: a human-readable structure report plus the
    compiled step's HLO, written to config.debug_dir (the reference writes a
    TensorBoard graph for visual inspection, f_o.py:239-268)."""
    log.info("generating the debug model\n" + "-" * 55)
    from .debug import write_debug_artifacts

    return write_debug_artifacts(model, **runner_kw)

"""Run configuration: `train_options.ini`-compatible.

Same sections and keys as the reference (code/train_options.ini,
framework_operations.py:34-36 reads it with ExtendedInterpolation):
[PATHS] train_dataset / eval_dataset / predict_dataset / json_path /
model_dir / debug_dir / warm_start_path; [TRAINING_OPTIONS] batch_size /
train_steps / shuffle_* / eval_samples / save_checkpoints_secs /
keep_checkpoint_max / throttle_secs. `execute_gpu` is accepted and ignored
(device selection is JAX's; see docs). Values may also be provided
programmatically.
"""

from __future__ import annotations

import configparser
from dataclasses import dataclass, field
from typing import Optional


def _str_to_bool(v: str) -> bool:
    return str(v).strip().lower() in ("true", "1", "yes")


@dataclass
class RunConfig:
    # [PATHS]
    train_dataset: str = ""
    eval_dataset: str = ""
    predict_dataset: Optional[str] = None
    json_path: str = ""
    model_dir: str = "./checkpoints"
    debug_dir: str = "./debug_model"
    warm_start_path: Optional[str] = None
    # extension over the reference: persistent XLA compilation cache
    # directory. Compiles of large models take tens of seconds; with this
    # set, every process restart after the first reuses the compiled
    # executables. JAX_COMPILATION_CACHE_DIR, where set, takes precedence
    # (utils/cache.py).
    compilation_cache_dir: Optional[str] = None
    # [TRAINING_OPTIONS]
    batch_size: int = 3
    train_steps: int = 5_000_000
    shuffle_train_samples: bool = True
    shuffle_eval_samples: bool = False
    eval_samples: int = 100
    # extension over the reference (which evaluates one graph at a time):
    # graphs merged per eval batch. eval_samples keeps its meaning — the
    # number of eval BATCHES drawn, as the reference's EvalSpec steps
    eval_batch_size: int = 1
    save_checkpoints_secs: int = 300
    keep_checkpoint_max: int = 20
    throttle_secs: int = 300
    log_every: int = 10
    # extension over the reference: gradient accumulation. "auto" (default)
    # measures the dataset's edges/graph and splits large effective batches
    # into peak-throughput microbatches automatically
    # (Trainer._auto_accumulate; PERF.md 'Large effective batches'); an int
    # forces that many stacked microbatches per optimizer step
    accumulate_steps: object = "auto"
    # extensions over the reference: host input-pipeline knobs
    # (Trainer.batches — parallel archive readers + batch builders, and
    # first-epoch batch caching; see PERF.md 'Host input pipeline')
    input_workers: int = 1
    # False | True (host cache after epoch one) | "device" (also keep every
    # cached batch device-resident: zero steady-state transfer cost)
    cache_batches: "bool | str" = False
    # opt-in: batches staged onto the device ahead of the running step
    # (Trainer._device_prefetch); 0 disables
    device_prefetch: int = 0
    # pad every graph's node blocks to the batch max so merged batches are
    # uniform and ride the block-diagonal incidence fast paths
    # (data/graph.py PaddingConfig.per_graph)
    per_graph_padding: bool = False

    @staticmethod
    def from_ini(path: str = "./train_options.ini") -> "RunConfig":
        cp = configparser.ConfigParser()
        cp._interpolation = configparser.ExtendedInterpolation()
        read = cp.read(path)
        if not read:
            raise FileNotFoundError(f"config file '{path}' not found")
        cfg = RunConfig()
        _PATH_KEYS = (
            "train_dataset",
            "eval_dataset",
            "predict_dataset",
            "json_path",
            "model_dir",
            "debug_dir",
            "warm_start_path",
            "compilation_cache_dir",
        )
        _INT_KEYS = (
            "batch_size",
            "train_steps",
            "eval_samples",
            "eval_batch_size",
            "save_checkpoints_secs",
            "keep_checkpoint_max",
            "throttle_secs",
            "log_every",
            "input_workers",
            "device_prefetch",
        )
        _BOOL_KEYS = (
            "shuffle_train_samples",
            "shuffle_eval_samples",
            "per_graph_padding",
        )
        # typo protection (the reference silently ignores misspelled keys):
        # every key must be known. execute_gpu is known-but-ignored (device
        # selection is JAX's — the reference's flag only ever disabled a
        # device, framework_operations.py:134-145).
        known = {
            "PATHS": set(_PATH_KEYS),
            "TRAINING_OPTIONS": set(_INT_KEYS)
            | set(_BOOL_KEYS)
            | {"accumulate_steps", "cache_batches", "execute_gpu"},
        }
        for section in cp.sections():
            if section not in known:
                raise ValueError(
                    f"unknown config section [{section}] in '{path}'; "
                    f"expected {sorted(known)}"
                )
            # configparser folds [DEFAULT] keys into every section view —
            # exclude them, they are interpolation helpers, not settings
            unknown = set(cp[section]) - known[section] - set(cp.defaults())
            if unknown:
                raise ValueError(
                    f"unknown key(s) {sorted(unknown)} in [{section}] of "
                    f"'{path}'; known keys: {sorted(known[section])}"
                )
        paths = cp["PATHS"] if cp.has_section("PATHS") else {}
        for key in _PATH_KEYS:
            if key in paths:
                setattr(cfg, key, paths[key])
        to = cp["TRAINING_OPTIONS"] if cp.has_section("TRAINING_OPTIONS") else {}
        for key in _INT_KEYS:
            if key in to:
                setattr(cfg, key, int(to[key]))
        if "accumulate_steps" in to:
            v = to["accumulate_steps"]
            cfg.accumulate_steps = v if v.strip().lower() == "auto" else int(v)
        for key in _BOOL_KEYS:
            if key in to:
                setattr(cfg, key, _str_to_bool(to[key]))
        if "cache_batches" in to:
            v = to["cache_batches"]
            cfg.cache_batches = "device" if v.lower() == "device" else _str_to_bool(v)
        return cfg

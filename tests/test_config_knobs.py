"""Config-knob wiring: shuffle_eval_samples is honored (reference
framework_operations.py:162), eval batch size is configurable, and unknown
INI keys fail loudly (typo protection the reference lacks)."""

from __future__ import annotations

import copy
import os

import jax
import numpy as np
import pytest

from ignnition_tpu.config import RunConfig
from ignnition_tpu.data.synthetic import write_dataset
from ignnition_tpu.frontend import parser
from ignnition_tpu.model import build
from ignnition_tpu.training.trainer import Trainer

from helpers import routenet_description

DIMS = {"link_capacity": 1, "traffic": 1,
        "adj_links_paths": 0, "adj_paths_links": 0}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg_ds")
    write_dataset(str(d), 2, 8, seed=5, n_links=8, n_paths=10, max_path_len=3)
    ir = parser.parse_model_description(
        copy.deepcopy(routenet_description(num_iterations=2, hs=8)), dict(DIMS)
    )
    trainer = Trainer(build(ir))
    state = trainer.init_state(jax.random.PRNGKey(0))
    return str(d), trainer, state


def test_shuffled_eval_same_metrics_over_full_set(setup):
    """Shuffling changes the evaluated ORDER but, over the full dataset,
    not the pooled metrics."""
    d, trainer, state = setup
    base = trainer.evaluate(state, d, num_batches=16)
    shuf = trainer.evaluate(state, d, num_batches=16, shuffle=True, seed=3)
    for k in ("r-squared", "mae", "mre"):
        key = k if k in base else [x for x in base if k.split("-")[0] in x][0]
        np.testing.assert_allclose(shuf[key], base[key], rtol=1e-5)


def test_shuffled_eval_subset_varies_with_seed(setup):
    """With fewer batches than the dataset holds, the shuffle decides WHICH
    samples are evaluated — different seeds give different subsets."""
    d, trainer, state = setup
    a = trainer.evaluate(state, d, num_batches=4, shuffle=True, seed=1)
    b = trainer.evaluate(state, d, num_batches=4, shuffle=True, seed=2)
    assert a["loss"] != b["loss"]


def test_shuffled_eval_with_cache(setup):
    """cache=True + shuffle: full set built once, fresh permutation per
    call; full-set metrics still match the unshuffled ones."""
    d, trainer, state = setup
    base = trainer.evaluate(state, d, num_batches=16)
    shuf = trainer.evaluate(state, d, num_batches=16, shuffle=True,
                            cache=True, seed=7)
    np.testing.assert_allclose(shuf["loss"], base["loss"], rtol=1e-5)
    sub_a = trainer.evaluate(state, d, num_batches=4, shuffle=True,
                             cache=True, seed=11)
    sub_b = trainer.evaluate(state, d, num_batches=4, shuffle=True,
                             cache=True, seed=12)
    assert sub_a["loss"] != sub_b["loss"]


def test_eval_batch_size_metrics_match(setup):
    """Merged-batch eval (batch_size > 1) pools the same statistics as
    one-graph-at-a-time eval."""
    d, trainer, state = setup
    one = trainer.evaluate(state, d, num_batches=16, batch_size=1)
    four = trainer.evaluate(state, d, num_batches=4, batch_size=4)
    for k in ("mae", "mre"):
        np.testing.assert_allclose(four[k], one[k], rtol=1e-4)


def test_unknown_ini_key_raises(tmp_path):
    p = tmp_path / "train_options.ini"
    p.write_text(
        "[TRAINING_OPTIONS]\nbatch_size = 4\nbatch_sixe = 2\n"
    )
    with pytest.raises(ValueError, match="batch_sixe"):
        RunConfig.from_ini(str(p))


def test_unknown_ini_section_raises(tmp_path):
    p = tmp_path / "train_options.ini"
    p.write_text("[TRAININGOPTIONS]\nbatch_size = 4\n")
    with pytest.raises(ValueError, match="TRAININGOPTIONS"):
        RunConfig.from_ini(str(p))


def test_eval_knobs_parse_from_ini(tmp_path):
    p = tmp_path / "train_options.ini"
    p.write_text(
        "[TRAINING_OPTIONS]\n"
        "eval_batch_size = 8\nshuffle_eval_samples = True\n"
        "execute_gpu = True\n"  # known-but-ignored, reference compat
    )
    cfg = RunConfig.from_ini(str(p))
    assert cfg.eval_batch_size == 8
    assert cfg.shuffle_eval_samples is True


def test_default_section_keys_allowed(tmp_path):
    """configparser folds [DEFAULT] keys into every section view — they are
    interpolation helpers, not settings, and must not trip the unknown-key
    validation (review-found)."""
    p = tmp_path / "train_options.ini"
    p.write_text(
        "[DEFAULT]\nroot = /data\n"
        "[PATHS]\ntrain_dataset = ${root}/train\n"
        "[TRAINING_OPTIONS]\nbatch_size = 4\n"
    )
    cfg = RunConfig.from_ini(str(p))
    assert cfg.train_dataset == "/data/train"
    assert cfg.batch_size == 4


def test_compilation_cache_dir_wires_jax_config(tmp_path, monkeypatch):
    """[PATHS] compilation_cache_dir parses and the API entry points point
    JAX's persistent compilation cache at it (api._enable_compilation_cache
    — restarted processes then reuse compiled executables)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    p = tmp_path / "train_options.ini"
    cache = tmp_path / "xla_cache"
    p.write_text(
        f"[PATHS]\ncompilation_cache_dir = {cache}\n"
        "[TRAINING_OPTIONS]\nbatch_size = 4\n"
    )
    cfg = RunConfig.from_ini(str(p))
    assert cfg.compilation_cache_dir == str(cache)

    from ignnition_tpu import api

    prev = jax.config.jax_compilation_cache_dir
    try:
        api._enable_compilation_cache(cfg)
        assert jax.config.jax_compilation_cache_dir == str(cache)
        # unset leaves the current setting alone
        api._enable_compilation_cache(RunConfig())
        assert jax.config.jax_compilation_cache_dir == str(cache)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_rule(tmp_path, monkeypatch, env_set):
    """utils/cache.py: JAX_COMPILATION_CACHE_DIR, where set, is the cache
    and nothing is set in code (the INI key yields to it too); otherwise
    the caller's directory, by default .jax_cache/ at the checkout root."""
    from ignnition_tpu import api
    from ignnition_tpu.utils import cache

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            assert cache.enable_compilation_cache() == str(tmp_path / "env")
            api._enable_compilation_cache(
                RunConfig(compilation_cache_dir=str(tmp_path / "ini"))
            )
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            d = cache.enable_compilation_cache()
            assert d == os.path.join(cache.CHECKOUT_ROOT, ".jax_cache")
            assert os.path.isfile(os.path.join(cache.CHECKOUT_ROOT, "pyproject.toml"))
            assert jax.config.jax_compilation_cache_dir == d
            other = str(tmp_path / "mine")
            assert cache.enable_compilation_cache(other) == other
            assert jax.config.jax_compilation_cache_dir == other
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)

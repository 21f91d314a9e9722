"""The main path needs nothing beyond JAX, numpy, scipy, optax, chex and
einops: with jsonschema, PyYAML, orbax and flatbuffers blocked, a model is
created from a JSON description, trained with a checkpoint, resumed,
exported for serving and served — in a fresh interpreter, so nothing the
test process already imported can hide an import."""

import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import json, os, sys
    BLOCKED = ("jsonschema", "yaml", "orbax", "flatbuffers", "tensorflow",
               "torch", "tensorboardX", "networkx")
    for name in BLOCKED:
        sys.modules[name] = None  # any import of it raises ImportError
    sys.path[:0] = [{root!r}, os.path.join({root!r}, "tests")]
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ignnition_tpu as ig
    from ignnition_tpu.data.synthetic import write_dataset
    from ignnition_tpu.training.trainer import CheckpointManager
    from helpers import routenet_description

    work = sys.argv[1]
    ds = os.path.join(work, "ds")
    write_dataset(ds, num_archives=1, samples_per_archive=4, seed=0,
                  n_links=10, n_paths=8, max_path_len=3)
    desc = os.path.join(work, "model_description.json")
    with open(desc, "w") as f:
        json.dump(routenet_description(num_iterations=2, hs=8), f)
    cfg = ig.RunConfig(json_path=desc, train_dataset=ds, eval_dataset=ds,
                       predict_dataset=ds,
                       model_dir=os.path.join(work, "model"), batch_size=2,
                       train_steps=3, eval_samples=1, log_every=0,
                       accumulate_steps=1)
    model = ig.create_model(cfg)
    run = os.path.join(work, "model", "run")
    state = ig.train_and_evaluate(model, run)
    assert state.step == 3 and CheckpointManager(run).steps() == [3]
    cfg.train_steps = 4
    assert ig.train_and_evaluate(model, run).step == 4
    preds = ig.predict(model, state)
    assert preds and all(p.size for p in preds)
    art = os.path.join(work, "artifact")
    ig.Runner(model).export_serving(art, state=state, batch_size=1)
    sm = ig.load_serving(art)
    sample = next(iter(ig.iter_samples(ds, ig.SampleSpec.from_ir(model.ir))))
    assert sm.predict_samples([sample]).size
    loaded = sorted({{m.split(".")[0] for m, v in sys.modules.items()
                     if v is not None}} & set(BLOCKED))
    print("BLOCKED_LOADED", loaded)
""")


def test_main_path_without_optional_packages(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(root=ROOT), str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BLOCKED_LOADED []" in out.stdout


def test_one_backend_dispatch_point():
    """Only ops/platform.py asks which backend JAX runs on, and every Pallas
    kernel names its GPU route."""
    pkg = os.path.join(ROOT, "ignnition_tpu")
    asks, calls = [], []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            src = open(path).read()
            if "default_backend(" in src:
                asks.append(os.path.relpath(path, pkg))
            if "pallas_call(" in src:
                calls.append(os.path.relpath(path, pkg))
                assert 'backend="triton"' in src or 'backend="mosaic_gpu"' in src
                routes = re.findall(r"experimental\.pallas import (\w+)", src)
                assert set(routes) <= {"triton", "mosaic_gpu"}, routes
                assert "interpret=True" not in src
    assert asks == [os.path.join("ops", "platform.py")]
    assert calls == [os.path.join("ops", "pallas", "attention_kernels.py")]

"""Host input-pipeline throughput: batches/s of Trainer.batches streaming
from disk (tar.gz JSON -> merged GraphBatch with all index companions),
across worker counts and with/without the native C++ aux core.

This is the host-side half of training throughput: if batches/s here is
below the device steps/s (bench.py), streaming training is host-bound.
"""

import os
import tempfile
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from ignnition_tpu.data import graph as G
from ignnition_tpu.data.synthetic import write_dataset
from ignnition_tpu.frontend.parser import parse_model_description
from ignnition_tpu.model import build
from ignnition_tpu.training import Trainer
import ignnition_tpu as ig


def flagship_ir(d):
    from __graft_entry__ import _flagship

    model_ir = _flagship(num_iterations=8, hs=32)
    return model_ir


def main():
    d = os.path.join(tempfile.gettempdir(), "bench_input_ds16")
    if not os.path.isdir(d):
        # ~800 graphs of ~120 links / 400 paths each
        write_dataset(d, num_archives=16, samples_per_archive=50, seed=0,
                      n_links=120, n_paths=400)
    model_ir = flagship_ir(d)
    model = build(model_ir)
    tr = Trainer(model)
    bs = 8

    def measure(workers, native, n=60, reps=3):
        G._USE_NATIVE_AUX = native
        best = 0.0
        for _ in range(reps):
            it = tr.batches(
                d, bs, shuffle=True, seed=0, repeat=True, workers=workers
            )
            next(it)  # warm (opens archives, caches)
            t0 = time.time()
            for _ in range(n):
                next(it)
            best = max(best, n / (time.time() - t0))
        return best

    for native in (False, True):
        for workers in (1, 2, 4):
            r = measure(workers, native)
            print(
                f"native_aux={int(native)} workers={workers}: "
                f"{r:6.2f} batches/s ({r * bs:6.1f} graphs/s)"
            )
    G._USE_NATIVE_AUX = True


if __name__ == "__main__":
    main()

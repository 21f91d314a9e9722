"""Streaming-training transfer A/B: per-array host dispatch vs packed
per-dtype buffers vs device-prefetch staging vs device-resident batches.

Small-graph streaming workloads pay the host->device dispatch per step;
this measures every transfer strategy the trainer offers. Packing and
staging default off; their effect on the GPU is not measured yet.
"""

import itertools
import os
import tempfile
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import numpy as np

from ignnition_tpu.data.synthetic import write_dataset
from ignnition_tpu.model import build
from ignnition_tpu.training import Trainer
from ignnition_tpu.training.packing import pack_arrays, pack_layout


def main():
    from __graft_entry__ import _flagship

    d = os.path.join(tempfile.gettempdir(), "bench_stream_ds")
    if not os.path.isdir(d):
        write_dataset(d, num_archives=8, samples_per_archive=50, seed=0,
                      n_links=120, n_paths=400)
    model_ir = _flagship(num_iterations=8, hs=32)
    trainer = Trainer(build(model_ir))

    # materialize batches host-side and keep the dominant meta so the whole
    # run is one jit program (isolates the transfer, not recompiles)
    built = list(trainer.batches(d, 8, shuffle=True, seed=0, repeat=False))
    metas = {}
    for _, m in built:
        metas[m] = metas.get(m, 0) + 1
    meta = max(metas, key=metas.get)
    batches = [a for a, m in built if m == meta][:16]
    layout = pack_layout(batches[0])
    packed = [pack_arrays(a, layout) for a in batches]
    nbytes = sum(v.nbytes for v in batches[0].values())
    print(f"{len(batches)} batches of one meta, {len(batches[0])} arrays, "
          f"{nbytes / 1e6:.2f} MB/batch -> {len(packed[0])} packed buffers")

    state = trainer.init_state(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)

    def run(step, data, n, prefetch):
        it = ((a, meta) for a in itertools.islice(itertools.cycle(data), n))
        if prefetch:
            it = Trainer._device_prefetch(it, prefetch)
        p, o = state.params, state.opt_state
        for arrays, _ in it:
            p, o, logs = step(p, o, arrays, key)
        float(logs["loss"])

    plain = trainer.train_step_fn(meta)
    pstep = trainer.train_step_fn(meta, layout=layout)
    run(plain, batches, 3, 0)  # compile + warm
    run(pstep, packed, 3, 0)

    # packed == plain (same batch, same state)
    a = plain(state.params, state.opt_state, batches[0], key)[2]["loss"]
    b = pstep(state.params, state.opt_state, packed[0], key)[2]["loss"]
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)

    dev = [jax.device_put(a) for a in batches]  # cache_batches="device"
    for name, step, data, prefetch in (
        ("per-array dispatch      ", plain, batches, 0),
        ("packed buffers          ", pstep, packed, 0),
        ("packed + thread staging ", pstep, packed, 2),
        ("device-resident cache   ", plain, dev, 0),
    ):
        run(step, data, 3, prefetch)
        t0 = time.time()
        run(step, data, 60, prefetch)
        dt = (time.time() - t0) / 60
        print(f"{name}: {dt * 1e3:6.2f} ms/step ({1 / dt:6.1f} steps/s)")


if __name__ == "__main__":
    main()

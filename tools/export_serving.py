"""Export a trained model to a self-contained serving artifact.

Usage:
  python tools/export_serving.py --config train_options.ini --out DIR \
      [--ckpt CHECKPOINT_DIR] [--batch-size N] [--platforms cuda]

The artifact (serialized StableHLO + params + manifest, see
ignnition_tpu/serving.py) reloads with `ignnition_tpu.load_serving(DIR)`
and serves raw samples via `ServingModel.predict_samples`.
"""

import argparse
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="./train_options.ini")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument(
        "--ckpt",
        default=None,
        help="checkpoint to export (default: the config's warm_start_path)",
    )
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument(
        "--platforms",
        default=None,
        help="comma-separated lowering platforms, e.g. 'cuda' or 'cpu,cuda' "
        "(default: the current backend)",
    )
    ap.add_argument(
        "--compute-dtype",
        default=None,
        help="e.g. bfloat16 for mixed-precision serving",
    )
    args = ap.parse_args()

    import ignnition_tpu as ig

    model = ig.create_model(args.config)
    if args.ckpt:
        model.config.warm_start_path = args.ckpt
    runner = ig.Runner(model)
    dtype = None
    if args.compute_dtype:
        import jax.numpy as jnp

        dtype = jnp.dtype(args.compute_dtype)
    path = runner.export_serving(
        args.out,
        batch_size=args.batch_size,
        compute_dtype=dtype,
        platforms=args.platforms.split(",") if args.platforms else None,
    )
    print(f"serving artifact written to {path}")


if __name__ == "__main__":
    main()

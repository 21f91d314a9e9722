#!/usr/bin/env python
"""RouteNet quickstart.

Either migrate a real KDN dataset first:

    python tools/migrate.py --dataset /path/to/nsfnetbw --output_path ./data

or pass --synthetic to generate a small synthetic dataset in the same format.
Then:

    python examples/routenet/main.py --synthetic
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import ignnition_tpu as ig
from ignnition_tpu.config import RunConfig


def normalization_routenet(feature, name):
    # feature scaling from the reference quickstart (code/main.py:40-46)
    if name == "traffic":
        return (feature - 170.0) / 130.0
    if name == "link_capacity":
        return (feature - 25000.0) / 40000.0
    return feature


ig.register_normalization("normalization_routenet", normalization_routenet)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true", help="generate demo data")
    p.add_argument("--data", default="./data", help="dataset root (train/ eval/)")
    p.add_argument("--steps", type=int, default=2000)
    args = p.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    if args.synthetic:
        from ignnition_tpu.data.synthetic import write_dataset

        os.makedirs(args.data, exist_ok=True)
        write_dataset(os.path.join(args.data, "train"), 4, 25, seed=0)
        write_dataset(os.path.join(args.data, "eval"), 1, 25, seed=99)

    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
        predict_dataset=os.path.join(args.data, "eval"),
        json_path=os.path.join(here, "model_description.json"),
        model_dir=os.path.join(args.data, "checkpoints"),
        debug_dir=os.path.join(args.data, "debug"),
        batch_size=8,
        train_steps=args.steps,
        eval_samples=10,
        throttle_secs=120,
        save_checkpoints_secs=120,
    )

    model = ig.create_model(cfg)
    ig.debug(model)
    state = ig.train_and_evaluate(model)
    runner = ig.Runner(model)
    print("final eval:", runner.evaluate(state))


if __name__ == "__main__":
    main()

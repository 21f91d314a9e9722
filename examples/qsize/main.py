#!/usr/bin/env python
"""Q-size quickstart (three-entity interleave model) on synthetic data:

    python examples/qsize/main.py
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import ignnition_tpu as ig
from ignnition_tpu.config import RunConfig


def normalization_queue_size(feature, name):
    # reference quickstart scalings (code/main.py:26-38)
    if name == "delay":
        return (np.log(feature) + 1.78) / 0.93
    if name == "traffic":
        return (feature - 0.28) / 0.15
    if name == "jitter":
        return (feature - 1.5) / 1.5
    if name == "link_capacity":
        return (feature - 27.0) / 14.86
    if name == "queue_sizes":
        return (feature - 16.5) / 15.5
    return feature


ig.register_normalization("normalization_queue_size", normalization_queue_size)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="./data_qsize")
    p.add_argument("--steps", type=int, default=1000)
    args = p.parse_args()

    from ignnition_tpu.data.synthetic import write_dataset

    os.makedirs(args.data, exist_ok=True)
    write_dataset(os.path.join(args.data, "train"), 4, 25, seed=0, with_nodes=True)
    write_dataset(os.path.join(args.data, "eval"), 1, 25, seed=99, with_nodes=True)

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
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
    state = ig.train_and_evaluate(model)
    print("final eval:", ig.Runner(model).evaluate(state))


if __name__ == "__main__":
    main()

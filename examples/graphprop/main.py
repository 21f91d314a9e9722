#!/usr/bin/env python
"""Graph-property quickstart: GAT/GCN-family model on homogeneous graphs.

A single `node` entity message-passes over a symmetric `adj_nodes_nodes`
adjacency (attention aggregation + feed-forward update, then convolution +
GRU), and a pooled readout predicts one scalar per graph. Demonstrates the
DSL on a standard homogeneous-GNN workload, beyond the heterogeneous
RouteNet/Q-size families.

    python examples/graphprop/main.py --synthetic
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import ignnition_tpu as ig
from ignnition_tpu.config import RunConfig


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true", help="generate demo data")
    p.add_argument("--data", default="./data_graphprop", help="dataset root")
    p.add_argument("--steps", type=int, default=1500)
    args = p.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    if args.synthetic:
        from ignnition_tpu.data.synthetic import write_graphprop_dataset

        os.makedirs(args.data, exist_ok=True)
        write_graphprop_dataset(os.path.join(args.data, "train"), 4, 50, seed=0)
        write_graphprop_dataset(os.path.join(args.data, "eval"), 1, 30, seed=99)

    cfg = RunConfig(
        train_dataset=os.path.join(args.data, "train"),
        eval_dataset=os.path.join(args.data, "eval"),
        predict_dataset=os.path.join(args.data, "eval"),
        json_path=os.path.join(here, "model_description.json"),
        model_dir=os.path.join(args.data, "checkpoints"),
        debug_dir=os.path.join(args.data, "debug"),
        batch_size=16,
        train_steps=args.steps,
        eval_samples=30,
        throttle_secs=300,
        save_checkpoints_secs=300,
    )

    model = ig.create_model(cfg)
    state = ig.train_and_evaluate(model)
    runner = ig.Runner(model)
    print("final eval:", runner.evaluate(state))


if __name__ == "__main__":
    main()

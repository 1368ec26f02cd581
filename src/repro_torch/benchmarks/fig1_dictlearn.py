"""Figure 1 reproduction: the impact of the aggregation space (the
counterpart of the reference's ``benchmarks/fig1_dictlearn.py``).

Federated dictionary learning (eq. 28) on three data settings (synthetic
homogeneous, synthetic heterogeneous, MovieLens-like), FedMM (S-space
aggregation) against the naive Theta-space baseline. Reports the
objective, the parameter-space movement (E^{p,s}) of FedMM and the
surrogate-space movements (E^s of FedMM, E^{s,p} of naive) per round.

The paper's observations: FedMM's objective decays on all three settings;
the naive algorithm does not reach FedMM's objective (on the synthetic
heterogeneous data it stalls far above it).

    python -m repro_torch.benchmarks.fig1_dictlearn [--full] [--device cpu]
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import api
from ..configs.dictlearn import (MOVIELENS, SYNTH_HETEROGENEOUS,
                                 SYNTH_HOMOGENEOUS)
from ..core import compression as C
from ..core.variational import DictLearnSpec, make_dictlearn
from ..data.movielens import movielens_like
from ..data.synthetic import (balanced_kmeans_split, client_minibatch_fn,
                              dictlearn_data, homogeneous_split)
from .run import figure_args, harness

SETTINGS = (SYNTH_HOMOGENEOUS, SYNTH_HETEROGENEOUS, MOVIELENS)


class Setting(NamedTuple):
    spec: DictLearnSpec
    clients: torch.Tensor     # (n_clients, n_local, p)
    z: torch.Tensor           # (n_samples, p), all the data
    theta0: torch.Tensor      # (p, K), the initial dictionary


def make_setting(exp, seed: int = 0, reduced: bool = True,
                 device=None) -> Setting:
    """One experiment's data, client split, problem size and initial
    dictionary, drawn on the host from ``seed`` (so every device gets the
    same) and placed on ``device`` (the GPU unless asked otherwise)."""
    dev = api.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if exp.split == "movielens":
        p, K = (100, 20) if reduced else (exp.p, exp.K)
        n_samples = 1000 if reduced else exp.n_samples
        z = movielens_like(gen, n_users=n_samples, n_movies=p, rank=K,
                           device=dev)
    else:
        p, K = exp.p, exp.K
        n_samples = exp.n_samples if not reduced else min(exp.n_samples, 1500)
        z, _ = dictlearn_data(gen, n_samples, p, K, device=dev)
    if exp.split == "homogeneous":
        clients = homogeneous_split(z, exp.n_clients)
    else:
        split_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        clients = balanced_kmeans_split(split_seed, z, exp.n_clients,
                                        n_iters=5 if reduced else 20)
    spec = DictLearnSpec(p=p, K=K, lam=exp.lam, eta=exp.eta,
                         ista_iters=50 if reduced else 100)
    theta0 = (torch.randn((p, K), generator=gen) * 0.1).to(dev)
    return Setting(spec, clients, z, theta0)


def algorithm_args(exp, setting: Setting, compressor) -> dict:
    """The ``api.run`` arguments of FedMM (S-space aggregation) and of the
    naive Theta-space baseline on one setting: ``{"fedmm": ..., "naive":
    ...}``, each ``(problem, x0, data, schedule, keywords)``. The two
    differ in one flag and their starting point and diagnostic."""
    spec, clients, z, theta0 = setting
    sur = make_dictlearn(spec)
    fed = api.FederationSpec(
        n_clients=exp.n_clients, participation=exp.participation,
        alpha=exp.alpha, compressor=compressor)
    batch_fn = client_minibatch_fn(clients, exp.batch_size)
    gamma = api.decaying_stepsize(exp.beta_stepsize)
    eval_z = z[:512]
    return {
        "fedmm": (sur, sur.s_bar(z[:128], theta0), batch_fn, gamma,
                  dict(spec=fed, eval_batch=eval_z, track_mirror=True)),
        "naive": (sur, theta0, batch_fn, gamma,
                  dict(spec=dataclasses.replace(fed, aggregation="parameter"),
                       eval_batch=eval_z,
                       diag=("e_s_p", api.mean_oracle_diag(
                           sur, clients[:, :128])))),
    }


def run_setting(exp, rounds: int = 120, reduced: bool = True, seed: int = 0,
                device=None, setting: Setting | None = None) -> dict:
    """FedMM and naive on one setting (built here unless ``setting`` is
    given), both from the same seed: the same participation masks, dither
    seeds and minibatches."""
    dev = api.resolve_device(device)
    if setting is None:
        setting = make_setting(exp, seed, reduced, dev)
    out = {}
    for name, (sur, x0, data, gamma, kw) in algorithm_args(
            exp, setting, C.block_quant(exp.quant_bits, 128)).items():
        _, out[name], out["seconds_" + name] = harness(
            sur, x0, data, gamma, key=seed, rounds=rounds, device=dev, **kw)
    out["seconds"] = out["seconds_fedmm"] + out["seconds_naive"]
    return out


def summary(exp, out: dict) -> dict:
    f, n = out["fedmm"], out["naive"]
    return {
        "setting": exp.name,
        "fedmm_loss_first": f[0]["loss"], "fedmm_loss_last": f[-1]["loss"],
        "naive_loss_first": n[0]["loss"], "naive_loss_last": n[-1]["loss"],
        "fedmm_es_last": f[-1]["e_s"],
        "naive_esp_last": n[-1].get("e_s_p", float("nan")),
        "seconds": out["seconds"],
    }


def main(reduced: bool = True, rounds: int = 120, device=None) -> list:
    rows = []
    for exp in SETTINGS:
        row = summary(exp, run_setting(exp, rounds=rounds, reduced=reduced,
                                       device=device))
        rows.append(row)
        print(f"[fig1] {exp.name:22s} "
              f"FedMM loss {row['fedmm_loss_first']:.3f}->{row['fedmm_loss_last']:.3f}  "
              f"naive loss {row['naive_loss_first']:.3f}->{row['naive_loss_last']:.3f}  "
              f"E^s(FedMM)={row['fedmm_es_last']:.3e} "
              f"E^sp(naive)={row['naive_esp_last']:.3e}  ({row['seconds']:.1f}s)",
              flush=True)
    return rows


if __name__ == "__main__":
    _args = figure_args(__doc__)
    main(reduced=not _args.full, rounds=300 if _args.full else 120,
         device=_args.device)

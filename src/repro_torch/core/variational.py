"""Example 3, the variational surrogate: dictionary learning / matrix
factorization (Section 2.3, eqs. (14)-(18); the Section 6 experiment; the
counterpart of ``repro/core/variational.py``).

Problem (eq. 28):
    argmin_theta  (1/n) sum_i E_{pi_i}[ min_h 0.5 ||Z - theta h||^2
                                        + lam ||h||_1 ] + eta ||theta||^2

Mirror parameter  s = (s1, s2) in S = M_K^+ x R^{pxK}:
    s1 = E[ h* h*^T ],    s2 = E[ Z h*^T ],    h* = M(Z, theta)  (lasso)

T(s) = argmin_theta  eta ||theta||^2 + Tr(theta^T theta s1) - 2 Tr(theta^T s2)
     = s2 (s1 + eta I)^{-1}

``s_bar`` and ``T`` run under ``torch.func.vmap`` (``api.step``'s
``client_mode="vmap"``; ``T`` there in parameter-space aggregation).
"""
from __future__ import annotations

import dataclasses

import torch

from .prox import lasso_ista, project_psd
from .surrogate import Surrogate


@dataclasses.dataclass(frozen=True)
class DictLearnSpec:
    p: int                 # observation dimension
    K: int                 # dictionary size / embedding dim
    lam: float = 0.1       # l1 penalty on codes h
    eta: float = 0.2       # l2 penalty on the dictionary theta
    ista_iters: int = 100  # inner lasso solver iterations


def sparse_code(z, theta, spec: DictLearnSpec):
    """M(Z, theta): batched lasso (eq. 16/24). z: (b, p) -> h: (b, K)."""
    return lasso_ista(z, theta, spec.lam, spec.ista_iters)


def _z(batch):
    return batch["z"] if isinstance(batch, dict) else batch


def make_dictlearn(spec: DictLearnSpec) -> Surrogate:
    def s_bar(batch, theta):
        z = _z(batch)                                           # (b, p)
        h = sparse_code(z, theta, spec)                         # (b, K)
        b = z.shape[0]
        s1 = h.T @ h / b                                        # (K, K) in M_K^+
        s2 = z.T @ h / b                                        # (p, K)
        return {"s1": s1, "s2": s2}

    def T(s):
        A = s["s1"] + spec.eta * torch.eye(spec.K, dtype=s["s1"].dtype,
                                           device=s["s1"].device)
        # theta = s2 A^{-1}; solve A^T X^T = s2^T for X
        return torch.linalg.solve(A.T, s["s2"].T).T             # (p, K)

    def project(s):
        # S = M_K^+ x R^{pxK}: PSD-project s1 (quantization / control-variate
        # corrections can push it off the cone — Section 5 "Challenges")
        return {"s1": project_psd(s["s1"]), "s2": s["s2"]}

    def loss(batch, theta):
        z = _z(batch)
        h = sparse_code(z, theta, spec)
        recon = 0.5 * torch.mean(torch.sum((z - h @ theta.T) ** 2, dim=1))
        l1 = spec.lam * torch.mean(torch.sum(torch.abs(h), dim=1))
        return recon + l1 + spec.eta * torch.sum(theta ** 2)

    return Surrogate(s_bar=s_bar, T=T, project=project, loss=loss)

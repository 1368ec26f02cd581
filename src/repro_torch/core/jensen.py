"""Example 2, Jensen surrogates: EM in vector exponential families (the
counterpart of ``repro/core/jensen.py``).

Two instances from Appendix C:

1. Poisson observations with a latent log-intensity shift (App. C.1, the
   "E_pi[Z] explicit" variant):
       psi(theta) = -theta E[Z],  phi(theta) = exp(theta),
       S(Z, h) = -exp(h),  S = R_{<0},  T(s) = log(E[Z] / (lambda - s)),
   and the A7 geometry B(s) = E[Z]/(lambda - s)^2 in closed form (App. E.2).

2. A mixture of L Gaussians with known weights/covariances and
   ridge-penalized means (App. C.2). Mirror parameter s = (s1, s2) with
       s1[l] = E[ Z * post_l(Z) ],   s2[l] = E[ post_l(Z) ],  l < L,
   and T the closed-form penalized M-step. All L components stay in s (an
   equivalent parameterization of the paper's L - 1, as FedEM keeps them).

The reference maps its per-component solves over the components with
``jax.vmap``; here they are batched ``torch.linalg`` calls over the
leading component axis.
"""
from __future__ import annotations

import dataclasses

import torch

from .surrogate import Surrogate


# ---------------------------------------------------------------------------
# Poisson-EM (Appendix C.1, second parameterization)
# ---------------------------------------------------------------------------

def make_poisson_em(mean_z: float, lam: float, s_min: float = -50.0) -> Surrogate:
    """Latent-intensity Poisson MAP-EM. Batches are dicts whose key 'h'
    holds posterior draws of the latent h given Z at parameter tau; the
    oracle is s_bar = -mean(exp(h))."""

    def s_bar(batch, tau):
        del tau
        return -torch.mean(torch.exp(batch["h"]))

    def T(s):
        return torch.log(mean_z / (lam - s))

    def project(s):
        return torch.clamp(s, s_min, -1e-8)  # S = [-M, 0)

    def psi(theta):
        return -theta * mean_z

    def phi(theta):
        return torch.exp(theta)

    return Surrogate(s_bar=s_bar, T=T, project=project, psi=psi, phi=phi)


def poisson_em_metric(mean_z: float, lam: float):
    """Returns B(s) over S = [-M, 0] (App. E.2)."""
    def B(s):
        return mean_z / (lam - s) ** 2
    return B


# ---------------------------------------------------------------------------
# GMM-EM with known covariances/weights, ridge MAP on the means (App. C.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GMMSpec:
    weights: torch.Tensor      # (L,)
    covs: torch.Tensor         # (L, p, p)
    lam: float                 # ridge penalty on the means


def _gmm_logp(z, means, spec: GMMSpec):
    """Joint log densities log(w_l N(z; m_l, C_l)) up to the shared
    constant: z (b, p), means (L, p) -> (b, L)."""
    chols = torch.linalg.cholesky(spec.covs)                 # (L, p, p)
    diff = z[:, None, :] - means[None, :, :]                 # (b, L, p)
    # one triangular solve per component, batched over L: (L, p, b)
    sol = torch.linalg.solve_triangular(chols, diff.permute(1, 2, 0),
                                        upper=False)
    maha = torch.sum(sol ** 2, dim=1).T                      # (b, L)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chols, dim1=1, dim2=2)),
                             dim=1)                          # (L,)
    return torch.log(spec.weights)[None, :] - 0.5 * (maha + logdet[None, :])


def _gmm_log_post(z, means, spec: GMMSpec):
    """log responsibilities: z (b, p), means (L, p) -> (b, L)."""
    logp = _gmm_logp(z, means, spec)
    return logp - torch.logsumexp(logp, dim=1, keepdim=True)


def gmm_neg_loglik(z, means, spec: GMMSpec):
    """Penalized negative log-likelihood (the f + g the EM minimizes)."""
    ll = torch.logsumexp(_gmm_logp(z, means, spec), dim=1)
    return -torch.mean(ll) + 0.5 * spec.lam * torch.sum(means ** 2)


def make_gmm_em(spec: GMMSpec) -> Surrogate:
    """theta = means (L, p); s = dict(s1=(L, p), s2=(L,))."""

    def s_bar(batch, means):
        z = batch["z"] if isinstance(batch, dict) else batch      # (b, p)
        post = torch.exp(_gmm_log_post(z, means, spec))           # (b, L)
        s1 = post.T @ z / z.shape[0]                              # (L, p)
        s2 = torch.mean(post, dim=0)                              # (L,)
        return {"s1": s1, "s2": s2}

    def T(s):
        # M-step of the ridge-MAP EM: means_l = (s2_l I + lam C_l)^{-1} s1_l
        covs = spec.covs
        eye = torch.eye(covs.shape[-1], dtype=covs.dtype, device=covs.device)
        A = s["s2"][:, None, None] * eye + spec.lam * covs        # (L, p, p)
        return torch.linalg.solve(A, s["s1"][..., None])[..., 0]

    def project(s):
        # s2 in [0, 1] (all L components kept, so sum == 1 at fixed
        # points); clipped for robustness to quantization noise
        return {"s1": s["s1"], "s2": torch.clamp(s["s2"], 1e-6, 1.0)}

    def loss(batch, means):
        z = batch["z"] if isinstance(batch, dict) else batch
        return gmm_neg_loglik(z, means, spec)

    return Surrogate(s_bar=s_bar, T=T, project=project, loss=loss)

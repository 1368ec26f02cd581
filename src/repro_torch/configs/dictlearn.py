"""The paper's own experiment configs (Section 6; the counterpart of
``repro/configs/dictlearn.py``): federated dictionary learning on
synthetic homogeneous / heterogeneous data and the MovieLens-like matrix
(an offline synthetic stand-in, ``data/movielens.py``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DictLearnExperiment:
    name: str
    p: int               # observation dim
    K: int               # embedding dim
    n_clients: int = 20
    lam: float = 0.1
    eta: float = 0.2
    n_samples: int = 5000
    split: str = "heterogeneous"   # homogeneous | heterogeneous | movielens
    batch_size: int = 50
    participation: float = 0.5     # 10 of 20 clients per round
    alpha: float = 0.01
    quant_bits: int = 8
    beta_stepsize: float = 0.02    # gamma_t = beta / sqrt(beta + t)


SYNTH_HOMOGENEOUS = DictLearnExperiment(
    name="synth_homogeneous", p=50, K=15, n_samples=250, split="homogeneous")
SYNTH_HETEROGENEOUS = DictLearnExperiment(
    name="synth_heterogeneous", p=50, K=15, n_samples=5000, split="heterogeneous")
MOVIELENS = DictLearnExperiment(
    name="movielens", p=500, K=50, n_samples=5000, split="movielens")

"""The port's data generators, client splits and dictlearn configs against
the JAX package's (``repro/data``, ``repro/configs/dictlearn.py``).

The generators draw from different PRNGs (threefry there, a
``torch.Generator`` here), so their outputs are held to the same shapes,
supports and statistics, not to equal values. The splits take handed-over
arrays: ``homogeneous_split`` and ``balanced_kmeans_split`` (given the
reference's integer seed) are held bit for bit; ``iid_split`` and the
minibatch function draw their own indices and are held to partitions and
shapes. Mirrors ``tests/test_data_checkpoint.py``'s split and generator
tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dictlearn as jcfg
from repro.data import synthetic as jsyn
from repro.data.movielens import movielens_like as jmovielens
from repro_torch import configs as tconfigs
from repro_torch.configs import dictlearn as tcfg
from repro_torch.data import synthetic as tsyn
from repro_torch.data.movielens import movielens_like as tmovielens

from _torch_parity import assert_bits_equal, to_torch

KEY = jax.random.PRNGKey(0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_homogeneous_split_bitwise():
    z = np.arange(20.0, dtype=np.float32).reshape(10, 2)
    want = np.asarray(jsyn.homogeneous_split(jnp.asarray(z), 3))
    got = tsyn.homogeneous_split(to_torch(z), 3)
    assert_bits_equal(got, want)


def test_iid_split_partition():
    z = np.arange(42.0, dtype=np.float32).reshape(21, 2)
    want = jsyn.iid_split(KEY, jnp.asarray(z), 4)
    got = tsyn.iid_split(_gen(), to_torch(z), 4)
    assert tuple(got.shape) == want.shape == (4, 5, 2)
    flat = np.sort(got[..., 0].numpy().reshape(-1))
    assert len(np.unique(flat)) == 20            # a partition, no repeats
    # rows stay whole: each row is (2k, 2k + 1) of the input
    np.testing.assert_array_equal(got[..., 1].numpy(), got[..., 0].numpy() + 1)


@pytest.mark.parametrize("n,p,K,clients,iters", [(300, 10, 3, 5, 5),
                                                 (403, 20, 4, 8, 3),
                                                 (250, 50, 15, 20, 2)])
def test_balanced_kmeans_bit_for_bit(n, p, K, clients, iters):
    """Given the reference's integer seed (``synthetic.py:55``) and its
    data, the port's split is the reference's, bit for bit."""
    z, _ = jsyn.dictlearn_data(KEY, n, p, K)
    want = np.asarray(jsyn.balanced_kmeans_split(KEY, z, clients,
                                                 n_iters=iters))
    seed = int(jax.random.randint(KEY, (), 0, 2**31 - 1))
    got = tsyn.balanced_kmeans_split(seed, to_torch(np.asarray(z)), clients,
                                     n_iters=iters)
    assert tuple(got.shape) == (clients, n // clients, p)
    assert_bits_equal(got, want)


def test_balanced_kmeans_is_heterogeneous():
    z, _ = tsyn.dictlearn_data(_gen(), 300, 10, 3, device="cpu")
    out = tsyn.balanced_kmeans_split(0, z, 5, n_iters=5)
    assert tuple(out.shape) == (5, 60, 10)
    # a partition: the clients' rows are z's rows, each once
    def rows(a):
        return sorted(map(tuple, a.reshape(-1, 10).numpy().tolist()))
    assert rows(out) == rows(z)
    cmeans = out.mean(dim=1)
    between = torch.linalg.vector_norm(cmeans[:, None] - cmeans[None],
                                       dim=-1).mean()
    assert float(between) > 0.1


@pytest.mark.parametrize("gen_device", ["cpu", "data"])
def test_minibatch_fn_shapes_and_rows(gen_device):
    data = np.arange(120.0, dtype=np.float32).reshape(4, 10, 3)
    want = jsyn.client_minibatch_fn(jnp.asarray(data), batch_size=6)(0, KEY)
    tdata = to_torch(data)
    gen = (_gen() if gen_device == "cpu"
           else torch.Generator(device=tdata.device).manual_seed(0))
    got = tsyn.client_minibatch_fn(tdata, batch_size=6)(0, gen)
    assert tuple(got.shape) == want.shape == (4, 6, 3)
    # every drawn row is a row of its own client's shard
    for c in range(4):
        shard = {tuple(r) for r in data[c].tolist()}
        assert all(tuple(r) in shard for r in got[c].numpy().tolist())


def test_dictlearn_data_rank_and_shapes():
    jz, jtheta = jsyn.dictlearn_data(KEY, 500, 20, 5)
    z, theta = tsyn.dictlearn_data(_gen(), 500, 20, 5, device="cpu")
    assert tuple(z.shape) == jz.shape and tuple(theta.shape) == jtheta.shape
    # Z lives in the span of theta*: rank <= 5
    s = torch.linalg.svdvals(z)
    assert float(s[5] / s[0]) < 1e-4
    # 20% support of N(0, 1) codes: E||z||^2 = 0.2 * ||theta*||_F^2
    ratio = float(torch.mean(torch.sum(z ** 2, dim=1))
                  / (0.2 * torch.sum(theta ** 2)))
    assert 0.8 < ratio < 1.2


def test_gmm_data_component_means():
    means = np.array([[-10.0, 0.0], [10.0, 0.0]], np.float32)
    covs = np.stack([np.eye(2, dtype=np.float32)] * 2)
    w = np.array([0.5, 0.5], np.float32)
    jz = jsyn.gmm_data(KEY, 4000, jnp.asarray(means), jnp.asarray(covs),
                       jnp.asarray(w))
    z = tsyn.gmm_data(_gen(), 4000, means, covs, w, device="cpu")
    assert tuple(z.shape) == jz.shape
    assert abs(float(torch.mean(z[:, 0]))) < 1.0   # symmetric components
    # each point sits near one of the two means
    near = torch.minimum(torch.abs(z[:, 0] - 10), torch.abs(z[:, 0] + 10))
    assert float(torch.mean(near)) < 1.0


def test_movielens_like_geometry():
    jr = jmovielens(KEY, n_users=400, n_movies=60, rank=8)
    r = tmovielens(_gen(), n_users=400, n_movies=60, rank=8, device="cpu")
    assert tuple(r.shape) == jr.shape and r.dtype == torch.float32
    obs = r[r > 0]
    assert 0.5 <= float(obs.min()) and float(obs.max()) <= 5.0
    # half-star levels, and the same observed density as the reference
    np.testing.assert_array_equal((obs * 2).numpy(), np.round(obs.numpy() * 2))
    dens, jdens = float((r > 0).float().mean()), float(jnp.mean(jr > 0))
    assert abs(dens - jdens) < 0.01 and abs(dens - 0.08) < 0.01


def test_dictlearn_configs_equal_reference():
    for name in ("SYNTH_HOMOGENEOUS", "SYNTH_HETEROGENEOUS", "MOVIELENS"):
        assert dataclasses.asdict(getattr(tcfg, name)) == \
            dataclasses.asdict(getattr(jcfg, name)), name
        assert getattr(tconfigs, name) is getattr(tcfg, name)
    assert "dictlearn" not in tconfigs.ARCH_IDS


def test_generators_default_to_the_gpu():
    """Without a device argument the data lands on the GPU, and with no GPU
    the call raises: the CPU only when asked for."""
    if torch.cuda.is_available():
        z = tmovielens(_gen(), n_users=8, n_movies=4, rank=2)
        assert z.device.type == "cuda"
        return
    for call in (lambda: tsyn.dictlearn_data(_gen(), 8, 4, 2),
                 lambda: tmovielens(_gen(), n_users=8, n_movies=4, rank=2),
                 lambda: tsyn.gmm_data(_gen(), 8, np.zeros((1, 2)),
                                       np.eye(2)[None], np.ones(1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

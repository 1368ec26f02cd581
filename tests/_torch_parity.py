"""Helpers shared by the parity tests of the PyTorch port: the reference's
per-leaf dither seeds as the port takes them, bitwise comparison, and the
interop conversions onto the CPU (the port's own default is the GPU)."""
import jax
import numpy as np
import torch

from repro.core import compression as JC
from repro_torch import interop


def folded_seed(key) -> int:
    """The reference's folded 32-bit seed of one leaf key, as an int."""
    return int(np.asarray(JC.fold_seed(key)).astype(np.int32).view(np.uint32))


def leaf_seeds(key, n_leaves: int) -> list:
    """The per-leaf seeds the reference's compressors derive from ``key``
    (``_tree_keyed_map`` splits it, ``fold_seed`` folds each part)."""
    return [folded_seed(k) for k in jax.random.split(key, n_leaves)]


def client_seeds(quant_keys, n_leaves: int) -> np.ndarray:
    """(n, n_leaves) seeds for the per-client keys of a driver round."""
    return np.array([leaf_seeds(k, n_leaves) for k in quant_keys],
                    dtype=np.int64)


def edge_seeds(k_round, n_edges: int, n_leaves: int = 1) -> np.ndarray:
    """(n_edges, n_leaves) tier-boundary seeds of a reference round (its
    private edge-key lane), as the port's ``step(edge_seeds=)`` takes
    them."""
    from repro.api.driver import _edge_keys
    return np.array([leaf_seeds(k, n_leaves)
                     for k in _edge_keys(k_round, n_edges)], dtype=np.int64)


def round_draws(key, jspec, n_leaves: int):
    """One round of the reference ``run``'s host key chain: returns the
    next key, the round key, the round's minibatch key, the participation
    mask and the (n, n_leaves) dither seeds."""
    from repro import api as japi
    key, k_round, k_batch = jax.random.split(key, 3)
    active, quant_keys = japi.participation_draw(k_round, jspec)
    return (key, k_round, k_batch, np.asarray(active),
            client_seeds(quant_keys, n_leaves))


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_close(a, b, rtol=1e-5, atol=1e-6, msg: str = "") -> None:
    """Leaf by leaf allclose of two pytrees (tensors or arrays); the
    default tolerance is ``tests/test_torch_driver.py``'s (rtol 1e-5,
    atol 1e-6)."""
    la = jax.tree.leaves(jax.tree.map(np_of, a))
    lb = jax.tree.leaves(jax.tree.map(np_of, b))
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=msg)


def assert_bits_equal(a, b, msg: str = "") -> None:
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, (a.shape, b.shape, msg)
    assert a.dtype.itemsize == b.dtype.itemsize, (a.dtype, b.dtype, msg)
    view = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
    np.testing.assert_array_equal(a.view(view[a.dtype.itemsize]),
                                  b.view(view[b.dtype.itemsize]),
                                  err_msg=msg)


def to_torch(tree):
    """``interop.to_torch`` onto the CPU."""
    return interop.to_torch(tree, device="cpu")


def state_to_torch(state):
    """``interop.state_to_torch`` onto the CPU."""
    return interop.state_to_torch(state, device="cpu")


TOP_K_GAP = 1e-5


def spy_reference_moe_gaps(monkeypatch) -> list:
    """Wraps the reference's ``moe_block`` so that every call (eager, or
    traced under ``jit``, ``lax.scan``, ``grad`` and ``vmap``) appends the
    least gap between a token's k-th and (k+1)-th router probability, on
    the reference's own probabilities, to the returned list. The top-k
    selection turns a difference of one ulp into another expert, so a
    parity test over an MoE asserts that every gap exceeds ``TOP_K_GAP``
    (``tests/test_torch_moe.py``)."""
    import jax.numpy as jnp
    from repro.models import moe as JMOE
    gaps = []
    orig = JMOE.moe_block

    def record(gap):
        gaps.append(float(np.min(np.asarray(gap))))

    def spy(params, cfg, x, *args, **kwargs):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], -1)
        top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
        jax.debug.callback(record, jnp.min(top[..., -2] - top[..., -1]))
        return orig(params, cfg, x, *args, **kwargs)

    monkeypatch.setattr(JMOE, "moe_block", spy)
    return gaps


def assert_gaps(gaps, n_calls: int = 1) -> None:
    """At least ``n_calls`` MoE calls were seen, each with its least top-k
    gap over ``TOP_K_GAP``."""
    assert len(gaps) >= n_calls, gaps
    assert min(gaps) > TOP_K_GAP, min(gaps)

"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX package's (``repro.models.moe``) on the CPU, float32, at qwen3's
and llama4's reduced configs (4 experts, top 2 and top 1).

The same weights (the reference's ``moe_init``) and the same numpy
inputs go through both: y and the balance loss, and the gradient of a
scalar of both with respect to x and every parameter against
``jax.grad``, at ``assert_tree_close``'s rtol 1e-5 / atol 1e-6. The
scalar is a loss's: a mean over the tokens, sum(y * r) / (B * S) + aux.
At sum(y * r) + aux the gradients reach 30, and both packages' float32
gradients are then further than that tolerance from a float64 run of the
port at a few elements of every weight.
Token counts that make the group size halve (S 24 and 40 under groups
of 16 give 8), a capacity that drops pairs, and the decode step's group
of one token.

The top-k selection turns a difference of one ulp in the router's
probabilities into another expert, and ties break by index in
``lax.top_k`` where ``torch.topk`` promises no order. So every input is
checked, on the reference's own probabilities, to leave a gap of over
1e-5 between each token's k-th and (k+1)-th probability: a flip cannot
hide as a tolerance miss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
from repro.models import moe as JMOE
import repro_torch.configs as TCFG
from repro_torch.models import moe as TMOE

from _torch_parity import assert_tree_close, np_of, to_torch

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
GAP = 1e-5
# (S, moe_group) -> the group the reference takes
GROUPS = [(16, 256), (16, 16), (16, 8), (24, 256), (24, 16), (24, 8),
          (40, 256), (40, 16), (40, 8)]


def _cfgs(arch, **kw):
    return (dataclasses.replace(JCFG.get(arch).reduced(), **kw),
            dataclasses.replace(TCFG.get(arch).reduced(), **kw))


def _weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, JMOE.moe_init(jax.random.PRNGKey(seed),
                                                  jcfg, jnp.float32))


def _inputs(jcfg, params, B, S, seed):
    """x (B, S, d) and r (B, S, d) from a seed; asserts the top-k gap on
    the reference's probabilities."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ params["router"], -1))
    top = -np.sort(-probs, axis=-1)
    k = jcfg.top_k
    gap = float((top[..., k - 1] - top[..., k]).min())
    assert gap > GAP, f"a token's k-th and (k+1)-th probabilities are " \
        f"{gap} apart"
    return x, r


def _both(jcfg, tcfg, params, x, r):
    """(y, aux, grads) of the reference and of the port; the grads of
    sum(y * r) / (B * S) + aux by x and by every parameter."""
    n_tokens = x.shape[0] * x.shape[1]

    def jloss(p, xx):
        y, aux = JMOE.moe_block(p, jcfg, xx)
        return jnp.sum(y * r) / n_tokens + aux, (y, aux)

    jp = jax.tree.map(jnp.asarray, params)
    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda a: to_torch(a).requires_grad_(), params)
    tx = torch.tensor(x, requires_grad=True)
    ty, taux = TMOE.moe_block(tp, tcfg, tx)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(
        (ty * torch.tensor(r)).sum() / n_tokens + taux, leaves + [tx])
    tg = (jax.tree.unflatten(jax.tree.structure(tp), list(grads[:-1])),
          grads[-1])
    return (jy, jaux, jg), (ty, taux, tg)


def _assert_match(j, t, msg):
    jy, jaux, jg = j
    ty, taux, tg = t
    assert tuple(ty.shape) == jy.shape
    assert_tree_close(ty, jy, msg=f"y {msg}")
    assert_tree_close(taux, jaux, msg=f"aux {msg}")
    assert_tree_close(tg, jg, msg=f"grads {msg}")


@pytest.mark.parametrize("S,group", GROUPS,
                         ids=[f"S{s}-group{g}" for s, g in GROUPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, S, group):
    jcfg, tcfg = _cfgs(arch, moe_group=group)
    params = _weights(jcfg)
    x, r = _inputs(jcfg, params, 2, S, seed=S + group)
    g = TMOE.group_size(S, group)
    assert S % g == 0 and g <= min(group, S)
    j, t = _both(jcfg, tcfg, params, x, r)
    _assert_match(j, t, f"{arch} S {S} group {group} (g {g})")


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch):
    """capacity_factor 0.5: pairs drop, a token whose choices all drop
    gives exactly 0, and the port still follows the reference (values
    and gradients)."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.5, moe_group=16)
    params = _weights(jcfg, seed=1)
    x, r = _inputs(jcfg, params, 2, 32, seed=7)
    j, t = _both(jcfg, tcfg, params, x, r)
    _assert_match(j, t, f"{arch} capacity 0.5")
    with torch.no_grad():
        _, _, _, _, pos, C = TMOE.route(to_torch(params), tcfg,
                                        torch.tensor(x))
    keep = np_of(pos < C).reshape(2 * 32, tcfg.top_k)
    assert not keep.all(), "no pair dropped"
    gone = ~keep.any(-1)
    assert gone.any(), "no token lost every choice"
    y = np_of(t[0]).reshape(2 * 32, -1)
    assert (y[gone] == 0.0).all()
    assert (np.abs(y[~gone]).max(-1) > 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_group_of_one(arch):
    """A (B, 1, d) token, as decode gives it: g = 1 and C = 1, so nothing
    drops, and the block matches the reference."""
    jcfg, tcfg = _cfgs(arch)
    params = _weights(jcfg, seed=2)
    x, r = _inputs(jcfg, params, 4, 1, seed=11)
    with torch.no_grad():
        g, _, _, _, pos, C = TMOE.route(to_torch(params), tcfg,
                                        torch.tensor(x))
    assert (g, C) == (1, 1) and bool((pos < C).all())
    j, t = _both(jcfg, tcfg, params, x, r)
    _assert_match(j, t, f"{arch} decode")


@pytest.mark.parametrize("capacity", [1.25, 0.5, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_scatter_dispatch_matches_dense_einsum(arch, capacity):
    """The scatter dispatch against the one-hot einsum form written
    densely (``moe_block_dense``, the plain check), values and gradients,
    and the pairs it counts in ``DISPATCH``."""
    _, tcfg = _cfgs(arch, capacity_factor=capacity, moe_group=16)
    gen = torch.Generator().manual_seed(3)
    params = TMOE.moe_init(gen, tcfg, torch.float32)
    x = torch.randn((2, 48, tcfg.d_model), generator=gen)
    r = torch.randn(x.shape, generator=gen)
    outs = []
    for fn in (TMOE.moe_block, TMOE.moe_block_dense):
        leaves = [t.clone().requires_grad_() for t in
                  jax.tree.leaves(params)] + [x.clone().requires_grad_()]
        p = jax.tree.unflatten(jax.tree.structure(params), leaves[:-1])
        TMOE.reset_dispatch()
        y, aux = fn(p, tcfg, leaves[-1])
        counted = dict(TMOE.DISPATCH)
        loss = (y * r).sum() / (2 * 48) + aux
        outs.append((y, aux, torch.autograd.grad(loss, leaves), counted))
    (y, aux, g, counted), (y2, aux2, g2, _) = outs
    torch.testing.assert_close(y, y2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux, aux2, rtol=1e-6, atol=0)
    for a, b in zip(g, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        *_, pos, C = TMOE.route(params, tcfg, x)
    assert counted == {"pairs": pos.numel(), "kept": int((pos < C).sum())}


def test_bfloat16_gates_rounded_as_the_reference():
    """A bf16 block: the gates are rounded to bf16 before the combine, as
    the reference casts its combine tensor; y within the reference's
    bf16 tolerance, the router's float32 weights kept float32."""
    arch = ARCHS[0]
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    params = jax.tree.map(np.asarray, JMOE.moe_init(
        jax.random.PRNGKey(4), jcfg, jnp.bfloat16))
    assert params["router"].dtype == np.float32
    assert params["experts"]["w_in"].dtype.name == "bfloat16"
    x32, _ = _inputs(jcfg, jax.tree.map(lambda a: a.astype(np.float32),
                                        params), 2, 16, seed=5)
    xb = jnp.asarray(x32, jnp.bfloat16)
    jy, jaux = JMOE.moe_block(jax.tree.map(jnp.asarray, params), jcfg, xb)
    tp = to_torch(params)
    assert tp["router"].dtype == torch.float32
    ty, taux = TMOE.moe_block(tp, tcfg, torch.tensor(x32).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(ty.float()),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

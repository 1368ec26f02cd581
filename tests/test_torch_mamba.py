"""The port's Mamba block (``repro_torch.models.mamba``) against the JAX
package's (``repro.models.mamba``) on the CPU, float32, at jamba's reduced
config (d 128, inner width 256, d_state 8, d_conv 4, dt_rank 8).

The reference's ``mamba_init`` weights and the same numpy inputs go
through both: y and both states (conv, ssm) of a full sequence at S 12,
13 (odd: the reference scans in chunks of 1), 24 and 32; a decode step
from the reference's state; prefill followed by decode steps against the
full sequence; the gradient of a mean scalar with respect to x and every
leaf against ``jax.grad``. Everything at ``assert_tree_close``'s rtol
1e-5 / atol 1e-6 except the gradients, at the reference's own float32
tolerance for its layers (rtol 1e-4 / atol 1e-5, ``tests/test_layers.py``):
they sum over every later step of the recurrence, in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
from repro.models import mamba as JM
import repro_torch.configs as TCFG
from repro_torch.models import mamba as TM

from _torch_parity import assert_tree_close, np_of, to_torch

ARCH = "jamba-1.5-large-398b"
B = 2
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_layers.py, float32


def _cfgs(**kw):
    return (dataclasses.replace(JCFG.get(ARCH).reduced(), **kw),
            dataclasses.replace(TCFG.get(ARCH).reduced(), **kw))


def _weights(jcfg, dtype=jnp.float32, seed=0):
    return jax.tree.map(np.asarray, JM.mamba_init(jax.random.PRNGKey(seed),
                                                  jcfg, dtype))


def _x(jcfg, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)


def _port(params):
    return jax.tree.map(to_torch, params)


def test_init_layout_matches_reference():
    """The port's tree has the reference's leaves, shapes and dtypes
    (``A_log`` float32 in a bf16 tree, ``dt_bias`` -4.6), so interop carries
    the weights across unchanged."""
    jcfg, tcfg = _cfgs()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = _weights(jcfg, jdt)
        got = TM.mamba_init(torch.Generator().manual_seed(0), tcfg, tdt)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            assert tuple(got[key].shape) == w.shape, key
            assert str(got[key].dtype).split(".")[1] == w.dtype.name, key
        assert got["A_log"].dtype == torch.float32
        # torch's and XLA's float32 log part in the last bit at some n
        np.testing.assert_allclose(np_of(got["A_log"]), want["A_log"],
                                   rtol=2.5e-7, atol=0)
        np.testing.assert_array_equal(np_of(got["dt_bias"].float()),
                                      want["dt_bias"].astype(np.float32))


@pytest.mark.parametrize("S", [12, 13, 24, 32])
def test_full_sequence_matches_reference(S):
    jcfg, tcfg = _cfgs()
    params = _weights(jcfg)
    x = _x(jcfg, S, seed=S)
    jy, jstate = JM.mamba_block(jax.tree.map(jnp.asarray, params), jcfg,
                                jnp.asarray(x))
    ty, tstate = TM.mamba_block(_port(params), tcfg, torch.tensor(x))
    assert tuple(ty.shape) == jy.shape
    assert tstate["ssm"].dtype == torch.float32
    assert tuple(tstate["conv"].shape) == (B, jcfg.d_conv - 1,
                                           jcfg.expand * jcfg.d_model)
    assert_tree_close(ty, jy, msg=f"y at S {S}")
    assert_tree_close(tstate, jstate, msg=f"state at S {S}")


def test_scan_chunk_changes_no_state_bit():
    """The port's chunk length changes no bit of the state (chunks of 1, 5
    and 64 at S 13), and y only by the rounding of its sum over n (the
    product with C is one batched product a chunk)."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(4)
    di, n, S = 256, tcfg.d_state, 13
    u = torch.tensor(rng.standard_normal((B, S, di)), dtype=torch.float32)
    dt = torch.tensor(rng.uniform(0.001, 0.1, (B, S, di)),
                      dtype=torch.float32)
    Bm, Cm = (torch.tensor(rng.standard_normal((B, S, n)),
                           dtype=torch.float32) for _ in range(2))
    A = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n)
    D = torch.ones(di)
    outs = [TM._ssm_scan(u, dt, Bm, Cm, A, D, chunk=c) for c in (1, 5, 64)]
    for y, h in outs[1:]:
        assert torch.equal(h, outs[0][1])
        assert_tree_close(y, outs[0][0])


def test_scan_counts_its_calls():
    _, tcfg = _cfgs()
    params = TM.mamba_init(torch.Generator().manual_seed(1), tcfg,
                           torch.float32)
    S = 2 * TM.CHUNK + 3
    TM.LAUNCHES["ssm_scan"] = 0
    TM.mamba_block(params, tcfg, torch.randn(B, S, tcfg.d_model))
    assert TM.LAUNCHES["ssm_scan"] == 3 * TM.CALLS_PER_CHUNK + S
    TM.LAUNCHES["ssm_scan"] = 0


def test_decode_step_from_reference_state():
    """One decode step from the reference's state after a 12-token
    prefix: output and both new states."""
    jcfg, tcfg = _cfgs()
    params = _weights(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(jcfg, 13, seed=5)
    _, jstate = JM.mamba_block(jp, jcfg, jnp.asarray(x[:, :12]))
    jy, jnew = JM.mamba_block(jp, jcfg, jnp.asarray(x[:, 12:]), state=jstate,
                              single_step=True)
    tstate = jax.tree.map(lambda a: to_torch(np.asarray(a)), jstate)
    ty, tnew = TM.mamba_block(_port(params), tcfg, torch.tensor(x[:, 12:]),
                              state=tstate, single_step=True)
    assert_tree_close(ty, jy, msg="y")
    assert_tree_close(tnew, jnew, msg="state")


@pytest.mark.parametrize("prefix", [1, 8, 13])
def test_prefill_then_steps_match_full_sequence(prefix):
    """Prefill ``prefix`` tokens, then decode step by step to 16: each
    step's output equals the full sequence's at that position (the
    port's against its own full sequence and against the reference's
    steps), and the last state the full sequence's."""
    jcfg, tcfg = _cfgs()
    params = _weights(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, params), _port(params)
    S = 16
    x = _x(jcfg, S, seed=prefix)
    ty_full, tstate_full = TM.mamba_block(tp, tcfg, torch.tensor(x))
    ty, tstate = TM.mamba_block(tp, tcfg, torch.tensor(x[:, :prefix]))
    jy, jstate = JM.mamba_block(jp, jcfg, jnp.asarray(x[:, :prefix]))
    assert_tree_close(ty, ty_full[:, :prefix], msg="prefix")
    for t in range(prefix, S):
        ty, tstate = TM.mamba_block(tp, tcfg, torch.tensor(x[:, t:t + 1]),
                                    state=tstate, single_step=True)
        jy, jstate = JM.mamba_block(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                    state=jstate, single_step=True)
        assert_tree_close(ty, ty_full[:, t:t + 1], msg=f"step {t}")
        assert_tree_close(ty, jy, msg=f"reference step {t}")
    assert_tree_close(tstate, tstate_full, msg="last state")
    assert_tree_close(tstate, jstate, msg="reference last state")


@pytest.mark.parametrize("S", [13, 24])
def test_gradients_match_reference(S):
    """d/d(x, every leaf) of mean(y * r) against ``jax.grad``."""
    jcfg, tcfg = _cfgs()
    params = _weights(jcfg)
    x = _x(jcfg, S, seed=S + 1)
    r = np.random.default_rng(S + 2).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = JM.mamba_block(p, jcfg, xx)
        return jnp.mean(y * r)

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(x))
    tp = jax.tree.map(lambda a: to_torch(a).requires_grad_(), params)
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = TM.mamba_block(tp, tcfg, tx)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad((ty * torch.tensor(r)).mean(), leaves + [tx])
    tg = (jax.tree.unflatten(jax.tree.structure(tp), list(grads[:-1])),
          grads[-1])
    assert_tree_close(tg, jg, msg=f"grads at S {S}", **GRAD_TOL)


def test_bfloat16_block_follows_reference_rounding():
    """bf16 weights and input: the conv state is the raw in_proj rows in
    bf16 bit for bit, the ssm state float32; y within the reference's
    bf16 tolerance (tests/test_kernels.py: 3e-2)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = _weights(jcfg, jnp.bfloat16)
    x = _x(jcfg, 12, seed=9)
    jx = jnp.asarray(x, jnp.bfloat16)
    jy, jstate = JM.mamba_block(jax.tree.map(jnp.asarray, params), jcfg, jx)
    ty, tstate = TM.mamba_block(_port(params), tcfg,
                                to_torch(np.asarray(jx)))
    assert ty.dtype == torch.bfloat16 and tstate["conv"].dtype == \
        torch.bfloat16 and tstate["ssm"].dtype == torch.float32
    np.testing.assert_allclose(np_of(ty.float()),
                               np.asarray(jy, np.float32), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(np_of(tstate["ssm"]),
                               np.asarray(jstate["ssm"]), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_array_equal(
        np_of(tstate["conv"].view(torch.int16)),
        np.asarray(jstate["conv"]).view(np.int16))

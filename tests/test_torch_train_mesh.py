"""The LM trainer's physical silos on a ``DeviceMesh`` (``fed/trainer.py``
with ``mesh=``), on the CPU over gloo, at gemma3-12b's reduced config
(2 layers, d 128, float32).

One rank in this process (a one-rank gloo process group for the module):
the mesh with ``uplink="gather"`` and ``"reduce"``, variates on and off,
against the reference's single-device trainer (``jax.jit`` of its
``make_train_step``, physical, no mesh) with its draws handed in, two free
rounds with the identity compressor at ``tests/test_torch_train.py``'s
trainer tolerance (rtol 1e-5 / atol 1e-6); the refusals.

Several ranks: ``tests/_torch_train_mesh_worker.py`` runs as 2 and as 4
processes (one job each, each with a hard timeout), with
``block_quant(8, 256, "hash")`` and p 0.5. Every round starts from the
one-rank run's state of that round (lockstep: a reduce re-associates the
float32 sum, and over 426,624 elements a drift that moves by an ulp can
cross a rounding edge and move its code a whole level in the next round).
Gather is bit-identical to one rank (iterate, variates, each rank's rows
of ``v_i``, metrics); reduce is within rtol 1e-5 / atol 1e-6 of one
rank's reduce, the tolerance ``tests/test_torch_mesh.py`` holds the
reduce uplink to.
"""
import dataclasses
import datetime
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro.configs as JC
from repro import api as japi
from repro.fed import trainer as JFT
from repro.models.model import build_model as j_build

from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.fed import trainer as TFT
from repro_torch.tree import tree_leaves, tree_map

import _torch_train_mesh_worker as W
from _torch_parity import assert_tree_close, client_seeds

HERE = Path(__file__).resolve().parent
JOB_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo process group in this process, for the module."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
    dist.destroy_process_group()


def _batches(t: int, vocab: int):
    toks = np.random.default_rng(20 + t).integers(
        0, vocab, (W.N_CLIENTS, W.B_LOCAL, W.SEQ + 1))
    j = {"tokens": jax.numpy.asarray(toks[..., :-1], jax.numpy.int32),
         "labels": jax.numpy.asarray(toks[..., 1:], jax.numpy.int32)}
    t_ = {"tokens": torch.tensor(toks[..., :-1]),
          "labels": torch.tensor(toks[..., 1:])}
    return j, t_


# ---------------------------------------------------------------------------
# one rank against the reference's single-device trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_cv", [True, False], ids=["variates", "off"])
@pytest.mark.parametrize("uplink", ["gather", "reduce"])
def test_one_rank_mesh_matches_reference_trainer(one_rank, uplink, use_cv):
    """Two free rounds on a one-rank mesh with the identity compressor and
    the reference's draws: iterate, variates and loss follow the
    reference's trainer without a mesh; the metrics carry the
    collective's operand bytes (the gathered stack of n clients' raw
    deltas, or the float32 partial: the same bytes in float32)."""
    jcfg = JC.get(W.ARCH).reduced()
    jm = j_build(jcfg)
    tm = W.model()
    kw = dict(n_clients=W.N_CLIENTS, rho=0.05, p=0.5, alpha=0.1,
              use_cv=use_cv, quant_bits=0, client_mode="physical")
    jf, tf = JFT.FedLMConfig(**kw), TFT.FedLMConfig(**kw)
    js = JFT.init_state(jm, jax.random.PRNGKey(0), jf)
    ts = interop.fedlm_state_to_torch(tm.cfg, jax.tree.map(np.asarray, js),
                                      device="cpu")
    ts = interop.fedlm_state_for_rank(ts, tf.federation_spec(), one_rank,
                                      device="cpu")
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    tstep = TFT.make_train_step(tm, tf, mesh=one_rank, uplink=uplink)
    n_leaves = len(tree_leaves(ts.s_hat))
    n_params = sum(x.numel() for x in tree_leaves(ts.s_hat))
    for t in range(2):
        k = jax.random.PRNGKey(60 + t)
        jb, tb = _batches(t, jcfg.vocab)
        js, jmet = jstep(js, jb, k, W.gamma(t))
        active, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, tmet = tstep(ts, tb, None, W.gamma(t), active=np.asarray(active),
                         seeds=client_seeds(qkeys, n_leaves))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
            1e-5 * abs(float(jmet["loss"])), t
        assert float(tmet["n_active"]) == float(jmet["n_active"])
        want = interop.fedlm_state_to_torch(
            tm.cfg, jax.tree.map(np.asarray, js), device="cpu")
        assert_tree_close(ts.s_hat, want.s_hat, msg=f"s_hat round {t}")
        assert_tree_close(ts.v, want.v, msg=f"v round {t}")
        assert_tree_close(ts.v_i, want.v_i, msg=f"v_i round {t}")
        per = W.N_CLIENTS if uplink == "gather" else 1
        assert float(tmet["collective_payload_bytes"]) == per * 4 * n_params


def test_trainer_refusals_match_reference(one_rank):
    """Logical clients on a mesh raise ``ValueError`` (the reference's
    ``api.step`` refuses ``"scan"`` on a mesh), as does the reduce uplink
    without a mesh, at the first step, in both packages."""
    tm = W.model()
    logical = dataclasses.replace(W.fed_config(True), client_mode="logical")
    with pytest.raises(ValueError, match="mesh"):
        TFT.make_train_step(tm, logical, mesh=one_rank)
    jcfg = JC.get(W.ARCH).reduced()
    jm = j_build(jcfg)
    jf = JFT.FedLMConfig(n_clients=W.N_CLIENTS, client_mode="physical")
    tf = TFT.FedLMConfig(n_clients=W.N_CLIENTS, client_mode="physical")
    jb, tb = _batches(0, jcfg.vocab)
    js = JFT.init_state(jm, jax.random.PRNGKey(0), jf)
    with pytest.raises(ValueError, match="mesh"):
        JFT.make_train_step(jm, jf, uplink="reduce")(
            js, jb, jax.random.PRNGKey(1), 0.5)
    ts = TFT.init_state(tm, torch.Generator().manual_seed(0), tf)
    with pytest.raises(ValueError, match="mesh"):
        TFT.make_train_step(tm, tf, uplink="reduce")(
            ts, tb, torch.Generator().manual_seed(1), 0.5)


# ---------------------------------------------------------------------------
# several ranks
# ---------------------------------------------------------------------------

def _inputs(tm) -> dict:
    """The rounds' batches and draws (participation and dither seeds from
    the port's own draw) and a start state."""
    spec = W.fed_config(True).federation_spec()
    gen = torch.Generator().manual_seed(11)
    state = TFT.init_state(tm, torch.Generator().manual_seed(0),
                           W.fed_config(True))
    n_leaves = len(tree_leaves(state.s_hat))
    batches, active, seeds = [], [], []
    for t in range(W.ROUNDS):
        batches.append(_batches(t, tm.cfg.vocab)[1])
        a, s = tapi.participation_draw(gen, spec, n_leaves)
        active.append(torch.as_tensor(a))
        seeds.append(torch.as_tensor(s))
    return {"batches": batches, "active": active, "seeds": seeds,
            "state0": state}


@pytest.fixture(scope="module")
def single(one_rank, tmp_path_factory):
    """Every case's free run on the one-rank mesh: the state each round
    starts from and each round's output; the inputs of the jobs."""
    tm = W.model()
    inp = _inputs(tm)
    state0 = inp.pop("state0")
    starts, outs = {}, {}
    for name, (uplink, use_cv) in W.CASES.items():
        fcfg = W.fed_config(use_cv)
        state = state0 if use_cv else state0._replace(v=(), v_i=())
        step = TFT.make_train_step(tm, fcfg, mesh=one_rank, uplink=uplink)
        starts[name], outs[name] = [], []
        for t in range(W.ROUNDS):
            starts[name].append(W.as_dict(state))
            out = W.lockstep(step, [W.as_dict(state)], inp,
                             fcfg.federation_spec(), one_rank, first=t)[0]
            outs[name].append(out)
            state = W.as_state(out["state"])
    io_dir = tmp_path_factory.mktemp("train_mesh")
    torch.save(dict(inp, starts=starts), io_dir / "inputs.pt")
    return {"outs": outs, "dir": io_dir}


@pytest.fixture(scope="module")
def jobs(single):
    """Start the 2- and 4-rank jobs together; wait for both. Returns
    ``{world: [out_0, out_1, ...]}``."""
    procs = {}
    for world in (2, 4):
        d = single["dir"] / f"w{world}"
        d.mkdir()
        (d / "inputs.pt").write_bytes((single["dir"] / "inputs.pt")
                                      .read_bytes())
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
        procs[world] = (d, [subprocess.Popen(
            [sys.executable, str(HERE / "_torch_train_mesh_worker.py"),
             str(r), str(world), str(port), str(d)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)])
    out = {}
    for world, (d, ps) in procs.items():
        logs = []
        for p in ps:
            try:
                logs.append(p.communicate(timeout=JOB_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
        assert all(p.returncode == 0 for p in ps), "\n".join(logs)[-4000:]
        out[world] = [torch.load(d / f"out_{r}.pt") for r in range(world)]
    return out


def _leaves_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("name", sorted(W.CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_one_rank(jobs, single, world, name):
    """Each round on 2 and 4 ranks against one rank: gather bit for bit
    (iterate, v, each rank's v_i rows, every metric), reduce within rtol
    1e-5 / atol 1e-6 (n_active and the bytes bit-equal)."""
    uplink, use_cv = W.CASES[name]
    for t in range(W.ROUNDS):
        want = single["outs"][name][t]
        ws, wm = want["state"], want["metrics"]
        for r, got in enumerate(jobs[world]):
            lo, hi = got["rows"]
            assert (lo, hi) == (r * W.N_CLIENTS // world,
                                (r + 1) * W.N_CLIENTS // world)
            gs, gm = got[name][t]["state"], got[name][t]["metrics"]
            rows = tree_map(lambda x: x[lo:hi], ws["v_i"])
            what = f"{name} world {world} rank {r} round {t}"
            if uplink == "gather":
                assert _leaves_equal(gs["s_hat"], ws["s_hat"]), what
                assert _leaves_equal(gs["v"], ws["v"]), what
                assert _leaves_equal(gs["v_i"], rows), what
                assert set(gm) == set(wm), what
                assert all(torch.equal(gm[k], wm[k]) for k in wm), what
            else:
                assert_tree_close(gs["s_hat"], ws["s_hat"], msg=what)
                assert_tree_close(gs["v"], ws["v"], msg=what)
                assert_tree_close(gs["v_i"], rows, msg=what)
                for k in ("n_active", "comm_bytes",
                          "collective_payload_bytes"):
                    assert torch.equal(gm[k], wm[k]), (what, k)
                assert_tree_close(gm["loss"], wm["loss"], msg=what)
            if use_cv:
                assert len(tree_leaves(gs["v_i"])) > 0

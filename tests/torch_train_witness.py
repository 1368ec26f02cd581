"""The entry point's training curve, the port against the JAX package on the
CPU, on the same tokens from the same weights: ``launch.train``'s smoke
preset (4 clients, a global batch of 8 rows of 128 tokens, 8-bit hash
dither, rho 0.05, gamma 0.5 / sqrt(1 + t), alpha 0.1), its batches drawn
by the port's ``token_stream`` from ``--seed`` and handed to both, the
reference's initial state (PRNGKey(0)) carried across, and the
reference's participation draws and dither seeds handed to the port.

It shows whether a per-step loss that does not fall over a run is the
batches' noise (both curves part from their first step alike) or the
port's trainer (the port's curve alone stays up). Each step's loss is the
clients' mean on that step's fresh batch, before the update. Too long for
the tier-1 tests (a few minutes for the three archs at 60 steps); run it
from the root of the repo:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_train_witness.py \\
        [--arch gemma3-12b] [--steps 60] [--seed 0] [--out witness.json]
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
from repro import api as japi
from repro.fed import trainer as JFT
from repro.models.model import build_model as j_build
import repro_torch.configs as TC
from repro_torch import interop
from repro_torch.fed import trainer as TFT
from repro_torch.launch.train import sample_batch
from repro_torch.models.model import build_model as t_build
from repro_torch.tree import tree_leaves

from _torch_parity import client_seeds

ARCHS = ("phi3-medium-14b", "gemma3-12b", "rwkv6-3b")
N_CLIENTS, B_LOCAL, SEQ = 4, 2, 128


def curves(arch: str, steps: int, seed: int) -> dict:
    jcfg, tcfg = JC.get(arch).reduced(), TC.get(arch).reduced()
    jm, tm = j_build(jcfg), t_build(tcfg, device="cpu")
    kw = dict(n_clients=N_CLIENTS, rho=0.05, p=1.0, alpha=0.1, quant_bits=8,
              client_mode="logical")
    jf, tf = JFT.FedLMConfig(**kw), TFT.FedLMConfig(**kw)
    js = JFT.init_state(jm, jax.random.PRNGKey(0), jf)
    ts = interop.fedlm_state_to_torch(tcfg, jax.tree.map(np.asarray, js),
                                      device="cpu")
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    tstep = TFT.make_train_step(tm, tf)
    n_leaves = len(tree_leaves(ts.s_hat))
    data_gen = torch.Generator().manual_seed(seed)
    key = jax.random.PRNGKey(seed + 1)
    ref, port = [], []
    for t in range(steps):
        gamma = 0.5 / (1.0 + t) ** 0.5
        tb = sample_batch(data_gen, tcfg, N_CLIENTS, B_LOCAL, SEQ, "cpu")
        jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in tb.items()}
        key, k = jax.random.split(key)
        js, jmet = jstep(js, jb, k, gamma)
        active, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, tmet = tstep(ts, tb, None, gamma, active=np.asarray(active),
                         seeds=client_seeds(qkeys, n_leaves))
        ref.append(float(jmet["loss"]))
        port.append(float(tmet["loss"]))

    def summary(c):
        k = max(1, len(c) // 6)
        return {"first": c[0], "last": c[-1], "last_below_first":
                c[-1] < c[0], f"mean_first_{k}": float(np.mean(c[:k])),
                f"mean_last_{k}": float(np.mean(c[-k:])),
                "step_std": float(np.std(np.diff(c)) / np.sqrt(2))}

    return {"arch": arch, "steps": steps, "seed": seed,
            "reference": summary(ref), "port": summary(port),
            "max_abs_loss_gap": max(abs(a - b) for a, b in zip(ref, port)),
            "loss_reference": ref, "loss_port": port}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = []
    for arch in args.arch or ARCHS:
        rec = curves(arch, args.steps, args.seed)
        short = {k: v for k, v in rec.items() if not k.startswith("loss_")}
        print(json.dumps(short), flush=True)
        out.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

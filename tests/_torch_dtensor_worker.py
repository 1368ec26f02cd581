"""One rank of ``tests/test_torch_dtensor.py``'s gloo job: the models'
``DTensor`` path on data.

    python tests/_torch_dtensor_worker.py RANK WORLD PORT OUT_DIR

Every rank builds the same reduced model of each family from the same
seed and runs, first on plain tensors with no rules installed, then with
the production rules installed on a (2, WORLD / 2) ``("data", "model")``
mesh, its parameters laid out by ``placements(param_specs(...))`` and
its batch over ``"data"``: ``prefill`` (logits and caches), one
``decode`` step from those caches, and ``loss_fn`` with its gradient.
Rank 0 writes, for each family and quantity (the caches after prefill
and after the decode step's write), the largest difference of
the ``DTensor`` result (gathered) from the plain one and the largest
magnitude of the plain one to ``OUT_DIR/out.json``. No JAX.
"""
import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as S
from repro_torch.models.layers import params_tree
from repro_torch.models.model import build_model, make_batch
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

# one architecture of each family whose layers the DTensor branches serve,
# with overrides of its reduced config: gemma3's sliding-window layers make
# the ring cache; at 3 query heads over 'model' of 2 the head split and
# merge gather first
ARCHS = {"dense": ("phi3-medium-14b", {}), "swa": ("gemma3-12b", {}),
         "heads3": ("gemma3-12b", {"n_heads": 3, "n_kv_heads": 1}),
         "moe": ("qwen3-moe-235b-a22b", {}),
         "hybrid": ("jamba-1.5-large-398b", {}), "rwkv": ("rwkv6-3b", {})}
BATCH, SEQ = 4, 32


def _laid_out(tree, specs, mesh, grad=False):
    """``tree``'s leaves as ``DTensor``s laid out by ``specs`` (every rank
    holds the same values)."""
    from torch.distributed.tensor import distribute_tensor
    leaves, treedef = tree_flatten(tree)
    slist, _ = tree_flatten(specs, is_leaf=S.is_spec)
    out = []
    for x, spec in zip(leaves, slist):
        d = distribute_tensor(x.detach(), mesh, S.placements(
            D._fit(spec, x.shape, mesh), mesh), src_data_rank=None)
        out.append(d.requires_grad_() if grad else d)
    return tree_unflatten(treedef, out)


def _whole(t):
    return t.full_tensor() if S.is_dtensor(t) else t


def _gap(got, want) -> list:
    """[max |got - want|, max |want|] over the leaves."""
    err, scale = 0.0, 0.0
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        g, w = _whole(g).double(), w.double()
        assert g.shape == w.shape, (g.shape, w.shape)
        err = max(err, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
    return [err, scale]


def run(arch, overrides, mesh) -> dict:
    cfg = dataclasses.replace(C.get(arch).reduced(), **overrides)
    model = build_model(cfg, device="cpu")
    params = params_tree(model.init(torch.Generator().manual_seed(0)))
    batch = make_batch(torch.Generator().manual_seed(1), cfg, BATCH, SEQ)
    token = batch["tokens"][:, :1]

    def serve(p, b, tok):
        logits, caches = model.prefill(p, b)
        kept = tree_map(torch.clone, caches)
        next_logits, caches = model.decode(p, caches, tok, SEQ)
        return {"prefill": logits, "caches": kept, "decode": next_logits,
                "decoded_caches": caches}

    def train(p, b):
        leaves, treedef = tree_flatten(p)
        loss = model.loss_fn(tree_unflatten(treedef, leaves), b)
        grads = torch.autograd.grad(loss, leaves)
        return {"loss": loss.detach(), "grad": list(grads)}

    leaves, treedef = tree_flatten(params)
    want = {**serve(params, batch, token), **train(tree_unflatten(
        treedef, [x.detach().requires_grad_() for x in leaves]), batch)}
    S.install_rules(M.axis_rules(False))
    try:
        specs = S.param_specs(params, fsdp=("data",), fsdp_size=2,
                              tp_size=mesh.size(1))
        bspec = {k: ("data",) + (None,) * (v.ndim - 1)
                 for k, v in batch.items()}
        # prefill and decode run under inference_mode, which takes no view
        # of a DTensor made outside it
        with torch.inference_mode():
            got = serve(_laid_out(params, specs, mesh),
                        _laid_out(batch, bspec, mesh),
                        _laid_out(token, ("data", None), mesh))
        got.update(train(_laid_out(params, specs, mesh, grad=True),
                         _laid_out(batch, bspec, mesh)))
    finally:
        S.install_rules(None)
    sharded = any(not all(pl.is_replicate() for pl in x.placements)
                  for x in tree_flatten(got["grad"])[0])
    return {**{key: _gap(got[key], want[key]) for key in want},
            "grad_sharded": sharded}


def main(rank: int, world: int, port: int, out_dir: Path) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    out = {family: run(arch, overrides, mesh)
           for family, (arch, overrides) in ARCHS.items()}
    out["jax_imported"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "repro" or m.startswith("repro."))
    if rank == 0:
        (out_dir / "out.json").write_text(json.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         Path(sys.argv[4]))

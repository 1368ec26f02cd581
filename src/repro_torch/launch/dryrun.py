"""The dry run on the production mesh (the counterpart of
``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) combination, run the real
step of the port (the FedMM train step for ``train_4k``, ``prefill`` and
``decode`` for the serving shapes) on shape-only stand-ins laid out on
the production mesh, and record per device:

  * the flops, collective bytes by kind and the peak of live bytes
    (``roofline.count_step``: the counters' own, in place of XLA's
    ``cost_analysis``/``memory_analysis``);
  * the bytes of the step's arguments and outputs (local shards);
  * the roofline's three terms at the H100's peaks (``roofline``), the
    memory term from ``analytic_bytes``, as the reference takes it.

No device is touched. The process group is torch's ``"fake"`` backend
(``FakeStore``) of 256 or 512 ranks, which answers every collective
without moving data; this process is rank 0. Parameters, optimizer
state, caches and batches are ``meta`` ``DTensor``s laid out by
``sharding.placements`` of ``param_specs``/``state_specs``/
``cache_specs``/``input_specs``; ``DTensor``'s sharding propagation then
plays the part of XLA's partitioner, and the models' ``shard`` call
sites are the reference's activation constraints. A spec entry whose mesh
dims do not divide its tensor dim is replicated (``DTensor`` would shard
it unevenly). The sequence kernels take their ``meta`` route: the peak
counts their outputs, never the plain versions' S x S scores, and the
flops are the kernels' formulas. The quantizers keep their plain path
on ``meta``: a train step's peak counts their int64 dither temporaries,
which their kernels never make.

The train step. The reference lets ``jit`` partition the whole step from
its input shardings. The port runs its own trainer's step
(``make_train_step`` without a mesh: ``api.step`` with the LM clients on
the driver's ``client_mode="scan"``, one after another) on ``DTensor``
state, the route its trainer takes off a mesh (``make_train_step(mesh=)``
keeps the silos' blocks as local tensors, with no layout inside a
silo). Clients that run in sequence are laid out as the reference lays
out its logical clients (``state_specs``/``batch_spec`` with
``client_mode="logical"``: Shat, V and each client's V_i row over
(fsdp, tp), each client's batch over the client axes), whatever
``choose_client_layout`` picks, which the record still names. A round
then asks, per client: the all-gathers of each layer's weights over
the client axes and of activations over 'model' (forward, rematerialised
forward and backward), the all-reduces and reduce-scatters of the
gradients to the iterate's layout, and the uplink's per-leaf work on each
rank's block (the shard-safe groups lie in one block); the server's
update is elementwise on the sharded leaves. Every client does the same
work, so the step is counted at one and at two clients and the counts at
n are the line through them (exact for flops and collectives; the peak
grows by one client's rows of V_i and of the new V_i). ``client_mode=
"scan"`` on a mesh raises, as the reference's does.

Left out of the record: the reference's ``hlo_traffic_proxy_bytes``, a
sum over XLA's fusion boundaries. PyTorch runs no fusion here, and the
sum of every local operation's operand and result bytes would charge
each elementwise pass separately, so it would not be the same quantity.
``counted`` holds what the counters read (the reference's
``xla_cost_analysis``).

``count_serve`` and ``count_train_step`` count one step, on the mesh or,
without one, on plain ``meta`` tensors at one chip (``chip_smoke.py``'s
``roofline`` line counts its timed phases so). ``client_line`` and
``depth_line`` give the points a step is counted at and their weights:
the clients, and for shallow stand-ins of a deep model the layers, each
doing the same work. ``compile_one`` counts every layer at full depth.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-medium-14b \\
      --shape train_4k [--multi-pod] [--out results/torch_base_<name>.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--archs a,b] --out results/torch_base_all.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
import time
import traceback

import torch
import torch.distributed as dist

from .. import configs as C
from ..configs.base import INPUT_SHAPES
from ..fed import trainer as FT
from ..models import layers as L
from ..models import sharding as shd
from ..models import transformer as T
from ..models.model import FRONTEND_KEYS, build_model
from ..tree import tree_flatten, tree_map, tree_unflatten
from . import mesh as M
from .roofline import (analytic_bytes, count_step, model_flops_estimate,
                       roofline_terms)

# the clients the train step is counted at (the counts at n are the line
# through these two)
COUNTED_CLIENTS = (1, 2)
# what the collective counts are, in every record and under the table
COLLECTIVE_NOTE = ("the collective bytes of DTensor's layout chosen op by "
                   "op, not of a layout planned for the whole step "
                   "(ROADMAP Queue C item 9)")


# ---------------------------------------------------------------------------
# the fake process group and the mesh
# ---------------------------------------------------------------------------

def start_fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks (this process rank 0)
    unless one that large is running; a smaller fake one is replaced."""
    if dist.is_initialized():
        # repro: allow[RPL001] the dry run's fake group is the whole world
        running = dist.get_world_size()
        if running >= world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group of "
                               f"{running} ranks is running; "
                               f"the dry run needs {world}")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(multi_pod: bool):
    start_fake_group(512 if multi_pod else 256)
    return M.make_production_mesh(multi_pod=multi_pod, device="cpu")


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def _layout(mesh, multi_pod: bool):
    """(client axes, their rank count) of ``mesh``; ``((), 1)`` without
    one."""
    if mesh is None:
        return (), 1
    axes = M.client_axes(multi_pod)
    return axes, math.prod(_sizes(mesh)[a] for a in axes)


def _fit(spec, shape, mesh) -> tuple:
    """``spec`` with every entry whose mesh dims do not divide its tensor
    dim replaced by None."""
    sizes = _sizes(mesh)
    out = []
    for size, e in zip(shape, shd.canonical(spec)):
        names = () if e is None else (e,) if isinstance(e, str) else e
        n = math.prod(sizes[a] for a in names)
        out.append(e if e is None or size % n == 0 else None)
    return tuple(out)


def meta_dtensor(shape, dtype, mesh, spec):
    """A ``meta`` ``DTensor`` of global ``shape`` laid out by ``spec``; a
    plain ``meta`` tensor without a mesh."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    if mesh is None:
        return t
    return distribute_tensor(
        t, mesh, shd.placements(_fit(spec, shape, mesh), mesh),
        src_data_rank=None)


def _distribute(tree, specs, mesh, lead=()):
    leaves, treedef = tree_flatten(tree)
    slist, _ = tree_flatten(specs, is_leaf=shd.is_spec)
    return tree_unflatten(treedef, [
        meta_dtensor(tuple(lead) + tuple(x.shape), x.dtype, mesh, s)
        for x, s in zip(leaves, slist)])


def _local_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    total = 0
    for t in leaves:
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


# ---------------------------------------------------------------------------
# stand-ins
# ---------------------------------------------------------------------------

def meta_params(cfg, pattern=None) -> dict:
    """The tree of ``build_model(cfg, pattern=pattern).init(gen)`` on
    ``meta`` tensors: each layer kind initialised once under
    ``FakeTensorMode`` and its shapes repeated for every layer of the kind
    (faking an MoE layer's experts takes seconds; a stack of 94 would take
    minutes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    pattern = T.layer_pattern(cfg) if pattern is None else list(pattern)
    enc = (["enc_mlp"] * cfg.n_encoder_layers if cfg.family == "audio"
           else [])
    with FakeTensorMode():
        gen = torch.Generator()
        one = {k: T.layer_init(k, gen, cfg, dtype)
               for k in dict.fromkeys(pattern + enc)}
        emb = L.embedding_init(gen, cfg, dtype)

    def meta(tree):
        return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                              device="meta"), tree)

    def norm():
        return {"scale": torch.empty((cfg.d_model,), dtype=dtype,
                                     device="meta")}

    out = {"embedding": meta(emb), "layers": [meta(one[k]) for k in pattern],
           "final_norm": norm()}
    if enc:
        out["encoder"] = [meta(one[k]) for k in enc]
        out["enc_norm"] = norm()
    return out


def _client_batches(cfg, mesh, bspec, n: int, b_local: int, S: int) -> dict:
    """``n`` clients' batches of ``b_local`` sequences, laid out by
    ``bspec``."""
    out = {name: meta_dtensor((n, b_local, S), torch.int64, mesh, bspec)
           for name in ("tokens", "labels")}
    key = FRONTEND_KEYS.get(cfg.family)
    if key:
        out[key] = meta_dtensor((n, b_local, cfg.n_frontend_tokens,
                                 cfg.d_model), torch.float32, mesh,
                                tuple(bspec) + (None,))
    return out


def input_specs(cfg, shape, mesh, fed_cfg=None, n_clients=None) -> dict:
    """``meta`` ``DTensor`` stand-ins for every model input of this shape.
    Training inputs carry the leading client dim (the FedMM batch
    contract), laid out by ``trainer.batch_spec(fed_cfg)``."""
    multi = mesh is not None and "pod" in mesh.mesh_dim_names
    batch_axes, _ = _layout(mesh, multi)
    GB, S = shape.global_batch, shape.seq_len
    key = FRONTEND_KEYS.get(cfg.family)
    if shape.kind == "train":
        return _client_batches(cfg, mesh, FT.batch_spec(fed_cfg, batch_axes),
                               n_clients, GB // n_clients, S)
    bspec = (batch_axes, None)
    out = {name: meta_dtensor((GB, S), torch.int64, mesh, bspec)
           for name in ("tokens", "labels")}
    if key:
        out[key] = meta_dtensor((GB, cfg.n_frontend_tokens, cfg.d_model),
                                torch.float32, mesh,
                                (batch_axes, None, None))
    return out


# ---------------------------------------------------------------------------
# one combination
# ---------------------------------------------------------------------------

def _where(tb) -> str:
    """The innermost frame of the port in a traceback: "file:line"."""
    site = "?"
    for frame in traceback.extract_tb(tb):
        if "repro_torch" in frame.filename:
            path = frame.filename[frame.filename.index("repro_torch"):]
            site = f"src/{path}:{frame.lineno}"
    return site


def _op(message: str) -> str:
    m = re.search(r"\b(aten\.[\w.]+|_c10d_functional\.\w+|repro_torch\.\w+)",
                  message)
    return m.group(1) if m else "?"


def affine(terms) -> dict:
    """The counts ``sum(w * c)`` over ``terms``, (weight, counts) pairs
    whose weights sum to one: the counts at a point on the line through
    the counted ones (``client_line``, ``depth_line``). A peak of None
    (not tracked) stays None."""
    kinds = sorted(set().union(*(c["by_kind"] for _, c in terms)))

    def at(get):
        vals = [get(c) for _, c in terms]
        if any(v is None for v in vals):
            return None
        return sum(w * v for (w, _), v in zip(terms, vals))

    by_kind = {k: at(lambda c: c["by_kind"].get(k, 0.0)) for k in kinds}
    peak = at(lambda c: c["peak_bytes"])
    return {
        "flops": at(lambda c: c["flops"]),
        "collective_bytes": sum(by_kind.values()),
        "by_kind": by_kind,
        "counts": {k: int(round(at(lambda c: c["counts"].get(k, 0))))
                   for k in kinds},
        "peak_bytes": None if peak is None else int(peak),
        "output_bytes": int(at(lambda c: c["output_bytes"]))}


def client_line(n: int) -> list:
    """(weight, clients) pairs: a train step of ``n`` clients on the line
    through its counts at ``COUNTED_CLIENTS`` (every client does the same
    work, one after another), or counted at ``n`` itself where it is one
    of them."""
    if n in COUNTED_CLIENTS:
        return [(1.0, n)]
    n1, n2 = COUNTED_CLIENTS
    t = (n - n1) / (n2 - n1)
    return [(1 - t, n1), (t, n2)]


def count_train_step(cfg, fed_cfg, shape, mesh=None, *, model=None,
                     params=None, pattern=None, peak: bool = True):
    """The FedMM train step of ``fed_cfg.n_clients`` clients, each with
    ``shape.global_batch // n_clients`` sequences of ``shape.seq_len``,
    counted (``count_step``) on its ``client_line``: ``(counts, argument
    bytes at n_clients)``. ``mesh``: the production mesh, the state and
    batches laid out there as logical clients (the module docstring);
    None: plain ``meta`` tensors at one chip. ``pattern``: the layer kinds
    (``depth_line``)."""
    model = model or build_model(cfg, device="meta", pattern=pattern)
    params = params or meta_params(cfg, pattern)
    multi = mesh is not None and "pod" in mesh.mesh_dim_names
    batch_axes, fsdp_size = _layout(mesh, multi)
    layout = dataclasses.replace(fed_cfg, client_mode="logical")
    sspec, vspec, vispec = FT.state_specs(params, layout, fsdp=batch_axes,
                                          fsdp_size=fsdp_size)
    b_local = shape.global_batch // fed_cfg.n_clients
    bspec = FT.batch_spec(layout, batch_axes)

    def args_at(n):
        """The step's arguments for ``n`` of the clients."""
        cfg_n = dataclasses.replace(fed_cfg, n_clients=n)
        use_cv = cfg_n.federation_spec().use_variates
        state = FT.FedLMState(
            s_hat=_distribute(params, sspec, mesh),
            v=_distribute(params, vspec, mesh) if use_cv else (),
            v_i=_distribute(params, vispec, mesh, (n,)) if use_cv else (),
            step=torch.zeros((), dtype=torch.int64))
        batch = _client_batches(cfg, mesh, bspec, n, b_local, shape.seq_len)
        return cfg_n, state, batch

    def counted(n):
        cfg_n, state, batch = args_at(n)
        out, c = count_step(FT.make_train_step(model, cfg_n), state, batch,
                            torch.Generator().manual_seed(0), 0.1, peak=peak,
                            external=tree_flatten((state, batch))[0])
        c["output_bytes"] = _local_bytes(out[0])
        return c

    counts = affine([(w, counted(n))
                     for w, n in client_line(fed_cfg.n_clients)])
    _, state, batch = args_at(fed_cfg.n_clients)
    return counts, _local_bytes((state, batch))


def count_serve(cfg, shape, mesh=None, *, model=None, params=None,
                pattern=None, variant=None, peak: bool = True):
    """``prefill`` (a ``"prefill"`` shape) or one ``decode`` step counted
    (``count_step``): ``(counts, argument bytes)``. ``mesh``: the
    production mesh, parameters, caches and batch laid out by their specs
    there; None: plain ``meta`` tensors at one chip. ``pattern``: the
    layer kinds (``depth_line``)."""
    variant = variant or {}
    model = model or build_model(cfg, device="meta", pattern=pattern)
    params = params or meta_params(cfg, pattern)
    multi = mesh is not None and "pod" in mesh.mesh_dim_names
    batch_axes, fsdp_size = _layout(mesh, multi)
    attn_mode = variant.get("attn_mode", "sharded")
    mlp_mode = variant.get("mlp_mode", "generic")
    # prefill and decode run under inference_mode, which cannot take views
    # of a DTensor made outside it: their arguments are made there (decode
    # writes its slot into the caches in place)
    with torch.inference_mode():
        if shape.kind == "prefill":
            pspec = shd.param_specs(params, fsdp=batch_axes,
                                    fsdp_size=fsdp_size, attn_mode=attn_mode,
                                    mlp_mode=mlp_mode)
            args = (_distribute(params, pspec, mesh),
                    input_specs(cfg, shape, mesh))
        else:
            # fsdp_off: TP-resident weights for serving, no per-token
            # gathers over the client axes, at P_bytes / 16 a device
            off = variant.get("fsdp_off", False)
            pspec = shd.param_specs(params, fsdp=() if off else batch_axes,
                                    fsdp_size=10 ** 9 if off else fsdp_size,
                                    attn_mode=attn_mode, mlp_mode=mlp_mode)
            caches = model.init_cache(shape.global_batch, shape.seq_len)
            cspec = shd.cache_specs(caches, batch_axes, batch_size=fsdp_size)
            tok = meta_dtensor((shape.global_batch, 1), torch.int64, mesh,
                               (batch_axes, None))
            args = (_distribute(params, pspec, mesh),
                    _distribute(caches, cspec, mesh), tok, shape.seq_len - 1)
    fn = model.prefill if shape.kind == "prefill" else model.decode
    out, counts = count_step(fn, *args, peak=peak,
                             external=tree_flatten(args[:3])[0])
    counts["output_bytes"] = _local_bytes(out)
    return counts, _local_bytes(args[:3])


def depth_line(cfg) -> list:
    """(weight, cfg', pattern) triples: a model of ``cfg``'s layers on the
    line through two shallow models of the same layer kinds (``pattern``;
    ``cfg'`` its depth). ``cfg``'s layers are g times a block (n_k = g b_k
    layers of each kind k, g the greatest common divisor of the n_k); the
    counts at one block (b_k of each kind) and at two (2 b_k) give the
    counts at g. Every layer of a kind does the same work wherever it
    stands, so flops and collectives are exact there (a peak is not: take
    it from a full-depth count). Audio's encoder layers are the kind
    ``"enc_mlp"``. A model of one block (g = 1) is itself."""
    pattern = T.layer_pattern(cfg)
    n = {k: pattern.count(k) for k in dict.fromkeys(pattern)}
    if cfg.family == "audio":
        n["enc_mlp"] = cfg.n_encoder_layers
    g = math.gcd(*n.values())
    if g == 1:
        return [(1.0, cfg, pattern)]

    def blocks(m):
        kinds = [k for k in n if k != "enc_mlp" for _ in range(m * n[k] // g)]
        return dataclasses.replace(
            cfg, n_layers=len(kinds),
            n_encoder_layers=m * n.get("enc_mlp", 0) // g), kinds

    return [(2.0 - g, *blocks(1)), (g - 1.0, *blocks(2))]


def compile_one(arch_id: str, shape_name: str, multi_pod: bool,
                overrides=None, variant=None):
    """Run and count one combination; returns its record.

    ``variant`` (the reference's levers):
      kv_dtype="int8"        quantized KV cache (decode shapes)
      attn_mode="replicated" attention weights replicated over 'model'
      use_cv=False           drop control variates (alpha=0 regime)
      quant_bits=<n>         FedMM uplink quantization width (0 = off)
      n_clients=<n>          override the client layout
      moe_group=<g>          the MoE's token group
      fsdp_off=True          decode weights not sharded over the client axes
      mlp_mode="megatron"    row-parallel w_out/wo
    """
    variant = variant or {}
    cfg = C.get(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if "kv_dtype" in variant:
        cfg = dataclasses.replace(cfg, kv_dtype=variant["kv_dtype"])
    if "moe_group" in variant:
        cfg = dataclasses.replace(cfg, moe_group=variant["moe_group"])
    shape = INPUT_SHAPES[shape_name]
    head = {"arch": arch_id, "shape": shape_name, "multi_pod": multi_pod}

    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return {**head, "status": "skipped",
                "reason": "full-attention arch; long_500k requires "
                          "sub-quadratic attention (DESIGN.md §4)"}

    mesh = production_mesh(multi_pod)
    sizes = _sizes(mesh)
    _, fsdp_size = _layout(mesh, multi_pod)
    n_chips = math.prod(sizes.values())
    attn_mode = variant.get("attn_mode", "sharded")
    mlp_mode = variant.get("mlp_mode", "generic")
    shd.install_rules(M.axis_rules(multi_pod))
    try:
        model = build_model(cfg, device="meta")
        params = meta_params(cfg)
        n_params = sum(t.numel() for t in tree_flatten(params)[0])
        extra = {}
        if shape.kind == "train":
            n_clients, mode = FT.choose_client_layout(n_params, multi_pod)
            n_clients = variant.get("n_clients", n_clients)
            use_cv = variant.get("use_cv", True)
            fed_cfg = FT.FedLMConfig(
                n_clients=n_clients, client_mode=mode, use_cv=use_cv,
                alpha=0.1 if use_cv else 0.0,
                quant_bits=variant.get("quant_bits", 8),
                attn_mode=attn_mode, mlp_mode=mlp_mode)
            acct, arg_bytes = count_train_step(cfg, fed_cfg, shape, mesh,
                                               model=model, params=params)
            extra = {"n_clients": n_clients, "client_mode": mode,
                     "train_route": "scan",
                     "counted_clients": list(COUNTED_CLIENTS)}
        else:
            acct, arg_bytes = count_serve(cfg, shape, mesh, model=model,
                                          params=params, variant=variant)
        flops_dev = acct["flops"]
        bytes_dev = analytic_bytes(
            cfg, shape, n_params, n_clients=extra.get("n_clients", 1),
            client_mode=extra.get("client_mode", "physical"),
            dp=fsdp_size, tp=sizes["model"], n_chips=n_chips)
        terms = roofline_terms(flops_dev, bytes_dev,
                               acct["collective_bytes"], n_chips=n_chips)
        mf = model_flops_estimate(cfg, shape, n_params)
        return {
            **head, "status": "ok", "n_params": n_params,
            "n_chips": n_chips, "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "collective_bytes_per_device": acct["collective_bytes"],
            "collectives": acct["by_kind"],
            "collective_counts": acct["counts"],
            "collective_note": COLLECTIVE_NOTE,
            "counted": {"flops": flops_dev,
                        "peak_bytes": acct["peak_bytes"]},
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": acct["output_bytes"],
                       "peak_bytes": acct["peak_bytes"]},
            "roofline": terms, "model_flops": mf,
            "useful_flops_ratio": (mf / (flops_dev * n_chips)
                                   if flops_dev else None),
            **extra}
    except (ValueError, TypeError, NotImplementedError, RuntimeError) as e:
        # a layout or an operator the sharding propagation cannot take: a
        # result of the sweep. Anything else (an AssertionError inside
        # DTensor, our own KeyError/AttributeError) propagates
        msg = f"{type(e).__name__}: {e}"
        return {**head, "status": "error", "error": msg[:2000],
                "op": _op(msg), "where": _where(e.__traceback__),
                "traceback": traceback.format_exc()[-2000:]}
    finally:
        shd.install_rules(None)


def summary(r: dict) -> str:
    """The one-line summary of a record."""
    brief = (f"{r['arch']:28s} {r['shape']:12s} "
             f"pod={2 if r['multi_pod'] else 1} {r['status']}")
    if r["status"] == "ok":
        t = r["roofline"]
        brief += (f"  peak={r['memory']['peak_bytes'] / 2**30:.2f}GiB "
                  f"compute={t['compute_s']:.4f}s "
                  f"hbm={t['memory_s']:.4f}s "
                  f"coll={t['collective_s']:.4f}s -> {t['dominant']}")
    elif r["status"] == "error":
        brief += f"  {r['op']} at {r['where']}: {r['error'][:120]}"
    return brief


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on this mesh")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch subset (with --all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    start_fake_group(512 if args.multi_pod else 256)
    archs = args.archs.split(",") if args.archs else C.ARCH_IDS
    combos = ([(a, s) for a in archs for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    results = []
    for arch, shape in combos:
        t0 = time.perf_counter()
        r = compile_one(arch, shape, args.multi_pod)
        r["seconds"] = time.perf_counter() - t0
        results.append(r)
        print(summary(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    dist.destroy_process_group()
    bad = [r for r in results if r["status"] == "error"]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()

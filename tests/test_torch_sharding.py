"""The sharding rules (``models/sharding.py``), the production mesh's rules
(``launch/mesh.py``) and the trainer's ``state_specs``/``batch_spec``
against the reference, on shapes alone.

The reference's trees come from ``jax.eval_shape`` of its ``init`` and
``init_cache``; the port's from ``init`` under ``FakeTensorMode`` (as
``fed.trainer.param_count``) and ``init_cache`` likewise: nothing is drawn
or allocated. Every config is at full width. The port's parameter trees
are cut to two cycles of the layer pattern (a prefix of the full pattern;
qwen3-moe's 94 layers of 128 fake experts alone take 34 s to build): a
layer's spec reads only its own shapes.

The port keeps one tensor per layer where the reference stacks a cycle
position's layers, so layer ``i``'s spec is the reference's for stack
position ``i % c`` less its leading stack entry; that entry is ``None``
everywhere but on the leaves ``STACK_SHARDED`` names, where the reference
puts fsdp on the block axis and the port, having none, replicates. The
production mesh and ``DTensor`` placements run in a subprocess with a fake
process group of 256 and 512 ranks (no JAX imported there).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as JC
from repro.configs.base import INPUT_SHAPES
from repro.fed import trainer as JFT
from repro.launch import mesh as JM
from repro.models import sharding as JS
from repro.models.model import build_model as j_build

import repro_torch.configs as TC
from repro_torch.fed import trainer as TFT
from repro_torch.launch import mesh as TM
from repro_torch.models import sharding as TS
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model as t_build
from repro_torch.tree import tree_flatten

from _hypothesis_compat import given, settings, st

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(JC.ARCH_IDS)
MODES = [("sharded", "generic"), ("replicated", "generic"),
         ("sharded", "megatron")]
LAYOUTS = {16: ("data",), 32: ("pod", "data")}

# the reference's leaves whose stack axis it shards (fsdp on the block
# axis of a per-layer 1-D leaf), by (arch, fsdp size), in every mode
_RWKV = tuple(f"stack/0/{leaf}" for leaf in (
    "cm_norm/scale", "mix_c", "mix_k", "mix_r", "mix_v", "mix_w",
    "tm_norm/scale", "w_bias"))
_NORMS = ("stack/0/norm1/scale", "stack/0/norm2/scale")
STACK_SHARDED = {("rwkv6-3b", 16): _RWKV, ("rwkv6-3b", 32): _RWKV,
                 ("internvl2-26b", 16): _NORMS,
                 ("llama4-maverick-400b-a17b", 16): _NORMS}


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _ref_specs(tree) -> dict:
    """path -> tuple of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree) -> dict:
    """path -> spec of a port spec tree."""
    leaves, _ = tree_flatten(tree, is_leaf=TS.is_spec)
    return dict(zip(TS.leaf_paths(tree, TS.is_spec), leaves))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    return jax.eval_shape(j_build(JC.get(arch)).init, jax.random.PRNGKey(0))


def _cut(arch: str):
    """The port's config at two cycles of its pattern (at most its
    depth)."""
    cfg = TC.get(arch)
    c = TT._cycle(TT.layer_pattern(cfg))
    cut = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, 2 * c))
    full = TT.layer_pattern(cfg)
    assert TT.layer_pattern(cut) == full[:cut.n_layers]
    return cut, c


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    cfg, c = _cut(arch)
    model = t_build(cfg, device="cpu")
    with FakeTensorMode():
        return model.init(torch.Generator()), c


def _ref_path(port_path: str, c: int) -> str:
    """The reference's path of a port leaf: layer ``i`` is cycle position
    ``i % c`` of the stack; an encoder layer position 0 of its own."""
    head, *rest = port_path.split("/")
    if head == "layers":
        return "/".join(["stack", str(int(rest[0]) % c)] + rest[1:])
    if head == "encoder":
        return "/".join(["encoder", "0"] + rest[1:])
    return port_path


def _check_layer_specs(port: dict, ref: dict, c: int, lead: int,
                       sharded=(), stack_entry=None, what=""):
    """Every port leaf against the reference's: whole-tree leaves equal;
    a layer's leaf equal to the reference's less its stack entry (at index
    ``lead``), which must be None, or ``stack_entry`` on ``sharded``."""
    assert set(ref) == {_ref_path(p, c) for p in port}, what
    seen = set()
    for path, spec in port.items():
        rpath = _ref_path(path, c)
        want = ref[rpath]
        if rpath.split("/")[0] not in ("stack", "encoder"):
            assert spec == want, (what, path, spec, want)
            continue
        assert spec == want[:lead] + want[lead + 1:], (what, path, spec,
                                                       want)
        entry = want[lead]
        if rpath in sharded:
            assert entry == stack_entry, (what, rpath, want)
            seen.add(rpath)
        else:
            assert entry is None, (what, rpath, want)
    assert seen == set(sharded), (what, sorted(seen))


# ---------------------------------------------------------------------------
# param_specs, cache_specs, state_specs, batch_spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mode):
    """fsdp ("data",) at 16 and ("pod", "data") at 32, each attention/MLP
    mode: every leaf's spec is the reference's, less the stack entry,
    which the reference shards on exactly the leaves STACK_SHARDED names."""
    attn_mode, mlp_mode = mode
    params, c = _port_params(arch)
    for size, fsdp in LAYOUTS.items():
        kw = dict(fsdp=fsdp, fsdp_size=size, tp="model", tp_size=16,
                  attn_mode=attn_mode, mlp_mode=mlp_mode)
        ref = _ref_specs(JS.param_specs(_ref_shapes(arch), **kw))
        port = _port_specs(TS.param_specs(params, **kw))
        _check_layer_specs(port, ref, c, 0, STACK_SHARDED.get((arch, size),
                                                              ()),
                           TS.canonical((fsdp,))[0], f"{arch} fsdp {size}")


def _decode_cases():
    for arch in ARCHS:
        cfg = JC.get(arch)
        shapes = ["decode_32k"] + (["long_500k"] if cfg.is_subquadratic
                                   else [])
        kv = ["bfloat16"] + ([] if cfg.family == "audio" else ["int8"])
        for shape in shapes:
            for dt in kv:
                yield pytest.param(arch, shape, dt, id=f"{arch}-{shape}-{dt}")


@pytest.mark.parametrize("arch,shape,kv", list(_decode_cases()))
def test_cache_specs_match_reference(arch, shape, kv):
    """The per-layer decode caches at the reference's decode shapes
    (``configs/base.py:INPUT_SHAPES``), bf16 and (but for audio, whose
    int8 decode the port refuses) int8: layer ``i``'s spec is the
    reference's stacked cache spec of position ``i % c`` less its block
    entry, which is never sharded; batch over ("data",) at 16 and
    ("pod", "data") at 32."""
    shp = INPUT_SHAPES[shape]
    kw = {} if kv == "bfloat16" else {"kv_dtype": "int8"}
    jcfg = dataclasses.replace(JC.get(arch), **kw)
    tcfg = dataclasses.replace(TC.get(arch), **kw)
    jm = j_build(jcfg)
    ref_shapes = jax.eval_shape(
        lambda: jm.init_cache(shp.global_batch, shp.seq_len))
    tm = t_build(tcfg, device="cpu")
    with FakeTensorMode():
        caches = tm.init_cache(shp.global_batch, shp.seq_len)
    c = TT._cycle(TT.layer_pattern(tcfg))
    for size, axes in LAYOUTS.items():
        ref = {f"stack/{k}": v for k, v in _ref_specs(JS.cache_specs(
            ref_shapes, axes, batch_size=size)).items()}
        port = {f"layers/{k}": v for k, v in _port_specs(TS.cache_specs(
            caches, axes, batch_size=size)).items()}
        _check_layer_specs(port, ref, c, 0, what=f"{arch} {shape} {size}")


@pytest.mark.parametrize("use_cv", [True, False], ids=["variates", "off"])
@pytest.mark.parametrize("client_mode", ["physical", "logical"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-moe-235b-a22b",
                                  "gemma3-12b"])
def test_state_and_batch_specs_match_reference(arch, client_mode, use_cv):
    """``state_specs`` (s_hat, v, v_i) and ``batch_spec``, physical (inner
    dims over tp only, v_i's client dim over fsdp) and logical (inner dims
    over fsdp and tp), with and without variates, both layouts; under
    logical the stack entry is the parameters' (rwkv6's eight leaves)."""
    params, c = _port_params(arch)
    for size, fsdp in LAYOUTS.items():
        kw = dict(n_clients=size, client_mode=client_mode, use_cv=use_cv,
                  attn_mode="replicated" if arch == "gemma3-12b"
                  else "sharded")
        jf, tf = JFT.FedLMConfig(**kw), TFT.FedLMConfig(**kw)
        ref = JFT.state_specs(_ref_shapes(arch), jf, fsdp=fsdp,
                              fsdp_size=size)
        port = TFT.state_specs(params, tf, fsdp=fsdp, fsdp_size=size)
        sharded = (STACK_SHARDED.get((arch, size), ())
                   if client_mode == "logical" else ())
        entry = TS.canonical((fsdp,))[0]
        what = f"{arch} {client_mode} {size}"
        _check_layer_specs(_port_specs(port[0]), _ref_specs(ref[0]), c, 0,
                           sharded, entry, what + " s_hat")
        if not use_cv:
            assert port[1:] == ((), ()) and ref[1:] == ({}, {})
        else:
            _check_layer_specs(_port_specs(port[1]), _ref_specs(ref[1]), c,
                               0, sharded, entry, what + " v")
            vi = _ref_specs(ref[2])
            lead = entry if client_mode == "physical" else None
            assert all(s[0] == lead for s in vi.values()), what
            _check_layer_specs(_port_specs(port[2]), vi, c, 1, sharded,
                               entry, what + " v_i")
        assert TFT.batch_spec(tf, fsdp) == tuple(JFT.batch_spec(jf, fsdp))


# ---------------------------------------------------------------------------
# the reference's own cases, on the port's trees
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def test_param_specs_2d_sharding():
    """``tests/test_dryrun.py::TestSpecBuilders::test_param_specs_2d_
    sharding`` with one tensor per layer: the reference's scan-stacked
    leaves (2, ...) become two layers of their trailing shapes."""
    layer = {"w_in": _meta(512, 2048), "norm": {"scale": _meta(512)},
             "moe": {"experts": {"w_out": _meta(128, 2048, 512)}}}
    params = {"embedding": {"embed": _meta(51968, 512)},
              "layers": [layer, layer], "final_norm": {"scale": _meta(512)}}
    specs = TS.param_specs(params, fsdp=("data",), fsdp_size=16, tp="model",
                           tp_size=16)
    assert specs["embedding"]["embed"] == tuple(P("model", ("data",)))
    assert specs["final_norm"]["scale"] == tuple(P(None))
    for i in range(2):
        assert specs["layers"][i]["w_in"] == tuple(P(("data",), "model"))
        # the reference's stacked (2, 512) norm: (None, "model")
        assert specs["layers"][i]["norm"]["scale"] == tuple(P("model"))
        # expert dim over tp
        assert specs["layers"][i]["moe"]["experts"]["w_out"] == \
            tuple(P("model", ("data",), None))


def test_cache_specs():
    """``TestSpecBuilders::test_cache_specs`` on per-layer caches (no
    block axis)."""
    caches = [{"k": _meta(128, 32768, 8, 128), "v": _meta(128, 32768, 8, 128)},
              {"ssm": torch.empty((1, 16384, 16), device="meta")}]
    specs = TS.cache_specs(caches, ("data",), batch_size=16)
    assert specs[0]["k"] == tuple(P(("data",), "model", None, None))
    # batch 1 not divisible -> replicated batch; channels over model
    assert specs[1]["ssm"] == tuple(P(None, "model", None))


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 4), st.integers(1, 8), st.integers(0, 10**6))
def test_param_specs_always_valid(depth, width, seed):
    """``tests/test_property_invariants.py::test_param_specs_always_valid``
    on meta tensors: a spec per leaf with rank == leaf rank and only
    divisible dims sharded, equal to the reference's for the same tree."""
    rng = np.random.default_rng(seed)
    shapes = {}
    for i in range(depth):
        shapes[f"leaf{i}/w_in"] = tuple(
            int(rng.choice([1, 3, 16, 64, 512, 1536]))
            for _ in range(int(rng.integers(1, 4))))
    tree = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    specs = TS.param_specs(tree, fsdp=("data",), fsdp_size=16, tp="model",
                           tp_size=16)
    ref = JS.param_specs({k: jax.ShapeDtypeStruct(s, np.float32)
                          for k, s in shapes.items()}, fsdp=("data",),
                         fsdp_size=16, tp="model", tp_size=16)
    for name, shape in shapes.items():
        spec = specs[name]
        assert spec == tuple(ref[name])
        assert len(spec) <= len(shape)
        for dim, s in enumerate(spec):
            if s is not None:
                assert shape[dim] % 16 == 0


# ---------------------------------------------------------------------------
# the small functions
# ---------------------------------------------------------------------------

def test_client_axes_and_axis_rules_match_reference():
    for multi in (False, True):
        assert TM.client_axes(multi) == JM.client_axes(multi)
        assert TM.axis_rules(multi) == JM.axis_rules(multi)


def test_rules_logical_to_spec_and_shard():
    """Without rules ``shard`` returns its input; with the production
    rules ``logical_to_spec`` gives the reference's spec, and ``shard``
    returns a plain tensor as it is."""
    x = torch.ones(4, 8)
    assert TS.get_rules() is None and JS.get_rules() is None
    assert TS.shard(x, "batch", "ff") is x
    try:
        for multi in (False, True):
            TS.install_rules(TM.axis_rules(multi))
            JS.install_rules(JM.axis_rules(multi))
            assert TS.get_rules() == JM.axis_rules(multi)
            for axes in (("batch", "ff"), ("clients", None, "vocab"),
                         ("cache_seq",), ("nope", "experts")):
                assert TS.logical_to_spec(*axes) == \
                    tuple(JS.logical_to_spec(*axes))
            assert TS.shard(x, "batch", "ff") is x
    finally:
        TS.install_rules(None)
        JS.install_rules(None)


class _Mesh:
    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements():
    """One placement per mesh dim; a tuple entry shards one tensor dim
    over its mesh dims major first; what DTensor cannot lay out raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh("pod", "data", "model")
    assert TS.placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert TS.placements((None, "model", ("data",)), mesh) == \
        [Replicate(), Shard(2), Shard(1)]
    assert TS.placements((None,), mesh) == [Replicate()] * 3
    for bad, match in (((("data", "pod"),), "orders"),
                       (("data", "data"), "two tensor dims"),
                       (("nope",), "not a dim")):
        with pytest.raises(ValueError, match=match):
            TS.placements(bad, mesh)


# ---------------------------------------------------------------------------
# the production mesh, under a fake process group
# ---------------------------------------------------------------------------

FAKE_PG = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import repro_torch.configs as TC
    from repro_torch.launch import mesh as M
    from repro_torch.models import sharding as S
    from repro_torch.models.layers import params_tree
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_flatten

    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)

    out = {"refused": {}, "meshes": {}, "leaves": {}}
    # too few ranks
    for world, multi in ((255, False), (511, True)):
        start(world)
        try:
            M.make_production_mesh(multi_pod=multi, device="cpu")
            out["refused"][str(world)] = None
        except ValueError as e:
            out["refused"][str(world)] = str(e)
        dist.destroy_process_group()
    params = {}
    for arch, layers in (("phi3-medium-14b", None),
                         ("qwen3-moe-235b-a22b", 2)):
        cfg = TC.get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        with FakeTensorMode():
            params[arch] = build_model(cfg, device="cpu").init(
                torch.Generator())
    for world, multi in ((256, False), (512, True)):
        start(world)
        mesh = M.make_production_mesh(multi_pod=multi, device="cpu")
        sizes = dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape)))
        out["meshes"][str(world)] = {
            "shape": list(mesh.mesh.shape), "names": list(mesh.mesh_dim_names),
            "device_type": mesh.device_type}
        fsdp = M.client_axes(multi)
        fsdp_size = 1
        for a in fsdp:
            fsdp_size *= sizes[a]
        for arch, p in params.items():
            specs = S.param_specs(p, fsdp=fsdp, fsdp_size=fsdp_size)
            leaves, _ = tree_flatten(params_tree(p))
            slist, _ = tree_flatten(specs, is_leaf=S.is_spec)
            n = bad = 0
            for leaf, spec in zip(leaves, slist):
                meta = torch.empty(tuple(leaf.shape), dtype=leaf.dtype,
                                   device="meta")
                d = distribute_tensor(meta, mesh, S.placements(spec, mesh),
                                      src_data_rank=None)
                want = []
                for size, e in zip(leaf.shape, spec):
                    for name in (() if e is None else
                                 (e,) if isinstance(e, str) else e):
                        size //= sizes[name]
                    want.append(size)
                n += 1
                bad += tuple(d.to_local().shape) != tuple(want)
            out["leaves"][f"{arch}@{world}"] = [n, bad]
        # shard() redistributes a DTensor to the rules' spec
        S.install_rules(M.axis_rules(multi))
        x = distribute_tensor(torch.empty((4096, 8192), device="meta"), mesh,
                              S.placements((None, None), mesh),
                              src_data_rank=None)
        y = S.shard(x, "batch", "ff")
        out["shard"] = out.get("shard", {})
        out["shard"][str(world)] = [str(p) for p in y.placements] + [
            list(y.to_local().shape)]
        S.install_rules(None)
        dist.destroy_process_group()
    out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "repro."))
                              for m in sys.modules)
    print(json.dumps(out))
""")


def test_production_mesh_under_a_fake_process_group():
    """A fake process group of 256 and 512 ranks (no JAX in the process):
    ``make_production_mesh`` has the reference's shapes and names and
    refuses a smaller world; ``distribute_tensor`` of a meta tensor takes
    ``placements(spec)`` for every leaf of phi3-medium-14b (full depth)
    and qwen3-moe (2 of 94 layers), full width, with the spec's local
    shapes; ``shard`` redistributes a replicated DTensor."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", FAKE_PG], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert not out["jax_imported"]
    assert "256" in out["refused"]["255"] and "255" in out["refused"]["255"]
    assert "512" in out["refused"]["511"]
    assert out["meshes"]["256"] == {"shape": [16, 16],
                                    "names": ["data", "model"],
                                    "device_type": "cpu"}
    assert out["meshes"]["512"] == {"shape": [2, 16, 16],
                                    "names": ["pod", "data", "model"],
                                    "device_type": "cpu"}
    for key, (n, bad) in out["leaves"].items():
        assert n > 0 and bad == 0, (key, n, bad)
    assert out["shard"]["256"] == ["S(0)", "S(1)", [256, 512]]
    assert out["shard"]["512"] == ["S(0)", "S(0)", "S(1)", [128, 512]]

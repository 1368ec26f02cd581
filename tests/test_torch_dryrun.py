"""The dry run (``repro_torch/launch/dryrun.py``) and the roofline table
(``repro_torch/benchmarks/roofline_table.py``).

The dry run starts torch's fake process group, so every combination runs
in a subprocess (none leaks into the test process), two of them side by
side. At two layers and full width on the 256-rank mesh, one ``ok``
combination each of a dense attention model, a sliding-window one, RWKV,
an MoE, Mamba, audio and vlm, prefill, decode and train among them. The
stand-ins of ``meta_params`` are checked against ``init`` in this
process (no process group needed)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.configs as TC
from repro_torch.benchmarks import roofline_table
from repro_torch.launch import dryrun as TD
from repro_torch.models.layers import params_tree
from repro_torch.models.model import build_model
from repro_torch.models import sharding as TS
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
# (arch, shape): dense prefill would repeat gemma3's; phi3 takes the train
# step, the slowest of the kinds
GROUPS = ([("phi3-medium-14b", "train_4k"), ("gemma3-12b", "prefill_32k"),
           ("rwkv6-3b", "decode_32k")],
          [("qwen3-moe-235b-a22b", "decode_32k"),
           ("jamba-1.5-large-398b", "prefill_32k"),
           ("whisper-base", "prefill_32k"),
           ("internvl2-26b", "decode_32k")])
TABLE_KEYS = ("arch", "shape", "multi_pod", "status", "roofline", "memory",
              "useful_flops_ratio")

RUN = textwrap.dedent("""
    import json, math, sys
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.models import sharding as S
    from repro_torch.tree import tree_flatten

    combos = json.loads(sys.argv[1])
    out = {"records": [], "expected_argument_bytes": {}}
    skip = D.compile_one("mistral-large-123b", "long_500k", False)
    out["records"].append(skip)
    for arch, shape in combos:
        r = D.compile_one(arch, shape, False, overrides={"n_layers": 2})
        r.pop("traceback", None)
        out["records"].append(r)
        if shape == "prefill_32k":
            # the local shard bytes of the parameters under param_specs,
            # and of the batch's tokens and labels over the client axes
            cfg = D.C.get(arch)
            import dataclasses
            cfg = dataclasses.replace(cfg, n_layers=2)
            params = D.meta_params(cfg)
            mesh = D.production_mesh(False)
            sizes = {"data": 16, "model": 16}
            leaves, _ = tree_flatten(params)
            specs, _ = tree_flatten(S.param_specs(params, fsdp=("data",),
                                                  fsdp_size=16),
                                    is_leaf=S.is_spec)
            total = 0
            for x, spec in zip(leaves, specs):
                n = x.numel()
                for e in D._fit(spec, x.shape, mesh):
                    for a in (() if e is None else (e,) if
                              isinstance(e, str) else e):
                        n //= sizes[a]
                total += n * x.element_size()
            B, L = D.INPUT_SHAPES[shape].global_batch, \\
                D.INPUT_SHAPES[shape].seq_len
            total += 2 * (B // 16) * L * 8
            if cfg.family in ("audio", "vlm"):
                total += (B // 16) * cfg.n_frontend_tokens * cfg.d_model * 4
            out["expected_argument_bytes"][arch] = total
    out["jax_imported"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "repro" or m.startswith("repro."))
    print(json.dumps(out))
""")


def _start(combos):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", RUN, json.dumps(combos)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def records():
    procs = [_start(group) for group in GROUPS]
    outs = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    return outs


def test_skip_policy(records):
    for out in records:
        skip = out["records"][0]
        assert skip["status"] == "skipped"
        assert "sub-quadratic" in skip["reason"]


@pytest.mark.parametrize("arch,shape", [c for g in GROUPS for c in g])
def test_combination_is_ok(records, arch, shape):
    """Every kind of layer and step counts on the mesh: flops, collective
    bytes and a peak (every layout here asks for collectives), and the
    keys the roofline table reads."""
    rec = next(r for out in records for r in out["records"]
               if r["arch"] == arch and r["shape"] == shape)
    assert rec["status"] == "ok", rec.get("error")
    for key in TABLE_KEYS:
        assert key in rec
    assert rec["n_chips"] == 256 and rec["multi_pod"] is False
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all"}
    t = rec["roofline"]
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["compute_s"] == pytest.approx(rec["flops_per_device"] / 989e12)
    if shape == "train_4k":
        assert rec["client_mode"] == "physical" and rec["n_clients"] == 16
        assert rec["train_route"] == "scan"
    assert rec["collective_note"] == TD.COLLECTIVE_NOTE


def test_argument_bytes_are_the_local_shards(records):
    for out in records:
        for arch, want in out["expected_argument_bytes"].items():
            rec = next(r for r in out["records"] if r["arch"] == arch)
            assert rec["memory"]["argument_bytes"] == want, arch


def test_no_jax_in_the_dry_run(records):
    for out in records:
        assert out["jax_imported"] == []


@pytest.mark.parametrize("arch", ["gemma3-12b", "jamba-1.5-large-398b",
                                  "whisper-base", "internvl2-26b",
                                  "qwen3-moe-235b-a22b"])
def test_meta_params_are_inits_tree(arch):
    """``meta_params`` has the paths, shapes and dtypes of ``init``'s tree
    (a reduced config: every layer kind of the family)."""
    cfg = TC.get(arch).reduced()
    with FakeTensorMode():
        want = params_tree(build_model(cfg, device="cpu").init(
            torch.Generator()))
    got = TD.meta_params(cfg)
    assert TS.leaf_paths(got) == TS.leaf_paths(want)
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert (g.shape, g.dtype, g.device.type) == (w.shape, w.dtype,
                                                     "meta")


def test_roofline_table_renders_the_records(tmp_path, monkeypatch, capsys):
    ok = {"arch": "phi3-medium-14b", "shape": "train_4k", "multi_pod": False,
          "status": "ok", "useful_flops_ratio": 0.5,
          "memory": {"peak_bytes": 3 * 2**30},
          "roofline": {"compute_s": 1.5, "memory_s": 0.25,
                       "collective_s": 2.0, "dominant": "collective"}}
    skipped = {"arch": "mistral-large-123b", "shape": "long_500k",
               "multi_pod": True, "status": "skipped"}
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "torch_base_a.json").write_text(json.dumps([ok]))
    (tmp_path / "results" / "torch_mp_a.json").write_text(
        json.dumps([skipped]))
    # the reference's records are never read
    (tmp_path / "results" / "base_a.json").write_text(json.dumps([ok, ok]))
    monkeypatch.chdir(tmp_path)
    rows = roofline_table.load()
    assert len(rows) == 2
    out = roofline_table.render(rows, markdown=True)
    assert out[0] == ("mistral-large-123b", "long_500k", 2, "skipped") + \
        ("-",) * 6
    assert out[1] == ("phi3-medium-14b", "train_4k", 1, "ok", "1.5000",
                      "0.2500", "2.0000", "collective", "3.0", "0.50")
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("| arch | shape | pods")


def test_roofline_table_says_what_the_collectives_are(tmp_path, monkeypatch,
                                                      capsys):
    """Under the table: the records' note on their collective bytes."""
    rec = {"arch": "rwkv6-3b", "shape": "decode_32k", "multi_pod": False,
           "status": "ok", "useful_flops_ratio": 1.0,
           "memory": {"peak_bytes": 2**30},
           "roofline": {"compute_s": 0.0, "memory_s": 0.1,
                        "collective_s": 0.2, "dominant": "collective"},
           "collective_note": TD.COLLECTIVE_NOTE}
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "torch_base_a.json").write_text(
        json.dumps([rec]))
    monkeypatch.chdir(tmp_path)
    roofline_table.main(["--markdown"])
    text = capsys.readouterr().out
    assert text.strip().splitlines()[-1] == (
        f"collective_s: {TD.COLLECTIVE_NOTE}.")


# configs whose layers are several blocks of kinds (gemma3 3 local : 1
# global, whisper's encoder and decoder, jamba's period of four)
DEPTH_CASES = [("gemma3-12b", {"n_layers": 12, "global_every": 4}),
               ("whisper-base", {"n_layers": 3, "n_encoder_layers": 3}),
               ("jamba-1.5-large-398b", {"n_layers": 12, "attn_every": 4,
                                         "moe_every": 2}),
               ("rwkv6-3b", {"n_layers": 5})]


def _counted(cfg, kind, pattern=None, n_clients=1):
    """One step's flops on plain ``meta`` tensors at one chip."""
    from repro_torch.configs.base import InputShape
    from repro_torch.fed import trainer as FT
    if kind == "prefill":
        counts, _ = TD.count_serve(cfg, InputShape("p", 16, 2, "prefill"),
                                   pattern=pattern, peak=False)
    else:
        fed = FT.FedLMConfig(n_clients=n_clients, client_mode="logical")
        counts, _ = TD.count_train_step(
            cfg, fed, InputShape("t", 16, n_clients, "train"),
            pattern=pattern, peak=False)
    return counts["flops"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch,over", DEPTH_CASES)
def test_depth_line_is_exact(arch, over, kind):
    """The flops of a deep model equal those on the ``depth_line`` through
    one and two blocks of its layer kinds, each of them shallower."""
    import dataclasses
    cfg = dataclasses.replace(TC.get(arch).reduced(), **over)
    points = TD.depth_line(cfg)
    assert len(points) == 2 and sum(w for w, _, _ in points) == 1.0
    for _, cfg_d, pattern in points:
        assert cfg_d.n_layers == len(pattern) < cfg.n_layers
    got = sum(w * _counted(c, kind, p) for w, c, p in points)
    assert got == pytest.approx(_counted(cfg, kind), rel=1e-12)


def test_depth_line_of_one_block_is_the_model():
    cfg = TC.get("jamba-1.5-large-398b").reduced()
    ((w, cfg_d, pattern),) = TD.depth_line(cfg)
    assert w == 1.0 and cfg_d == cfg and pattern == T.layer_pattern(cfg)


def test_client_line_is_exact(monkeypatch):
    """A step of three clients: the line through one and two of them, and
    the count at three."""
    cfg = TC.get("rwkv6-3b").reduced()
    assert TD.client_line(3) == [(-1.0, 1), (2.0, 2)]
    assert TD.client_line(2) == [(1.0, 2)]
    line = _counted(cfg, "train", n_clients=3)
    monkeypatch.setattr(TD, "COUNTED_CLIENTS", (3, 4))
    assert line == pytest.approx(_counted(cfg, "train", n_clients=3),
                                 rel=1e-12)

"""The port's A/B driver (``repro_torch/benchmarks/perf_iterations.py``)
against the reference's (``benchmarks/perf_iterations.py``), every mode at
a small size on the CPU.

The wire mode's aggregates are held bit for bit against the reference's on
the reference's inputs and dither seeds (both on their plain routes), and
its byte fields against the reference's own row at the same size; the
mesh modes' bytes against the reference's committed rows in
``results/perf_log.json`` (the reference's mesh path itself is not run
here: its bit-identity tests fail on this host, ROADMAP Queue C item 2).
The ``--pair`` mode runs in two subprocesses (it starts torch's fake
process group), started when the module's first test runs so that they
overlap the rest, with ``launch.dryrun.compile_one`` wrapped to count two
layers."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro_torch.benchmarks import perf_iterations as P
from repro_torch.core import compression as TC

from _torch_parity import assert_bits_equal, leaf_seeds

ROOT = Path(__file__).resolve().parents[1]
REF_LOG = json.loads((ROOT / "results" / "perf_log.json").read_text())
TOP_KEYS = {"pair", "variant", "hypothesis", "multi_pod", "result"}

PAIR_RUN = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    count = dryrun.compile_one

    def two_layers(*args, **kw):
        return count(*args, overrides={"n_layers": 2}, **kw)

    dryrun.compile_one = two_layers
    from repro_torch.benchmarks import perf_iterations as P
    P.main(sys.argv[1:])
    print(json.dumps(sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "repro" or m.startswith("repro."))))
""")


def _start_pair(tmp: Path, *args):
    log = tmp / f"pair_{args[1]}.json"
    # meta tensors compute nothing: one thread each
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", PAIR_RUN, *args, "--log", str(log)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, log


@pytest.fixture(scope="module", autouse=True)
def pair_runs(tmp_path_factory):
    """``--pair decode`` (every variant) and ``--pair train --variant
    no_cv``, each in its own subprocess, started before the module's
    first test."""
    tmp = tmp_path_factory.mktemp("pairs")
    started = {"decode": _start_pair(tmp, "--pair", "decode"),
               "train": _start_pair(tmp, "--pair", "train", "--variant",
                                    "no_cv")}
    yield started
    for proc, _ in started.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _pair_records(pair_runs, pair: str) -> list:
    proc, log = pair_runs[pair]
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    assert json.loads(stdout.strip().splitlines()[-1]) == []
    assert "===" in stdout
    return json.loads(log.read_text())


def _ref_rows(pair: str) -> dict:
    return {e["variant"]: e for e in REF_LOG if e["pair"] == pair}


def _assert_keys(entry: dict, ref: dict, added: set = frozenset()) -> None:
    assert set(entry) == TOP_KEYS | {"card"}
    assert entry["card"] is None                      # the CPU
    assert set(entry["result"]) == set(ref["result"]) | added, (
        set(entry["result"]) ^ (set(ref["result"]) | added))


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------

def _reference_inputs(n: int, dim: int, seed: int = 0):
    """The reference's wire inputs (``bench_wire``'s key split) and each
    client's folded dither seed."""
    k_xs, k_clients = jax.random.split(jax.random.PRNGKey(seed))
    xs = jax.random.normal(k_xs, (n, dim))
    keys = jax.random.split(k_clients, n)
    return xs, keys, [leaf_seeds(k, 1)[0] for k in keys]


@pytest.mark.parametrize("bits", [8, 4])
def test_wire_aggregates_bit_for_bit_against_the_reference(bits):
    """On the reference's inputs and seeds (n 4, dim 4,096: the plain
    route on both sides) the port's dequantized, code-space and fused
    aggregates equal the reference's bit for bit."""
    n, dim = 4, 4096
    xs, keys, seeds = _reference_inputs(n, dim)
    jcomp = JC.block_quant(bits, 256, dither="hash",
                           kernel_threshold=1 << 62)
    mu = jnp.full((n,), 1.0 / n)
    want_d = jnp.tensordot(mu, jax.vmap(jcomp.apply)(keys, xs), axes=1)
    want_w = jnp.tensordot(mu, jcomp.decode(jax.vmap(jcomp.encode)(keys, xs)),
                           axes=1)
    assert_bits_equal(want_d, want_w)
    tcomp = TC.block_quant(bits, 256, dither="hash")
    txs = torch.from_numpy(np.array(xs))
    tmu = torch.full((n,), 1.0 / n)
    for path, want in (("dequant", want_d), ("code_space", want_w),
                       ("fused", want_w)):
        got = P.wire_round(tcomp, txs, seeds, tmu, path)
        assert_bits_equal(got, np.asarray(want), msg=path)


def test_wire_row_against_the_reference_row(tmp_path, monkeypatch):
    """The byte fields of the port's row equal the reference's own row at
    the same size; the aggregates agree; the CPU launches no kernel."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import perf_iterations as jperf
    n, dim = 4, 4096
    ref = jperf.bench_wire(n_clients=n, dim=dim,
                           log_path=str(tmp_path / "ref.json"))
    entry = P.bench_wire(log_path=str(tmp_path / "port.json"), n_clients=n,
                         dim=dim, device="cpu")
    _assert_keys(entry, ref, P.ADDED_KEYS["wire"])
    r = entry["result"]
    assert r["f32_stack_bytes"] == ref["result"]["f32_stack_bytes"]
    assert r["launches"] == {} and r["device"] == "cpu"
    assert r["kernel_threshold"] == TC.KERNEL_DISPATCH_MIN
    for b in ("b8", "b4"):
        assert set(r[b]) == set(ref["result"][b]) | P.ADDED_KEYS["wire_bits"]
        for k in ("payload_stack_bytes", "footprint_ratio_vs_f32"):
            assert r[b][k] == ref["result"][b][k], (b, k)
        assert r[b]["aggregate_bit_identical"] is True
        assert r[b]["fused_max_abs_diff_vs_code_space"] == 0.0
        assert r[b]["fused_allclose_vs_code_space"] is True
        assert r[b]["plain_route_bit_identical"] is True
        assert min(r[b]["us_dequant_plain"], r[b]["us_code_space_plain"]) > 0
    assert r["b8"]["payload_stack_bytes"] == n * (dim + dim // 64)
    assert r["b4"]["payload_stack_bytes"] == n * (dim // 2 + dim // 64)
    (logged,) = json.loads((tmp_path / "port.json").read_text())
    assert logged == entry


# ---------------------------------------------------------------------------
# driver, collective, hier, scheduler, faults
# ---------------------------------------------------------------------------

def test_driver_run_equals_the_hand_loop(tmp_path):
    entry = P.bench_driver(rounds=3, log_path=str(tmp_path / "p.json"),
                           device="cpu")
    _assert_keys(entry, _ref_rows("driver")["scan_vs_python_loop"],
                 P.ADDED_KEYS["driver"])
    r = entry["result"]
    assert r["hand_loop_bit_identical"] is True
    assert r["rounds_per_sec_scan"] is None and r["speedup"] is None
    assert "scan" in r["scan"] and r["rounds"] == 3
    assert r["rounds_per_sec_python_loop"] > 0 and r["scan_compile_s"] > 0


def test_collective_bytes_equal_the_reference_rows(tmp_path):
    """On a one-rank gloo group (started and destroyed by the mode): 8
    clients, gather bit for bit, reduce allclose, and the bytes of the
    reference's committed rows (recorded at 8 devices; the bytes do not
    depend on the device count)."""
    import torch.distributed as dist
    rows = P.bench_collective(rounds=2, log_path=str(tmp_path / "p.json"),
                              device="cpu")
    assert not dist.is_initialized()
    ref = _ref_rows("collective")
    g, r = (e["result"] for e in rows)
    for entry in rows:
        _assert_keys(entry, ref[entry["variant"]],
                     P.ADDED_KEYS["collective"])
        assert entry["result"]["backend"] == "gloo"
        assert entry["result"]["n_devices"] == 1
    rg, rr = ref["uplink_gather"]["result"], ref["uplink_reduce"]["result"]
    assert g["trajectory_bit_identical"] is True
    assert r["trajectory_allclose_vs_single"] is True
    for k in ("n_clients", "collective_wire_bytes_per_round",
              "per_device_stack_bytes", "f32_stack_bytes_per_round",
              "wire_vs_f32_ratio"):
        assert g[k] == rg[k], k
    for k in ("psum_operand_bytes_per_device", "gathered_stack_bytes_gone",
              "gather_stack_vs_psum_ratio"):
        assert r[k] == rr[k], k
    assert (g["collective_wire_bytes_per_round"],
            r["psum_operand_bytes_per_device"],
            g["f32_stack_bytes_per_round"]) == (3168, 1216, 9728)
    # at one rank the whole stack is the rank's: 8 x 396 + 1,216
    assert r["per_device_memory_bound_bytes"] == 8 * 396 + 1216


def test_hier_bytes_equal_the_reference_rows(tmp_path):
    rows = P.bench_hier(rounds=2, log_path=str(tmp_path / "p.json"),
                        device="cpu")
    ref = _ref_rows("hier")
    for entry in rows:
        _assert_keys(entry, ref[entry["variant"]], P.ADDED_KEYS["hier"])
        got, want = entry["result"], ref[entry["variant"]]["result"]
        assert got["on_mesh"] is False and got["n_edges"] == 4
        assert got["trajectory_within_quant_step"] is True
        # on the same draws the gap is the edge sum's reassociation
        assert got["max_abs_diff_vs_flat"] < 0.01
        for k in ("n_clients", "uplink_bytes_per_round",
                  "flat_backbone_bytes", "backbone_bytes_per_round"):
            assert got[k] == want[k], (entry["variant"], k)
    raw, re = (e["result"] for e in rows)
    assert (raw["uplink_bytes_per_round"], raw["backbone_bytes_per_round"],
            re["backbone_bytes_per_round"]) == (3168, 4864, 1584)
    for k in ("backbone_vs_uplink_ratio", "backbone_below_uplink",
              "backbone_vs_raw_ratio"):
        assert re[k] == ref["two_tier_reencode"]["result"][k], k


def test_scheduler_peaks_are_null_on_the_cpu(tmp_path, monkeypatch):
    """At dim 1,024 and cohorts of 8 (the module's sizes are the
    reference's, 16,384 and 64)."""
    assert (P.SCHED_DIM, P.SCHED_COHORT) == (16384, 64)
    monkeypatch.setattr(P, "SCHED_DIM", 1024)
    monkeypatch.setattr(P, "SCHED_COHORT", 8)
    entry = P.bench_scheduler(rounds=1, log_path=str(tmp_path / "p.json"),
                              device="cpu")
    _assert_keys(entry, _ref_rows("scheduler")["population_streaming"])
    r = entry["result"]
    assert (r["dim"], r["cohort_size"], r["n_small"], r["n_big"]) == \
        (1024, 8, 32, 256)
    assert r["peak_device_bytes_small"] is None
    assert r["peak_device_bytes_big"] is None
    assert r["peak_bytes_ratio_big_vs_small"] is None
    assert min(r["rounds_per_sec_small"], r["rounds_per_sec_big"],
               r["rounds_per_sec_async_pipelined_big"]) > 0


def test_faults_keep_three_snapshots(tmp_path, monkeypatch):
    """At p 64, K 8, 64 samples a client and cohorts of 8 (the module's
    sizes are the reference's, 256, 16, 512 and 64)."""
    sizes = ("FAULTS_P", "FAULTS_K", "FAULTS_SAMPLES", "FAULTS_COHORT")
    assert [getattr(P, k) for k in sizes] == [256, 16, 512, 64]
    for k, v in zip(sizes, (64, 8, 64, 8)):
        monkeypatch.setattr(P, k, v)
    entry = P.bench_faults(rounds=3, log_path=str(tmp_path / "p.json"),
                           device="cpu")
    _assert_keys(entry, _ref_rows("faults")["checksum_plus_checkpointing"])
    r = entry["result"]
    assert r["checkpoints_retained"] == 3
    assert r["workload"] == "dictlearn p=64 K=8 ista_iters=30"
    assert (r["cohort_size"], r["n_clients"]) == (8, 32)
    assert r["overhead_budget_met"] == (r["overhead_frac"] < 0.05)


# ---------------------------------------------------------------------------
# the log and the entry points
# ---------------------------------------------------------------------------

def _entry_text(entry: dict) -> str:
    """An entry as ``json.dump(log, indent=1)`` writes it inside the
    log's list."""
    return "\n".join(" " + line
                     for line in json.dumps(entry, indent=1).splitlines())


def test_writing_keeps_the_kernel_bench_entry_byte_identical(tmp_path):
    committed = ROOT / "results" / "perf_log_torch.json"
    (bench,) = [e for e in json.loads(committed.read_text())
                if e["pair"] == "kernel_bench_smoke"]
    assert _entry_text(bench) in committed.read_text()
    log = tmp_path / "perf_log_torch.json"
    log.write_text(json.dumps([bench], indent=1) + "\n")
    P.write_log(str(log), "wire", [{"pair": "wire", "variant": "a"}])
    P.write_log(str(log), "wire", [{"pair": "wire", "variant": "b"}])
    P.write_log(str(log), "hier", [{"pair": "hier", "variant": "c"}])
    text = log.read_text()
    assert _entry_text(bench) in text
    assert [(e["pair"], e.get("variant")) for e in json.loads(text)] == \
        [("kernel_bench_smoke", "baseline"), ("wire", "b"), ("hier", "c")]


def test_timed_modes_refuse_the_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = str(tmp_path / "p.json")
    for mode in ("driver", "wire", "collective", "hier", "scheduler",
                 "faults"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.main([f"--{mode}", "--log", log])
    assert not os.path.exists(log)


def test_main_runs_a_mode_on_the_cpu(tmp_path, capsys):
    log = tmp_path / "p.json"
    P.main(["--hier", "--rounds", "1", "--device", "cpu", "--log", str(log)])
    assert "[hier]" in capsys.readouterr().out
    assert [e["variant"] for e in json.loads(log.read_text())] == \
        ["two_tier_raw", "two_tier_reencode"]
    with pytest.raises(SystemExit):
        P.main(["--log", str(log)])


def test_pairs_table_is_the_reference_table(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import perf_iterations as jperf
    assert P.PAIRS == jperf.PAIRS


# ---------------------------------------------------------------------------
# the dry run's pairs (the subprocesses)
# ---------------------------------------------------------------------------

def test_pair_decode_counts_every_variant(pair_runs):
    recs = _pair_records(pair_runs, "decode")
    assert [e["variant"] for e in recs] == [
        "baseline", "int8_kv_cache", "tp_resident", "tp_megatron"]
    for e in recs:
        assert e["result"]["status"] == "ok", e["result"].get("error")
        assert (e["arch"], e["shape"], e["multi_pod"]) == \
            ("mistral-large-123b", "decode_32k", False)
        assert e["card"] is None and "no time" in e["counted"]
        assert e["result"]["seconds"] > 0
    by = {e["variant"]: e["result"] for e in recs}
    assert by["int8_kv_cache"]["bytes_per_device"] < \
        by["baseline"]["bytes_per_device"]


def test_pair_train_counts_the_asked_variant(pair_runs):
    recs = _pair_records(pair_runs, "train")
    assert [e["variant"] for e in recs] == ["baseline", "no_cv"]
    by = {e["variant"]: e["result"] for e in recs}
    for r in by.values():
        assert r["status"] == "ok", r.get("error")
    assert by["no_cv"]["memory"]["peak_bytes"] < \
        by["baseline"]["memory"]["peak_bytes"]

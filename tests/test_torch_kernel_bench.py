"""The port's kernel microbenchmarks (``repro_torch.benchmarks.
kernel_bench``) and their gate (``check_kernel_bench``).

On the CPU: a ``--smoke`` run through ``benchmarks.run kernels`` prints
the reference's CSV contract (``name,us_per_call,derived``) with the
route in each timed row's name, dumps the same rows as JSON, and its
``wire_bytes`` rows equal the reference's committed ones byte for byte.
``pairs`` hands each kernel row's call beside its plain version, and a
row's time is the median of its timings. The gate
runs on rows made up here: the drift factor, FAIL past ``--tol``, NEW
and GONE rows, no baseline, a CPU run's rows never compared with a card
run's, the median over several runs, and the baseline written from
them. The card run of ``--smoke`` is marked ``cuda`` and skips here. No
JAX.
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import check_kernel_bench, kernel_bench
from repro_torch.benchmarks import run as bench_run
from repro_torch.benchmarks.timing import bound, time_ms
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS_F32

REPO = Path(__file__).resolve().parents[1]

CPU_NAMES = [
    "quantize_block_ref_4k_cpu", "quantize_block_plain_4k",
    "quantize_compressor_hash_4k_cpu", "quantize_compressor_uniform_4k_cpu",
    "quantize_grouped_streamed_dither_16x1024_cpu",
    "quantize_grouped_kernel_dither_16x1024_cpu",
    "quantize_encode_streamed_dither_16x1024_cpu",
    "quantize_encode_kernel_dither_16x1024_cpu",
    "wire_bytes_b8_16x1024", "wire_bytes_b4_16x1024",
    "flash_attention_ref_128_cpu", "flash_attention_plain_128",
    "rwkv_scan_ref_64_cpu", "rwkv_scan_plain_64",
]


def _reference_rows():
    """The reference's committed kernel_bench --smoke rows."""
    log = json.loads((REPO / "results" / "perf_log.json").read_text())
    entry = next(e for e in log if e.get("pair") == "kernel_bench_smoke")
    return entry["result"]["rows"]


def _card_names(cpu_names):
    return [n.replace("_plain_", "_cuda_").removesuffix("_cpu")
            for n in cpu_names]


def test_cpu_smoke_csv_and_json(tmp_path, capsys):
    out = tmp_path / "rows.json"
    bench_run.main(["kernels", "--smoke", "--device", "cpu",
                    "--json", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    csv = [ln.split(",", 2) for ln in lines]
    assert [c[0] for c in csv] == CPU_NAMES
    dumped = json.loads(out.read_text())
    assert [r["name"] for r in dumped] == CPU_NAMES
    for (name, us, derived), row in zip(csv, dumped):
        assert set(row) == {"name", "us", "derived"}
        assert us == f"{row['us']:.1f}" and derived == row["derived"]
        assert (row["us"] > 0) == (not name.startswith("wire_bytes_"))
    # the card's names are the reference's, pallas_interp -> cuda
    ref_names = [r["name"].replace("pallas_interp", "cuda")
                 for r in _reference_rows()]
    assert _card_names(CPU_NAMES) == ref_names
    # no CPU timed row shares a name with a card row
    timed = [n for n in CPU_NAMES if not n.startswith("wire_bytes_")]
    assert not set(timed) & set(ref_names)


def test_wire_bytes_rows_equal_the_reference():
    rows = {name: (us, derived) for name, us, derived in
            kernel_bench.run(smoke=True, device="cpu")}
    want = {r["name"]: (r["us"], r["derived"]) for r in _reference_rows()
            if r["name"].startswith("wire_bytes_")}
    assert want == {
        "wire_bytes_b8_16x1024": (0.0, "packed=16640B f32=65536B "
                                       "ratio=3.94x analytic_match=1"),
        "wire_bytes_b4_16x1024": (0.0, "packed=8448B f32=65536B "
                                       "ratio=7.76x analytic_match=1")}
    assert {n: rows[n] for n in want} == want


def test_pairs_are_the_kernel_rows_on_their_tensors():
    """``pairs`` names each kernel row of ``run`` and hands its call and
    its plain version on the same tensors: on the CPU the wrapper runs
    the plain version, so the two agree bit for bit."""
    pairs = kernel_bench.pairs(smoke=True, device="cpu")
    assert [name for name, _, _ in pairs] == [
        n for n in CPU_NAMES if "_plain_" in n or "_dither_" in n]
    for name, kern, plain in pairs:
        got, want = kern(), plain()
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name


def test_repeat_takes_each_rows_median(monkeypatch):
    """Each timed row is timed ``repeat`` times in turns over the rows,
    and its time is the median of those timings."""
    ticks = iter(range(1, 1000))
    monkeypatch.setattr(kernel_bench, "time_ms",
                        lambda fn, iters, warmup, cuda: next(ticks) / 1e3)
    rows = kernel_bench._rows(True, torch.device("cpu"), 3)
    timed = [name for name, us, _ in rows if us > 0]
    assert timed == [n for n in CPU_NAMES if not n.startswith("wire_bytes_")]
    # pass p times row i at tick 1 + p * n + i: the middle pass's tick
    n = len(timed)
    assert [us for _, us, _ in rows if us > 0] == pytest.approx(
        [1 + n + i for i in range(n)])


def test_timer_and_bound_on_the_cpu():
    calls = []
    ms = time_ms(lambda: calls.append(1), 5, warmup=2, cuda=False)
    assert len(calls) == 7 and ms >= 0.0
    # 12 bytes an element over the memory rate beats 11 operations over
    # the float32 rate: bound by bytes
    n = 1 << 20
    ms, by = bound(12 * n, 11 * n, PEAK_FLOPS_F32)
    assert by == "bytes" and ms == pytest.approx(12 * n / HBM_BW * 1e3)
    ms, by = bound(1.0, 1e12, PEAK_FLOPS_F32)
    assert by == "operations" and ms == pytest.approx(1e12 / 67e12 * 1e3)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def _write(path, rows):
    path.write_text(json.dumps([{"name": n, "us": us, "derived": ""}
                                for n, us in rows.items()]))
    return str(path)


def _baseline(path, rows, pair="kernel_bench_smoke"):
    path.write_text(json.dumps([
        {"pair": "other", "variant": "x", "result": {"rows": []}},
        {"pair": pair, "variant": "baseline", "hypothesis": "test",
         "result": {"status": "ok", "rows": [
             {"name": n, "us": us, "derived": ""}
             for n, us in rows.items()]}}]))
    return str(path)


BASE = {"quantize_block_cuda_4k": 10.0, "quantize_grouped_kernel_dither_"
        "16x1024": 20.0, "quantize_encode_kernel_dither_16x1024": 40.0,
        "flash_attention_cuda_128": 100.0, "wire_bytes_b8_16x1024": 0.0}


def _gate(tmp_path, capsys, fresh, *extra, base=BASE):
    rc = check_kernel_bench.main(
        ["--json", _write(tmp_path / "fresh.json", fresh),
         "--baseline", _baseline(tmp_path / "base.json", base), *extra])
    return rc, capsys.readouterr().out


def test_gate_passes_within_tolerance(tmp_path, capsys):
    rc, out = _gate(tmp_path, capsys, {**BASE, "quantize_block_cuda_4k": 12.0})
    assert rc == 0
    assert "drift factor (median slowdown): 1.00x" in out
    assert "ok    quantize_block_cuda_4k: 12.0us vs baseline 10.0us " \
        "(1.20x raw, 1.20x drift-adjusted)" in out
    # non-quantize rows are not gated
    assert "flash_attention" not in out and "wire_bytes" not in out


def test_gate_fails_past_tolerance(tmp_path, capsys):
    fresh = {**BASE, "quantize_block_cuda_4k": 13.0}
    rc, out = _gate(tmp_path, capsys, fresh)
    assert rc == 1
    assert "FAIL  quantize_block_cuda_4k" in out
    assert "regressed >25% on: quantize_block_cuda_4k" in out
    rc, out = _gate(tmp_path, capsys, fresh, "--tol", "0.5")
    assert rc == 0


def test_gate_divides_by_the_drift(tmp_path, capsys):
    # every row 2x slower: the median slowdown is drift, not a fault
    fresh = {n: 2 * us for n, us in BASE.items()}
    rc, out = _gate(tmp_path, capsys, fresh)
    assert rc == 0 and "drift factor (median slowdown): 2.00x" in out
    # one row 3x on top of a 2x machine: 1.5x beyond the drift fails
    fresh["quantize_block_cuda_4k"] = 60.0
    rc, out = _gate(tmp_path, capsys, fresh)
    assert rc == 1 and "(6.00x raw, 3.00x drift-adjusted)" in out
    # a faster machine never lowers the bar: drift is at least 1
    rc, out = _gate(tmp_path, capsys, {n: us / 2 for n, us in BASE.items()})
    assert rc == 0 and "drift factor (median slowdown): 1.00x" in out


def test_gate_new_and_gone_rows_do_not_fail(tmp_path, capsys):
    fresh = {"quantize_block_cuda_4k": 10.0,
             "quantize_new_row_16x1024": 5.0}
    rc, out = _gate(tmp_path, capsys, fresh)
    assert rc == 0
    assert "NEW   quantize_new_row_16x1024: 5.0us (no baseline)" in out
    assert "GONE  quantize_encode_kernel_dither_16x1024 (was 40.0us)" in out
    assert "GONE  quantize_grouped_kernel_dither_16x1024 (was 20.0us)" in out


def test_gate_cpu_rows_never_match_card_rows(tmp_path, capsys):
    # a CPU run, however slow, is NEW against a card baseline, never FAIL
    fresh = {n: 1e6 for n in CPU_NAMES}
    base = {n: 1.0 for n in _card_names(CPU_NAMES)}
    rc, out = _gate(tmp_path, capsys, fresh, base=base)
    assert rc == 0
    assert "FAIL" not in out and " ok " not in out
    assert out.count("NEW ") == sum(n.startswith("quantize_")
                                    for n in CPU_NAMES)


def test_gate_without_a_baseline_exits_0(tmp_path, capsys):
    fresh = _write(tmp_path / "fresh.json", BASE)
    rc = check_kernel_bench.main(["--json", fresh, "--baseline",
                                  str(tmp_path / "missing.json")])
    assert rc == 0 and "skipping gate" in capsys.readouterr().out
    other = _baseline(tmp_path / "base.json", BASE, pair="something_else")
    rc = check_kernel_bench.main(["--json", fresh, "--baseline", other])
    assert rc == 0 and "skipping gate" in capsys.readouterr().out


def test_gate_takes_the_median_of_several_runs(tmp_path, capsys):
    # one slow run among three does not fail the gate; two do
    runs = [BASE, {**BASE, "quantize_block_cuda_4k": 30.0}, BASE]
    paths = [_write(tmp_path / f"run{i}.json", r) for i, r in enumerate(runs)]
    base = _baseline(tmp_path / "base.json", BASE)
    args = [a for p in paths for a in ("--json", p)] + ["--baseline", base]
    assert check_kernel_bench.main(args) == 0
    assert "ok    quantize_block_cuda_4k: 10.0us" in capsys.readouterr().out
    _write(tmp_path / "run2.json", runs[1])
    assert check_kernel_bench.main(args) == 1
    assert "FAIL  quantize_block_cuda_4k: 30.0us" in capsys.readouterr().out


def test_write_baseline_from_several_runs(tmp_path, capsys, monkeypatch):
    runs = [{n: us * f for n, us in BASE.items()} for f in (1.0, 3.0, 2.0)]
    paths = [_write(tmp_path / f"run{i}.json", r) for i, r in enumerate(runs)]
    out = tmp_path / "perf_log_torch.json"
    # nvidia-smi's line, which this machine may not have
    monkeypatch.setattr(check_kernel_bench, "_card",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    rc = check_kernel_bench.main(
        [a for p in paths for a in ("--json", p)]
        + ["--write-baseline", str(out)])
    assert rc == 0 and "baseline of 3 run(s) written" in \
        capsys.readouterr().out
    (entry,) = json.loads(out.read_text())
    assert entry["pair"] == "kernel_bench_smoke"
    assert entry["variant"] == "baseline"
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in entry["hypothesis"]
    assert "median over 3 runs" in entry["hypothesis"]
    assert "kernel_bench --smoke --json" in entry["hypothesis"]
    assert {r["name"]: r["us"] for r in entry["result"]["rows"]} == \
        {n: 2 * us for n, us in BASE.items()}
    # the middle run gates clean against the medians, the fast one too
    for p in (paths[2], paths[0]):
        assert check_kernel_bench.main(["--json", p, "--baseline",
                                        str(out)]) == 0
    capsys.readouterr()


def test_write_baseline_keeps_the_other_pairs(tmp_path, monkeypatch):
    """Writing the baseline replaces the kernel_bench_smoke entry and
    keeps every other pair's rows (``perf_iterations``') as they were."""
    out = tmp_path / "perf_log_torch.json"
    others = [{"pair": "wire", "variant": "code_space_aggregation",
               "result": {"status": "ok"}},
              {"pair": "decode", "variant": "baseline", "result": {}}]
    out.write_text(json.dumps(
        [{"pair": "kernel_bench_smoke", "variant": "old"}] + others))
    monkeypatch.setattr(check_kernel_bench, "_card",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    path = _write(tmp_path / "run.json", BASE)
    assert check_kernel_bench.main(["--json", path, "--write-baseline",
                                    str(out)]) == 0
    log = json.loads(out.read_text())
    assert [e["variant"] for e in log if e["pair"] == "kernel_bench_smoke"] \
        == ["baseline"]
    assert [e for e in log if e["pair"] != "kernel_bench_smoke"] == others


def test_committed_baseline_is_a_card_run():
    log = json.loads((REPO / "results" / "perf_log_torch.json").read_text())
    (entry,) = [e for e in log if e["pair"] == "kernel_bench_smoke"]
    assert entry["pair"] == "kernel_bench_smoke"
    assert entry["variant"] == "baseline"
    assert "H100" in entry["hypothesis"] and " W" in entry["hypothesis"]
    assert "kernel_bench --smoke --json" in entry["hypothesis"]
    assert "median over" in entry["hypothesis"]
    names = [r["name"] for r in entry["result"]["rows"]]
    ref_names = [r["name"].replace("pallas_interp", "cuda")
                 for r in _reference_rows()]
    assert names == ref_names
    gated = [r for r in entry["result"]["rows"]
             if r["name"].startswith("quantize_")]
    assert len(gated) == 8 and all(r["us"] > 0 for r in gated)


@pytest.mark.cuda
def test_card_smoke_rows(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.kernels import rwkv_scan as rs
    for mod in (qb, fa, rs):
        mod.reset_launches()
    out = tmp_path / "rows.json"
    kernel_bench.main(["--smoke", "--json", str(out)])
    rows = json.loads(out.read_text())
    ref_names = [r["name"].replace("pallas_interp", "cuda")
                 for r in _reference_rows()]
    assert [r["name"] for r in rows] == ref_names
    for key in ("quantize_block", "quantize", "quantize_seeded", "encode",
                "encode_seeded"):
        assert qb.LAUNCHES[key] > 0, key
    assert fa.LAUNCHES["flash_attention"] > 0
    assert rs.LAUNCHES["rwkv_scan"] > 0
    for r in rows:
        if "_cuda_" in r["name"] or "dither_" in r["name"]:
            assert "bound_us=" in r["derived"], r
    for r in rows:
        if r["name"].startswith("wire_bytes_"):
            assert "analytic_match=1" in r["derived"], r
    # each kernel row's call against its plain version on its tensors
    # (float32: the output at the reference's attention tolerance, the
    # WKV6 state at 1e-4, as tests/test_torch_cuda_lm.py holds them)
    tols = (dict(rtol=2e-4, atol=2e-5), dict(rtol=1e-4, atol=1e-4))
    for name, kern, plain in kernel_bench.pairs(smoke=True):
        got, want = kern(), plain()
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        for a, b, tol in zip(got, want, tols):
            if name.startswith("quantize_"):
                assert torch.equal(a, b), name
            else:
                torch.testing.assert_close(a, b, **tol)

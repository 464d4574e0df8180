"""The port's bench CLI (``dcf_tpu_torch.cli``) against ``dcf_tpu``'s
(``dcf_tpu/cli.py``), on the CPU with ``--device cpu``, in process.

- the same bad argv exits non-zero in both packages, before any work;
- the shared helpers (cipher keys, the pinned-ratio helpers, the flag
  parsers) return ``dcf_tpu``'s results on the same inputs, corrupt and
  absent baseline files included;
- each subcommand's JSON line has ``dcf_tpu``'s keys (taken from a
  ``dcf_tpu`` run on its host backends where that is cheap, else pinned
  to the keys ``dcf_tpu/cli.py`` writes), plus ``"device"``, and its
  parity gates pass; a CPU line carries no ``vs_baseline``;
- a corrupted correction word makes ``dcf_batch_eval --check`` exit
  non-zero, ``--device cuda`` without a card never runs on the CPU, and
  ``python -m dcf_tpu_torch.cli`` works.

Sizes are the smallest each bench's validation allows.  The serving
benches that check against the C++ core run their facade on the port's
C++ backend here (``cpu_facade``), which keeps the file inside its time
budget; the same benches run on the kernels in ``chip_smoke.py``."""

import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from dcf_tpu import cli as jcli

import dcf_tpu_torch
from dcf_tpu_torch import cli as tcli
from dcf_tpu_torch.errors import BackendUnavailableError
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu", "--reps", "1"]
COMMON = {"bench", "backend", "metric", "value", "unit"}
MED = {"median_s", "mad_s", "samples"}
PINNED = {"vs_baseline", "baseline"}


def quantiles(prefix: str = "") -> set:
    return {f"{prefix}p{q}_s" for q in (50, 90, 99)}


def run_port(capsys, argv) -> list:
    tcli.main(argv + CPU)
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out]


def run_ref(capsys, argv) -> list:
    jcli.main(argv + ["--reps=1"])
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out]


def assert_keys(rec: dict, required: set, optional: set = frozenset()):
    """The line's keys are ``required`` (dcf_tpu's, less what a CPU line
    drops) plus ``"device"``, and at most ``optional`` besides."""
    keys = set(rec)
    assert rec["device"] == "cpu"
    assert not keys & PINNED, "a CPU line carries no vs_baseline"
    missing = (required | {"device"}) - keys
    extra = keys - required - optional - {"device"}
    assert not missing and not extra, (missing, extra)
    assert rec["value"] > 0


@pytest.fixture
def cpu_facade(monkeypatch):
    """Serve through the port's C++ core (``Dcf(backend="cpu")``)
    whatever backend the bench picks: the serving benches' host-time
    budget here."""
    base = dcf_tpu_torch.Dcf

    class CpuDcf(base):
        def __init__(self, n_bytes, lam, cipher_keys, backend="auto",
                     backend_opts=None, device=None):
            super().__init__(n_bytes, lam, cipher_keys, backend="cpu",
                             device=device)

    monkeypatch.setattr(dcf_tpu_torch, "Dcf", CpuDcf)
    monkeypatch.setattr(tcli, "_serve_backend",
                        lambda args, bench, cpu_means=None: "cpu")


# -- flag validation: the same bad argv in both packages ---------------------

BAD_ARGV = [
    (["keygen_bench", "--lam=16"], "lam >= 48"),
    (["keygen_bench", "--lam=40"], "lam >= 48"),
    (["keyfactory_bench", "--lam=8"], "lam >= 16"),
    (["keyfactory_bench", "--backend=pallas"], None),
    (["keyfactory_bench", "--backend=hybrid", "--lam=16"], "lam >= 48"),
    (["chaos_bench", "--backend=numpy", "--keyfactory", "--duration=1"],
     "crash-restart"),
    (["edge_bench", "--connections=0"], "connections"),
    (["edge_bench", "--max-batch=64", "--min-req-points=200"],
     "request-size range"),
    (["chaos_bench", "--backend=bitsliced", "--crash-restart",
      "--max-batch=64", "--min-req-points=200"], None),
    (["chaos_bench", "--backend=numpy", "--crash-restart",
      "--max-batch=64", "--min-req-points=200"], "request-size range"),
    (["chaos_bench", "--backend=numpy", "--crash-restart",
      "--fault-window=0"], "fault-window"),
    (["chaos_bench", "--backend=cpu", "--crash-restart"], "chaos_bench"),
    (["chaos_bench", "--backend=numpy", "--max-batch=64",
      "--min-req-points=200"], "request-size range"),
    (["chaos_bench", "--backend=numpy", "--fault-window=0"],
     "fault-window"),
    (["pir_bench", "--n-bits=3"], "5 <= n <= 24"),
    (["pir_bench", "--n-bits=25"], "5 <= n <= 24"),
    (["pir_bench", "--keys=-1"], "queries-per-batch"),
    (["dcf_large_lambda", "--backend=pallas"], None),
    (["dcf_large_lambda", "--lam=40"], "multiple of 16 >= 48"),
    (["full_domain", "--n-bits=12"], "multiple of 8"),
    (["dcf_batch_eval", "--backend=numpy", "--prefix-levels=6"],
     "prefix-levels"),
    (["dcf", "--backend=tree"], "full_domain"),
    (["dcf", "--backend=hybrid"], "large-lambda"),
    (["secure_relu", "--device-gen", "--backend=numpy"], "device-gen"),
    (["serve_bench", "--backend=cpu"], "serve_bench serves"),
    (["mic_bench", "--backend=cpu"], "mic_bench serves"),
    (["gate_bench", "--backend=cpu"], "gate_bench serves"),
] + [([bench, "--backend=numpy", f"--skew={bad}"], "--skew")
     for bench in ("serve_bench", "mic_bench", "chaos_bench")
     for bad in ("-1", "nan", "zipf")]


@pytest.mark.parametrize("argv,match", BAD_ARGV,
                         ids=[" ".join(a) for a, _ in BAD_ARGV])
def test_flag_validation_matches_dcf_tpu(argv, match, monkeypatch):
    """Both packages exit non-zero on the same argv; the port exits
    before it chooses a device (so before any work), with dcf_tpu's
    message where one is named."""
    def no_work(args):
        raise AssertionError("the port started work on a bad argv")

    monkeypatch.setattr(tcli, "_dev", no_work)
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code not in (0, None)
        if match:
            assert match in str(e.value.code), (main.__module__,
                                                e.value.code)


@pytest.mark.parametrize("argv,names", [
    # the pod benches run now, with dcf_tpu's own refusals
    (["serve_host"], "serve_host needs --store-dir"),
    (["pod_bench", "--shards=1"], "--shards must be >= 2"),
    # the mesh routes run now; what dcf_tpu refuses on them still exits
    (["dcf", "--backend=sharded"], "single-point latency bench"),
    (["secure_relu", "--mesh=4by2"], "--mesh wants KxP (e.g. 4x2)"),
    (["secure_relu", "--backend=sharded-pallas", "--device-gen"],
     "its own pipeline"),
    (["dcf_large_lambda", "--backend=sharded", "--mesh=1x4"],
     "lam=16 only"),
    (["dcf_batch_eval", "--backend=pallas"], "--backend walk"),
    (["dcf", "--backend=jax"], "--backend walk"),
    (["serve_bench", "--backend=bitsliced"], "--backend walk"),
    # dcf_tpu refuses this one only after its parity gate; the port
    # before any work.
    (["serve_bench", "--backend=numpy", "--edge", "--skew=1.1"],
     "run them separately"),
])
def test_later_slices_exit_before_work(argv, names, monkeypatch):
    monkeypatch.setattr(tcli, "_dev", lambda args: pytest.fail("work"))
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert names in str(e.value.code)


@pytest.mark.parametrize("argv", [
    ["pod_bench", "--mesh", "--shards=1"],
    ["pod_bench", "--mesh=4x2", "--shards=1"],
    ["pod_bench", "--backend=sharded"],
])
def test_pod_bench_mesh_is_not_the_multi_gpu_refusal(argv, monkeypatch):
    """Any non-empty --mesh on pod_bench is the co-evaluation scenario
    over shard processes (dcf_tpu's dispatch), and a sharded backend
    there meets dcf_tpu's facade-backend refusal: neither is refused
    as multi-GPU."""
    monkeypatch.setattr(tcli, "_dev", lambda args: pytest.fail("work"))
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code not in (0, None)
    assert "multi-GPU" not in str(e.value.code), e.value.code


class _FacadeBuilt(Exception):
    pass


@pytest.mark.parametrize("argv,device,backend", [
    (["pod_bench"], "cuda", "walk"),
    (["serve_host", "--store-dir", "{tmp}"], "cuda", "walk"),
    (["pod_bench", "--backend", "prefix"], "cuda", "prefix"),
    (["pod_bench", "--device", "cpu"], "cpu", "cpu"),
    (["serve_host", "--store-dir", "{tmp}", "--device", "cpu"], "cpu",
     "cpu"),
])
def test_pod_default_backend_runs_the_kernels_on_the_card(
        argv, device, backend, monkeypatch, tmp_path):
    """The default ``--backend cpu`` of serve_host / pod_bench is
    dcf_tpu's on-device walk: on the card a shard's facade is ``walk``
    (B1), and so is the backend each spawned shard is told; the C++ core
    serves only under ``--device cpu``."""
    import argparse
    import subprocess

    import torch

    built = {}

    def fake_dcf(*a, backend=None, device=None, **kw):
        built.update(backend=backend, device=device)
        raise _FacadeBuilt

    monkeypatch.setattr(tcli, "_dev", lambda args: torch.device(device))
    monkeypatch.setattr(dcf_tpu_torch, "Dcf", fake_dcf)
    with pytest.raises(_FacadeBuilt):
        tcli.main([a.replace("{tmp}", str(tmp_path)) for a in argv])
    assert built == {"backend": backend, "device": torch.device(device)}

    spawned = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, env=None: spawned.append(cmd))
    args = argparse.Namespace(
        seed=0, device=device, max_batch=0, max_delay_ms=5.0, lam=0,
        domain_bytes=0, prefix_levels=0,
        backend="prefix" if "prefix" in argv else "cpu")
    tcli._pod_spawn("s0", str(tmp_path), str(tmp_path), args)
    cmd = spawned[0]
    assert cmd[cmd.index("--backend") + 1] == backend
    assert cmd[cmd.index("--device") + 1] == device


@pytest.mark.parametrize("argv", [
    ["dcf_batch_eval", "--backend=numpy", "--shards", "8"],
    ["serve_bench", "--backend=numpy", "--port", "9000"],
    ["edge_bench", "--backend=numpy", "--partition"],
])
def test_pod_flags_belong_to_the_pod_benches(argv, monkeypatch):
    """serve_host / pod_bench's own flags are not the other benches':
    argparse refuses them there before any work."""
    monkeypatch.setattr(tcli, "_dev", lambda args: pytest.fail("work"))
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code == 2


def test_no_silent_cpu(capsys):
    """--device cuda (the default) on a host without a card exits
    non-zero and prints no line: nothing runs on the CPU unasked."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit) as e:
        tcli.main(["dcf", "--backend=numpy", "--reps=1"])
    assert "CUDA is not available" in str(e.value.code)
    assert capsys.readouterr().out == ""
    from dcf_tpu_torch.utils.provision import select_device

    with pytest.raises(BackendUnavailableError):
        select_device("cuda")


# -- shared helpers against dcf_tpu's ---------------------------------------

@pytest.mark.parametrize("lam", [16, 32, 48, 256, 16384])
def test_cipher_keys_match(lam):
    assert tcli._cipher_keys(lam, np.random.default_rng(5)) == \
        jcli._cipher_keys(lam, np.random.default_rng(5))


PIN = {
    "evals_per_sec": 5e5, "date": "x",
    "shapes": {"n32": {"evals_per_sec": 4e5},
               "lam128": {"evals_per_sec": 2e4, "anchor": "flagship"},
               "lam256": {"evals_per_sec": 1e4},
               "lam16384": {"evals_per_sec": 300.0}},
    "keygen": {"lam128": {"keys_per_sec": 50.0, "keys": 64},
               "lam256": {"keys_per_sec": 20.0, "keys": 64}},
    "protocols": {"mic_m8": {"points_per_sec": 1e3}},
    "gates": {"sigmoid_m8": {"points_per_sec": 4e6},
              "trunc": {"points_per_sec": 9e6}},
    "dpf": {"evalall_n16": {"queries_per_sec": 2.0}},
}


@pytest.fixture
def baselines(tmp_path):
    """A healthy pin, a corrupt file and an absent path."""
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(PIN))
    bad = tmp_path / "bad.json"
    bad.write_text("{ not json at all")
    return [str(ok), str(bad), str(tmp_path / "absent.json")]


def _same(fn_name, *args, interpreted_note=False, **kw):
    """The helper's result in both packages; with ``interpreted_note``
    the numerator note is the package's own, so only the ratio and the
    presence of a note are compared."""
    got = getattr(tcli, fn_name)(*args, **kw)
    want = getattr(jcli, fn_name)(*args, **kw)
    if interpreted_note and want:
        assert got["vs_baseline"] == want["vs_baseline"]
        assert "numerator" in got["baseline"]
    else:
        assert got == want
    return got


@pytest.mark.parametrize("nb,k,lam,rate", [
    (16, 1, 16, 1e6), (4, 1, 16, 8e5), (8, 1, 16, 1e6), (16, 2, 16, 1e6),
    (16, 1, 128, 4e4), (16, 1, 256, 3e4), (16, 1, 16384, 600.0),
    (16, 1, 48, 1e3)])
def test_pinned_ratio_matches(baselines, nb, k, lam, rate):
    for path in baselines:
        for interp in (False, True):
            _same("_pinned_ratio", nb, k, rate, interpreted=interp,
                  baseline_path=path, lam=lam)
    assert _same("_pinned_ratio", nb, k, rate, baseline_path=baselines[1],
                 lam=lam) == {}


@pytest.mark.parametrize("k,lam", [(64, 128), (64, 256), (8, 128),
                                   (64, 48)])
def test_keygen_ratio_matches(baselines, k, lam):
    for path in baselines:
        _same("_pinned_ratio", 16, k, 100.0, baseline_path=path, lam=lam,
              keygen=True)
        _same("_pinned_ratio", 16, k, 100.0, interpreted=True,
              baseline_path=path, lam=lam, keygen=True,
              interpreted_note=True)


def test_protocol_gate_dpf_serve_ratios_match(baselines):
    for path in baselines:
        for m in (8, 4):
            _same("_protocols_pinned_ratio", m, 2500.0, baseline_path=path)
        for tag in ("sigmoid_m8", "trunc", "sign"):
            _same("_gates_pinned_ratio", tag, 1234.5, baseline_path=path)
        for n in (14, 16, 18, 24):
            _same("_dpf_pinned_ratio", n, 4.0, baseline_path=path)
            _same("_dpf_pinned_ratio", n, 4.0, interpreted=True,
                  baseline_path=path, interpreted_note=True)
        _same("_serve_pinned_ratio", 2e6, "cuda", baseline_path=path)
    assert tcli._dpf_pinned_ratio(14, 4.0, baseline_path=baselines[0])[
        "vs_baseline"] == 0.5


def test_flag_parsers_match():
    for good in ("0", "1.1", "2"):
        assert tcli._parse_skew(good) == jcli._parse_skew(good)
    for spec in ("critical=0.2,normal=0.5,batch=0.3", "batch=1"):
        assert tcli._parse_priority_mix(spec) == \
            jcli._parse_priority_mix(spec)
    for bad in ("critical,normal=1", "urgent=1", "batch=0.2,batch=0.3",
                "critical=nan,normal=1", "critical=0,normal=0"):
        for parse in (tcli._parse_priority_mix, jcli._parse_priority_mix):
            with pytest.raises(SystemExit, match="priority-mix"):
                parse(bad)


# -- the JSON lines and their parity gates ----------------------------------

def test_dcf_and_batch_keys_match_dcf_tpu(capsys):
    ref = {r["bench"]: set(r) for r in run_ref(capsys, ["dcf",
                                                        "--backend=cpu1"])}
    port = run_port(capsys, ["dcf", "--backend", "cpu1"])
    assert [r["bench"] for r in port] == ["dcf_gen", "dcf_eval_1pt"]
    for rec in port:
        assert_keys(rec, ref[rec["bench"]] - PINNED)
    (ref,) = run_ref(capsys, ["dcf_batch_eval", "--backend=cpu",
                              "--points=64", "--check"])
    for b in ("numpy", "cpu", "walk", "prefix"):
        (rec,) = run_port(capsys, ["dcf_batch_eval", "--backend", b,
                                   "--points", "64", "--check"])
        assert rec["backend"] == b and rec["metric"] == "evals_per_sec"
        assert_keys(rec, set(ref) - PINNED)
    assert "CUDA-event" not in rec["unit"]  # a CPU run says so


def test_full_domain_keys_match_dcf_tpu(capsys):
    (ref,) = run_ref(capsys, ["full_domain", "--backend=cpu",
                              "--n-bits=8"])
    (rec,) = run_port(capsys, ["full_domain", "--backend", "tree",
                               "--n-bits", "8"])
    assert_keys(rec, set(ref) - PINNED)
    (rec,) = run_port(capsys, ["full_domain", "--backend", "walk",
                               "--n-bits", "8"])
    assert_keys(rec, set(ref) - PINNED)


KEYGEN = {"lam", "n_bytes", "device_fallbacks", "legs", "mic_intervals",
          "mic_keys_per_sec", "host_gen_batch_keys_per_sec", "platform",
          "interpreted", "repro"}
PIR = {"lam", "record_bytes", "keys", "queries_per_sec", "legs",
       "platform", "interpreted", "repro"}
GATES = MED | {"points", "pieces", "frac_bits", "group", "domain_bits",
               "max_batch", "trunc_points_per_sec", "sign_points_per_sec",
               "platform", "interpreted", "metrics_snapshot", "repro"}
HARNESSES = {
    "large_lambda": (["dcf_large_lambda", "--backend", "hybrid", "--lam",
                      "48", "--points", "32", "--prefix-levels", "6",
                      "--check"], "hybrid", MED),
    "relu_device_gen": (["secure_relu", "--keys", "2", "--points", "2",
                         "--device-gen"], "device-gen+keylanes", MED),
    "relu_keylanes": (["secure_relu", "--keys", "2", "--points", "2",
                       "--backend", "keylanes"], "keylanes", MED),
    "relu_walk": (["secure_relu", "--keys", "2", "--points", "2"], "walk",
                  MED),
    "keygen": (["keygen_bench", "--lam", "48", "--keys", "1",
                "--intervals", "1"], "device", KEYGEN),
    "pir": (["pir_bench", "--n-bits", "5", "--keys", "1"], "device", PIR),
    "gates": (["gate_bench", "--backend", "numpy", "--points", "32",
               "--intervals", "4"], "numpy", GATES),
}


@pytest.mark.parametrize("case", sorted(HARNESSES))
def test_criterion_and_device_harness_keys(case, capsys, monkeypatch):
    """The large-lambda, secure-ReLU, keygen, PIR and gate lines at their
    smallest shapes; each bench's own gates pass (keygen: keys equal to
    gen_batch's and reconstructing; PIR: records retrieved bit-exactly;
    gates: the clear-input oracles)."""
    argv, backend, keys = HARNESSES[case]
    monkeypatch.setattr(tcli, "KEYGEN_PIN_K", 1)
    (rec,) = run_port(capsys, argv)
    assert rec["backend"] == backend
    assert_keys(rec, COMMON | keys)
    if "repro" in rec:
        assert rec["repro"].startswith("python -m dcf_tpu_torch.cli ")
    if case == "keygen":
        assert rec["device_fallbacks"] == 0 and rec["interpreted"] is True
    if case == "pir":
        assert rec["legs"][0]["eval_faults"] == 0


SERVED = {"duration_s", "concurrency", "max_batch", "req_points",
          "requests_ok", "requests_shed", "requests_failed", "platform",
          "interpreted", "metrics_snapshot"}


def test_serving_benches_keys(capsys, cpu_facade):
    (rec,) = run_port(capsys, ["serve_bench", "--max-batch", "64",
                               "--bundles", "1", "--duration", "0.2",
                               "--edge"])
    assert_keys(rec, COMMON | SERVED | {
        "bundles", "wire_evals_per_sec", "wire_requests_ok",
        "wire_vs_inprocess"},
        quantiles() | {"staged_path_evals_per_sec", "serve_vs_staged"})
    (rec,) = run_port(capsys, ["edge_bench", "--max-batch", "64",
                               "--bundles", "1", "--duration", "0.2",
                               "--connections", "1"])
    assert_keys(rec, COMMON | {
        "duration_s", "connections", "max_batch", "req_points", "bundles",
        "segments_per_leg", "wire_requests_ok", "inprocess_evals_per_sec",
        "wire_vs_inprocess", "ingest_single_feed", "ingest_probe_calls",
        "open_loop_rate_rps", "open_loop_ok", "open_loop_shed",
        "open_loop_expired", "open_loop_reconciled", "refusals",
        "refusals_hinted", "soak_connections", "soak_sessions_ok",
        "soak_mismatches", "soak_reconnects", "soak_refusals",
        "soak_refusals_hinted", "soak_other_failures",
        "edge_frames_total", "edge_connection_errors_total", "platform",
        "interpreted", "repro"}, quantiles() | quantiles("open_loop_"))
    (rec,) = run_port(capsys, ["mic_bench", "--max-batch", "64",
                               "--duration", "0.2", "--intervals", "1"])
    assert_keys(rec, COMMON | SERVED | {
        "skew", "intervals", "staged_mic_points_per_sec",
        "serve_vs_staged"}, quantiles())
    (rec,) = run_port(capsys, ["chaos_bench", "--max-batch", "64",
                               "--duration", "2", "--concurrency", "3",
                               "--fault-window", "8",
                               "--breaker-failures", "2",
                               "--breaker-cooldown", "0.05"])
    assert_keys(rec, COMMON | {
        "duration_s", "concurrency", "max_batch", "fault_window",
        "fault_evals_failed", "priority_mix", "skew", "requests_ok",
        "requests_shed", "requests_failed", "by_class", "breaker_opens",
        "breaker_closes", "brownout_refusals", "metrics_snapshot",
        "assertions_failed"})
    assert rec["assertions_failed"] == []


def test_durability_benches_keys(capsys, cpu_facade, tmp_path):
    (rec,) = run_port(capsys, [
        "chaos_bench", "--crash-restart", "--keyfactory", "--max-batch",
        "64", "--bundles", "1", "--duration", "0.5", "--concurrency", "2",
        "--fault-window", "4", "--breaker-cooldown", "0.05",
        "--store-dir", str(tmp_path / "store")])
    assert_keys(rec, COMMON | {
        "scenario", "pool_published", "pool_claimed_pre_kill",
        "pool_restored", "duration_s", "concurrency", "max_batch",
        "bundles", "fault_window", "fault_evals_failed", "requests_ok",
        "requests_failed", "killed_inflight", "regen_count", "restored",
        "quarantined", "store_restored_total", "assertions_failed"})
    assert rec["regen_count"] == 0 and rec["assertions_failed"] == []
    assert (tmp_path / "store" / "MANIFEST.dcfm").exists()
    (rec,) = run_port(capsys, ["keyfactory_bench", "--lam", "16",
                               "--keys", "2", "--duration", "0.2",
                               "--host-refill"])
    assert_keys(rec, COMMON | {
        "lam", "n_bytes", "refill_batch", "device_refill",
        "device_fallbacks", "fills", "pool_hit_register_s",
        "sync_register_s", "pool_hit_speedup", "pool_hits",
        "pool_misses", "pool_hit_rate", "store_writes", "platform",
        "interpreted", "repro", "churn_duration_s", "churn_concurrency",
        "churn_sessions_ok", "churn_sessions_failed",
        "churn_sessions_per_sec"},
        quantiles("register_") | quantiles("session_"))
    assert rec["pool_hit_speedup"] >= 10


def test_baseline_runs_dcf_tpus_eight_lines(monkeypatch):
    """``baseline`` drives the same five configurations with the same
    overrides as dcf_tpu's (seven bench calls, eight lines)."""
    fields = ("backend", "points", "keys", "domain_bytes", "n_bits",
              "lam", "device_gen")

    def recorder(pkg, calls):
        return {name: (lambda a, name=name: calls.append(
            (name, {f: getattr(a, f) for f in fields})))
            for name in pkg.BENCHES}

    got, want = [], []
    monkeypatch.setattr(tcli, "BENCHES", recorder(tcli, got))
    monkeypatch.setattr(jcli, "BENCHES", recorder(jcli, want))
    tcli.main(["baseline", "--device", "cpu"])
    jcli.main(["baseline"])
    assert got == want and len(got) == 7
    assert got[1] == ("dcf_batch_eval", {
        "backend": "prefix", "points": 1 << 20, "keys": 1,
        "domain_bytes": 0, "n_bits": 0, "lam": 0, "device_gen": False})


def test_planted_fault_fails_check(capsys, monkeypatch):
    """One corrupted correction word (level 0's cw_v of the key both
    parties share) makes dcf_batch_eval --check exit non-zero: the C++
    anchor agrees with the corrupt key, the two-party count does not."""
    from dcf_tpu_torch.keys import KeyBundle
    from dcf_tpu_torch.native import NativeDcf

    real = NativeDcf.gen_batch

    def corrupt(self, *a, **kw):
        b = real(self, *a, **kw)
        cw_v = b.cw_v.copy()
        cw_v[0, 0, 0] ^= 0x01
        return KeyBundle(s0s=b.s0s, cw_s=b.cw_s, cw_v=cw_v, cw_t=b.cw_t,
                         cw_np1=b.cw_np1, group=b.group)

    monkeypatch.setattr(NativeDcf, "gen_batch", corrupt)
    with pytest.raises(SystemExit) as e:
        run_port(capsys, ["dcf_batch_eval", "--backend", "walk",
                          "--points", "64", "--check"])
    assert "mismatching points" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_module_entry():
    out = subprocess.run(
        [sys.executable, "-m", "dcf_tpu_torch.cli", "dcf", "--backend",
         "numpy", "--device", "cpu", "--reps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    recs = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [r["bench"] for r in recs] == ["dcf_gen", "dcf_eval_1pt"]
    assert all(r["device"] == "cpu" and math.isfinite(r["value"])
               for r in recs)


# -- the device mesh on CPU positions (DCF_CPU_DEVICES) ---------------------

MESH_RUNS = {
    "batch_sharded_pallas": (
        ["dcf_batch_eval", "--backend", "sharded-pallas", "--points", "64",
         "--domain-bytes", "2", "--check"], "sharded-pallas", MED),
    "batch_prefix_mesh": (
        ["dcf_batch_eval", "--backend", "prefix", "--mesh", "1x4",
         "--points", "64", "--domain-bytes", "2", "--check"],
        "prefix --mesh=1x4", MED),
    "relu_sharded": (
        ["secure_relu", "--backend", "sharded", "--mesh", "2x2", "--keys",
         "4", "--points", "4"], "sharded", MED),
    "relu_sharded_pallas": (
        ["secure_relu", "--backend", "sharded-pallas", "--mesh", "2x2",
         "--keys", "40", "--points", "4"], "sharded-keylanes-pallas", MED),
    "full_domain_tree_mesh": (
        ["full_domain", "--backend", "tree", "--mesh", "2x2", "--n-bits",
         "16"], "tree", MED),
    "hybrid_mesh": (
        ["dcf_large_lambda", "--backend", "hybrid", "--lam", "48", "--mesh",
         "2x2", "--keys", "2", "--points", "32", "--prefix-levels", "6",
         "--check"], "hybrid (K=2)", MED),
}


@pytest.mark.parametrize("case", sorted(MESH_RUNS))
def test_mesh_routes_on_cpu_positions(case, capsys, monkeypatch):
    """``DCF_CPU_DEVICES=4`` runs the sharded routes on four CPU
    positions (dcf_tpu's virtual-device mode), without ``--device cpu``:
    each line has dcf_tpu's name for the route and keys, says ``"device":
    "cpu"``, and its parity gates passed."""
    monkeypatch.setenv("DCF_CPU_DEVICES", "4")
    argv, backend, keys = MESH_RUNS[case]
    tcli.main(argv + ["--reps", "1"])
    out = capsys.readouterr()
    (rec,) = [json.loads(line) for line in out.out.strip().splitlines()]
    assert rec["backend"] == backend
    assert_keys(rec, COMMON | keys)
    assert "mesh: {" in out.err and "forced 4 CPU positions" in out.err


def test_mesh_routes_need_a_device(monkeypatch):
    """A mesh the host cannot hold exits non-zero with make_mesh's text
    (dcf_tpu's "requested N devices, have M"); without CUDA and without
    DCF_CPU_DEVICES a mesh route never runs on the CPU."""
    monkeypatch.setenv("DCF_CPU_DEVICES", "4")
    with pytest.raises(SystemExit) as e:
        tcli.main(["full_domain", "--backend", "tree", "--mesh", "4x4",
                   "--n-bits", "16"])
    assert "requested 16 devices, have 4" in str(e.value.code)
    monkeypatch.delenv("DCF_CPU_DEVICES")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")  # pragma: no cover
    with pytest.raises(SystemExit) as e:
        tcli.main(["dcf_batch_eval", "--backend", "sharded", "--points",
                   "4"])
    assert e.value.code not in (0, None)
    assert "CUDA is not available" in str(e.value.code)


@pytest.mark.parametrize("backend", ["sharded", "sharded-pallas", "walk"])
def test_all_skips_what_dcf_tpu_skips(backend, monkeypatch, capsys):
    """``all`` runs the same benches as dcf_tpu's for each backend: the
    sharded ones skip ``dcf`` (one point is not shardable) and the
    large-lambda bench (lam = 16 backends)."""
    ran = {}
    for mod in (tcli, jcli):
        names = ran.setdefault(mod.__name__, [])
        monkeypatch.setattr(mod, "BENCHES", {
            k: (lambda args, k=k, names=names: names.append(k))
            for k in mod.BENCHES})
    tcli.main(["all", "--backend", backend])
    jcli.main(["all", "--backend",
               "pallas" if backend == "walk" else backend])
    assert ran[tcli.__name__] == ran[jcli.__name__]
    if backend != "walk":
        assert "dcf" not in ran[tcli.__name__]
        assert "skipping dcf (single-point bench" in capsys.readouterr().err

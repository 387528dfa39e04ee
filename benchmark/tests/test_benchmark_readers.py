"""The metric readers, the kernels' bound and the trace arithmetic on
recorded laps, spans, launches and kernel times; BENCHMARK.json against
the files it names."""

import json
import math
import re

import pytest

from harness import roofline, spec, trace

BENCH = spec.benchmark()
RUN = {
    "setup_s": 12.5, "window_s": 10.0, "device_peak_bytes": 3 * 2 ** 30,
    "proofs": [
        {"latency_s": 2.0 + 0.1 * i,
         "laps": {"stage params (host->device)": 0.2,
                  "stage inputs (host->device)": 0.1,
                  "H pipeline (device NTT)": 1.0 + i,
                  "scalar from_monty (device)": 0.01,
                  "MSMs (device Pippenger)": 2.0,
                  "readback + host assembly": 0.05},
         "spans": {"load params": 0.5, "load inputs": 0.25}}
        for i in range(5)],
    "trace": None,
}


def value(name, run=RUN):
    return spec.reader(name).read(run)


def test_end_to_end_readers():
    assert value("setup_s") == 12.5
    assert value("proof_s") == 2.0
    assert math.isclose(value("proof_p95_s"), 2.4)       # 5 proofs: the max
    assert value("device_peak_gib") == 3.0
    lat = {"proofs": [{"latency_s": float(i)} for i in range(1, 101)]}
    assert value("proof_p95_s", lat) == 95.0             # nearest rank


def test_per_layer_readers_on_laps_and_spans():
    assert math.isclose(value("prover.stage_s"), 0.3)
    assert math.isclose(value("ntt.h_s"), 3.0)
    assert math.isclose(value("msm.msm_s"), 2.0)
    assert math.isclose(value("epilogue.assembly_s"), 0.05)
    assert math.isclose(value("files.load_s"), 0.75)
    served = dict(RUN, proofs=[dict(p, spans={}) for p in RUN["proofs"]])
    assert value("files.load_s", served) is None         # nothing to read
    assert value("kernels.roofline_pct") is None         # untraced
    assert value("device.idle_pct") is None


PEAKS = (16.0e12, 3.0e12)
LAUNCHES = [
    ("g16_mont_mul", (0, None, None, None, 1 << 20, None)),
    ("g16_ec_op_1", (0, None, None, None, None, 1000, None)),      # Fq2 add
    ("g16_ec_op_0", (1, None, None, None, None, 4000, None)),      # G1 dbl
    ("g16_ec_op_3", (2, None, None, None, None, 10, None)),        # Fq3 mix
    ("g16_msm_scan_2", (None, None, None, None, 128, 4096, None, None,
                        None, None, None, None)),
    ("g16_error_string", (3,)),
]


def test_kernel_bounds_by_hand():
    ks = spec.kernels()
    got = roofline.bound_seconds(ks, LAUNCHES, *PEAKS)
    mm = max((1 << 20) * 2304 / 16e12, (1 << 20) * 288 / 3e12)
    add = max(1000 * 40 * 2304 / 16e12, 1000 * 9 * 2 * 96 / 3e12)
    dbl = max(4000 * 13 * 2304 / 16e12, 4000 * 6 * 96 / 3e12)
    mix = max(10 * 72 * 2304 / 16e12, 10 * (8 * 3 * 96 + 1) / 3e12)
    scan_b = 128 * 4096 * (2 * 96 + 9) + 127 * 4096 * (3 * 96 + 1) \
        + 4096 * (6 * 96 + 1)
    scan = max(127 * 4096 * 13 * 2304 / 16e12, scan_b / 3e12)
    want = {"mont_mul": (mm, 1), "ec_add": (add, 1), "ec_dbl": (dbl, 1),
            "ec_mixed_add": (mix, 1), "msm_scan": (scan, 1)}
    for name, (b, n) in want.items():
        assert math.isclose(got[name][0], b) and got[name][1] == n, name


def test_roofline_reader():
    ks = spec.kernels()
    bound = sum(b for b, _ in roofline.bound_seconds(ks, LAUNCHES,
                                                     *PEAKS).values())
    kernel_s = {"void k_mont_mul<0>(unsigned int const*, unsigned int "
                "const*, unsigned int*, long long)": 0.001,
                "void (anonymous namespace)::k_ec_add(unsigned int const*, "
                "unsigned int const*, unsigned int*, long long)": 0.002,
                "void (anonymous namespace)::k_ec_mixed_add(...)": 0.0005,
                "void (anonymous namespace)::k_ec_dbl(...)": 0.0025,
                "void (anonymous namespace)::k_msm_scan(...)": 0.05,
                "void at::native::elementwise_kernel<128, 2>(...)": 9.0}
    run = dict(RUN, trace={"window_s": 10.0, "busy_s": 7.5,
                           "kernel_s": kernel_s, "launches": LAUNCHES,
                           "peaks": PEAKS + ({},)})
    assert math.isclose(value("kernels.roofline_pct", run),
                        100 * bound / 0.056)
    assert math.isclose(value("device.idle_pct", run), 25.0)
    nopeak = dict(run, trace=dict(run["trace"], peaks=None))
    assert value("kernels.roofline_pct", nopeak) is None


def test_device_seconds_matches_whole_names():
    ks = {"void (anonymous namespace)::k_ec_add(int)": 1.0,
          "void (anonymous namespace)::k_ec_mixed_add(int)": 2.0,
          "void k_mont_mul<1>(int)": 4.0}
    assert trace.device_seconds(ks, "k_ec_add") == 1.0
    assert trace.device_seconds(ks, "k_ec_mixed_add") == 2.0
    assert trace.device_seconds(ks, "k_mont_mul") == 4.0
    assert trace.short_name("void (anonymous namespace)::k_ec_add(unsigned"
                            " int const*)") == "k_ec_add"
    assert trace.short_name("void at::native::vectorized_elementwise_kernel"
                            "<4, at::native::X>(int, T)") == \
        "at::native::vectorized_elementwise_kernel"


def test_idle_gaps_by_innermost_block():
    notes = [(0, 100, "prove"), (10, 40, "H"), (60, 90, "MSM")]
    segs = trace._innermost(notes, 0, 120)
    assert segs == [(0, 10, "prove"), (10, 40, "H"), (40, 60, "prove"),
                    (60, 90, "MSM"), (90, 100, "prove"),
                    (100, 120, trace.OUTSIDE)]
    gaps = [(5, 15), (50, 65), (95, 120)]
    got = {}
    for s, e, label in trace._overlaps(gaps, segs):
        got[label] = got.get(label, 0) + e - s
    assert got == {"prove": 5 + 10 + 5, "H": 5, "MSM": 5,
                   trace.OUTSIDE: 20}


def test_read_profile_on_the_cpu():
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with torch.profiler.record_function(trace.PREFIX + "H"):
                torch.ones(1000).sum()
    out = trace.read_profile(prof)
    assert out["busy_s"] == 0 and out["window_s"] > 0
    assert out["breakdown"]["device_ops"] == []
    labels = [k for k, _ in out["breakdown"]["idle_gaps"]]
    assert "H" in labels and len(labels) <= 10


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_its_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = spec.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"] == []
        assert c["source"].split()[0] == cfg["source"].split()[0]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert spec.mix(w["traffic"])["entry"] in ("session", "cli")
        assert any(c["name"] == w["config"] for c in BENCH["configs"])
        e2e = spec.metrics_for(BENCH, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert spec.metrics_for(BENCH, w["name"], True)
    for m in BENCH["end_to_end"]:
        r = spec.reader(m["name"])
        assert (m["unit"], m["better"], m["source"]) == \
            (r.UNIT, r.BETTER, r.SOURCE)
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in BENCH["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]
    for m in BENCH["per_layer"]:
        r = spec.reader(m["name"])
        assert (m["layer"], m["unit"], m["moves"], m["source"]) == \
            (r.LAYER, r.UNIT, r.MOVES, r.SOURCE)
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for name in ([c["name"] for c in BENCH["configs"]]
                 + [w["name"] for w in BENCH["workloads"]]
                 + [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]):
        assert NAME.match(name), name
    # every run of a full check, at the full 24 cells, fits in 12 hours
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_kernel_files():
    ks = spec.kernels()
    assert set(ks) == {"mont_mul", "ec_add", "ec_dbl", "ec_mixed_add",
                       "msm_scan"}
    for k in ks.values():
        assert k["mads_per_fq_product"] == 2 * 2 * 24 * 24
        assert k["derivation"]
    with open(spec.HERE / "peaks.json") as f:
        assert json.load(f)["int32_mad_per_sm_per_clock"] == 64


class _Event:
    def __init__(self, name, cuda):
        self._name, self._cuda = name, cuda

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"


@pytest.mark.parametrize("name,cuda,kind", [
    ("void (anonymous namespace)::k_msm_scan(...)", True, "kernel"),
    ("Memcpy HtoD (Pageable -> Device)", True, "gpu_memcpy"),
    ("Memset (Device)", True, "gpu_memset"),
    ("Stream Sync", True, "cuda_sync"),
    (trace.PREFIX + "H pipeline (device NTT)", True, "gpu_user_annotation"),
    (trace.PREFIX + "H pipeline (device NTT)", False, "user_annotation"),
    ("aten::add", False, "cpu_op")])
def test_event_kinds_by_device_and_name(name, cuda, kind):
    assert trace._kind(_Event(name, cuda)) == kind

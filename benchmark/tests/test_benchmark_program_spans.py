"""The program's own spans and counters (utils/profiling.py) under the
benchmark, on the CPU at 2^4:

- every old reader reads the same value from a proof's record as from
  the record the program wrote before it had spans (its block laps
  alone);
- the three readers of the new spans and counter on a synthetic record,
  and on the real records;
- `#msm.host_syncs` is one per `prop.any()` the carry chain reads;
- the harness's hooks (harness/trace.open_patches) still see the six
  blocks and the three loaders, and no program span becomes a profiler
  event, a device op or an idle-gap label."""

import math
from contextlib import ExitStack

import pytest
import torch

from groth16_ref import curves, keys
from harness import spec, trace

from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.models.preprocess_device import \
    run_preprocess
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.utils import profiling as P

NAME, LOG2 = "MNT4753", 4
# the labels of the record before the program had spans: its blocks
BLOCKS = {"stage params (host->device)", "stage inputs (host->device)",
          "H pipeline (device NTT)", "scalar from_monty (device)",
          "MSMs (device Pippenger)",
          "MSMs (device: Straus tables + Pippenger A/H)",
          "readback + host assembly"}
OLD_READERS = ["prover.stage_s", "ntt.h_s", "msm.msm_s",
               "epilogue.assembly_s", "prover.stage_s.host", "ntt.h_s.host",
               "msm.msm_s.host", "epilogue.assembly_s.host", "files.load_s"]
NEW_READERS = ["ntt.addsub_s.host", "msm.host_syncs", "files.self_s.host"]


def _params(base):
    q = {k: keys.query_rows(k, LOG2, base) for k in keys.QUERIES}
    sz = keys.sizes(LOG2)
    return GP.DeviceParams(sz["d"], sz["m"], q["A"], q["B1"], q["B2"],
                           q["L"], q["H"])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A session proof and a `prove_files` beside a table file, both
    under the harness's patches inside one CPU profile: each one's
    record (laps), loader spans and the profile's events."""
    enabled, threads = P._enabled, torch.get_num_threads()
    P.set_profiling_enabled(False)
    torch.set_num_threads(2)
    try:
        return _record(tmp_path_factory.mktemp("files"))
    finally:
        P.set_profiling_enabled(enabled)
        torch.set_num_threads(threads)


def _record(work):
    """The fixture's two requests, with printing off and two threads."""
    rc = curves.CURVES[NAME]
    curve = CURVES[NAME]
    base = keys.base_rows(rc)
    params_path, input_path = str(work / "params"), str(work / "input")
    table_path = str(work / f"{NAME}_preprocessed")
    stream = keys.InputStream(rc, LOG2, 11, "cpu")
    v = stream.next()
    keys.write_params(params_path, LOG2, base)
    keys.write_input(input_path, rc, stream.next())
    run_preprocess(curve, params_path, table_path, device="cpu")
    spans, notes = trace.Spans(), trace.Annotations()
    out = {}
    with ExitStack() as stack, pytest.MonkeyPatch.context() as mp:
        mp.setenv("GROTH16_PREPROCESSED_PATH", table_path)
        trace.open_patches(stack, trace.Launches(), spans, notes)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        stack.enter_context(prof)
        stack.enter_context(torch.profiler.record_function(trace.WINDOW))
        P.clear_laps()
        sess = GP.ProverSession(curve, _params(base), "cpu")
        sess.prove(GP.DeviceInput(v[0].T, v[1].T, v[2].T, v[3].T, v[4]))
        out["serve"] = (P.last_laps(), spans.take(), P.last_spans())
        P.clear_laps()
        GP.prove_files(curve, params_path, input_path, str(work / "proof"),
                       device="cpu")
        out["files"] = (P.last_laps(), spans.take(), P.last_spans())
    events = [e.name() for e in prof.profiler.kineto_results.events()]
    return out, events, trace.read_profile(prof)


def _run(laps, spans):
    return {"proofs": [{"laps": laps, "spans": spans}], "trace": None}


@pytest.mark.parametrize("record", ["serve", "files"])
@pytest.mark.parametrize("metric", OLD_READERS)
def test_old_reader_reads_the_same_with_and_without_new_spans(traced,
                                                              record,
                                                              metric):
    laps, spans, _ = traced[0][record]
    old = {k: v for k, v in laps.items() if k in BLOCKS}
    assert set(laps) > set(old) and old
    read = spec.reader(metric).read
    got = read(_run(laps, spans))
    assert got == read(_run(old, spans))
    if metric != "files.load_s" or record == "files":
        assert got is not None and got > 0


def test_new_readers_on_a_synthetic_record():
    laps = [{"H pipeline (device NTT)": 0.6, "ntt.addsub": 0.4 + i / 10,
             "self:ntt.addsub": 0.4 + i / 10, "#msm.host_syncs": 100 + i,
             "files.compute": 2.0, "self:files.compute": 0.1 * (i + 1)}
            for i in range(3)]
    run = {"proofs": [{"laps": x, "spans": {}} for x in laps],
           "trace": None}
    want = {"ntt.addsub_s.host": 0.5, "msm.host_syncs": 101,
            "files.self_s.host": 0.2}
    for name, value in want.items():
        assert math.isclose(spec.reader(name).read(run), value)
    # a record without the spans (the parent's): nothing to read
    parent = {"proofs": [{"laps": {"H pipeline (device NTT)": 0.6},
                          "spans": {}}], "trace": None}
    assert all(spec.reader(n).read(parent) is None for n in NEW_READERS)
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_READERS:
        r = spec.reader(name)
        assert entries[name]["source"] == "program_span" == r.SOURCE


def test_new_readers_on_the_real_records(traced):
    serve, files = traced[0]["serve"], traced[0]["files"]
    read = {n: spec.reader(n).read for n in NEW_READERS}
    syncs = read["msm.host_syncs"](_run(serve[0], serve[1]))
    assert syncs == int(syncs) > 0
    addsub = read["ntt.addsub_s.host"](_run(serve[0], serve[1]))
    assert 0 < addsub < spec.reader("ntt.h_s.host").read(
        _run(serve[0], serve[1]))
    assert read["files.self_s.host"](_run(serve[0], serve[1])) is None
    own = read["files.self_s.host"](_run(files[0], files[1]))
    assert 0 < own < files[0]["files.compute"]


def test_host_syncs_are_the_carry_chain_reads(monkeypatch):
    """On a CPU MSM (rows resident, no upload events) the counter equals
    the number of `Tensor.any` calls, each read on the host."""
    torch.set_num_threads(2)
    calls = []
    real = torch.Tensor.any

    def counted(self, *a, **k):
        calls.append(self.shape)
        return real(self, *a, **k)
    curve = CURVES[NAME]
    base = keys.base_rows(curves.CURVES[NAME])
    rows = torch.from_numpy(keys.query_rows("A", LOG2, base)[:16].copy())
    g = torch.Generator().manual_seed(3)
    scalars = torch.randint(0, 2 ** 31, (24, 16), generator=g,
                            dtype=torch.int32)
    scalars[-1] = 0
    P.clear_laps()
    monkeypatch.setattr(torch.Tensor, "any", counted)
    M.msm_window_sums(get_curve_ops(curve, "g1"), scalars, rows, 8, 4,
                      signed=True)
    monkeypatch.undo()
    assert P.last_laps()["#msm.host_syncs"] == len(calls) >= 1


@pytest.mark.parametrize("record", ["serve", "files"])
def test_hooks_see_six_blocks_and_three_loaders(traced, record):
    (laps, spans, timeline), events = traced[0][record], traced[1]
    notes = {e[len(trace.PREFIX):] for e in events
             if e.startswith(trace.PREFIX)}
    blocks = {k for k in laps if k in BLOCKS}
    assert len(blocks) == 6 and blocks <= notes
    if record == "files":
        assert set(spans) == set(trace.Spans.LOADERS.values()) <= notes
        assert {"files.compute", "files.load_params", "files.load_inputs",
                "files.load_preprocessing", "files.store",
                "msm.straus_trees"} <= {s[0] for s in timeline}
    else:
        assert spans == {}


def test_no_program_span_in_the_profile_or_breakdown(traced):
    out, events, prof = traced
    names = {s[0] for rec in out.values() for s in rec[2]} - BLOCKS
    assert {"proof", "ntt.addsub", "msm.carry"} <= names
    assert names.isdisjoint(events)
    labels = {k for k, _ in prof["breakdown"]["idle_gaps"]}
    devops = {k for k, _ in prof["breakdown"]["device_ops"]}
    assert labels <= BLOCKS | set(trace.Spans.LOADERS.values()) | {
        trace.OUTSIDE}
    assert names.isdisjoint(labels | devops)

"""The port's block timers and span record (utils/profiling.py) against
the JAX package's block timers: the same calls give the same block keys
and lines; printing follows set_profiling_enabled while the record is
always kept; silent spans stand where the JAX package's PhaseTimer
stands.  The record sums repeats, keeps self times and counters, starts
anew after a root span, is bounded, and its timeline is on the
profiler's clock; the program opens no profiler range."""

import math
import time

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.utils import profiling as JP
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.host import ec as host_ec
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops import ntt as N
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.utils import profiling as TP

DATA = "tests/data/torch_port"


@pytest.fixture(autouse=True)
def restore_profiling():
    """Both modules keep process-wide state: leave it as found."""
    saved = [(m, m._enabled, m.last_laps()) for m in (JP, TP)]
    stack = list(TP._stack)
    yield
    TP._stack[:] = stack
    for m, enabled, laps in saved:
        m.set_profiling_enabled(enabled)
        m.clear_laps()
        m._last_laps.update(laps)


def seconds_keys(laps) -> set:
    """The record's span labels (no self times, no counters)."""
    return {k for k in laps if not k.startswith((TP.SELF, TP.COUNT))}


def drive(mod):
    """The same nested blocks and context-manager block."""
    mod.clear_laps()
    mod.enter_block("outer")
    mod.enter_block("inner")
    mod.leave_block("inner")
    with mod.block("ctx"):
        pass
    mod.leave_block("outer")
    return mod.last_laps()


def jax_phases() -> dict:
    timer = JP.PhaseTimer()
    timer.lap("load")
    timer.lap("prove")
    timer.total()
    return timer.laps


def port_phases() -> dict:
    """The PhaseTimer's laps as the port takes them: silent spans."""
    TP.clear_laps()
    with TP.span("total"):
        with TP.span("load"):
            pass
        with TP.span("prove"):
            pass
    return {k: v for k, v in TP.last_laps().items()
            if k in seconds_keys(TP.last_laps())}


@pytest.mark.parametrize("enabled", [True, False], ids=["enabled",
                                                        "disabled"])
def test_same_laps_keys_as_jax(enabled, capsys):
    JP.set_profiling_enabled(enabled)
    TP.set_profiling_enabled(enabled)
    j_laps = drive(JP)
    jax_err = capsys.readouterr().err
    j_timer = jax_phases()
    capsys.readouterr()
    t_laps = drive(TP)
    port_err = capsys.readouterr().err
    t_timer = port_phases()
    assert capsys.readouterr().err == ""           # spans never print
    assert seconds_keys(t_laps) == set(j_laps) == {"outer", "inner", "ctx"}
    assert set(t_timer) == set(j_timer) == {"load", "prove", "total"}
    assert all(v >= 0 for v in list(t_laps.values()) + list(
        t_timer.values()))
    assert t_timer["total"] >= t_timer["load"] + t_timer["prove"]
    # the same lines, up to the times
    strip = [line.split("[")[0].split(":")[0]
             for line in port_err.splitlines()]
    assert strip == [line.split("[")[0].split(":")[0]
                     for line in jax_err.splitlines()]
    assert bool(port_err) == enabled


def test_disabled_prints_nothing_and_keeps_laps(capsys):
    TP.set_profiling_enabled(False)
    TP.clear_laps()
    with TP.block("quiet"):
        TP.enter_block("nested")
        TP.leave_block("nested")
    TP.log_device_memory("quiet")
    with TP.span("total") as total:
        with TP.span("a") as a:
            pass
    out = capsys.readouterr()
    assert out.err == "" and out.out == ""
    assert seconds_keys(TP.last_laps()) == {"quiet", "nested", "total", "a"}
    assert total.seconds >= a.seconds >= 0


def test_clear_laps_and_unbalanced_blocks():
    TP.set_profiling_enabled(False)
    with TP.block("x"):
        pass
    assert "x" in TP.last_laps()
    TP.clear_laps()
    assert TP.last_laps() == {} and TP.last_spans() == []
    TP.enter_block("a")
    with pytest.raises(RuntimeError, match="unbalanced"):
        TP.leave_block("b")


def test_block_records_when_the_body_raises():
    TP.set_profiling_enabled(False)
    TP.clear_laps()
    with pytest.raises(ValueError):
        with TP.block("failing"):
            raise ValueError("inside")
    assert "failing" in TP.last_laps()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_label_opened_k_times_sums(k):
    TP.clear_laps()
    parts = []
    for _ in range(k):
        with TP.span("level") as sp:
            time.sleep(0.001)
        parts.append(sp.seconds)
        TP.count("levels")
    laps = TP.last_laps()
    assert math.isclose(laps["level"], sum(parts), rel_tol=1e-12)
    assert laps["#levels"] == k
    assert [s[0] for s in TP.last_spans()] == ["level"] * k


# each shape: (name, children) trees, opened in this order
SHAPES = {
    "leaf": ("a", []),
    "two_children": ("a", [("b", []), ("c", [])]),
    "nested": ("a", [("b", [("c", []), ("c", [])]), ("d", [])]),
}


def _open_tree(tree, seconds):
    name, children = tree
    with TP.span(name) as sp:
        time.sleep(0.001)
        kids = [_open_tree(t, seconds) for t in children]
    seconds.setdefault(name, []).append((sp.seconds, sum(kids)))
    return sp.seconds


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_self_time_is_seconds_less_children(shape):
    TP.clear_laps()
    seconds = {}
    _open_tree(SHAPES[shape], seconds)
    laps = TP.last_laps()
    for name, opens in seconds.items():
        total = sum(s for s, _ in opens)
        own = sum(s - kids for s, kids in opens)
        assert math.isclose(laps[name], total, rel_tol=1e-9)
        assert math.isclose(laps[TP.SELF + name], own, rel_tol=1e-9,
                            abs_tol=1e-12)
        assert 0 <= laps[TP.SELF + name] <= laps[name]
    parents = {s[0]: s[1] for s in TP.last_spans()}
    assert parents["a"] is None


@pytest.mark.parametrize("enabled", [True, False], ids=["enabled",
                                                        "disabled"])
def test_span_never_prints(enabled, capsys):
    TP.set_profiling_enabled(enabled)
    with TP.span("outer", root=True):
        with TP.span("inner"):
            TP.count("things", 3)
    out = capsys.readouterr()
    assert out.err == "" and out.out == ""
    assert TP.last_laps()["#things"] == 3


@pytest.mark.parametrize("case", ["next_root", "thousand_roots", "cap"])
def test_root_span_starts_the_record(case, monkeypatch):
    TP.clear_laps()
    if case == "next_root":
        with TP.span("before"):          # joins the first request's record
            pass
        with TP.span("proof", root=True):
            with TP.span("ntt.addsub"):
                pass
        assert {"before", "proof", "ntt.addsub"} <= set(TP.last_laps())
        with TP.span("proof", root=True):
            TP.count("msm.host_syncs")
        assert seconds_keys(TP.last_laps()) == {"proof"}
        assert [s[0] for s in TP.last_spans()] == ["proof"]
    elif case == "thousand_roots":
        for _ in range(1000):
            with TP.span("proof", root=True) as sp:
                with TP.span("inner"):
                    TP.count("n")
        laps = TP.last_laps()
        assert laps["proof"] == sp.seconds and laps["#n"] == 1
        assert len(TP.last_spans()) == 2 < TP.MAX_SPANS
    else:
        monkeypatch.setattr(TP, "MAX_SPANS", 5)
        with TP.span("proof", root=True):
            for _ in range(9):
                with TP.span("inner"):
                    pass
        assert len(TP.last_spans()) == 5
        assert TP.last_laps()["#profiling.spans_dropped"] == 5
        assert TP.last_laps()["proof"] > 0          # the sums stay whole


@pytest.mark.parametrize("request_", ["session", "files"])
def test_proof_raising_in_a_block_raises_its_own_error(request_, tmp_path,
                                                       monkeypatch):
    """A proof that fails inside a block (out of memory in the H
    pipeline) raises that error, leaves the stack as it found it, and
    the next root span starts the record anew."""
    TP.set_profiling_enabled(False)
    TP.clear_laps()
    depth = len(TP._stack)

    def out_of_memory(*args):
        raise torch.OutOfMemoryError("H pipeline")

    monkeypatch.setattr(GP, "compute_h", out_of_memory)
    monkeypatch.setenv("GROTH16_PREPROCESSED_PATH", str(tmp_path / "none"))
    curve = CURVES["MNT4753"]
    params_path = f"{DATA}/MNT4753-parameters"
    input_path = f"{DATA}/MNT4753-input"
    with pytest.raises(torch.OutOfMemoryError, match="H pipeline"):
        if request_ == "session":
            params = GP.load_params(params_path, curve)
            inputs = GP.load_input(input_path, curve, params.d, params.m)
            GP.ProverSession(curve, params, "cpu").prove(inputs)
        else:
            GP.prove_files(curve, params_path, input_path,
                           str(tmp_path / "proof"), device="cpu")
    assert len(TP._stack) == depth
    root = "proof" if request_ == "session" else "files.compute"
    laps = TP.last_laps()
    assert root in laps and "H pipeline (device NTT)" not in laps
    with TP.span("proof", root=True):
        pass
    assert seconds_keys(TP.last_laps()) == {"proof"}


@pytest.mark.parametrize("where", ["span", "block"])
def test_exception_drops_the_blocks_it_left_open(where):
    TP.set_profiling_enabled(False)
    TP.clear_laps()
    depth = len(TP._stack)
    opener = TP.span("outer") if where == "span" else TP.block("outer")
    with pytest.raises(KeyError):
        with opener:
            TP.enter_block("left open")
            raise KeyError("inside")
    assert len(TP._stack) == depth
    assert "outer" in TP.last_laps() and "left open" not in TP.last_laps()


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def test_span_encloses_profiler_event_on_one_clock():
    """The timeline's clock is the profiler's: a span opened around a
    record_function range encloses the range's event within 1 ms."""
    TP.clear_laps()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TP.span("outer.span"):
            with torch.profiler.record_function("inner_range"):
                torch.ones(64).sum()
    (_, _, s0, s1), = TP.last_spans()
    ev, = [e for e in _events(prof) if e.name() == "inner_range"]
    e0, e1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    slack = 1_000_000
    assert s0 - slack <= e0 <= e1 <= s1 + slack


def _layers(curve):
    """A proof's instrumented layers at their smallest on the CPU: the
    NttPlan and H pipeline at 2^4, one signed MSM (c = 4) of the fixture's
    16 A rows and its epilogue."""
    plan = N.NttPlan(curve.fr, 16, "cpu")
    rng = np.random.default_rng(5)
    cols = [rng.integers(0, 2 ** 31, (24, 16), dtype=np.int32)
            for _ in range(4)]
    for c in cols:
        c[-1] = 0                            # below r
    N.compute_h(plan, *(torch.from_numpy(c) for c in cols[:3]))
    params = GP.load_params(f"{DATA}/{curve.name}-parameters", curve)
    g1 = get_curve_ops(curve, "g1")
    ws = M.msm_window_sums(g1, torch.from_numpy(cols[3]),
                           torch.from_numpy(params.A[:16].copy()), 8, 4,
                           signed=True)
    M.finalize_windows(g1, host_ec.g1_group(curve), ws, 4)


def test_profile_holds_no_program_span_event():
    """No program span is a profiler range: a CPU profile of the
    instrumented layers holds no event named after a span."""
    torch.set_num_threads(2)
    TP.clear_laps()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TP.span("proof", root=True):
            _layers(CURVES["MNT4753"])
    names = {s[0] for s in TP.last_spans()}
    assert {"proof", "ntt.twiddle", "ntt.addsub", "msm.sort", "msm.scan",
            "msm.carry", "msm.reduce", "epilogue.readback",
            "epilogue.horner"} <= names
    assert TP.last_laps()["#msm.host_syncs"] >= 1
    assert names.isdisjoint(e.name() for e in _events(prof))

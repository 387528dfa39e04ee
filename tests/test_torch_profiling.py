"""The port's block timers (utils/profiling.py) against the JAX package's:
the same calls give the same laps keys; printing follows
set_profiling_enabled while the laps are always kept; PhaseTimer fills
its laps."""

import pytest

from gpu_groth16_prover_3x_tpu.utils import profiling as JP
from gpu_groth16_prover_3x_tpu_torch.utils import profiling as TP


@pytest.fixture(autouse=True)
def restore_profiling():
    """Both modules keep process-wide state: leave it as found."""
    saved = [(m, m._enabled, m.last_laps()) for m in (JP, TP)]
    yield
    for m, enabled, laps in saved:
        m.set_profiling_enabled(enabled)
        m.clear_laps()
        m._last_laps.update(laps)


def drive(mod):
    """The same nested blocks, context-manager block and phase timer."""
    mod.clear_laps()
    mod.enter_block("outer")
    mod.enter_block("inner")
    mod.leave_block("inner")
    with mod.block("ctx"):
        pass
    mod.leave_block("outer")
    timer = mod.PhaseTimer()
    timer.lap("load")
    timer.lap("prove")
    timer.total()
    return mod.last_laps(), timer.laps


@pytest.mark.parametrize("enabled", [True, False], ids=["enabled",
                                                        "disabled"])
def test_same_laps_keys_as_jax(enabled, capsys):
    JP.set_profiling_enabled(enabled)
    TP.set_profiling_enabled(enabled)
    j_laps, j_timer = drive(JP)
    jax_err = capsys.readouterr().err
    t_laps, t_timer = drive(TP)
    port_err = capsys.readouterr().err
    assert set(t_laps) == set(j_laps) == {"outer", "inner", "ctx"}
    assert set(t_timer) == set(j_timer) == {"load", "prove", "total"}
    assert all(v >= 0 for v in list(t_laps.values()) + list(
        t_timer.values()))
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
    timer = TP.PhaseTimer()
    timer.lap("a")
    timer.total()
    out = capsys.readouterr()
    assert out.err == "" and out.out == ""
    assert set(TP.last_laps()) == {"quiet", "nested"}
    assert set(timer.laps) == {"a", "total"}
    assert timer.laps["total"] >= timer.laps["a"]


def test_clear_laps_and_unbalanced_blocks():
    TP.set_profiling_enabled(False)
    with TP.block("x"):
        pass
    assert "x" in TP.last_laps()
    TP.clear_laps()
    assert TP.last_laps() == {}
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

"""The check fails the faults a cell can have, and its control.

Each case drives the rest of a run on the CPU (run_cell with a cell of
the smallest domain, 2^4) with the timed path broken underneath, and
sees `correct` come out false; a sound run comes out true.  Faults: a
proof that returns the state of the one before (the last proof, or no
new file); half of the witness left out; an answer altered where it is
produced.  One card and no exchange between chips: no cell can leave an
exchange out.  The control is the reference with one guarantee broken
(h's top coefficient, which the H query's d rows leave out, taken in).
"""

import time

import numpy as np
import pytest
import torch

from harness import cell, spec

from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.utils import serialization as SER

CELLS = {"serve": "mnt4753-2p20.serve", "files": "mnt4753-2p20.files"}


def _run(traffic, trace=False, control=None):
    torch.set_num_threads(2)
    bench = spec.benchmark()
    wl = dict(spec.workload(bench, CELLS[traffic]))
    c = cell.Cell(wl, {"curve": "MNT4753", "log2_domain": 4},
                  spec.mix(traffic), 2 ** 35 + 3, 0.001, trace, "cpu",
                  control)
    return cell.run_cell(c, bench, time.perf_counter())


def test_sound_run_is_correct():
    out = _run("serve", trace=True)
    assert out["correct"] is True and out["attempted"] == 1
    assert out["checks"]["proofs_wrong"] == {"value": 0, "limit": 0}
    assert list(out)[-1] == "checks"
    assert {"ntt.h_s", "msm.msm_s"} <= set(out["metrics"])
    assert cell.banned_modules() == []


def test_control_is_not_correct():
    out = _run("serve", control="h-off-by-one")
    assert out["correct"] is False
    assert out["checks"]["proofs_wrong"]["value"] == out["attempted"] >= 1


def _wrap_prove(monkeypatch, make):
    real = GP.ProverSession.prove
    monkeypatch.setattr(GP.ProverSession, "prove", make(real))


def test_state_returned_unchanged(monkeypatch):
    def make(real):
        last = {}

        def prove(self, inputs):
            out = last.get("out") or real(self, inputs)
            last["out"] = out
            return out
        return prove
    _wrap_prove(monkeypatch, make)
    assert _run("serve")["correct"] is False


def test_half_the_witness_left_out(monkeypatch):
    def make(real):
        def prove(self, inputs):
            w = np.array(inputs.w_mont)
            w[len(w) // 2:] = 0
            return real(self, GP.DeviceInput(w, inputs.ca, inputs.cb,
                                             inputs.cc, inputs.r))
        return prove
    _wrap_prove(monkeypatch, make)
    assert _run("serve")["correct"] is False


def test_answer_altered_where_produced(monkeypatch):
    def make(real):
        def prove(self, inputs):
            (ax, ay), b, c = real(self, inputs)
            return (ax + 1, ay), b, c
        return prove
    _wrap_prove(monkeypatch, make)
    assert _run("serve")["correct"] is False


@pytest.mark.parametrize("fault", ["altered", "unchanged"])
def test_file_faults(monkeypatch, fault):
    real = SER.write_output
    calls = []

    def write_output(path, *args):
        calls.append(path)
        if fault == "unchanged" and len(calls) > 1:
            return                              # no new proof file
        real(path, *args)
        if fault == "altered":
            with open(path, "r+b") as f:
                f.seek(5)
                b = f.read(1)
                f.seek(5)
                f.write(bytes([b[0] ^ 1]))
    monkeypatch.setattr(SER, "write_output", write_output)
    out = _run("files")
    assert out["correct"] is False
    key = "proofs_wrong" if fault == "altered" else "proofs_missing"
    assert out["checks"][key]["value"] == 1

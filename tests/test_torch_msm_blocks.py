"""The streamed MSM's block loop in a proof (ops/msm.py
msm_window_sums_streamed): an MNT4753 ProverSession at 2^6 with its rows
resident and `block_points` forcing several blocks per MSM against the
one-pass session, the known logs (utils/synthetic.py), and the record's
span "msm.block", span "msm.combine" and counter "#msm.blocks"
(utils/profiling.py).

A block costs seconds here (each runs its own bucket reduction with the
plain group operations), so the file holds few tests and both sessions
are proved once for the module.  Two tests: the file is dispatched
among the last of a parallel run, beside its longest file."""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.utils import profiling as P
from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

LOG2 = 6
BLOCK = 64          # G1: 4 blocks of 64 points; B2: 2 blocks of 40
MSM_LAP = "MSMs (device Pippenger)"


def _prove(sess, values):
    P.clear_laps()
    out = sess.prove(SY.input_arrays(values))
    return out, P.last_laps(), P.last_spans()


@pytest.fixture(scope="module")
def proofs():
    """The blocked and the one-pass session's proof of one input, each
    with its record, and the known proof."""
    enabled, threads = P._enabled, torch.get_num_threads()
    P.set_profiling_enabled(False)
    torch.set_num_threads(2)
    try:
        params = SY.params_arrays(MNT4753, LOG2)
        values = SY.input_values(MNT4753, LOG2, np.random.default_rng(24))
        blocked = GP.ProverSession(MNT4753, params, "cpu",
                                   block_points=BLOCK)
        one = GP.ProverSession(MNT4753, params, "cpu")
        want = SY.expected_proof(MNT4753, LOG2, SY.KS,
                                 SY.query_logs(LOG2), values, "cpu")
        return {"blocked": (blocked, _prove(blocked, values)),
                "one": (one, _prove(one, values)), "want": want}
    finally:
        P.set_profiling_enabled(enabled)
        torch.set_num_threads(threads)
        P.clear_laps()


def _grid(sess):
    """Blocks of the G1 and the B2 MSM, by block_grid."""
    return [M.block_grid(n, sess.chunk_s, sess.block_points)[0]
            for n in (sess.n_pad, sess.n2_pad)]


def test_blocked_proof_equals_one_pass_and_known_logs(proofs):
    sess, (got, _, _) = proofs["blocked"]
    assert sess.resident and sess.block_points == BLOCK
    g1, b2 = _grid(sess)
    assert g1 >= 3 and b2 >= 2
    assert got == proofs["one"][1][0] == proofs["want"]


def test_block_spans_and_counter(proofs):
    """#msm.blocks is block_grid's blocks summed over both MSMs (2 for
    the one-pass session); one msm.block span a block and one msm.combine
    a block after each MSM's first, each a child of the MSM block, with
    the MSM's steps inside the blocks."""
    passes = 2
    for kind, want_blocks in (("blocked", 6), ("one", passes)):
        sess, (_, laps, spans) = proofs[kind]
        blocks = sum(_grid(sess))
        assert blocks == want_blocks
        assert laps["#msm.blocks"] == blocks
        parent = {}
        for name, up, start, end in spans:
            parent.setdefault(name, []).append(up)
            assert start <= end
        assert parent["msm.block"] == [MSM_LAP] * blocks
        assert parent.get("msm.combine", []) == \
            [MSM_LAP] * (blocks - passes)
        for step in ("msm.sort", "msm.scan", "msm.reduce"):
            assert set(parent[step]) == {"msm.block"}
        assert laps["msm.block"] + laps.get("msm.combine", 0.0) \
            <= laps[MSM_LAP]

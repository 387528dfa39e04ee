"""The cell of the streamed MSM (mnt4753-2p24.serve) on the CPU:

- a session whose MSMs run in forced blocks (block_points) proves the
  reference's bytes on the reference's keys, and its record feeds the
  readers msm.blocks and msm.block_s;
- both readers on a made-up record, and nothing to read where the
  program has no counter "#msm.blocks" (a parent without it);
- the configuration is the reference's domain at 2^24, where the H rows'
  root t still has t^n != 1, and BENCHMARK.json lists the cell where
  its metrics read something."""

import math

import torch

from groth16_ref import algebra, curves, keys, proof
from harness import spec

from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.utils import profiling as P

CELL, CONFIG = "mnt4753-2p24.serve", "mnt4753-2p24"
LAP = "MSMs (device Pippenger)"
READERS = ("msm.blocks", "msm.block_s")


def _run(laps):
    return {"proofs": [{"laps": x, "spans": {}} for x in laps],
            "trace": None}


def test_streamed_session_proves_the_reference_bytes():
    name, log2, block = "MNT4753", 6, 64
    enabled, threads = P._enabled, torch.get_num_threads()
    P.set_profiling_enabled(False)
    torch.set_num_threads(2)
    try:
        rc = curves.CURVES[name]
        base = keys.base_rows(rc)
        q = {k: keys.query_rows(k, log2, base) for k in keys.QUERIES}
        sz = keys.sizes(log2)
        params = GP.DeviceParams(sz["d"], sz["m"], q["A"], q["B1"], q["B2"],
                                 q["L"], q["H"])
        sess = GP.ProverSession(CURVES[name], params, "cpu",
                                block_points=block)
        v = keys.InputStream(rc, log2, 2 ** 33 + 5, "cpu").next()
        P.clear_laps()
        got = sess.prove(GP.DeviceInput(v[0].T, v[1].T, v[2].T, v[3].T,
                                        v[4]))
        laps = P.last_laps()
    finally:
        P.set_profiling_enabled(enabled)
        torch.set_num_threads(threads)
    assert algebra.proof_bytes(rc, *got) == \
        proof.Reference(rc, log2, "cpu").expect(v)
    blocks = sum(M.block_grid(n, sess.chunk_s, block)[0]
                 for n in (sess.n_pad, sess.n2_pad))
    assert blocks >= 5
    run = _run([laps])
    assert spec.reader("msm.blocks").read(run) == blocks
    assert math.isclose(spec.reader("msm.block_s").read(run),
                        laps[LAP] / blocks)


def test_readers_on_a_made_up_record():
    laps = [{LAP: 30.0 + i, "#msm.blocks": 41, "msm.block": 29.0}
            for i in range(3)]
    assert spec.reader("msm.blocks").read(_run(laps)) == 41
    assert math.isclose(spec.reader("msm.block_s").read(_run(laps)),
                        31.0 / 41)
    # the parent's record: the MSM lap and no counter
    parent = _run([{LAP: 30.0, "msm.scan": 20.0}])
    assert all(spec.reader(n).read(parent) is None for n in READERS)
    # the table path's MSM lap is not the Pippenger block's
    tables = _run([{"MSMs (device: Straus tables + Pippenger A/H)": 1.0,
                    "#msm.blocks": 1}])
    assert spec.reader("msm.block_s").read(tables) is None
    assert spec.reader("msm.blocks").read(tables) == 1


def test_config_and_cell():
    cfg = spec.config(CONFIG)
    sz = keys.sizes(cfg["log2_domain"])
    assert (cfg["curve"], cfg["log2_domain"], cfg["d"], cfg["m"]) == \
        ("MNT4753", 24, sz["d"], sz["m"])
    assert cfg["reduced"] == [] and cfg["deployment"] and cfg["assumed"]
    # the H rows' root: t^n = t^64 at n = 2^24 (t of order 192)
    rc = curves.CURVES[cfg["curve"]]
    t, fr = keys.h_root(rc), rc.fr.p
    assert (1 << 24) % keys.PERIOD_H == 64
    assert pow(t, 1 << 24, fr) == pow(t, 64, fr) != 1
    bench = spec.benchmark()
    wl = spec.workload(bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (CONFIG, "serve", 1)
    listed = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert listed >= {"proof_s", "proof_p95_s.host", "device_peak_gib",
                      "setup_s", "prover.stage_s", "ntt.h_s", "msm.msm_s",
                      "epilogue.assembly_s", "kernels.roofline_pct",
                      "device.idle_pct", "msm.host_syncs", *READERS}
    for name in READERS:
        m, = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL]

"""Choose the lane design's compile-time constants by measurement.

    python3 tune_lanes.py [T:MINB:ILP[:stage] ...] [--cfgs 0,1,2,3] [--quick]

Builds the group and scan kernels once per variant (ops/build.py
build_dir with -DG16_T, -DG16_MINB, -DG16_ILP; every variant in its own
directory, all of a variant's units in parallel), holds each against its
plain version on small inputs (exact equality), and times it on one card
at the shapes the main path launches:

  cfg 0  MNT4753 G1   ec_add / ec_dbl at 192 x 2^14 lanes, scan S=128 B=65,536
  cfg 1  MNT4753 G2   ec_add / ec_dbl at  48 x 2^14 lanes, scan B=6 x 8,193
  cfg 2  MNT6753 G1   ec_add / ec_dbl at 2^16 lanes,       scan B=48 x 1,024
  cfg 3  MNT6753 G2   ec_add / ec_dbl at 2^16 lanes,       scan B=96 x 257

T is the number of lanes that share one element (4 or 8,
csrc/field_coop.cuh), MINB the blocks of 128 threads that must fit an SM
(__launch_bounds__), ILP the independent products per cooperative loop;
0 in a field keeps the source's own choice for each configuration, so
0:0:0 is the kernels as the port builds them.  A fourth field `stage`
builds ec_add with its operands staged through shared memory
(csrc/group.cu, -DG16_STAGE, 8 lanes) to hold against the direct access.
The variants are compiled side by side before any is timed.
Per variant and configuration it prints one JSON line: the times and,
per kernel, registers, stack and spill bytes from ptxas.
The constants that win are then written into the sources by hand: the
port has no run-time switch.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as CS

import torch  # noqa: E402  (chip_smoke pins the visible card first)

from gpu_groth16_prover_3x_tpu_torch.curves.constants import (  # noqa: E402
    MNT4753, MNT6753)
from gpu_groth16_prover_3x_tpu_torch.ops import build  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops  # noqa

GROUPS = ((MNT4753, "g1"), (MNT4753, "g2"), (MNT6753, "g1"), (MNT6753, "g2"))
GROUP_LANES = (192 << 14, 48 << 14, 1 << 16, 1 << 16)
SCAN_B = (1 << 16, 6 * 8193, 48 * 1024, 96 * 257)
DEV = "cuda"


def variant_defs(spec: str) -> tuple:
    fields = spec.split(":")
    t, minb, ilp = (int(v) for v in fields[:3])
    defs = [f"-DG16_T={t}"] if t else []
    if fields[3:] == ["stage"]:
        defs.append("-DG16_STAGE")
    if minb:
        defs.append(f"-DG16_MINB={minb}")
    if ilp:
        defs.append(f"-DG16_ILP={ilp}")
    return tuple(defs)


def check_small(rng, cops) -> None:
    """Exact equality with the plain versions at ragged small sizes."""
    for n in (1, 33, 1000):
        P = torch.from_numpy(CS.rand_points(rng, cops, n, 3)).to(DEV)
        Q = torch.from_numpy(CS.rand_points(rng, cops, n, 3)).to(DEV)
        Q[:, :, 5::11] = P[:, :, 5::11]
        xy = torch.from_numpy(CS.rand_points(rng, cops, n, 2)).to(DEV)
        inf = torch.from_numpy(rng.random(n) < 0.2).to(DEV)
        xy[cops.deg:, :, inf] = 0
        CS.require_equal("ec_add", GK.ec_add(cops, P, Q),
                         GK.ec_add_plain(cops, P, Q))
        CS.require_equal("ec_dbl", GK.ec_dbl(cops, P),
                         GK.ec_dbl_plain(cops, P))
        CS.require_equal("ec_mixed_add", GK.ec_mixed_add(cops, P, xy, inf),
                         GK.ec_mixed_add_plain(cops, P, xy, inf))
    for B in (1, 33, 300):
        rows, idx, keys, signs = CS.scan_inputs(rng, cops, 12, B, 64)
        rt, it, kt, st = (torch.from_numpy(a).to(DEV)
                          for a in (rows, idx, keys, signs))
        for sg in (st, None):
            CS.require_equal(
                "msm_scan",
                CS.scan_defined(M.msm_scan(cops, rt, it, kt, sg)),
                CS.scan_defined(M.msm_scan_plain(cops, rt, it, kt, sg)))
    torch.cuda.synchronize()


def time_variant(rng, cfg: int, quick: bool) -> dict:
    curve, group = GROUPS[cfg]
    cops = get_curve_ops(curve, group)
    check_small(rng, cops)
    out = {}
    n = GROUP_LANES[cfg] >> (4 if quick else 0)
    P = torch.from_numpy(CS.rand_points(rng, cops, 1 << 12, 3)).to(DEV)
    P = P.repeat(1, 1, n >> 12).contiguous()
    Q = P.roll(7, -1).contiguous()
    out["ec_add_ms"] = CS.cuda_ms(lambda: GK.ec_add(cops, P, Q), 3)
    out["ec_dbl_ms"] = CS.cuda_ms(lambda: GK.ec_dbl(cops, P), 3)
    out["group_lanes"] = n
    del P, Q
    B = SCAN_B[cfg] >> (4 if quick else 0)
    S = 128
    rows, idx, keys, signs = CS.scan_inputs(rng, cops, S, B, 4 * B)
    rt, it, kt, st = (torch.from_numpy(a).to(DEV)
                      for a in (rows, idx, keys, signs))
    out["scan_ms"] = CS.cuda_ms(lambda: M.msm_scan(cops, rt, it, kt, st), 2)
    out["scan_B"] = B
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=["0:0:0", "4:0:0", "8:0:0"])
    ap.add_argument("--cfgs", default="0,1,2,3")
    ap.add_argument("--quick", action="store_true",
                    help="1/16 of the widths: a build and correctness pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_lanes: no CUDA device", file=sys.stderr)
        return 1
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    cfgs = [int(c) for c in args.cfgs.split(",")]
    t0 = time.time()
    with ThreadPoolExecutor(len(args.variants)) as pool:
        dirs = list(pool.map(
            lambda spec: build.build_dir(variant_defs(spec)), args.variants))
    print(f"{len(dirs)} variants built in {time.time() - t0:.1f} s",
          flush=True)
    for spec, out_dir in zip(args.variants, dirs):
        defs = variant_defs(spec)
        print(f"variant {spec}:", flush=True)
        report = build.ptxas_report(defs)
        for line in report.splitlines():
            if line.startswith("== "):
                print("  " + line, flush=True)
        lib = build.load(out_dir)
        # the wrappers ask build.library() at each launch: hand them this
        # variant's library for the duration of its measurements
        build.library = lambda lib=lib: lib
        ptx = [r for r in build.ptxas_summary(report)
               if r[0].startswith(("group", "msm_scan"))]
        for cfg in cfgs:
            rng = np.random.default_rng(CS.SEED + cfg)
            row = {"variant": spec, "cfg": cfg, "card": card}
            row.update(time_variant(rng, cfg, args.quick))
            row["ptxas"] = [r[1:] for r in ptx if r[0].endswith(str(cfg))]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

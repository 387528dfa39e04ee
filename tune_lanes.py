"""Choose the lane design's compile-time constants by measurement.

    python3 tune_lanes.py [T:MINB:ILP[:stage] ...] [--src LABEL=DIR ...]
        [--cfgs 0,1,2,3] [--rounds N] [--sass] [--quick]

Builds the group and scan kernels once per variant (ops/build.py
build_dir with -DG16_T, -DG16_MINB, -DG16_ILP; every variant in its own
directory, all of a variant's units in parallel), holds each against its
plain version on small inputs (exact equality), and times it on one card
at the shapes the main path launches:

  cfg 0  MNT4753 G1   ec_add / ec_dbl at 192 x 2^14 lanes, scan S=128 B=65,536
  cfg 1  MNT4753 G2   ec_add / ec_dbl at  48 x 2^14 lanes, scan B=6 x 8,193
  cfg 2  MNT6753 G1   ec_add / ec_dbl at 2^16 lanes,       scan B=48 x 1,024
  cfg 3  MNT6753 G2   ec_add / ec_dbl at 2^16 lanes,       scan B=96 x 257

and, for every configuration, ec_add and ec_mixed_add at 2^16 lanes,
ec_mixed_add at the table build's width (2^20 + 1 for MNT4753, 2^15 + 1
for MNT6753), and the scan also on rows tiled from small multiples k * G,
where the step's doubling and conversion selects run.

T is the number of lanes that share one element (4 or 8,
csrc/field_coop.cuh), MINB the blocks of 128 threads that must fit an SM
(__launch_bounds__), ILP the independent products per cooperative loop;
0 in a field keeps the source's own choice for each configuration, so
0:0:0 is the kernels as the port builds them.  A fourth field `stage`
builds ec_add with its operands staged through shared memory
(csrc/group.cu, -DG16_STAGE, 8 lanes) to hold against the direct access.
`--src LABEL=DIR` adds, under LABEL, the kernels of another checkout DIR
(a parent commit, or a design tried in a copy) exactly as that checkout
builds them: its own ops/build.py runs there, in a process of its own,
with its own sources, generated constants header and flags; the library
is then driven through this checkout's wrappers, so the two must share
the C entry points.  The variants are compiled side by
side before any is timed; `--rounds 2` times them in order and then in
reverse (parent, change, change, parent).  `--sass` compares every
unit's machine code (cuobjdump -sass) with the first variant's.
Per variant, configuration and round it prints one JSON line: the times
and, per kernel, registers, stack and spill bytes from ptxas.
The constants that win are then written into the sources by hand: the
port has no run-time switch.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import chip_smoke as CS

import torch  # noqa: E402  (chip_smoke pins the visible card first)

from gpu_groth16_prover_3x_tpu_torch.curves.constants import (  # noqa: E402
    MNT4753, MNT6753)
from gpu_groth16_prover_3x_tpu_torch.ops import build  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops  # noqa
from gpu_groth16_prover_3x_tpu_torch.utils.synthetic import (  # noqa: E402
    KS, multiples_rows)

GROUPS = ((MNT4753, "g1"), (MNT4753, "g2"), (MNT6753, "g1"), (MNT6753, "g2"))
GROUP_LANES = (192 << 14, 48 << 14, 1 << 16, 1 << 16)
BUILD_LANES = ((1 << 20) + 1, (1 << 20) + 1, (1 << 15) + 1, (1 << 15) + 1)
SCAN_B = (1 << 16, 6 * 8193, 48 * 1024, 96 * 257)
SMALL_LANES = 1 << 16
DEV = "cuda"


def variant_defs(spec: str) -> tuple:
    fields = spec.split(":")
    if len(fields) not in (3, 4) or fields[3:] not in ([], ["stage"]):
        raise SystemExit(f"tune_lanes: bad variant {spec!r}: "
                         "T:MINB:ILP[:stage]")
    t, minb, ilp = (int(v) for v in fields[:3])
    defs = [f"-DG16_T={t}"] if t else []
    if fields[3:]:
        defs.append("-DG16_STAGE")
    if minb:
        defs.append(f"-DG16_MINB={minb}")
    if ilp:
        defs.append(f"-DG16_ILP={ilp}")
    return tuple(defs)


def build_other(root: str) -> Path:
    """Build another checkout's kernels with its own ops/build.py, in a
    process whose imports come from that checkout, and return its build
    directory."""
    root = Path(root).resolve()
    code = ("from gpu_groth16_prover_3x_tpu_torch.ops import build; "
            "print(build.__file__); print(build.build_dir())")
    done = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                          stdout=subprocess.PIPE, text=True)
    used, out_dir = done.stdout.split()[-2:]
    if not Path(used).resolve().is_relative_to(root):
        raise SystemExit(f"tune_lanes: {root} built with {used}")
    return Path(out_dir)


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
    base = multiples_rows(cops.curve, cops.group, KS[:CS.SCAN_MULTIPLES])
    for B in (1, 33, 300):
        for rows_of in (None, base):
            rows, idx, keys, signs = CS.scan_inputs(rng, cops, 12, B, 64,
                                                    rows_of)
            rt, it, kt, st = (torch.from_numpy(a).to(DEV)
                              for a in (rows, idx, keys, signs))
            for sg in (st, None):
                CS.require_equal(
                    "msm_scan",
                    CS.scan_defined(M.msm_scan(cops, rt, it, kt, sg)),
                    CS.scan_defined(M.msm_scan_plain(cops, rt, it, kt, sg)))
    torch.cuda.synchronize()


def tiled(rng, cops, n: int, ncoord: int) -> torch.Tensor:
    """(ncoord*deg, 24, n) coordinates: 2^12 random lanes repeated."""
    base = CS.rand_points(rng, cops, 1 << 12, ncoord)
    return torch.from_numpy(np.ascontiguousarray(
        np.take(base, np.arange(n) % base.shape[-1], axis=-1))).to(DEV)


def inputs(rng, cfg: int, quick: bool) -> dict:
    """The operands every variant is timed on, made once a configuration."""
    curve, group = GROUPS[cfg]
    cops = get_curve_ops(curve, group)
    cut = 4 if quick else 0
    n = GROUP_LANES[cfg] >> cut
    P = tiled(rng, cops, n, 3)
    ops = {"cops": cops, "P": P, "Q": P.roll(7, -1).contiguous()}
    small = SMALL_LANES >> cut
    ops["P16"] = tiled(rng, cops, small, 3)
    ops["Q16"] = ops["P16"].roll(5, -1).contiguous()
    for key, m in (("16", small), ("build", BUILD_LANES[cfg] >> cut)):
        ops["A" + key] = tiled(rng, cops, m, 3)
        xy = tiled(rng, cops, m, 2)
        inf = torch.from_numpy(rng.random(m) < 0.1).to(DEV)
        xy[cops.deg:, :, inf] = 0
        ops["xy" + key], ops["inf" + key] = xy, inf
    B = SCAN_B[cfg] >> cut
    base = multiples_rows(curve, group, KS[:CS.SCAN_MULTIPLES])
    for key, rows_of in (("scan", None), ("scan_multiples", base)):
        ops[key] = tuple(torch.from_numpy(a).to(DEV) for a in CS.scan_inputs(
            rng, cops, 128, B, 4 * B, rows_of))
    ops["group_lanes"], ops["scan_B"] = n, B
    return ops


def time_variant(ops: dict) -> dict:
    cops, P, Q = ops["cops"], ops["P"], ops["Q"]
    out = {"group_lanes": ops["group_lanes"], "scan_B": ops["scan_B"]}
    out["ec_add_ms"] = CS.cuda_ms(lambda: GK.ec_add(cops, P, Q), 3)
    out["ec_dbl_ms"] = CS.cuda_ms(lambda: GK.ec_dbl(cops, P), 3)
    out["ec_add_16_ms"] = CS.cuda_ms(
        lambda: GK.ec_add(cops, ops["P16"], ops["Q16"]), 5)
    for key in ("16", "build"):
        out[f"mixed_add_{key}_ms"] = CS.cuda_ms(lambda: GK.ec_mixed_add(
            cops, ops["A" + key], ops["xy" + key], ops["inf" + key]), 3)
    for key in ("scan", "scan_multiples"):
        rt, it, kt, st = ops[key]
        out[f"{key}_ms"] = CS.cuda_ms(
            lambda: M.msm_scan(cops, rt, it, kt, st), 3)
    return out


def sass(obj: Path) -> list:
    """The instructions of an object file, without symbol names (which
    carry a hash of the source's path)."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(obj)], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    return [ln.strip() for ln in text.splitlines()
            if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]


def sass_compare(ref: Path, other: Path) -> dict:
    """Per unit: 'same', or how many instruction lines differ."""
    out = {}
    for obj in sorted(ref.glob("*.o")):
        a, b = sass(obj), sass(other / obj.name)
        if a == b:
            out[obj.stem] = "same"
        else:
            n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            out[obj.stem] = f"differs: {n} of {len(a)} / {len(b)} lines"
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--src", action="append", default=[],
                    help="LABEL=DIR: the kernels of another source tree")
    ap.add_argument("--cfgs", default="0,1,2,3")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every variant this often, in turns")
    ap.add_argument("--sass", action="store_true",
                    help="compare each unit's SASS with the first variant's")
    ap.add_argument("--quick", action="store_true",
                    help="1/16 of the widths: a build and correctness pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_lanes: no CUDA device", file=sys.stderr)
        return 1
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    # (label, build): another checkout's build, or this one's with -D flags
    variants = [(label, lambda r=root: build_other(r)) for label, root in
                (s.split("=", 1) for s in args.src)]
    specs = args.variants or ([] if variants else ["0:0:0", "4:0:0", "8:0:0"])
    variants += [(spec, lambda d=variant_defs(spec): build.build_dir(d))
                 for spec in specs]
    cfgs = [int(c) for c in args.cfgs.split(",")]
    t0 = time.time()
    # three variants' units at a time: each builds its ten units at once
    with ThreadPoolExecutor(min(len(variants), 3)) as pool:
        dirs = list(pool.map(lambda v: v[1](), variants))
    print(f"{len(dirs)} variants built in {time.time() - t0:.1f} s",
          flush=True)
    libs, ptx = [], []
    for (label, _), out_dir in zip(variants, dirs):
        print(f"variant {label}:", flush=True)
        report = (out_dir / "ptxas.txt").read_text()
        for line in report.splitlines():
            if line.startswith("== "):
                print("  " + line, flush=True)
        for unit, kern, regs, stack, spill in build.ptxas_summary(report):
            print(f"  ptxas {unit} {kern}: {regs} registers, {stack} B "
                  f"stack, {spill} B spill stores", flush=True)
        ptx.append([r for r in build.ptxas_summary(report)
                    if r[0].startswith(("group", "msm_scan"))])
        libs.append(build.load(out_dir))
        if args.sass and out_dir != dirs[0]:
            print(f"  sass against {variants[0][0]}: "
                  f"{json.dumps(sass_compare(dirs[0], out_dir))}", flush=True)
    wrong = set()
    for cfg in cfgs:
        ops = inputs(np.random.default_rng(CS.SEED + cfg), cfg, args.quick)
        order = list(range(len(variants)))
        for rnd in range(args.rounds):
            for i in order:
                if (i, cfg) in wrong:
                    continue
                # the wrappers ask build.library() at each launch: hand them
                # this variant's library for the duration of its measurements
                build.library = lambda lib=libs[i]: lib
                if rnd == 0:
                    try:
                        check_small(np.random.default_rng(CS.SEED + cfg),
                                    ops["cops"])
                    except AssertionError as e:
                        print(f"variant {variants[i][0]} cfg {cfg}: {e}",
                              flush=True)
                        wrong.add((i, cfg))
                        continue
                row = {"variant": variants[i][0], "cfg": cfg, "round": rnd,
                       "card": card}
                row.update(time_variant(ops))
                row["ptxas"] = [r[1:] for r in ptx[i]
                                if r[0].endswith(str(cfg))]
                print(json.dumps(row), flush=True)
            order.reverse()
        del ops
        torch.cuda.empty_cache()
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())

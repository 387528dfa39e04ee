"""CPU oracle prover and preprocessed-table builder (file level).

A copy of the JAX package's models/cpu_prover.py over the port's own
host/ modules.  Equivalent of the reference's `main` binary modes
(libsnark/main.cpp:342-366):
  - compute:    run_prover (:172-233) -- the sha256 oracle for the device
    prover (`gpu <CURVE> compute`)
  - preprocess: run_preprocess (:311-339) -- writes windowed multiples of
    B1, B2, L with C=5 to `<CURVE>_preprocessed`
"""

import os
from typing import List

from ..curves.constants import CURVES, CurveParams
from ..host import ec, groth16
from ..utils import serialization as ser
from ..utils.profiling import enter_block, leave_block

PREPROCESS_C = 5  # window size of the multiples table (main.cpp:320)


def run_prover(curve: CurveParams, params_path: str, input_path: str,
               output_path: str) -> None:
    enter_block("load params")
    params = ser.read_params(params_path, curve)
    leave_block("load params")
    enter_block("load inputs")
    inputs = ser.read_input(input_path, curve, params.d, params.m)
    leave_block("load inputs")
    enter_block("prove (cpu oracle)")
    a, b, c = groth16.prove(curve, params, inputs)
    leave_block("prove (cpu oracle)")
    ser.write_output(output_path, curve, a, b, c)


def _multiples_rows(group, base_pts: List, c: int) -> List[List]:
    """[[P..], [2P..], ..., [(2^c - 1)P..]] (main.cpp:248-277).

    `base_pts` are affine; rows are returned affine (the file format is
    affine).
    """
    rows = []
    jac = [group.from_affine(xy) if not group.fis_zero(xy[1]) else group.zero
           for xy in base_pts]
    acc = list(jac)
    rows.append(list(acc))
    for _ in range(2, 1 << c):
        acc = [group.add(a, b) for a, b in zip(acc, jac)]
        rows.append(list(acc))
    out = []
    for row in rows:
        if group.deg == 1:
            out.append(group.batch_to_affine(row))
        else:
            out.append([group.to_affine(pt) for pt in row])
    return out


def run_preprocess(curve: CurveParams, params_path: str,
                   output_path: str) -> None:
    params = ser.read_params(params_path, curve)
    g1 = ec.g1_group(curve)
    g2 = ec.g2_group(curve)
    p = curve.fq.p
    with open(output_path, "wb") as f:
        for row in _multiples_rows(g1, params.B1, PREPROCESS_C):
            for xy in row:
                ser.write_g1(f, xy, p)
        for row in _multiples_rows(g2, params.B2, PREPROCESS_C):
            for xy in row:
                ser.write_g2(f, xy, p)
        for row in _multiples_rows(g1, params.L, PREPROCESS_C):
            for xy in row:
                ser.write_g1(f, xy, p)


def main_mode(curve_name: str, mode: str, params_path: str,
              input_path: str = None, output_path: str = None) -> None:
    """argv contract of the reference `main` binary (main.cpp:342-366)."""
    curve = CURVES[curve_name]
    if mode == "compute":
        run_prover(curve, params_path, input_path, output_path)
    elif mode == "preprocess":
        run_preprocess(curve, params_path, f"{curve_name}_preprocessed")
    else:
        raise ValueError(f"unknown mode {mode}")

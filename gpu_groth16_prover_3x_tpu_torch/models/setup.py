"""generate_parameters: trusted setup and input generation to files.

The file-level counterpart of the reference's `generate_parameters`
binary (libsnark/generate_parameters.cpp:125-137) and of the JAX
package's models/setup.py: writes `<CURVE>-parameters` and
`<CURVE>-input` for both curves (default sizes 2^20 / 2^15; `fast`
gives 2^14 / 2^10).  Below 2^10 the host oracle (host/groth16.setup) runs
the setup, from 2^10 up the device setup (models/setup_device.py); both
write the same bytes for the same seed.
"""

import json
import os
import random
from typing import Optional

from ..curves.constants import CURVES, CurveParams
from ..host import groth16
from ..utils import serialization as ser
from ..utils.profiling import enter_block, leave_block, log_device_memory
from . import setup_device

ORACLE_BELOW = 10      # log2 d below which the host oracle runs the setup


def generate_parameters(curve: CurveParams, log2_d: int, params_path: str,
                        input_path: str, seed: Optional[int] = None,
                        trapdoor_path: Optional[str] = None, device="cuda",
                        oracle: Optional[bool] = None) -> None:
    """One curve's files.  `oracle` None picks the host oracle below
    2^ORACLE_BELOW and the device setup on `device` from there up."""
    rng = random.Random(seed)
    if oracle is None:
        oracle = log2_d < ORACLE_BELOW
    if oracle:
        result = groth16.setup(curve, log2_d, rng)
        enter_block("write files")
        ser.write_params(params_path, curve, result.d, result.m,
                         result.A, result.B1, result.B2, result.L, result.H)
    else:
        rows, result = setup_device.setup(curve, log2_d, rng, device)
        log_device_memory(f"{curve.name} setup")
        enter_block("write files")
        ser.write_params_rows(params_path, rows)
    ser.write_input(input_path, curve, result.w, result.ca, result.cb,
                    result.cc, result.r)
    leave_block("write files")
    if trapdoor_path:
        enter_block("write trapdoor")
        td = result.trapdoor
        with open(trapdoor_path, "w") as f:
            json.dump({
                "t": td.t, "alpha": td.alpha, "beta": td.beta,
                "delta": td.delta, "g1_dlog": td.g1_dlog,
                "zt": td.zt, "at": td.at, "bt": td.bt, "ct": td.ct,
                "d": result.d, "m": result.m,
                "w": result.w, "r": result.r,
            }, f)
        leave_block("write trapdoor")


def trapdoor_result(curve: CurveParams, td_path: str, input_path: str):
    """The SetupResult host/groth16.verify_with_trapdoor needs, from the
    trapdoor JSON that generate_parameters writes and the input file."""
    with open(td_path) as f:
        td = json.load(f)
    inputs = ser.read_input(input_path, curve, td["d"], td["m"])
    if inputs.w != td["w"] or inputs.r != td["r"]:
        raise ValueError("the input file disagrees with the trapdoor")
    return groth16.SetupResult(
        d=td["d"], m=td["m"], A=None, B1=None, B2=None, L=None, H=None,
        w=inputs.w, ca=inputs.ca, cb=inputs.cb, cc=inputs.cc, r=inputs.r,
        trapdoor=groth16.Trapdoor(td["t"], td["alpha"], td["beta"],
                                  td["delta"], td["g1_dlog"], td["at"],
                                  td["bt"], td["ct"], td["zt"]))


def generate_all(fast: bool = False, outdir: str = ".",
                 log2_d_4753: Optional[int] = None,
                 log2_d_6753: Optional[int] = None,
                 seed: Optional[int] = None, device="cuda") -> None:
    """The reference binary's main (generate_parameters.cpp:125-137)."""
    l4 = log2_d_4753 if log2_d_4753 is not None else (14 if fast else 20)
    l6 = log2_d_6753 if log2_d_6753 is not None else (10 if fast else 15)
    for name, log2_d in (("MNT4753", l4), ("MNT6753", l6)):
        generate_parameters(
            CURVES[name], log2_d,
            os.path.join(outdir, f"{name}-parameters"),
            os.path.join(outdir, f"{name}-input"),
            seed=seed, device=device,
        )

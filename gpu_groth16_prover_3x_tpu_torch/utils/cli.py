"""Command line of the port, mirroring the reference prover binary.

    python -m gpu_groth16_prover_3x_tpu_torch gpu <CURVE> compute \
        <params> <input> <output> [--device cuda|cpu]

is the reference's `cuda_prover_piecewise <CURVE> compute params input
output` (cuda_prover_piecewise.cu:232-259).  The parser is strict: an
extra positional argument is an error, not ignored.
"""

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gpu_groth16_prover_3x_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("gpu", help="prover on a CUDA card (or the CPU)")
    pr.add_argument("curve", choices=["MNT4753", "MNT6753"])
    pr.add_argument("mode", choices=["compute"])
    pr.add_argument("params_path")
    pr.add_argument("input_path")
    pr.add_argument("output_path")
    pr.add_argument("--device", default="cuda",
                    help="torch device to prove on (default: cuda)")
    args = parser.parse_args(argv)

    from ..models import gpu_prover
    gpu_prover.run_prover(args.curve, args.params_path, args.input_path,
                          args.output_path, device=args.device)
    return 0

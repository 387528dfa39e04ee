"""Command line of the port, mirroring the reference prover binaries.

    python -m gpu_groth16_prover_3x_tpu_torch gpu <CURVE> compute \
        <params> <input> <output> [--device cuda|cpu]
    python -m gpu_groth16_prover_3x_tpu_torch gpu <CURVE> preprocess \
        <params> [--device cuda|cpu]
    python -m gpu_groth16_prover_3x_tpu_torch gpu <CURVE> serve \
        <params> <input> <output> [<input> <output> ...] [--device ...]

`compute` is the reference's `cuda_prover_piecewise <CURVE> compute
params input output` (cuda_prover_piecewise.cu:232-259); it takes the
table path when `<CURVE>_preprocessed` (or $GROTH16_PREPROCESSED_PATH) is
a file.  `preprocess` is the reference's `main <CURVE> preprocess params`
(libsnark/main.cpp:342-366) and writes `<CURVE>_preprocessed` in the
working directory.  `serve` stages the parameter set once and proves
every <input> <output> pair against it.  The parser is strict: a mode
given other paths than its own is an error, not ignored.
"""

import argparse

PATHS = {"compute": "<input> <output>", "preprocess": "no other path",
         "serve": "<input> <output> pairs"}


def _paths_ok(mode: str, paths: list) -> bool:
    if mode == "compute":
        return len(paths) == 2
    if mode == "preprocess":
        return not paths
    return len(paths) >= 2 and len(paths) % 2 == 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gpu_groth16_prover_3x_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("gpu", help="prover on a CUDA card (or the CPU)")
    pr.add_argument("curve", choices=["MNT4753", "MNT6753"])
    pr.add_argument("mode", choices=list(PATHS))
    pr.add_argument("params_path")
    pr.add_argument("paths", nargs="*", help="compute: <input> <output>; "
                    "serve: <input> <output> pairs; preprocess: none")
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    if not _paths_ok(args.mode, args.paths):
        pr.error(f"{args.mode} takes {PATHS[args.mode]} after <params>")

    if args.mode == "preprocess":
        from ..curves.constants import CURVES
        from ..models import preprocess_device
        preprocess_device.run_preprocess(
            CURVES[args.curve], args.params_path,
            f"{args.curve}_preprocessed", device=args.device)
        return 0
    from ..models import gpu_prover
    if args.mode == "serve":
        gpu_prover.serve_files(
            args.curve, args.params_path,
            list(zip(args.paths[0::2], args.paths[1::2])),
            device=args.device)
        return 0
    gpu_prover.run_prover(args.curve, args.params_path, *args.paths,
                          device=args.device)
    return 0

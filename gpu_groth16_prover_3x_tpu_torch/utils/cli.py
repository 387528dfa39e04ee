"""Command line of the port, mirroring the reference binaries.

    python -m gpu_groth16_prover_3x_tpu_torch generate_parameters [fast] \
        [--log2-d-4753 N] [--log2-d-6753 N] [--seed S] [--outdir DIR] \
        [--device cuda|cpu]
    python -m gpu_groth16_prover_3x_tpu_torch cpu <CURVE> compute \
        <params> <input> <output>
    python -m gpu_groth16_prover_3x_tpu_torch cpu <CURVE> preprocess <params>
    python -m gpu_groth16_prover_3x_tpu_torch gpu <CURVE> compute \
        <params> <input> <output> [--device cuda|cpu]
    python -m gpu_groth16_prover_3x_tpu_torch gpu <CURVE> preprocess \
        <params> [--device cuda|cpu]
    python -m gpu_groth16_prover_3x_tpu_torch gpu <CURVE> serve \
        <params> <input> <output> [<input> <output> ...] [--device ...]

`generate_parameters` is the reference's binary of that name
(generate_parameters.cpp:125-137): the host oracle below 2^10, the device
setup from 2^10 up (models/setup.py).  `cpu` is the reference's `main`
(libsnark/main.cpp:342-366), the host oracle whose proofs the device
prover must reproduce byte for byte.  `gpu compute` is the reference's
`cuda_prover_piecewise <CURVE> compute params input output`
(cuda_prover_piecewise.cu:232-259); it takes the table path when
`<CURVE>_preprocessed` (or $GROTH16_PREPROCESSED_PATH) is a file.
`preprocess` writes `<CURVE>_preprocessed` in the working directory.
`serve` stages the parameter set once and proves every <input> <output>
pair against it.  The parser is strict: a mode given other paths than
its own is an error, not ignored.
"""

import argparse

PATHS = {"compute": "<input> <output>", "preprocess": "no other path",
         "serve": "<input> <output> pairs"}
CURVE_NAMES = ["MNT4753", "MNT6753"]


def _paths_ok(mode: str, paths: list) -> bool:
    if mode == "compute":
        return len(paths) == 2
    if mode == "preprocess":
        return not paths
    return len(paths) >= 2 and len(paths) % 2 == 0


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gpu_groth16_prover_3x_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    gen = sub.add_parser("generate_parameters",
                         help="trusted setup + input files for both curves")
    gen.add_argument("fast", nargs="?", choices=["fast"])
    gen.add_argument("--log2-d-4753", type=int, default=None)
    gen.add_argument("--log2-d-6753", type=int, default=None)
    gen.add_argument("--seed", type=int, default=None)
    gen.add_argument("--outdir", default=".")
    _device_arg(gen)

    provers = {}
    for name, desc, modes in (
            ("cpu", "host oracle prover", ["compute", "preprocess"]),
            ("gpu", "prover on a CUDA card (or the CPU)", list(PATHS))):
        pr = sub.add_parser(name, help=desc)
        pr.add_argument("curve", choices=CURVE_NAMES)
        pr.add_argument("mode", choices=modes)
        pr.add_argument("params_path")
        pr.add_argument("paths", nargs="*", help="compute: <input> <output>; "
                        "serve: <input> <output> pairs; preprocess: none")
        if name == "gpu":
            _device_arg(pr)
        provers[name] = pr
    args = parser.parse_args(argv)

    if args.cmd == "generate_parameters":
        from ..models import setup
        setup.generate_all(
            fast=args.fast == "fast", outdir=args.outdir,
            log2_d_4753=args.log2_d_4753, log2_d_6753=args.log2_d_6753,
            seed=args.seed, device=args.device)
        return 0
    if not _paths_ok(args.mode, args.paths):
        provers[args.cmd].error(
            f"{args.mode} takes {PATHS[args.mode]} after <params>")

    if args.cmd == "cpu":
        from ..models import cpu_prover
        cpu_prover.main_mode(args.curve, args.mode, args.params_path,
                             *args.paths)
        return 0
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

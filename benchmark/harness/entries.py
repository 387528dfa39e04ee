"""The entries of the program that a traffic mix drives.

A mix file (benchmark/mixes/<mix>.json) names its `entry`:

- `session`: set-up stages the key once in a `ProverSession`; each proof
  is one `ProverSession.prove(DeviceInput)` on a fresh witness from a
  pool made in set-up.
- `cli`: set-up writes the params file and `input_files` input files to a
  work directory under TMPDIR (and, with `preprocess`, runs
  `gpu <CURVE> preprocess params` there); each proof is one
  `gpu <CURVE> compute params input output` through the port's command
  line, the inputs read in turn.

An entry's `prove(j)` proves input j of `values` and returns what the
program returned (affine points) or wrote (the proof file's bytes);
`None` stands for a proof file that was not written.
"""

import contextlib
import os
import shutil
import sys
import tempfile

from groth16_ref import algebra, keys


class SessionEntry:
    def __init__(self, cell, base):
        from gpu_groth16_prover_3x_tpu_torch.models.gpu_prover import (
            DeviceParams, ProverSession)
        q = {k: keys.query_rows(k, cell.log2, base) for k in keys.QUERIES}
        sz = keys.sizes(cell.log2)
        params = DeviceParams(sz["d"], sz["m"], q["A"], q["B1"], q["B2"],
                              q["L"], q["H"])
        del q
        self.cell = cell
        self.session = ProverSession(cell.curve, params, cell.device)
        self.values = []

    def add_inputs(self, values: list) -> None:
        self.values.extend(values)

    def before(self) -> None:
        pass

    def prove(self, j: int):
        from gpu_groth16_prover_3x_tpu_torch.models.gpu_prover import \
            DeviceInput
        w, ca, cb, cc, r = self.values[j]
        return self.session.prove(DeviceInput(w.T, ca.T, cb.T, cc.T, r))

    def proof_bytes(self, out) -> bytes:
        return algebra.proof_bytes(self.cell.ref_curve, *out)

    def close(self) -> None:
        self.session = None


class CliEntry:
    def __init__(self, cell, base):
        self.cell = cell
        self.mix = cell.mix
        self.workdir = tempfile.mkdtemp(prefix="groth16-bench-")
        self.cwd = os.getcwd()
        os.chdir(self.workdir)
        self.saved_env = os.environ.pop("GROTH16_PREPROCESSED_PATH", None)
        name = cell.curve.name
        self.params = os.path.join(self.workdir, f"{name}-parameters")
        keys.write_params(self.params, cell.log2, base)
        self.out = os.path.join(self.workdir, "proof")
        if self.mix.get("preprocess"):
            self._cli(["preprocess", self.params])
        self.values, self.paths = [], []

    def _cli(self, args):
        from gpu_groth16_prover_3x_tpu_torch.utils import cli
        with contextlib.redirect_stdout(sys.stderr):
            cli.main(["gpu", self.cell.curve.name, *args, "--device",
                      self.cell.device.type])

    def add_inputs(self, values: list) -> None:
        for v in values:
            path = os.path.join(self.workdir, f"input-{len(self.paths)}")
            keys.write_input(path, self.cell.ref_curve, v)
            self.values.append(v)
            self.paths.append(path)

    def before(self) -> None:
        """Outside the timed call: no proof file is left from the last."""
        if os.path.exists(self.out):
            os.remove(self.out)

    def prove(self, j: int):
        self._cli(["compute", self.params, self.paths[j], self.out])

    def proof_bytes(self, _out):
        """The proof file as written (read outside the timed call)."""
        if not os.path.exists(self.out):
            return None
        with open(self.out, "rb") as f:
            return f.read()

    def close(self) -> None:
        os.chdir(self.cwd)
        if self.saved_env is not None:
            os.environ["GROTH16_PREPROCESSED_PATH"] = self.saved_env
        shutil.rmtree(self.workdir, ignore_errors=True)


ENTRIES = {"session": SessionEntry, "cli": CliEntry}

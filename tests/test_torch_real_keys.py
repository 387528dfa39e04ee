"""Real keys through every proving path, in small: the steps of
`prove_at_scale.py keys` and `oracle-15` (setup, pippenger, preprocess,
compute, oracle) on the CPU at d + 1 = 2^4 for both curves and the run's
seed, held against the JAX package:

  * the port's parameters, input and trapdoor files are byte-equal to the
    JAX package's generate_parameters at the same seed and size;
  * every proof (unforced, rows in host memory in blocks that hold an
    identity row, both `serve` outputs, the table path, the port's `cpu`
    oracle) has the sha256 of the JAX package's `cpu` oracle on the
    port's files, which the JAX package's verify_with_trapdoor accepts;
  * A, B1 and B2 hold identity rows (real keys do; synthetic ones never);
  * table_bytes gives the size of the `cpu preprocess` file.

One setup and one run of the steps per curve (module scope).  The JAX
package's calls run with its in-place native library switched off (its
pure-Python fallbacks)."""

import hashlib
import os
import random

import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JCURVES
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.utils import cli
from gpu_groth16_prover_3x_tpu_torch.utils.synthetic import read_proof

import prove_at_scale as PAS

LOG2 = 4
CURVE_NAMES = ["MNT4753", "MNT6753"]
STEPS = ["setup", "pippenger", "preprocess", "compute", "oracle"]
# every proof the steps write, by path
PROOFS = ["unforced", "host-rows", "serve-0", "serve-1", "table", "oracle"]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the suite runs several workers per machine,
    and this file's plain bucket reductions (about 25 s a proof of
    MNT6753 on one thread, 18 on two) would make it the longest."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module", params=CURVE_NAMES)
def run(request, tmp_path_factory):
    """One curve: the port's steps in order in one work directory, the
    JAX package's setup files at the same seed and size, its setup result
    (the trapdoor) and its `cpu` proof on the port's files."""
    from gpu_groth16_prover_3x_tpu.host import groth16 as JHG
    from gpu_groth16_prover_3x_tpu.models import cpu_prover as JCP
    from gpu_groth16_prover_3x_tpu.models import setup as JSU
    from gpu_groth16_prover_3x_tpu.utils import native as jax_native
    name = request.param
    work = tmp_path_factory.mktemp(f"keys_{name}")
    jax_dir = tmp_path_factory.mktemp(f"jax_{name}")
    steps = {step: PAS.KEY_STEPS[step](str(work), {name: LOG2}, "cpu")
             for step in STEPS}
    jcurve = JCURVES[name]
    params, inp, _ = PAS.key_paths(str(work), name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_load", lambda: None)
        JSU.generate_parameters(jcurve, LOG2, str(jax_dir / "parameters"),
                                str(jax_dir / "input"), seed=PAS.SEED,
                                trapdoor_path=str(jax_dir / "trapdoor"))
        result = JHG.setup(jcurve, LOG2, random.Random(PAS.SEED))
        JCP.run_prover(jcurve, params, inp, str(jax_dir / "proof"))
    pip = os.path.dirname(PAS.pippenger_proof(str(work), name))
    proofs = {k: os.path.join(pip, f"{name}-{k}") for k in PROOFS[:4]}
    proofs["unforced"] = PAS.pippenger_proof(str(work), name)
    proofs["table"] = os.path.join(work, f"{name}-table-proof")
    proofs["oracle"] = os.path.join(work, f"{name}-oracle-proof")
    return dict(name=name, work=work, jax=jax_dir, steps=steps,
                result=result, proofs=proofs)


@pytest.mark.parametrize("step", STEPS)
def test_step_passes(run, step):
    res = run["steps"][step]
    assert res["faults"] == [] and res["ok"]
    assert list(res["curves"]) == [run["name"]]


@pytest.mark.parametrize("kind", ["parameters", "input", "trapdoor.json"])
def test_setup_files_equal_jax_generate_parameters(run, kind):
    mine = run["work"] / f"{run['name']}-{kind}"
    theirs = run["jax"] / kind.replace(".json", "")
    assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("path", PROOFS)
def test_proof_equals_jax_cpu_oracle(run, path):
    assert sha(run["proofs"][path]) == sha(run["jax"] / "proof")


def test_proofs_verify_with_jax_trapdoor(run):
    """Every proof has the bytes of the JAX oracle's (above), which the
    JAX package's verify_with_trapdoor accepts; a proof with A and C
    swapped it refuses."""
    from gpu_groth16_prover_3x_tpu.host import groth16 as JHG
    name = run["name"]
    a, b, c = read_proof(run["proofs"]["unforced"], CURVES[name])
    assert JHG.verify_with_trapdoor(JCURVES[name], run["result"], a, b, c)
    assert not JHG.verify_with_trapdoor(JCURVES[name], run["result"], c, b,
                                        a)


def test_a_b1_b2_hold_identity_rows(run):
    ids = run["steps"]["setup"]["curves"][run["name"]]["identity_rows"]
    assert set(ids) == set(PAS.QUERIES)
    assert ids["A"] > 0 and ids["B1"] > 0 and ids["B2"] > 0
    params, _, _ = PAS.key_paths(str(run["work"]), run["name"])
    assert ids == PAS.identity_rows(params, CURVES[run["name"]])


def test_host_row_blocks_hold_identity_rows(run):
    """The forced proof's G1 rows in 8 blocks and B2's in 3, both from
    host memory, each with a block that holds an identity row before a
    point."""
    got = run["steps"]["pippenger"]["curves"][run["name"]]
    assert got["block_points"] == 1 << (LOG2 - 1)
    g1, b2 = got["streamed"]
    assert (g1["deg"], g1["blocks"], g1["rows_on"]) == (1, 8, "host")
    assert (b2["blocks"], b2["rows_on"]) == (3, "host") and b2["deg"] > 1
    assert g1["identity_blocks"] and b2["identity_blocks"]
    assert PAS.block_faults(got["streamed"], None) == []
    # a grid with no identity row inside a block is a fault
    no_inner = [dict(k, identity_blocks=[]) for k in got["streamed"]]
    assert len(PAS.block_faults(no_inner, None)) == 2


def test_table_bytes_equal_cpu_preprocess_file(run, tmp_path, monkeypatch):
    name = run["name"]
    params, _, _ = PAS.key_paths(str(run["work"]), name)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["cpu", name, "preprocess", params]) == 0
    cpu_file = tmp_path / f"{name}_preprocessed"
    want = PAS.table_bytes(CURVES[name], 1 << LOG2)
    assert os.path.getsize(cpu_file) == want
    assert run["steps"]["preprocess"]["curves"][name]["file_bytes"] == want
    assert cpu_file.read_bytes() == \
        (run["work"] / f"{name}_preprocessed").read_bytes()


def test_table_bytes_at_the_reference_size():
    """MNT4753 2^20 (24.96 GB, the size `preprocess` writes there) and
    MNT6753 2^15, whose G2 points over Fq3 take 576 B."""
    assert PAS.table_bytes(CURVES["MNT4753"], 1 << 20) == 24_964_509_312
    assert PAS.table_bytes(CURVES["MNT6753"], 1 << 15) == \
        31 * ((2**15 + 1) * 768 + (2**15 - 1) * 192)


def test_key_child_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the child would run")
    assert PAS.main(["--child", "keys", "setup", str(tmp_path)]) == 1
    assert not list(tmp_path.iterdir())


def test_unknown_run_is_refused():
    assert PAS.main(["keys", "oracle-20"]) == 2

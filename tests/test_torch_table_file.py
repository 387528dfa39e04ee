"""The table file written a block of rows at a time, on the CPU.

`gpu <CURVE> preprocess` (models/preprocess_device.run_preprocess)
writes each table as multiples_blocks yields it: a block is the rows
whose projective points fit ROWS_BYTES.  At the fixtures' 17 points one
block holds all 31 rows, so ROWS_BYTES is forced down here to 16 rows
of the B1 table (B1 then goes in blocks of 16 and 15 rows, B2 over Fq2
in 8, 8, 8 and 7, over Fq3 in six of 5 and a last of 1, and L, two
points shorter, in 18 and 13).  The file must be byte-equal to the whole tables
(multiples_rows) written one after the other and to the JAX package's
`cpu <CURVE> preprocess` of the same fixture.  Each block costs one batch
inversion of plain field products (about a second here), so the blocks
are few."""

import os

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JCURVES
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.models import preprocess_device as PD
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")
CURVE_NAMES = ["MNT4753", "MNT6753"]
GROUPS = ("g1", "g2", "g1")         # B1, B2, L in file order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def params_path(curve_name: str) -> str:
    return os.path.join(FIX, f"{curve_name}-parameters")


def queries(curve_name: str):
    p = GP.load_params(params_path(curve_name), CURVES[curve_name])
    return list(zip((p.B1, p.B2, p.L), GROUPS))


def rows_per_block(curve_name: str, group: str, rows: int) -> int:
    """ROWS_BYTES that makes a block of `rows` rows of the B1 (or B2)
    table: its projective points, m + 1 to a row."""
    n = GP.load_params(params_path(curve_name), CURVES[curve_name]).m + 1
    deg = CURVES[curve_name].ext_degree if group == "g2" else 1
    return rows * n * 3 * deg * L.NWORDS * 4


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Per curve: the whole tables written one after the other, and the
    JAX package's `cpu` preprocess of the fixture."""
    from gpu_groth16_prover_3x_tpu.models import cpu_prover
    out = {}
    for name in CURVE_NAMES:
        whole = b"".join(
            PD.multiples_rows(CURVES[name], group, rows, device="cpu")
            .numpy().tobytes() for rows, group in queries(name))
        path = tmp_path_factory.mktemp(f"jax_{name}") / "preprocessed"
        cpu_prover.run_preprocess(JCURVES[name], params_path(name),
                                  str(path))
        out[name] = whole, path.read_bytes()
    return out


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_whole_tables_equal_jax_cpu_oracle(curve_name, references):
    whole, jax_file = references[curve_name]
    assert len(whole) > 0 and whole == jax_file


BLOCK_ROWS = 16         # G1 rows a block when ROWS_BYTES is forced


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_blockwise_file_equals_whole_tables(curve_name, references,
                                            tmp_path, monkeypatch):
    monkeypatch.setattr(PD, "ROWS_BYTES",
                        rows_per_block(curve_name, "g1", BLOCK_ROWS))
    writes = []
    write_rows = PD.write_rows

    def count(f, block):
        writes.append(block.shape[0])
        write_rows(f, block)
    monkeypatch.setattr(PD, "write_rows", count)
    path = tmp_path / f"{curve_name}_preprocessed"
    PD.run_preprocess(CURVES[curve_name], params_path(curve_name),
                      str(path), device="cpu")
    whole, jax_file = references[curve_name]
    got = path.read_bytes()
    assert got == whole and got == jax_file
    # B1 in blocks of 16 rows, B2 of 16 // deg, L (two points fewer) of 18
    def blocks(per):
        return [per] * (31 // per) + [31 % per] * (31 % per > 0)
    deg = CURVES[curve_name].ext_degree
    assert writes == (blocks(BLOCK_ROWS) + blocks(BLOCK_ROWS // deg)
                      + blocks(18))


def test_multiples_blocks_cover_the_table_in_order(monkeypatch):
    """multiples_blocks yields row offsets 0, 8, 16, 24 and together the
    rows of multiples_rows; ROWS_BYTES forced to 8 G1 rows."""
    name = "MNT4753"
    rows = GP.load_params(params_path(name), CURVES[name]).B1
    whole = PD.multiples_rows(CURVES[name], "g1", rows, device="cpu")
    monkeypatch.setattr(PD, "ROWS_BYTES", rows_per_block(name, "g1", 8))
    k0s, blocks = zip(*PD.multiples_blocks(CURVES[name], "g1", rows,
                                           device="cpu"))
    assert list(k0s) == [0, 8, 16, 24]
    assert [len(b) for b in blocks] == [8, 8, 8, 7]
    assert torch.equal(torch.cat(blocks), whole)


def test_upload_tables_shapes_and_words():
    """upload_tables: host arrays and tensors -> 2-D rows on the device,
    the same words; a tensor already there is not copied."""
    rng = np.random.default_rng(7)
    host = [rng.integers(-2**31, 2**31, size=s, dtype=np.int32)
            for s in ((31 * 5, 48), (31 * 5, 96), (31 * 3, 48))]
    on_dev = torch.from_numpy(host[1]).reshape(31, 5, 96)
    got = GP.upload_tables((host[0], on_dev, host[2]), "cpu")
    for g, h in zip(got, host):
        assert g.shape == h.shape and g.dtype == torch.int32
        assert np.array_equal(g.numpy(), h)
    assert got[1].data_ptr() == on_dev.data_ptr()

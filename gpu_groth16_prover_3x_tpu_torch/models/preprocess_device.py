"""The preprocessed-table builder on the device (the reference's
`main <CURVE> preprocess` mode, libsnark/main.cpp:311-339).

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/models/
preprocess_device.py.  The table holds rows [P..], [2P..], ...,
[(2^C - 1)P..] of the B1, B2 and L query points with C = 5
(output_g1_multiples, main.cpp:248-277): row k+1 is row k plus the base
row, one launch of the mixed-add kernel (group_kernels.ec_mixed_add) over
the whole query vector.  Rows are normalised to affine
(ops/inverse.to_affine_rows) a block at a time, the block's projective
points kept under ROWS_BYTES, so the projective rows never all live at
once (31 Fq2 rows at 2^20 points would be 18.6 GB).  `run_preprocess`
writes each block to the file as it comes (multiples_blocks,
write_rows): neither the card nor the host holds a whole table (the
MNT4753 B2 table alone is 12.48 GB at 2^20 points).

The file is byte-identical to the reference format and to the JAX
package's `cpu` and `tpu` preprocess: affine rows of raw Montgomery
words, row-major by multiple, infinity as the all-zero point.
"""

import torch

from ..curves.constants import CurveParams
from ..ops import limbs as L
from ..ops import group_kernels
from ..ops.ec import get_curve_ops
from ..ops.inverse import to_affine_rows
from ..ops.msm import identity_words
from ..ops.straus import STRAUS_C
from .gpu_prover import load_params

ROWS_BYTES = 2 << 30      # projective points normalised together


def affine_operand(cops, rows, device):
    """Affine rows (n, 2*deg*24) int32 (numpy or tensor) -> the mixed-add
    operand: (2*deg, 24, n) words on `device` and the (n,) infinity mask,
    y == 0."""
    deg = cops.deg
    rows = torch.as_tensor(rows).to(device)
    n, width = rows.shape
    if width != 2 * deg * L.NWORDS:
        raise ValueError(f"rows shape {tuple(rows.shape)}")
    xy = rows.t().reshape(2 * deg, L.NWORDS, n).contiguous()
    return xy, (xy[deg:] == 0).reshape(deg * L.NWORDS, n).all(0)


def multiples_blocks(curve: CurveParams, group: str, rows,
                     c: int = STRAUS_C, device="cuda"):
    """Affine base rows (n, 2*deg*24) int32 (numpy or tensor) -> the
    table's rows in order, a block at a time: yields (k0, block), block
    (k, n, 2*deg*24) int32 on `device` with entry [j, i] the affine
    (k0 + j + 1) * P_i in the row layout, the identity as the zero row.
    One ec_mixed_add launch a row; a block is the rows whose projective
    points fit ROWS_BYTES, normalised together."""
    cops = get_curve_ops(curve, group)
    deg = cops.deg
    dev = torch.device(device)
    xy, inf = affine_operand(cops, rows, dev)
    n, width = xy.shape[-1], 2 * deg * L.NWORDS
    nmul = (1 << c) - 1
    per = max(1, ROWS_BYTES // (n * 3 * deg * L.NWORDS * 4))
    acc = identity_words(cops, n, dev)
    block = []
    for k in range(nmul):
        acc = group_kernels.ec_mixed_add(cops, acc, xy, inf)
        block.append(acc)
        if len(block) == per or k == nmul - 1:
            yield k + 1 - len(block), to_affine_rows(
                cops, torch.cat(block, -1)).reshape(len(block), n, width)
            block = []


def multiples_rows(curve: CurveParams, group: str, rows, c: int = STRAUS_C,
                   device="cuda") -> torch.Tensor:
    """Affine base rows (n, 2*deg*24) int32 (numpy or tensor) -> the
    whole table (2^c - 1, n, 2*deg*24) int32 on `device`: entry [k, i] is
    the affine (k+1) * P_i in the row layout (multiples_blocks)."""
    cops = get_curve_ops(curve, group)
    out = torch.empty(((1 << c) - 1, len(rows), 2 * cops.deg * L.NWORDS),
                      dtype=torch.int32, device=torch.device(device))
    for k0, block in multiples_blocks(curve, group, rows, c, device):
        out[k0:k0 + len(block)] = block
    return out


def write_rows(f, rows: torch.Tensor) -> None:
    """Append table rows (a block of multiples_blocks) to the open file
    as raw words."""
    rows.cpu().numpy().tofile(f)


def run_preprocess(curve: CurveParams, params_path: str, output_path: str,
                   device="cuda") -> None:
    """Write `<CURVE>_preprocessed`: the B1, B2 and L multiples, C = 5,
    each table a block of rows at a time."""
    params = load_params(params_path, curve)
    with open(output_path, "wb") as f:
        for rows, group in ((params.B1, "g1"), (params.B2, "g2"),
                            (params.L, "g1")):
            for _, block in multiples_blocks(curve, group, rows,
                                             device=device):
                write_rows(f, block)

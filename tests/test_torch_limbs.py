"""Port limb layer (gpu_groth16_prover_3x_tpu_torch/ops/limbs.py and the
plain version of the mont_mul kernel) against exact Python integers and
against the JAX package's limb layer.

Inputs are made with numpy from a seed; every comparison is exact."""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import P_A, P_B, R
from gpu_groth16_prover_3x_tpu.ops import limbs as JL
from gpu_groth16_prover_3x_tpu.utils import serialization as JS
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops.mont_mul import mont_mul


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands(p: int, n: int, seed: int) -> list:
    """Adversarial values first (0, 1, p-1, p-2, all-ones low words under
    p's top word), then seeded random values below p."""
    rng = np.random.default_rng(seed)
    top = p >> 736
    special = [0, 1, p - 1, p - 2, ((top - 1) << 736) | ((1 << 736) - 1),
               (1 << 752) - 1, R % p]
    words = rng.integers(0, 1 << 32, size=(n, 24), dtype=np.uint64)
    words[:, -1] %= top
    rand = [int.from_bytes(w.astype("<u4").tobytes(), "little")
            for w in words]
    return special + rand


@pytest.mark.parametrize("p", [P_A, P_B], ids=["P_A", "P_B"])
def test_mont_mul_plain_vs_ints(p):
    xs = _operands(p, 60, 1)
    ys = _operands(p, 60, 2)[::-1]
    ctx = L.MontCtx(p)
    a = torch.from_numpy(L.ints_to_words(xs))
    b = torch.from_numpy(L.ints_to_words(ys))
    got = L.words_to_ints(mont_mul(ctx, a, b).numpy())
    rinv = pow(R, -1, p)
    assert got == [x * y * rinv % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("p", [P_A, P_B], ids=["P_A", "P_B"])
def test_add_sub_plain_vs_ints(p):
    xs = _operands(p, 40, 3)
    ys = _operands(p, 40, 4)[::-1]
    ctx = L.MontCtx(p)
    a = L.to_limbs(torch.from_numpy(L.ints_to_words(xs)))
    b = L.to_limbs(torch.from_numpy(L.ints_to_words(ys)))
    s = L.words_to_ints(L.from_limbs(L.add(ctx, a, b)).numpy())
    d = L.words_to_ints(L.from_limbs(L.sub(ctx, a, b)).numpy())
    assert s == [(x + y) % p for x, y in zip(xs, ys)]
    assert d == [(x - y) % p for x, y in zip(xs, ys)]


def test_word_limb_roundtrip():
    xs = _operands(P_A, 30, 5)
    w = torch.from_numpy(L.ints_to_words(xs))
    lm = L.to_limbs(w)
    assert lm.shape == (L.NLIMB, len(xs))
    assert int(lm.max()) <= L.MASK
    assert torch.equal(L.from_limbs(lm), w)
    assert L.words_to_ints(w.numpy()) == xs


def test_file_limbs_bitcast_to_words():
    """12 x u64 file limbs are the port's 24 words: a bitcast."""
    xs = _operands(P_B, 20, 6)
    raw = np.frombuffer(b"".join(x.to_bytes(96, "little") for x in xs),
                        "<u8").reshape(len(xs), 12)
    words = L.u64_to_words(raw)                         # (n, 24)
    assert L.words_to_ints(words.T) == xs


def test_jax_layout_conversions():
    """JAX (n, k*48) u16 rows and (48, n) u32 columns -> the port's words."""
    xs = _operands(P_A, 20, 7)
    raw = np.frombuffer(b"".join(x.to_bytes(96, "little") for x in xs),
                        "<u8").reshape(len(xs), 12)
    rows16 = JS.u64_to_u16x48(raw).astype(np.uint16)    # (n, 48)
    rows2 = np.concatenate([rows16, rows16[::-1]], 1)    # (n, 96): 2 coeffs
    got = L.jax_rows_to_words(rows2)
    assert got.shape == (len(xs), 48)
    assert L.words_to_ints(got[:, :24].T) == xs
    assert L.words_to_ints(got[:, 24:].T) == xs[::-1]
    cols = np.stack([JL.int_to_limbs(x) for x in xs], 1).astype(np.uint32)
    assert L.words_to_ints(L.jax_cols_to_words(cols)) == xs


@pytest.mark.slow
@pytest.mark.parametrize("p", [P_A, P_B], ids=["P_A", "P_B"])
def test_mont_mul_plain_vs_jax(p):
    """The plain CIOS against the JAX package's limbs.mont_mul (XLA
    path): equal values mod p, the port's canonical."""
    import jax.numpy as jnp
    xs = _operands(p, 30, 8)
    ys = _operands(p, 30, 9)[::-1]
    jctx = JL.MontCtx(p)
    ja = jnp.asarray(np.stack([JL.int_to_limbs(x) for x in xs], 1))
    jb = jnp.asarray(np.stack([JL.int_to_limbs(y) for y in ys], 1))
    jout = np.asarray(JL.mont_mul(jctx, ja, jb))
    want = [JL.limbs_to_int(jout[:, i:i + 1]) % p for i in range(len(xs))]
    got = L.words_to_ints(mont_mul(
        L.MontCtx(p), torch.from_numpy(L.ints_to_words(xs)),
        torch.from_numpy(L.ints_to_words(ys))).numpy())
    assert got == want

"""The frozen generator: keys and inputs repeat by seed."""

import numpy as np
import pytest

from groth16_ref import curves, keys


@pytest.mark.parametrize("name", ["MNT4753", "MNT6753"])
def test_inputs_repeat_by_seed(name):
    c = curves.CURVES[name]
    seed = 2 ** 33 + 12345                       # over 32 signed bits
    a = [keys.InputStream(c, 4, seed, "cpu").next() for _ in range(2)]
    s1, s2 = (keys.InputStream(c, 4, seed, "cpu") for _ in range(2))
    x, y = [s1.next(), s1.next()], [s2.next(), s2.next()]
    for u, v in zip(x, y):
        for p, q in zip(u[:4], v[:4]):
            assert np.array_equal(p, q)
        assert u[4] == v[4]
    assert not np.array_equal(x[0][0], x[1][0])  # the stream moves on
    other = keys.InputStream(c, 4, seed + 1, "cpu").next()
    assert not np.array_equal(other[1], x[0][1])
    assert a[0][4] == x[0][4]


@pytest.mark.parametrize("name", ["MNT4753", "MNT6753"])
def test_input_values_below_r(name):
    c = curves.CURVES[name]
    w, ca, cb, cc, r = keys.InputStream(c, 5, 99, "cpu").next()
    assert w.shape == (24, 33) and ca.shape == (24, 32)
    for arr in (w, ca, cb, cc):
        raw = np.ascontiguousarray(arr.T).astype("<u4").tobytes()
        vals = [int.from_bytes(raw[i:i + 96], "little")
                for i in range(0, len(raw), 96)]
        assert max(vals) < c.fr.p
    assert 1 <= r < c.fr.p


@pytest.mark.parametrize("name", ["MNT4753", "MNT6753"])
def test_key_rows(name, tmp_path):
    c = curves.CURVES[name]
    base = keys.base_rows(c)
    assert base["g1"].shape == (keys.NBASE, 48)
    assert base["g2"].shape == (keys.NBASE, 48 * c.ext_degree)
    assert base["h"].shape == (keys.PERIOD_H, 48)
    t = keys.h_root(c)
    assert pow(t, 1 << 20, c.fr.p) != 1           # t is off every domain
    sz = keys.sizes(4)
    for q in keys.QUERIES:
        rows = keys.query_rows(q, 4, base)
        assert rows.shape[0] == sz["counts"][q]
        half = rows.shape[1] // 2
        ident = np.flatnonzero(~rows[:, half:].any(axis=1))
        want = keys.identity_rows(q, sz["m"])
        assert sorted(ident.tolist()) == sorted(want)
    assert keys.query_rows("A", 4, base)[3].tolist() == \
        base["g1"][3].tolist()
    assert keys.query_rows("B1", 4, base)[3].tolist() == \
        base["g1"][4].tolist()
    path = tmp_path / "params"
    keys.write_params(str(path), 4, base)
    n = 16
    assert path.stat().st_size == 16 + 4 * (
        48 * ((n + 1) * 2 + (n - 1) * 2) + 48 * c.ext_degree * (n + 1))

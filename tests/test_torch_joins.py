"""The port's join kernels (K4-K6) and the widened K1 against the JAX primitives.

The plain PyTorch versions of K4 `set_count_rows`, K5
`distinct_first_rows`, K6 `seg_min_max_rows` and K1 `gather_rows` over a
(D, S) source are held here, row by row, against `jax.vmap` of the JAX
package's `_set_count_sorted`, `_in_set_sorted`, `_distinct_first_sorted`,
`_seg_min_max_keys` and `jnp.take` on seeded inputs with the edge cases
of the joins: rows with every entry masked out, duplicate pairs,
negative keys and orgs, INT32_MIN and INT32_MAX keys, empty segments and
a set of 2N entries. Everything is an integer: exact equality, no
tolerance. The CUDA kernels are held against these plain versions on a
card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guard_tpu.ops import kernels as jk
from guard_tpu_torch import kernels as K
from guard_tpu_torch.kernels import plain

SEED = 23
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1
KEYS = np.array([I32_MIN, I32_MAX, -7, -2, -1, 0, 1, 2, 3, 99], np.int32)
SIZES = [8, 64, 200]


def join_rows(rng, d: int, n: int, width: int):
    """(org, key, mask): few distinct values so pairs repeat, extreme and
    negative keys, negative orgs (some under the mask), row 0 fully
    masked out, row 1 fully masked in."""
    org = rng.integers(-2, max(3, n // 16), size=(d, width)).astype(np.int32)
    key = rng.choice(KEYS, size=(d, width))
    mask = rng.random((d, width)) < 0.6
    mask[0] = False
    mask[1] = True
    return org, key, mask


def t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def jx(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("set_factor", [1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_set_count_rows_matches_set_count_sorted(n, set_factor):
    rng = np.random.default_rng(SEED + n + set_factor)
    d = 12
    q = join_rows(rng, d, n, n)
    s = join_rows(rng, d, n, set_factor * n)
    # a few query entries whose pair is known to be in the set, one of
    # them twice (row 1 is fully masked in)
    q[0][2, :4], q[1][2, :4] = s[0][2, :4], s[1][2, :4]
    s[0][1, :2], s[1][1, :2] = 1, I32_MIN
    q[0][1, 0], q[1][1, 0] = 1, I32_MIN
    want = jax.vmap(lambda *a: jk._set_count_sorted(n, *a))(*jx(*q, *s))
    got = plain.set_count_rows(*t(*q, *s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0] == 0).all()  # masked-out queries read 0
    assert (got > 1).any()  # duplicates counted
    in_set = jax.vmap(lambda *a: jk._in_set_sorted(n, *a))(*jx(*q, *s))
    np.testing.assert_array_equal((got > 0).numpy(), np.asarray(in_set))


@pytest.mark.parametrize("n", SIZES)
def test_set_count_rows_all_masked_set(n):
    rng = np.random.default_rng(SEED + 7 * n)
    q = join_rows(rng, 4, n, n)
    s = list(join_rows(rng, 4, n, n))
    s[2] = np.zeros_like(s[2])
    want = jax.vmap(lambda *a: jk._set_count_sorted(n, *a))(*jx(*q, *s))
    got = plain.set_count_rows(*t(*q, *s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


@pytest.mark.parametrize("n", SIZES)
def test_distinct_first_rows_matches_distinct_first_sorted(n):
    rng = np.random.default_rng(SEED + 3 * n)
    org, key, mask = join_rows(rng, 12, n, n)
    want = jax.vmap(jk._distinct_first_sorted)(*jx(org, key, mask))
    got = plain.distinct_first_rows(*t(org, key, mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[0].any()
    # the representative is the lowest index of its pair
    for r in range(2, 6):
        seen = set()
        for i in range(n):
            if mask[r, i] and org[r, i] >= 0:
                pair = (int(org[r, i]), int(key[r, i]))
                assert bool(got[r, i]) == (pair not in seen)
                seen.add(pair)


@pytest.mark.parametrize("n", SIZES)
def test_seg_min_max_rows_matches_seg_min_max_keys(n):
    rng = np.random.default_rng(SEED + 5 * n)
    d, kinds = 12, 5
    s = (n + 1) * kinds
    # a few origins only, so most segments are empty
    seg = (rng.integers(0, 4, size=(d, n)) * kinds
           + rng.integers(0, kinds, size=(d, n))).astype(np.int32)
    mask = rng.random((d, n)) < 0.5
    mask[0] = False
    hi = rng.choice(KEYS, size=(d, n))
    lo = rng.choice(KEYS, size=(d, n))
    (mnh, mnl), (mxh, mxl) = jax.vmap(
        lambda *a: jk._seg_min_max_keys(*a, s)
    )(*jx(seg, mask, hi, lo))
    got = plain.seg_min_max_rows(*t(seg, mask, hi, lo), s)
    for a, b in zip(got, (mnh, mnl, mxh, mxl)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # empty segments read the INT32 sentinels
    assert (got[0][0] == I32_MAX).all() and (got[1][0] == I32_MAX).all()
    assert (got[2][0] == I32_MIN).all() and (got[3][0] == I32_MIN).all()


def test_seg_min_max_rows_sentinel_keys_tie():
    # legitimate (INT32_MIN, INT32_MIN) and (INT32_MAX, INT32_MAX) keys
    # equal the sentinels and must not be outranked by them
    seg = np.array([[0, 0, 1, 1, 2]], np.int32)
    mask = np.array([[True, True, True, False, True]])
    hi = np.array([[I32_MIN, I32_MAX, 5, 7, 0]], np.int32)
    lo = np.array([[I32_MIN, I32_MAX, I32_MIN, 0, I32_MAX]], np.int32)
    (mnh, mnl), (mxh, mxl) = jk._seg_min_max_keys(*jx(seg[0], mask[0], hi[0], lo[0]), 4)
    got = plain.seg_min_max_rows(*t(seg, mask, hi, lo), 4)
    for a, b in zip(got, (mnh, mnl, mxh, mxl)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


@pytest.mark.parametrize("n", SIZES)
def test_gather_rows_wide_source_matches_take(n):
    rng = np.random.default_rng(SEED + 11 * n)
    d = 8
    for s in (n + 1, (n + 1) * 5):
        vec = rng.integers(I32_MIN, I32_MAX, size=(d, s), dtype=np.int64).astype(np.int32)
        idx = rng.integers(0, s, size=(d, n)).astype(np.int32)
        want = jax.vmap(jnp.take)(*jx(vec, idx))
        got = plain.gather_rows(*t(vec, idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # out of range reads 0, as _parent_select masks the root
        bad = idx.copy()
        bad[:, ::3] = -1
        bad[:, 1::3] = s
        got = plain.gather_rows(*t(vec, bad)).numpy()
        ok = (bad >= 0) & (bad < s)
        np.testing.assert_array_equal(got[ok], np.take_along_axis(vec, np.where(ok, bad, 0), 1)[ok])
        assert (got[~ok] == 0).all()


def test_join_wrappers_use_plain_on_cpu():
    rng = np.random.default_rng(SEED)
    q = t(*join_rows(rng, 3, 16, 16))
    s = t(*join_rows(rng, 3, 16, 32))
    before = dict(K.LAUNCHES)
    assert torch.equal(K.set_count_rows(*q, *s), plain.set_count_rows(*q, *s))
    assert torch.equal(K.distinct_first_rows(*q), plain.distinct_first_rows(*q))
    seg = torch.randint(0, 85, (3, 16), dtype=torch.int32)
    got = K.seg_min_max_rows(seg, q[2], q[0], q[1], 85)
    for a, b in zip(got, plain.seg_min_max_rows(seg, q[2], q[0], q[1], 85)):
        assert torch.equal(a, b)
    assert K.LAUNCHES == before  # nothing launched, nothing counted


def test_join_wrappers_refuse_mixed_devices():
    q = t(*join_rows(np.random.default_rng(1), 2, 8, 8))
    meta = tuple(x.to("meta") for x in q)
    with pytest.raises(ValueError):
        K.set_count_rows(*q, *meta)


def _set_count_against_jax(q, s):
    """Plain K4 against vmapped _set_count_sorted and _in_set_sorted."""
    nq = q[0].shape[1]
    want = jax.vmap(lambda *a: jk._set_count_sorted(nq, *a))(*jx(*q, *s))
    got = plain.set_count_rows(*t(*q, *s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    in_set = jax.vmap(lambda *a: jk._in_set_sorted(nq, *a))(*jx(*q, *s))
    np.testing.assert_array_equal((got > 0).numpy(), np.asarray(in_set))
    return got


@pytest.mark.parametrize("n", SIZES)
def test_set_count_rows_all_equal_keys_matches_jax(n):
    """Every set entry the same pair (one hash slot takes them all); the
    queries that carry it count every masked set entry."""
    rng = np.random.default_rng(SEED + 13 * n)
    d = 6
    q = list(join_rows(rng, d, n, n))
    q[0][:, ::2], q[1][:, ::2] = 0, 7
    s_mask = rng.random((d, 2 * n)) < 0.8
    s = (np.zeros((d, 2 * n), np.int32), np.full((d, 2 * n), 7, np.int32), s_mask)
    got = _set_count_against_jax(q, s)
    hit = q[2] & (q[0] == 0) & (q[1] == 7)
    np.testing.assert_array_equal(got.numpy()[hit], np.repeat(s_mask.sum(1), n)[hit.ravel()])


@pytest.mark.parametrize("n", [64, 200])
def test_set_count_rows_with_org_zero_matches_jax(n):
    """org all 0 on both sides, as the `.%var` key match calls it
    (ops/kernels.py:501-507): node key ids against the variable's
    string ids, multiplicities included."""
    rng = np.random.default_rng(SEED + 17 * n)
    d = 8
    zeros = np.zeros((d, n), np.int32)
    node_key = np.where(rng.random((d, n)) < 0.7, rng.integers(0, 12, size=(d, n)), -1
                        ).astype(np.int32)
    vs = np.where(rng.random((d, n)) < 0.3, rng.integers(0, 12, size=(d, n)), -1
                  ).astype(np.int32)
    good = vs >= 0
    got = _set_count_against_jax((zeros, node_key, node_key >= 0), (zeros, vs, good))
    assert (got > 1).any()


@pytest.mark.parametrize("nq,ns", [(64, 100), (64, 257)])
def test_set_count_rows_set_not_a_power_of_two_matches_jax(nq, ns):
    rng = np.random.default_rng(SEED + ns)
    _set_count_against_jax(join_rows(rng, 8, nq, nq), join_rows(rng, 8, nq, ns))


@pytest.mark.parametrize("nq,ns", [(64, 31), (200, 8)])
def test_set_count_rows_set_shorter_than_queries_matches_jax(nq, ns):
    rng = np.random.default_rng(SEED + 5 * ns)
    _set_count_against_jax(join_rows(rng, 8, nq, nq), join_rows(rng, 8, nq, ns))


@pytest.mark.parametrize("how", ["mask_off", "org_negative"])
def test_set_count_rows_fully_excluded_set_matches_jax(how):
    """A set of 2N entries, every one excluded (mask off, or masked in
    with org < 0): every query reads 0."""
    n = 64
    rng = np.random.default_rng(SEED + len(how))
    q = join_rows(rng, 6, n, n)
    org, key, mask = join_rows(rng, 6, n, 2 * n)
    if how == "mask_off":
        mask = np.zeros_like(mask)
    else:
        org, mask = -1 - np.abs(org), np.ones_like(mask)
    got = _set_count_against_jax(q, (org.astype(np.int32), key, mask))
    assert not got.any()


@pytest.mark.parametrize("ns", [4096, 8192])
def test_set_count_rows_one_wide_document_matches_jax(ns):
    """One document of 4,096 query entries, alone in its row."""
    n = 4096
    rng = np.random.default_rng(SEED + ns)
    q = [a[1:2] for a in join_rows(rng, 2, n, n)]
    s = [a[1:2] for a in join_rows(rng, 2, n, ns)]
    got = _set_count_against_jax(q, s)
    assert (got > 1).any()


def _distinct_first_against_jax(org, key, mask):
    """Plain K5 against vmapped _distinct_first_sorted, exactly."""
    want = jax.vmap(jk._distinct_first_sorted)(*jx(org, key, mask))
    got = plain.distinct_first_rows(*t(org, key, mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got


def _seg_min_max_against_jax(seg, mask, hi, lo, s):
    """Plain K6 against vmapped _seg_min_max_keys, exactly."""
    (mnh, mnl), (mxh, mxl) = jax.vmap(
        lambda *a: jk._seg_min_max_keys(*a, s)
    )(*jx(seg, mask, hi, lo))
    got = plain.seg_min_max_rows(*t(seg, mask, hi, lo), s)
    for a, b in zip(got, (mnh, mnl, mxh, mxl)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return got


def seg_rows(rng, d: int, n: int, s: int, origins: int = 4, kinds: int = 5):
    """(seg, mask, hi, lo): segments origin * kinds + kind from a few
    origins (most segments empty), extreme and negative keys."""
    seg = (rng.integers(0, origins, size=(d, n)) * kinds
           + rng.integers(0, kinds, size=(d, n))).astype(np.int32)
    assert seg.max() < s
    mask = rng.random((d, n)) < 0.5
    return seg, mask, rng.choice(KEYS, size=(d, n)), rng.choice(KEYS, size=(d, n))


@pytest.mark.parametrize("n", [4096, 8192])
def test_distinct_first_rows_one_wide_document_matches_jax(n):
    """One document of 4,096 or 8,192 entries alone in its row, as the
    one-document bucket gives K5 its global form."""
    rng = np.random.default_rng(SEED + 31 * n)
    org, key, mask = (a[1:2] for a in join_rows(rng, 2, n, n))
    got = _distinct_first_against_jax(org, key, mask)
    valid = mask & (org >= 0)
    pairs = {(int(o), int(k)) for o, k in zip(org[valid], key[valid])}
    assert int(got.sum()) == len(pairs) > 1


@pytest.mark.parametrize("n", [100, 257])
def test_distinct_first_rows_not_a_power_of_two_matches_jax(n):
    rng = np.random.default_rng(SEED + 37 * n)
    _distinct_first_against_jax(*join_rows(rng, 9, n, n))


@pytest.mark.parametrize("n", [8, 64, 200])
def test_distinct_first_rows_all_one_pair_matches_jax(n):
    """Every entry the same pair (one hash slot takes every insert): the
    first entry with mask set is the only True one of its row."""
    rng = np.random.default_rng(SEED + 41 * n)
    d = 6
    org = np.zeros((d, n), np.int32)
    key = np.full((d, n), I32_MIN, np.int32)
    mask = rng.random((d, n)) < 0.7
    mask[0] = True
    mask[1] = False
    got = _distinct_first_against_jax(org, key, mask).numpy()
    for r in range(d):
        hits = np.flatnonzero(mask[r])
        assert list(np.flatnonzero(got[r])) == ([int(hits[0])] if len(hits) else [])


@pytest.mark.parametrize("n", [4096, 8192])
def test_seg_min_max_rows_one_wide_document_matches_jax(n):
    """One document at the query-RHS width S = (N + 1) * 5, as the
    one-document bucket gives K6 its grid form."""
    rng = np.random.default_rng(SEED + 43 * n)
    s = (n + 1) * 5
    got = _seg_min_max_against_jax(*seg_rows(rng, 1, n, s, origins=n // 8), s)
    assert (got[0] < I32_MAX).any() and (got[0] == I32_MAX).any()


@pytest.mark.parametrize("n", [100, 257])
def test_seg_min_max_rows_not_a_power_of_two_matches_jax(n):
    rng = np.random.default_rng(SEED + 47 * n)
    s = (n + 1) * 5
    _seg_min_max_against_jax(*seg_rows(rng, 9, n, s), s)


@pytest.mark.parametrize("n", [64, 257])
def test_seg_min_max_rows_all_masked_out_matches_jax(n):
    """No entry under the mask: every segment reads the sentinels."""
    rng = np.random.default_rng(SEED + 53 * n)
    s = (n + 1) * 5
    seg, mask, hi, lo = seg_rows(rng, 5, n, s)
    got = _seg_min_max_against_jax(seg, np.zeros_like(mask), hi, lo, s)
    assert (got[0] == I32_MAX).all() and (got[1] == I32_MAX).all()
    assert (got[2] == I32_MIN).all() and (got[3] == I32_MIN).all()


@pytest.mark.parametrize("n", [64, 257])
def test_seg_min_max_rows_one_segment_extreme_keys_matches_jax(n):
    """Every entry in segment 0, hi and lo drawn from INT32_MIN, INT32_MAX
    and their neighbours: the fold compares the full 64-bit key."""
    rng = np.random.default_rng(SEED + 59 * n)
    d, s = 6, (n + 1) * 5
    extremes = np.array([I32_MIN, I32_MIN + 1, -1, 0, I32_MAX - 1, I32_MAX], np.int32)
    hi = rng.choice(extremes, size=(d, n))
    lo = rng.choice(extremes, size=(d, n))
    mask = rng.random((d, n)) < 0.8
    got = _seg_min_max_against_jax(np.zeros((d, n), np.int32), mask, hi, lo, s)
    for r in range(d):
        keys = sorted(zip(hi[r][mask[r]].tolist(), lo[r][mask[r]].tolist()))
        assert (int(got[0][r, 0]), int(got[1][r, 0])) == keys[0]
        assert (int(got[2][r, 0]), int(got[3][r, 0])) == keys[-1]
    assert (got[0][:, 1:] == I32_MAX).all()


@pytest.mark.parametrize("n", [64, 257])
def test_seg_min_max_rows_segment_ids_at_the_edges_matches_jax(n):
    """Segment ids at S - 1 (the last segment, also where the reference
    parks excluded entries), at S and at -1 (outside: they add nothing)."""
    rng = np.random.default_rng(SEED + 61 * n)
    d, s = 6, (n + 1) * 5
    seg = rng.choice(np.array([s - 1, s, -1, 0], np.int32), size=(d, n))
    mask = rng.random((d, n)) < 0.7
    hi = rng.choice(KEYS, size=(d, n))
    lo = rng.choice(KEYS, size=(d, n))
    got = _seg_min_max_against_jax(seg, mask, hi, lo, s)
    inside = mask & (seg == s - 1)
    for r in range(d):
        if inside[r].any():
            keys = sorted(zip(hi[r][inside[r]].tolist(), lo[r][inside[r]].tolist()))
            assert (int(got[0][r, s - 1]), int(got[1][r, s - 1])) == keys[0]
            assert (int(got[2][r, s - 1]), int(got[3][r, s - 1])) == keys[-1]
    assert (got[0][:, 1:s - 1] == I32_MAX).all()

"""The port's kernels (guard_tpu_torch/kernels) against the JAX primitives.

K1 gather_rows, K2 segment_sum_rows and K3 rim_reduce have plain PyTorch
versions that run on the CPU; each is held here against the JAX
package's primitive it replaces (gather formulation), row by row, on
seeded inputs with the edge cases of the traversal: root and padding
lanes (parent -1), empty segments, and origin labels 0..N; K3 also at
its kernel's design widths (up to a full pack of 512 rules) and on
edge tables. The CUDA
kernels themselves are held against the plain versions on a card in
tests/test_torch_cuda.py. Results are integers: exact equality, no
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guard_tpu.ops import kernels as jk
from guard_tpu_torch import kernels as K
from guard_tpu_torch.kernels import plain
from test_torch_cuda import _batch, _rim_case, _tree

SEED = 7


def _jax_docs(parent_rows: np.ndarray):
    """One gather-mode JAX _DocArrays per row."""
    out = []
    for row in parent_rows:
        n = row.shape[0]
        z = jnp.zeros(n, jnp.int32)
        arrays = {
            "node_kind": z, "node_parent": jnp.asarray(row), "scalar_id": z,
            "num_hi": z, "num_lo": z, "child_count": z, "node_key_id": z,
            "node_index": z, "node_parent_kind": z,
        }
        out.append(jk._DocArrays(arrays, gather_mode=True))
    return out


@pytest.mark.parametrize("n", [8, 64, 200])
def test_gather_rows_plain_matches_parent_select(n):
    rng = np.random.default_rng(SEED + n)
    parents = _batch(rng, 6, n)
    vec = rng.integers(0, n + 1, size=parents.shape).astype(np.int32)
    got = plain.gather_rows(torch.from_numpy(vec), torch.from_numpy(parents))
    assert got.dtype == torch.int32
    for r, d in enumerate(_jax_docs(parents)):
        want = np.asarray(jk._parent_select(d, jnp.asarray(vec[r])))
        np.testing.assert_array_equal(got[r].numpy(), want)
    # root and padding lanes read 0
    assert (got.numpy()[parents < 0] == 0).all()


@pytest.mark.parametrize("n", [8, 64])
def test_gather_rows_plain_matches_select_at(n):
    rng = np.random.default_rng(SEED + 2 * n)
    parents = _batch(rng, 5, n)
    vec = rng.integers(0, n + 1, size=parents.shape).astype(np.int32)
    # key-chain anchor columns are always valid node indices
    idx = rng.integers(0, n, size=parents.shape).astype(np.int32)
    got = plain.gather_rows(torch.from_numpy(vec), torch.from_numpy(idx))
    for r, d in enumerate(_jax_docs(parents)):
        want = np.asarray(jk._select_at(d, jnp.asarray(vec[r]), jnp.asarray(idx[r])))
        np.testing.assert_array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("n", [8, 64, 200])
def test_segment_sum_plain_matches_count_children(n):
    rng = np.random.default_rng(SEED + 3 * n)
    parents = _batch(rng, 6, n)
    # pred set on root and padding lanes too: they must add nothing
    pred = rng.random(parents.shape) < 0.6
    got = plain.segment_sum_rows(
        torch.from_numpy(pred.astype(np.int32)), torch.from_numpy(parents), n
    )
    for r, d in enumerate(_jax_docs(parents)):
        want = np.asarray(jk._count_children(d, jnp.asarray(pred[r])))
        np.testing.assert_array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("n", [8, 64, 200])
def test_segment_sum_plain_matches_segment_count(n):
    rng = np.random.default_rng(SEED + 5 * n)
    parents = _batch(rng, 6, n)
    # origin labels 0..N, with N itself present and most labels absent
    # (empty segments)
    sel = np.where(rng.random(parents.shape) < 0.5, 0,
                   rng.integers(1, n + 1, size=parents.shape)).astype(np.int32)
    sel[:, -1] = n
    pred = rng.random(parents.shape) < 0.7
    active = pred & (sel > 0)
    got = plain.segment_sum_rows(
        torch.from_numpy(active.astype(np.int32)),
        torch.from_numpy(np.where(active, sel, 0).astype(np.int32)), n + 1,
    )
    for r, d in enumerate(_jax_docs(parents)):
        want = np.asarray(jk._segment_count(d, jnp.asarray(sel[r]), jnp.asarray(pred[r])))
        np.testing.assert_array_equal(got[r].numpy(), want)
    assert (got[:, 0] == 0).all()


def test_segment_sum_plain_matches_unres_finalize():
    n = 64
    rng = np.random.default_rng(SEED)
    parents = _batch(rng, 4, n)
    labels = np.where(rng.random(parents.shape) < 0.3,
                      rng.integers(1, n + 1, size=parents.shape), 0).astype(np.int32)
    counts = np.where(labels > 0, rng.integers(1, 4, size=parents.shape), 0).astype(np.int32)
    weight = np.where(labels > 0, counts, 0).astype(np.int32)
    got = plain.segment_sum_rows(torch.from_numpy(weight), torch.from_numpy(labels), n + 1)
    for r, d in enumerate(_jax_docs(parents)):
        acc = jk._UnresAcc(d)
        acc.miss_labels = jnp.asarray(labels[r])
        acc.miss_count = jnp.asarray(counts[r])
        acc.touched = True
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(acc.finalize(d, False)))


@pytest.mark.parametrize("with_unsure", [True, False])
@pytest.mark.parametrize("shape", [(9, 7, 4, 3), (5, 1, 2, 2), (4, 12, 6, 1)])
def test_rim_reduce_plain_matches_jax(shape, with_unsure):
    d, r, g, f = shape
    rng = np.random.default_rng(SEED + d * r)
    statuses, unsure, gid, fid, last = _rim_case(rng, d, r, g, f)
    want = jk.rim_reduce(
        jnp.asarray(statuses), jnp.asarray(unsure) if with_unsure else None,
        jnp.asarray(gid), jnp.asarray(fid), jnp.asarray(last), g, f,
    )
    got = plain.rim_reduce(
        torch.from_numpy(statuses),
        torch.from_numpy(unsure) if with_unsure else None,
        torch.from_numpy(gid), torch.from_numpy(fid), torch.from_numpy(last), g, f,
    )
    dtypes = (torch.int8, torch.bool, torch.int8, torch.bool, torch.bool, torch.int8)
    for a, b, dt in zip(got, want, dtypes):
        assert a.dtype == dt
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # empty group -> SKIP, empty file -> SKIP and no FAIL
    assert (got[0][:, g - 1] == 2).all()
    if f > 1:
        assert (got[2][:, f - 1] == 2).all() and not got[3][:, f - 1].any()


def _rim_against_jax(statuses, unsure, gid, fid, last, g, f):
    want = jk.rim_reduce(
        jnp.asarray(statuses), None if unsure is None else jnp.asarray(unsure),
        jnp.asarray(gid), jnp.asarray(fid), jnp.asarray(last), g, f,
    )
    got = plain.rim_reduce(
        torch.from_numpy(statuses), None if unsure is None else torch.from_numpy(unsure),
        torch.from_numpy(gid), torch.from_numpy(fid), torch.from_numpy(last), g, f,
    )
    dtypes = (torch.int8, torch.bool, torch.int8, torch.bool, torch.bool, torch.int8)
    for a, b, dt in zip(got, want, dtypes):
        assert a.dtype == dt and tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return got


# (D, R, G, F): K3's design shapes cut to a few documents (64 rules in
# 41 groups; 256 in 130 groups over 4 files; a full pack of 512 rules in
# 512 groups over 64 files), one group, G 64 and 65 on both sides of a
# 64-bit mask word, F 33 across a 32-bit word, and no rule at all
RIM_DESIGN_SHAPES = [(6, 64, 41, 1), (5, 256, 130, 4), (3, 512, 512, 64), (7, 9, 1, 1),
                     (5, 80, 64, 2), (5, 80, 65, 2), (6, 40, 10, 33), (4, 0, 0, 1)]


@pytest.mark.parametrize("with_unsure", [True, False])
@pytest.mark.parametrize("shape", RIM_DESIGN_SHAPES)
def test_rim_reduce_plain_matches_jax_at_the_design_shapes(shape, with_unsure):
    d, r, g, f = shape
    rng = np.random.default_rng(SEED + 3 * d + r + g)
    statuses, unsure, gid, fid, last = _rim_case(rng, d, r, g, f)
    _rim_against_jax(statuses, unsure if with_unsure else None, gid, fid, last, g, f)


@pytest.mark.parametrize("case", ["every_group_empty", "last_on_the_first_rule"])
def test_rim_reduce_plain_matches_jax_on_edge_tables(case):
    """Group ids all past the last group (every group empty: SKIP and
    no unsure bit), or every group's last rule the first rule."""
    d, r, g, f = 6, 12, 5, 3
    rng = np.random.default_rng(SEED + len(case))
    statuses, unsure, gid, fid, last = _rim_case(rng, d, r, g, f)
    if case == "every_group_empty":
        gid = np.full(r, g, np.int32)
    else:
        last = np.zeros(g, np.int32)
    got = _rim_against_jax(statuses, unsure, gid, fid, last, g, f)
    if case == "every_group_empty":
        assert (got[0] == 2).all() and not got[1].any()
    else:
        assert torch.equal(got[5], torch.from_numpy(statuses[:, :1]).expand(d, g))


def test_wrappers_use_plain_on_cpu():
    rng = np.random.default_rng(SEED)
    parents = torch.from_numpy(_batch(rng, 3, 16))
    vec = torch.arange(48, dtype=torch.int32).reshape(3, 16)
    before = dict(K.LAUNCHES)
    assert torch.equal(K.gather_rows(vec, parents), plain.gather_rows(vec, parents))
    assert torch.equal(
        K.segment_sum_rows(vec, parents, 17), plain.segment_sum_rows(vec, parents, 17)
    )
    assert K.LAUNCHES == before  # nothing launched, nothing counted


def _k2_cases_against_jax(parents: np.ndarray, rng, pred=None, counts=None):
    """Plain K2 as the walk calls it for _count_children, _segment_count
    and _UnresAcc.finalize, against the JAX functions row by row. The
    miss labels run from -1 to N + 5: lanes at -1, at S = N + 1 and
    beyond S add nothing."""
    d, n = parents.shape
    if pred is None:
        pred = rng.random(parents.shape) < 0.6
    sel = np.where(rng.random(parents.shape) < 0.4, 0,
                   rng.integers(1, n + 1, size=parents.shape)).astype(np.int32)
    labels = rng.integers(-1, n + 6, size=parents.shape).astype(np.int32)
    if counts is None:
        counts = rng.integers(0, 4, size=parents.shape).astype(np.int32)
    active = pred & (sel > 0)
    children = plain.segment_sum_rows(
        torch.from_numpy(pred.astype(np.int32)), torch.from_numpy(parents), n)
    per_origin = plain.segment_sum_rows(
        torch.from_numpy(active.astype(np.int32)),
        torch.from_numpy(np.where(active, sel, 0).astype(np.int32)), n + 1)
    misses = plain.segment_sum_rows(
        torch.from_numpy(np.where(labels > 0, counts, 0).astype(np.int32)),
        torch.from_numpy(labels), n + 1)
    for r, doc in enumerate(_jax_docs(parents)):
        np.testing.assert_array_equal(
            children[r].numpy(), np.asarray(jk._count_children(doc, jnp.asarray(pred[r]))))
        np.testing.assert_array_equal(
            per_origin[r].numpy(),
            np.asarray(jk._segment_count(doc, jnp.asarray(sel[r]), jnp.asarray(pred[r]))))
        acc = jk._UnresAcc(doc)
        acc.miss_labels = jnp.asarray(labels[r])
        acc.miss_count = jnp.asarray(counts[r])
        acc.touched = True
        np.testing.assert_array_equal(misses[r].numpy(), np.asarray(acc.finalize(doc, False)))
    return children, per_origin, misses


@pytest.mark.parametrize("n", [8, 16, 32, 33, 64, 65, 128])
def test_segment_sum_plain_matches_jax_at_row_geometry_boundaries(n):
    """N across the lane-group sizes the kernel picks (8, 16 and 32 lanes
    a row, 16-byte loads where N % 4 == 0)."""
    rng = np.random.default_rng(SEED + 31 * n)
    _k2_cases_against_jax(_batch(rng, 6, n), rng)


@pytest.mark.parametrize("n", [2048, 4096])
def test_segment_sum_plain_matches_jax_on_one_wide_document(n):
    """One document alone in its bucket, the shape of the split grid."""
    rng = np.random.default_rng(SEED + n)
    parents = _tree(rng, n, int(0.9 * n))[None]
    outs = _k2_cases_against_jax(parents, rng)
    assert all(o.any() for o in outs)


@pytest.mark.parametrize("where", ["minus_one", "at_s", "beyond_s"])
def test_segment_sum_plain_drops_lanes_outside_the_segments(where):
    """Every miss label -1, S (= N + 1) or beyond S: the finalize
    histogram stays zero, as the JAX package's does."""
    n = 64
    rng = np.random.default_rng(SEED + len(where))
    parents = _batch(rng, 5, n)
    label = {"minus_one": -1, "at_s": n + 1, "beyond_s": n + 40}[where]
    labels = np.full(parents.shape, label, np.int32)
    counts = rng.integers(1, 4, size=parents.shape).astype(np.int32)
    got = plain.segment_sum_rows(
        torch.from_numpy(np.where(labels > 0, counts, 0).astype(np.int32)),
        torch.from_numpy(labels), n + 1)
    assert not got.any()
    for r, doc in enumerate(_jax_docs(parents)):
        acc = jk._UnresAcc(doc)
        acc.miss_labels = jnp.asarray(labels[r])
        acc.miss_count = jnp.asarray(counts[r])
        acc.touched = True
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(acc.finalize(doc, False)))


@pytest.mark.parametrize("n", [64, 4096])
def test_segment_sum_plain_of_all_zero_values_matches_jax(n):
    """pred false and miss counts 0 everywhere: every histogram is zero."""
    rng = np.random.default_rng(SEED + 3 * n)
    parents = _batch(rng, 3, n) if n <= 64 else _tree(rng, n, n)[None]
    outs = _k2_cases_against_jax(parents, rng, pred=np.zeros(parents.shape, bool),
                                 counts=np.zeros(parents.shape, np.int32))
    assert not any(o.any() for o in outs)

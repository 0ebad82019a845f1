"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and carries the `cuda` marker; without
a card each skips. The file imports neither JAX nor the JAX package, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are seeded with numpy: random trees with root and padding lanes
(parent -1) for K1-K3, and for the joins rows with every entry masked
out, duplicate pairs, negative keys, INT32_MIN and INT32_MAX keys,
empty segments and a set twice the query's length; for K7 statuses
with values outside 0..2, n_valid below, at and beyond D, rule sets
that span several column tiles (258 to 1,028 rules), and rows that do
not start on a 4-byte boundary. K2 and K4 are held on every geometry
their launchers choose from (a lane group, a block or a split grid per
row for K2; a warp's, a block's or a global table per row for K4), at
the shapes around each threshold, at D 0 and D 1 x N 65,536, and on
rows that do not start on a 16-byte boundary. K3 and K7 are held on
every form their launchers choose from (a thread, a warp or a block per
row for K3; one block, one cluster or a grid of 8- or 16-byte words for
K7) at the main path's and the sweep's widths, off a 16-byte boundary,
at every R % 16 and at n_valid 0, 1, D - 3 and D. Results are integers:
exact equality, no tolerance. Beyond the kernels: full reports of 1,024
templates on the card against the CPU, and statuses-only validate of
8,192 templates on the card from the native encoder (in process and
over 2 ingest workers) against the tree encoder, launches included;
the `test` command over corpus/rules on the card against the CPU (no
K3), a warm result-cache run (no launch at all) and --no-vector-rim (no
K3); `sweep` over corpus rule files on the card against the CPU (K1, K2
and K3 launch; a warm run launches nothing).
"""

import numpy as np
import pytest
import torch

from guard_tpu_torch import kernels as K
from guard_tpu_torch.kernels import plain

SEED = 11
TREE_SEED = 7
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _tree(rng, n: int, real: int) -> np.ndarray:
    """Parent column of a random tree: root -1, node i < real has a
    parent in [0, i), padding (i >= real) -1."""
    parent = np.full(n, -1, np.int32)
    for i in range(1, real):
        parent[i] = rng.integers(0, i)
    return parent


def _batch(rng, d: int, n: int) -> np.ndarray:
    # rows of every fill: a bare root, a full row, padded rows
    reals = [1, n] + [int(rng.integers(1, n + 1)) for _ in range(d - 2)]
    return np.stack([_tree(rng, n, r) for r in reals])


def _rim_case(rng, d: int, r: int, g: int, f: int):
    statuses = rng.integers(0, 3, size=(d, r)).astype(np.int8)
    unsure = rng.random((d, r)) < 0.2
    # the last group and the last file stay empty
    group_ids = (np.arange(r) % max(g - 1, 1)).astype(np.int32)
    file_ids = (np.arange(r) * max(f - 1, 1) // max(r, 1)).astype(np.int32)
    last_ids = np.zeros(g, np.int32)
    last_ids[group_ids] = np.arange(r, dtype=np.int32)
    return statuses, unsure, group_ids, file_ids, last_ids


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1024, 65536])
def test_cuda_gather_and_segment_sum_match_plain(cuda_device, n):
    rng = np.random.default_rng(TREE_SEED + n)
    parents = torch.from_numpy(_batch(rng, 4, n)).to(cuda_device)
    vec = torch.from_numpy(
        rng.integers(0, n + 1, size=(4, n)).astype(np.int32)
    ).to(cuda_device)
    assert torch.equal(K.gather_rows(vec, parents), plain.gather_rows(vec, parents))
    for s in (n, n + 1):
        assert torch.equal(
            K.segment_sum_rows(vec, parents, s), plain.segment_sum_rows(vec, parents, s)
        )


@pytest.mark.cuda
@pytest.mark.parametrize("with_unsure", [True, False])
def test_cuda_rim_reduce_matches_plain(cuda_device, with_unsure):
    rng = np.random.default_rng(TREE_SEED)
    statuses, unsure, gid, fid, last = (
        torch.from_numpy(a).to(cuda_device) for a in _rim_case(rng, 300, 40, 17, 3)
    )
    u = unsure if with_unsure else None
    for a, b in zip(K.rim_reduce(statuses, u, gid, fid, last, 17, 3),
                    plain.rim_reduce(statuses, u, gid, fid, last, 17, 3)):
        assert torch.equal(a, b)


def join_rows(rng, d: int, n: int, width: int):
    """(org, key, mask) rows of `width` entries drawn from few distinct
    values (so pairs repeat), with extreme keys, an all-masked row and
    negative orgs under the mask."""
    org = rng.integers(-1, max(2, n // 8), size=(d, width)).astype(np.int32)
    key = rng.choice(
        np.array([I32_MIN, I32_MAX, -7, -1, 0, 1, 2, 3, 99], np.int32), size=(d, width)
    )
    mask = rng.random((d, width)) < 0.7
    mask[0] = False
    return org, key, mask


def to(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1024, 65536])
def test_cuda_set_count_and_distinct_first_match_plain(cuda_device, n):
    rng = np.random.default_rng(SEED + n)
    d = 4 if n == 65536 else 16
    q = to(cuda_device, *join_rows(rng, d, n, n))
    for ns in (n, 2 * n):
        s = to(cuda_device, *join_rows(rng, d, n, ns))
        got = K.set_count_rows(*q, *s)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.set_count_rows(*q, *s))
    got = K.distinct_first_rows(*q)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.distinct_first_rows(*q))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1024, 65536])
def test_cuda_seg_min_max_matches_plain(cuda_device, n):
    rng = np.random.default_rng(SEED + 3 * n)
    d = 4 if n == 65536 else 16
    s = (n + 1) * 5
    # segments from a few origins only: most segments stay empty
    seg = (rng.integers(0, 4, size=(d, n)) * 5 + rng.integers(0, 5, size=(d, n))).astype(np.int32)
    mask = rng.random((d, n)) < 0.6
    mask[0] = False
    vals = np.array([I32_MIN, I32_MAX, -1, 0, 1, 5], np.int32)
    hi = rng.choice(vals, size=(d, n))
    lo = rng.choice(vals, size=(d, n))
    args = to(cuda_device, seg, mask, hi, lo)
    got = K.seg_min_max_rows(*args, s)
    torch.cuda.synchronize()
    for a, b in zip(got, plain.seg_min_max_rows(*args, s)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(64, 65), (64, 325), (1024, 1025), (65536, 327685)])
def test_cuda_gather_rows_wide_source_matches_plain(cuda_device, n, s):
    rng = np.random.default_rng(SEED + s)
    vec = rng.integers(I32_MIN, I32_MAX, size=(8, s), dtype=np.int64).astype(np.int32)
    idx = rng.integers(-2, s + 2, size=(8, n)).astype(np.int32)
    v, i = to(cuda_device, vec, idx)
    got = K.gather_rows(v, i)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.gather_rows(v, i))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1024])
def test_cuda_gather_with_step_fn_var_idx_matches_plain(cuda_device, n):
    """K1 as the StepFnVar arm calls it: idx is the result root's
    fn_origin where the root's key id hits and it has an origin, else
    -1, so one gather gates and relabels each per-origin result."""
    rng = np.random.default_rng(TREE_SEED + 3 * n)
    d = 8
    sel = rng.integers(0, n + 1, size=(d, n)).astype(np.int32)
    sel[rng.random((d, n)) < 0.5] = 0  # unselected origins
    fn_origin = np.full((d, n), -1, np.int32)
    key = np.full((d, n), -2, np.int32)
    roots = rng.random((d, n)) < 0.2
    fn_origin[roots] = rng.integers(0, n, size=int(roots.sum()))
    key[roots] = rng.choice([-1000, -1001], size=int(roots.sum()))
    t = {k: torch.from_numpy(v).to(cuda_device)
         for k, v in (("sel", sel), ("fn_origin", fn_origin), ("key", key))}
    hit = t["key"] == -1000
    idx = torch.where(hit & (t["fn_origin"] >= 0), t["fn_origin"], -1)
    got = K.gather_rows(t["sel"], idx)
    assert torch.equal(got, plain.gather_rows(t["sel"], idx))
    want = np.where(hit.cpu().numpy() & (fn_origin >= 0),
                    np.take_along_axis(sel, np.maximum(fn_origin, 0), axis=1), 0)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_fnvar_walk_matches_cpu(cuda_device):
    """One statuses-only evaluation of the FNVAR_RULES workload on the
    card equals the same evaluation on the CPU, and its per-origin
    StepFnVar arms each launched K1 once."""
    from guard_tpu_torch.commands.validate import RuleFile
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops import kernels as walk
    from guard_tpu_torch.ops.backend import evaluate
    from guard_tpu_torch.workloads import FNVAR_RULES, make_fnvar_template

    rng = np.random.default_rng(SEED)
    docs = [from_plain(make_fnvar_template(rng, i, exotic=i % 50 == 7))
            for i in range(512)]
    rf = RuleFile("fn.guard", "fn.guard", FNVAR_RULES,
                  parse_rules_file(FNVAR_RULES, "fn.guard"))
    before = dict(walk.FNVAR_STEPS)
    card = evaluate([rf], docs, cuda_device).files[0]
    steps = walk.FNVAR_STEPS["per_origin"] - before["per_origin"]
    k1 = walk.FNVAR_STEPS["k1_launches"] - before["k1_launches"]
    cpu = evaluate([rf], docs, "cpu").files[0]
    assert steps > 0 and k1 == steps
    assert card.host_docs == cpu.host_docs and len(card.host_docs) >= 10
    assert np.array_equal(card.statuses, cpu.statuses)
    assert np.array_equal(card.unsure, cpu.unsure)
    for a, b in zip(card.rim, cpu.rim):
        assert np.array_equal(a, b)


REPORT_FORMATS = {
    "show_fail": [],
    "show_all": ["-S", "all"],
    "json": ["-o", "json"],
    "yaml": ["-o", "yaml"],
    "structured_json": ["-z", "-o", "json", "-S", "none"],
    "structured_yaml": ["-z", "-o", "yaml", "-S", "none"],
    "structured_sarif": ["-z", "-o", "sarif", "-S", "none"],
    "structured_junit": ["-z", "-o", "junit", "-S", "none"],
}


@pytest.fixture(scope="module")
def report_inputs(tmp_path_factory):
    """1,024 seeded security templates and the native oracle, built
    into a temporary directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json

    from guard_tpu_torch.ops import _native_lib, native_oracle
    from guard_tpu_torch.workloads import RULES, make_template

    root = tmp_path_factory.mktemp("reports")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(SEED)
    for i in range(1024):
        (data / f"t{i:04d}.json").write_text(json.dumps(make_template(rng, i)))
    (root / "security.guard").write_text(RULES)
    saved = _native_lib.NATIVE_DIR
    _native_lib.NATIVE_DIR = root / "native"
    try:
        native_oracle.build_native()
    finally:
        _native_lib.NATIVE_DIR = saved
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", sorted(REPORT_FORMATS))
def test_cuda_full_reports_match_cpu(cuda_device, report_inputs, monkeypatch, fmt):
    """A full-report validate run over 1,024 templates on the card, the
    native oracle built, prints what the same run on the CPU prints, in
    every output format; the native oracle built the failing reports."""
    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.ops import _native_lib, native_oracle
    from guard_tpu_torch.utils.io import Reader, Writer

    monkeypatch.setattr(_native_lib, "NATIVE_DIR", report_inputs / "native")
    monkeypatch.setattr(_native_lib, "_libs", {})
    monkeypatch.setattr(native_oracle, "_configured", None)
    flags = REPORT_FORMATS[fmt]
    kw = {
        "output_format": flags[flags.index("-o") + 1] if "-o" in flags else
        "single-line-summary",
        "structured": "-z" in flags,
        "show_summary": (flags[flags.index("-S") + 1] if "-S" in flags else "fail").split(","),
    }
    outs = []
    for device in ("cuda", "cpu"):
        cmd = Validate(rules=[str(report_inputs / "security.guard")],
                       data=[str(report_inputs / "data")], device=device,
                       result_cache=False, **kw)
        w = Writer.buffered()
        rc = cmd.execute(w, Reader.from_string(""))
        outs.append((rc, w.stripped(), w.err_to_stripped()))
        ev = cmd.last_evaluation
        fails = int(ev.files[0].rim[3][:, 0].sum())
        # a structured run reports every document in full
        assert 0 < fails == ev.reruns["native_reports"] or (
            kw["structured"] and ev.reruns["native_reports"] == ev.n_docs
        )
    assert outs[0] == outs[1] and outs[0][0] == 19 and outs[0][1]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0, 1, 4096, 65536])
@pytest.mark.parametrize("r", [1, 4, 37, 258, 512, 1024, 1028])
def test_cuda_rule_summary_matches_plain(cuda_device, d, r):
    """Every R is read in whole words, P = W / gcd(R, W) rows a period;
    R 258 and 1,028 take a period wider than one tile of words."""
    rng = np.random.default_rng(SEED + 7 * d + r)
    statuses, = to(cuda_device, rng.integers(-3, 6, size=(d, r), dtype=np.int8))
    for n_valid in sorted({0, max(d - 3, 0), d, d + 5}):
        before = K.LAUNCHES["rule_summary"]
        got = K.rule_summary(statuses, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.rule_summary(statuses, n_valid))
        launched = K.LAUNCHES["rule_summary"] - before
        assert launched == (1 if min(n_valid, d) > 0 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_cuda_rule_summary_of_unaligned_rows_matches_plain(cuda_device, offset):
    """A view whose rows do not start on a 4-byte boundary: the bytes
    before the first word boundary are counted apart."""
    rng = np.random.default_rng(SEED + offset)
    flat, = to(cuda_device, rng.integers(-3, 6, size=4096 * 8 + offset, dtype=np.int8))
    statuses = flat[offset:].view(4096, 8)
    for n_valid in (0, 4093, 4096):
        assert torch.equal(K.rule_summary(statuses, n_valid),
                           plain.rule_summary(statuses, n_valid))


@pytest.mark.cuda
def test_cuda_rule_summary_of_no_rules_launches_nothing(cuda_device):
    statuses = torch.zeros((16, 0), dtype=torch.int8, device=cuda_device)
    before = K.LAUNCHES["rule_summary"]
    got = K.rule_summary(statuses, 16)
    assert tuple(got.shape) == (3, 0) and K.LAUNCHES["rule_summary"] == before


@pytest.mark.cuda
def test_cuda_with_summary_matches_cpu(cuda_device):
    """The flagship example documents as one batch padded to the largest,
    as the dry run encodes them: statuses and K7 counts on the card equal
    the CPU's, with one K7 launch."""
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_batch
    from guard_tpu_torch.ops.ir import compile_rules_file
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
    from guard_tpu_torch.workloads import FLAGSHIP_RULES, example_docs

    batch, interner = encode_batch(
        [from_plain(d) for d in example_docs(61, two_buckets=True)]
    )
    compiled = compile_rules_file(parse_rules_file(FLAGSHIP_RULES, "f.guard"), interner)
    before = K.LAUNCHES["rule_summary"]
    card = DeviceBatchEvaluator(compiled, cuda_device).with_summary(batch)
    assert K.LAUNCHES["rule_summary"] == before + 1
    cpu = DeviceBatchEvaluator(compiled, "cpu").with_summary(batch)
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert int(card[1].sum()) == 61 * len(compiled.rules)
    part = K.rule_summary(torch.from_numpy(card[0]).to(cuda_device), 17)
    assert np.array_equal(part.cpu().numpy(),
                          plain.rule_summary(torch.from_numpy(cpu[0]), 17).numpy())


# K2 geometries (guard_segment_sum_branch): lanes per row, 256 a block
# per row, 0 a split grid
K2_GEOMETRIES = (8, 16, 32, 256, 0)


def k2_rows(rng, d: int, n: int, s: int):
    """(val, seg): values 0..3 (a quarter of them 0, skipped before the
    atomic) and segment ids in [-2, S + 2), so lanes at -1, at S and
    beyond S add nothing."""
    val = rng.integers(0, 4, size=(d, n)).astype(np.int32)
    seg = rng.integers(-2, s + 2, size=(d, n)).astype(np.int32)
    return val, seg


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32, 33, 64, 65, 128, 512, 513, 1024, 2048])
@pytest.mark.parametrize("d", [1, 16, 200])
def test_cuda_segment_sum_geometry_boundaries_match_plain(cuda_device, n, d):
    """N across the lane-group sizes (8, 16, 32 lanes a row), the group
    and block limit (N 512 / 513) and D across the SM count, with S at N,
    N + 1 and the query-RHS width (N + 1) * 5."""
    rng = np.random.default_rng(SEED + 13 * n + d)
    for s in (n, n + 1, (n + 1) * 5):
        val, seg = to(cuda_device, *k2_rows(rng, d, n, s))
        got = K.segment_sum_rows(val, seg, s)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.segment_sum_rows(val, seg, s))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", K2_GEOMETRIES)
@pytest.mark.parametrize("n,s", [(8, 9), (64, 65), (64, 325), (100, 101), (1024, 1025)])
def test_cuda_segment_sum_every_geometry_matches_plain(cuda_device, geometry, n, s):
    """Each geometry forced on the same rows, whichever the launcher
    would pick, including 16-byte and single-element loads."""
    lib = K._lib()
    rng = np.random.default_rng(SEED + 17 * n + geometry)
    val, seg = to(cuda_device, *k2_rows(rng, 300, n, s))
    out = torch.empty((300, s), dtype=torch.int32, device=cuda_device)
    rc = lib.guard_segment_sum_rows_as(
        geometry, val.data_ptr(), seg.data_ptr(), out.data_ptr(), 300, n, s,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(out, plain.segment_sum_rows(val, seg, s))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [65536, 65537, 65537 * 5])
def test_cuda_segment_sum_one_wide_row_matches_plain(cuda_device, s):
    """The one-document 65,536-node bucket takes the split grid and
    counts one launch."""
    n = 65536
    rng = np.random.default_rng(SEED + s)
    val, seg = to(cuda_device, *k2_rows(rng, 1, n, s))
    assert K._lib().guard_segment_sum_branch(1, n, s) == 0
    before = K.LAUNCHES["segment_sum_rows"]
    got = K.segment_sum_rows(val, seg, s)
    torch.cuda.synchronize()
    assert K.LAUNCHES["segment_sum_rows"] == before + 1
    assert K.SHAPES["segment_sum_rows"][(1, n, s)] >= 1
    assert torch.equal(got, plain.segment_sum_rows(val, seg, s))


@pytest.mark.cuda
def test_cuda_segment_sum_parent_histogram_matches_plain(cuda_device):
    """Child counts over random trees (seg = parent column, many lanes of
    one row on one bin), as _count_children calls it, from the 64-node
    bucket to one 65,536-node document."""
    for d, n in ((4096, 64), (64, 4096), (1, 65536)):
        rng = np.random.default_rng(SEED + n)
        parents, = to(cuda_device, _batch(rng, d, n) if n <= 4096
                      else _tree(rng, n, 60002)[None])
        pred = (torch.rand(parents.shape, device=cuda_device) < 0.6).to(torch.int32)
        got = K.segment_sum_rows(pred, parents, n)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.segment_sum_rows(pred, parents, n))


@pytest.mark.cuda
def test_cuda_segment_sum_of_no_rows_launches_nothing(cuda_device):
    for d, n, s in ((0, 64, 65), (0, 65536, 65537), (4, 64, 0)):
        val = torch.zeros((d, n), dtype=torch.int32, device=cuda_device)
        before = K.LAUNCHES["segment_sum_rows"]
        got = K.segment_sum_rows(val, val, s)
        assert tuple(got.shape) == (d, s)
        assert K.LAUNCHES["segment_sum_rows"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_cuda_segment_sum_of_unaligned_rows_matches_plain(cuda_device, offset):
    """Columns that do not start on a 16-byte boundary read one element
    a load (offset 4 starts on one, and reads 16 bytes)."""
    rng = np.random.default_rng(SEED + offset)
    for d, n, s in ((4096, 64, 65), (1, 65536, 65537)):
        val, seg = to(cuda_device, *k2_rows(rng, 1, d * n + offset, s))
        v = val[0, offset:].view(d, n)
        g = seg[0, offset:].view(d, n)
        got = K.segment_sum_rows(v, g, s)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.segment_sum_rows(v, g, s))


# K4 forms (guard_set_count_branch): 32 a warp's table, 256 a block's, 0
# tables in global scratch
K4_FORMS = (32, 256, 0)


def equal_key_rows(d: int, width: int):
    """Every entry the same pair (org 0, key 7), all masked in: one hash
    slot takes every insert."""
    org = np.zeros((d, width), np.int32)
    return org, np.full((d, width), 7, np.int32), np.ones((d, width), bool)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,ns", [(8, 8), (64, 31), (64, 64), (64, 128), (64, 129),
                                   (100, 256), (1024, 2048), (2048, 4096), (2048, 8192),
                                   (2048, 8193)])
@pytest.mark.parametrize("d", [1, 300])
def test_cuda_set_count_geometry_boundaries_match_plain(cuda_device, nq, ns, d):
    """Ns across the warp-table limit (128 / 256), the block-table limit
    (4,096 / 8,192) and the shared-memory limit (8,193), Ns below and
    above Nq, with D 1 (global tables) and D beyond the SM count."""
    rng = np.random.default_rng(SEED + 19 * ns + nq + d)
    q = to(cuda_device, *join_rows(rng, d, nq, nq))
    s = to(cuda_device, *join_rows(rng, d, nq, ns))
    got = K.set_count_rows(*q, *s)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.set_count_rows(*q, *s))


@pytest.mark.cuda
@pytest.mark.parametrize("form", K4_FORMS)
@pytest.mark.parametrize("nq,ns", [(8, 8), (64, 64), (64, 128), (128, 256)])
def test_cuda_set_count_every_form_matches_plain(cuda_device, form, nq, ns):
    lib = K._lib()
    rng = np.random.default_rng(SEED + 23 * ns + form)
    q = to(cuda_device, *join_rows(rng, 300, nq, nq))
    s = to(cuda_device, *join_rows(rng, 300, nq, ns))
    out = torch.empty((300, nq), dtype=torch.int32, device=cuda_device)
    scratch = torch.empty(lib.guard_set_count_scratch(300, ns), dtype=torch.uint8,
                          device=cuda_device)
    rc = lib.guard_set_count_rows_as(
        form, *(t.data_ptr() for t in (*q, *s)), out.data_ptr(),
        scratch.data_ptr() if form == 0 else None, 300, nq, ns,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(out, plain.set_count_rows(*q, *s))


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [65536, 131072])
def test_cuda_set_count_one_wide_row_matches_plain(cuda_device, ns):
    """The one-document 65,536-node bucket takes global tables and
    counts one launch for its memset and two grids."""
    n = 65536
    rng = np.random.default_rng(SEED + ns)
    q = to(cuda_device, *join_rows(rng, 1, n, n))
    s = to(cuda_device, *join_rows(rng, 1, n, ns))
    assert K._lib().guard_set_count_branch(1, ns) == 0
    before = K.LAUNCHES["set_count_rows"]
    got = K.set_count_rows(*q, *s)
    torch.cuda.synchronize()
    assert K.LAUNCHES["set_count_rows"] == before + 1
    assert torch.equal(got, plain.set_count_rows(*q, *s))


@pytest.mark.cuda
@pytest.mark.parametrize("d,nq,ns", [(300, 64, 128), (4, 4096, 8192), (1, 65536, 131072)])
def test_cuda_set_count_all_equal_keys_matches_plain(cuda_device, d, nq, ns):
    q = to(cuda_device, *equal_key_rows(d, nq))
    s = to(cuda_device, *equal_key_rows(d, ns))
    got = K.set_count_rows(*q, *s)
    torch.cuda.synchronize()
    assert (got == ns).all()
    assert torch.equal(got, plain.set_count_rows(*q, *s))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_cuda_set_count_of_unaligned_rows_matches_plain(cuda_device, offset):
    """Query and set rows cut from one buffer at an offset of 1, 2 and 4
    elements."""
    rng = np.random.default_rng(SEED + 29 * offset)
    for d, nq, ns in ((300, 64, 128), (1, 65536, 65536)):
        # row 1 of join_rows (row 0 is masked out)
        flat_q = to(cuda_device, *join_rows(rng, 2, nq, d * nq + offset))
        flat_s = to(cuda_device, *join_rows(rng, 2, nq, d * ns + offset))
        q = tuple(t[1, offset:].view(d, nq) for t in flat_q)
        s = tuple(t[1, offset:].view(d, ns) for t in flat_s)
        got = K.set_count_rows(*q, *s)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.set_count_rows(*q, *s))


@pytest.mark.cuda
def test_cuda_set_count_of_no_rows_launches_nothing(cuda_device):
    for d, nq, ns in ((0, 64, 128), (0, 65536, 131072), (4, 0, 64)):
        q = to(cuda_device, *equal_key_rows(d, nq))
        s = to(cuda_device, *equal_key_rows(d, ns))
        before = K.LAUNCHES["set_count_rows"]
        got = K.set_count_rows(*q, *s)
        assert tuple(got.shape) == (d, nq)
        assert K.LAUNCHES["set_count_rows"] == before


# K5 forms (guard_distinct_first_branch): 32 a warp's table, 256 a
# block's, 0 tables in global scratch
K5_FORMS = (32, 256, 0)


def distinct_first_as(form: int, org, key, mask) -> torch.Tensor:
    """K5 on a forced form, through guard_distinct_first_rows_as."""
    lib = K._lib()
    d, n = org.shape
    out = torch.empty_like(mask)
    scratch = torch.empty(lib.guard_distinct_first_scratch(d, n), dtype=torch.uint8,
                          device=org.device)
    rc = lib.guard_distinct_first_rows_as(
        form, org.data_ptr(), key.data_ptr(), mask.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if form == 0 else None, d, n,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert rc == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 64, 100, 128, 129, 256, 1024, 1025, 2048, 4096, 4097,
                               8192])
@pytest.mark.parametrize("d", [1, 300])
def test_cuda_distinct_first_form_boundaries_match_plain(cuda_device, n, d):
    """N across the warp-table limit (128 / 129), the limit of a block's
    table for fewer rows than SMs (1,024 / 1,025), the block-table limit
    (4,096 / 4,097) and beyond, with D 1 and D beyond the SM count,
    through the public wrapper."""
    rng = np.random.default_rng(SEED + 31 * n + d)
    q = to(cuda_device, *join_rows(rng, d, n, n))
    got = K.distinct_first_rows(*q)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.distinct_first_rows(*q))


@pytest.mark.cuda
@pytest.mark.parametrize("form", K5_FORMS)
@pytest.mark.parametrize("n", [8, 64, 100, 128, 256])
def test_cuda_distinct_first_every_form_matches_plain(cuda_device, form, n):
    rng = np.random.default_rng(SEED + 37 * n + form)
    q = to(cuda_device, *join_rows(rng, 300, n, n))
    assert torch.equal(distinct_first_as(form, *q), plain.distinct_first_rows(*q))


@pytest.mark.cuda
def test_cuda_distinct_first_one_wide_row_matches_plain(cuda_device):
    """The one-document 65,536-node bucket takes global tables and
    counts one launch for its memset and two grids."""
    n = 65536
    rng = np.random.default_rng(SEED + n)
    q = to(cuda_device, *join_rows(rng, 2, n, n))
    q = tuple(t[1:2] for t in q)  # row 0 of join_rows is masked out
    assert K._lib().guard_distinct_first_branch(1, n) == 0
    before = K.LAUNCHES["distinct_first_rows"]
    got = K.distinct_first_rows(*q)
    torch.cuda.synchronize()
    assert K.LAUNCHES["distinct_first_rows"] == before + 1
    assert K.SHAPES["distinct_first_rows"][(1, n)] >= 1
    assert torch.equal(got, plain.distinct_first_rows(*q))
    assert got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("form,d,n", [(32, 300, 64), (32, 4, 1024), (256, 300, 64),
                                      (256, 4, 4096), (0, 300, 64), (0, 4, 4096),
                                      (0, 1, 65536)])
def test_cuda_distinct_first_all_equal_keys_matches_plain(cuda_device, form, d, n):
    """Every entry the same pair: entry 0 alone is first, on each form at
    widths whose tables it holds (a warp's up to N 1,024, a block's up
    to N 8,192)."""
    q = to(cuda_device, *equal_key_rows(d, n))
    got = distinct_first_as(form, *q)
    want = torch.zeros_like(got)
    want[:, 0] = True
    assert torch.equal(got, want)
    assert torch.equal(got, plain.distinct_first_rows(*q))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_cuda_distinct_first_of_unaligned_rows_matches_plain(cuda_device, offset):
    rng = np.random.default_rng(SEED + 43 * offset)
    for d, n in ((300, 64), (200, 128), (1, 65536)):
        flat = to(cuda_device, *join_rows(rng, 2, n, d * n + offset))
        q = tuple(t[1, offset:].view(d, n) for t in flat)
        got = K.distinct_first_rows(*q)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.distinct_first_rows(*q))


@pytest.mark.cuda
def test_cuda_distinct_first_of_no_rows_launches_nothing(cuda_device):
    for d, n in ((0, 64), (0, 65536), (4, 0)):
        q = to(cuda_device, *equal_key_rows(d, n))
        before = K.LAUNCHES["distinct_first_rows"]
        got = K.distinct_first_rows(*q)
        assert tuple(got.shape) == (d, n)
        assert K.LAUNCHES["distinct_first_rows"] == before


# K6 forms (guard_seg_min_max_branch): 256 a block's table per row in
# shared memory, 0 the grid over tables in global scratch
K6_FORMS = (256, 0)


def seg_rows(rng, d: int, n: int, s: int, origins: int = 4):
    """(seg, mask, hi, lo): segments origin * 5 + kind from a few origins
    (most segments empty), extreme keys, row 0 masked out."""
    seg = (rng.integers(0, origins, size=(d, n)) * 5
           + rng.integers(0, 5, size=(d, n))).astype(np.int32) % max(s, 1)
    mask = rng.random((d, n)) < 0.6
    mask[0] = False
    vals = np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX], np.int32)
    return seg, mask, rng.choice(vals, size=(d, n)), rng.choice(vals, size=(d, n))


def seg_min_max_as(form: int, seg, mask, hi, lo, s: int):
    """K6 on a forced form, through guard_seg_min_max_rows_as."""
    lib = K._lib()
    d, n = seg.shape
    out = tuple(torch.empty((d, s), dtype=torch.int32, device=seg.device) for _ in range(4))
    scratch = torch.empty(lib.guard_seg_min_max_scratch(d, s), dtype=torch.uint8,
                          device=seg.device)
    rc = lib.guard_seg_min_max_rows_as(
        form, seg.data_ptr(), mask.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        *(t.data_ptr() for t in out), scratch.data_ptr() if form == 0 else None,
        d, n, s, torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert rc == 0
    return out


def assert_seg_min_max_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(8, 45), (64, 325), (128, 645), (1024, 5125),
                                 (1025, 5126), (1536, 7685), (2048, 14528),
                                 (2048, 14529), (4096, 20485)])
@pytest.mark.parametrize("d", [1, 131, 132, 300])
def test_cuda_seg_min_max_form_boundaries_match_plain(cuda_device, n, s, d):
    """S across the limit of a block's table for fewer rows than SMs
    (5,125 / 5,126), the shared-memory limit (14,528 / 14,529), and D
    across the SM count, through the public wrapper."""
    rng = np.random.default_rng(SEED + 47 * s + d)
    args = to(cuda_device, *seg_rows(rng, d, n, s, origins=max(4, n // 8)))
    got = K.seg_min_max_rows(*args, s)
    torch.cuda.synchronize()
    assert_seg_min_max_equal(got, plain.seg_min_max_rows(*args, s))


@pytest.mark.cuda
@pytest.mark.parametrize("form", K6_FORMS)
@pytest.mark.parametrize("d,n,s", [(300, 64, 325), (300, 128, 645), (8, 100, 505),
                                   (1, 1024, 5125), (3, 257, 1)])
def test_cuda_seg_min_max_every_form_matches_plain(cuda_device, form, d, n, s):
    rng = np.random.default_rng(SEED + 53 * n + form)
    args = to(cuda_device, *seg_rows(rng, d, n, s))
    assert_seg_min_max_equal(seg_min_max_as(form, *args, s),
                             plain.seg_min_max_rows(*args, s))


@pytest.mark.cuda
def test_cuda_seg_min_max_one_wide_row_matches_plain(cuda_device):
    """The one-document 65,536-node bucket at S 327,685 takes the grid
    and counts one launch for its memset and two grids."""
    n, s = 65536, 327685
    rng = np.random.default_rng(SEED + s)
    seg, mask, hi, lo = seg_rows(rng, 2, n, s, origins=n // 8)
    args = to(cuda_device, *(a[1:2] for a in (seg, mask, hi, lo)))
    assert K._lib().guard_seg_min_max_branch(1, n, s) == 0
    before = K.LAUNCHES["seg_min_max_rows"]
    got = K.seg_min_max_rows(*args, s)
    torch.cuda.synchronize()
    assert K.LAUNCHES["seg_min_max_rows"] == before + 1
    assert K.SHAPES["seg_min_max_rows"][(1, n, s)] >= 1
    assert_seg_min_max_equal(got, plain.seg_min_max_rows(*args, s))


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["masked_out", "one_segment", "edge_ids"])
@pytest.mark.parametrize("form,d,n,s", [(256, 300, 64, 325), (256, 1, 2048, 10245),
                                        (0, 300, 64, 325), (0, 1, 65536, 327685)])
def test_cuda_seg_min_max_edge_cases_match_plain(cuda_device, form, how, d, n, s):
    """Every entry masked out (sentinels everywhere); every entry in one
    segment with extreme hi and lo; and segment ids at S - 1, S and -1,
    on both forms (the block form where its table fits)."""
    rng = np.random.default_rng(SEED + 59 * n + len(how))
    seg, mask, hi, lo = seg_rows(rng, d, n, s)
    if how == "masked_out":
        mask = np.zeros_like(mask)
    elif how == "one_segment":
        seg = np.zeros_like(seg)
        mask = np.ones_like(mask)
    else:
        seg = rng.choice(np.array([s - 1, s, -1], np.int32), size=(d, n))
    args = to(cuda_device, seg, mask, hi, lo)
    got = seg_min_max_as(form, *args, s)
    assert_seg_min_max_equal(got, plain.seg_min_max_rows(*args, s))
    if how == "masked_out":
        assert (got[0] == I32_MAX).all() and (got[3] == I32_MIN).all()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_cuda_seg_min_max_of_unaligned_rows_matches_plain(cuda_device, offset):
    rng = np.random.default_rng(SEED + 61 * offset)
    for d, n, s in ((300, 64, 325), (1, 65536, 327685)):
        flat = to(cuda_device, *seg_rows(rng, 2, d * n + offset, s, origins=64))
        args = tuple(t[1, offset:].view(d, n) for t in flat)
        got = K.seg_min_max_rows(*args, s)
        torch.cuda.synchronize()
        assert_seg_min_max_equal(got, plain.seg_min_max_rows(*args, s))


@pytest.mark.cuda
def test_cuda_seg_min_max_of_no_rows_launches_nothing(cuda_device):
    for d, n, s in ((0, 64, 325), (0, 65536, 327685), (4, 64, 0)):
        args = to(cuda_device, *seg_rows(np.random.default_rng(SEED), max(d, 1), n, max(s, 1)))
        args = tuple(t[:d] for t in args)
        before = K.LAUNCHES["seg_min_max_rows"]
        got = K.seg_min_max_rows(*args, s)
        assert all(tuple(t.shape) == (d, s) for t in got)
        assert K.LAUNCHES["seg_min_max_rows"] == before


# K3 forms (guard_rim_reduce_branch): 1 a thread a row, 32 a warp a row,
# 256 a block a row
K3_FORMS = (1, 32, 256)
# (D, R, G, F): the main path's widths, D 1 and D not a multiple of a
# block's 256 rows, then wider rule axes up to a full pack of 512 rules
# (G 64 and 65 on both sides of the thread form's 64-bit masks, F 33
# across a 32-bit word), and no rule at all
K3_SHAPES = ((1, 4, 4, 1), (300, 4, 4, 1), (257, 5, 5, 1), (513, 16, 8, 2),
             (1000, 64, 41, 1), (300, 64, 64, 64), (200, 37, 65, 33),
             (100, 256, 130, 4), (64, 512, 512, 64), (50, 0, 0, 1))
K3_CASES = [(form, shape) for form in K3_FORMS for shape in K3_SHAPES
            if form != 1 or (shape[2] <= 64 and shape[3] <= 64)]


def rim_inputs(dev, d: int, r: int, g: int, f: int, offset: int = 0):
    """_rim_case's arrays on the card; statuses and unsure as views that
    start `offset` bytes into their buffers."""
    statuses, unsure, gid, fid, last = _rim_case(
        np.random.default_rng(SEED + d + 3 * r + g), d, r, g, f)
    if offset:
        flat = np.zeros((2, d * r + offset), np.int8)
        flat[0, offset:] = statuses.ravel()
        flat[1, offset:] = unsure.ravel()
        st, un = to(dev, flat[0], flat[1].astype(bool))
        st, un = st[offset:].view(d, r), un[offset:].view(d, r)
    else:
        st, un = to(dev, statuses, unsure)
    return (st, un, *to(dev, gid, fid, last))


def rim_as(form: int, statuses, unsure, gid, fid, last, g: int, f: int):
    """K3 forced onto one form, its six outputs in their own tensors."""
    d, r = statuses.shape
    out = tuple(torch.empty((d, w), dtype=torch.int8, device=statuses.device)
                for w in (g, g, f, f, f, g))
    rc = K._lib().guard_rim_reduce_as(
        form, statuses.data_ptr(), None if unsure is None else unsure.data_ptr(),
        gid.data_ptr(), fid.data_ptr(), last.data_ptr(), *(t.data_ptr() for t in out),
        d, r, g, f, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"K3 form {form} refused (cudaError {rc})"
    torch.cuda.synchronize()
    return tuple(t.view(torch.bool) if i in (1, 3, 4) else t for i, t in enumerate(out))


def assert_rim_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_unsure", [True, False])
@pytest.mark.parametrize("form,shape", K3_CASES)
def test_cuda_rim_reduce_every_form_matches_plain(cuda_device, form, shape, with_unsure):
    d, r, g, f = shape
    st, un, gid, fid, last = rim_inputs(cuda_device, d, r, g, f)
    un = un if with_unsure else None
    assert_rim_equal(rim_as(form, st, un, gid, fid, last, g, f),
                     plain.rim_reduce(st, un, gid, fid, last, g, f))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 4, 8])
@pytest.mark.parametrize("form,shape", [(form, shape) for form, shape in K3_CASES
                                        if shape[1] in (4, 16, 64, 512)])
def test_cuda_rim_reduce_off_a_16_byte_boundary_matches_plain(cuda_device, form, shape,
                                                              offset):
    """Statuses and unsure bits that start 1 to 8 bytes past a 16-byte
    boundary: the thread form reads them a byte or a word a load."""
    d, r, g, f = shape
    args = rim_inputs(cuda_device, d, r, g, f, offset)
    assert_rim_equal(rim_as(form, *args, g, f), plain.rim_reduce(*args, g, f))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65536, 4, 4, 1), (48694, 5, 5, 1), (1, 4, 4, 1),
                                   (1 << 18, 256, 130, 4), (65536, 512, 512, 64)])
def test_cuda_rim_reduce_main_path_shapes_match_plain(cuda_device, shape):
    """The wrapper at the main path's shapes and the sweep's: the form it
    picks, one launch counted a call, six views of one buffer."""
    d, r, g, f = shape
    args = rim_inputs(cuda_device, d, r, g, f)
    before = K.LAUNCHES["rim_reduce"]
    got = K.rim_reduce(*args, g, f)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rim_reduce"] == before + 1
    assert_rim_equal(got, plain.rim_reduce(*args, g, f))
    assert_rim_equal(K.rim_reduce(args[0], None, *args[2:], g, f),
                     plain.rim_reduce(args[0], None, *args[2:], g, f))


@pytest.mark.cuda
def test_cuda_rim_reduce_of_no_rows_launches_nothing(cuda_device):
    st, un, gid, fid, last = rim_inputs(cuda_device, 4, 5, 5, 1)
    before = K.LAUNCHES["rim_reduce"]
    got = K.rim_reduce(st[:0], un[:0], gid, fid, last, 5, 1)
    assert [tuple(t.shape) for t in got] == [(0, 5), (0, 5), (0, 1), (0, 1), (0, 1), (0, 5)]
    assert K.LAUNCHES["rim_reduce"] == before


@pytest.mark.cuda
def test_cuda_rim_reduce_thread_form_refuses_wide_masks(cuda_device):
    """The thread form holds 64 groups and 64 files; the launcher never
    picks it beyond, and a forced launch there is refused."""
    st, un, gid, fid, last = rim_inputs(cuda_device, 8, 65, 65, 1)
    lib = K._lib()
    assert lib.guard_rim_reduce_branch(8, 65, 65, 1) != 1
    out = torch.empty((8, 65), dtype=torch.int8, device=cuda_device)
    rc = lib.guard_rim_reduce_as(1, st.data_ptr(), un.data_ptr(), gid.data_ptr(),
                                 fid.data_ptr(), last.data_ptr(), *[out.data_ptr()] * 6,
                                 8, 65, 65, 1, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


# K7 forms (guard_rule_summary_branch): 1 one block writes every counter,
# 2 one cluster of 16 blocks whose block 0 writes every counter; 8 and 16
# a grid of words of that many bytes adds into the output the launcher
# zeroes
K7_FORMS = (1, 2, 8, 16)


def summary_as(form: int, statuses, n_valid: int):
    d, r = statuses.shape
    out = torch.full((3, r), -1, dtype=torch.int32, device=statuses.device)
    rc = K._lib().guard_rule_summary_as(form, statuses.data_ptr(), out.data_ptr(), d, r,
                                        n_valid, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"K7 form {form} refused (cudaError {rc})"
    torch.cuda.synchronize()
    return out


def summary_rows(dev, d: int, r: int, offset: int):
    """(D, R) statuses with values outside 0..2, as a view that starts
    `offset` bytes into its buffer."""
    rng = np.random.default_rng(SEED + 13 * d + r + offset)
    flat, = to(dev, rng.integers(-3, 6, size=d * r + offset, dtype=np.int8))
    return flat[offset:].view(d, r)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("r", range(16, 32))
@pytest.mark.parametrize("form", K7_FORMS)
def test_cuda_rule_summary_every_form_matches_plain(cuda_device, form, r, offset):
    """Every R % 16 (periods of 1 to 16 rows) on a base 0 to 3 bytes
    past a word boundary, n_valid 0, 1, D - 3 and D."""
    statuses = summary_rows(cuda_device, 300, r, offset)
    for n_valid in (0, 1, 297, 300):
        assert torch.equal(summary_as(form, statuses, n_valid),
                           plain.rule_summary(statuses, n_valid))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("d,r", [(65536, 4), (1 << 20, 37), (4099, 36), (4099, 38), (4099, 39),
                                 (65536, 512), (2000, 1028), (8, 2), (1, 4)])
def test_cuda_rule_summary_picked_form_matches_plain(cuda_device, d, r, offset):
    """The wrapper at the main path's and the sweep's widths: one launch
    counted where a row is valid, none where n_valid is 0."""
    statuses = summary_rows(cuda_device, d, r, offset)
    for n_valid in sorted({0, 1, max(d - 3, 0), d}):
        before = K.LAUNCHES["rule_summary"]
        got = K.rule_summary(statuses, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.rule_summary(statuses, n_valid))
        assert K.LAUNCHES["rule_summary"] - before == (1 if n_valid else 0)


@pytest.mark.cuda
def test_cuda_rule_summary_direct_form_refuses_a_period_of_several_tiles(cuda_device):
    """One block (or one cluster) writes every counter only where one
    tile spans a period (R 1,028: 257 words); the launcher picks a grid
    there."""
    statuses = summary_rows(cuda_device, 4, 1028, 0)
    lib = K._lib()
    assert lib.guard_rule_summary_branch(4, 1028, 4) not in (1, 2)
    out = torch.empty((3, 1028), dtype=torch.int32, device=cuda_device)
    for form in (1, 2):
        rc = lib.guard_rule_summary_as(form, statuses.data_ptr(), out.data_ptr(), 4, 1028,
                                       4, torch.cuda.current_stream().cuda_stream)
        assert rc != 0


@pytest.fixture(scope="module")
def ingest_inputs(tmp_path_factory):
    """8,192 seeded security templates and a 30,002-node volume template
    (the 32,768-node bucket), and the native encoder built into a
    temporary directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json

    from guard_tpu_torch.ops import _native_lib, native_encoder
    from guard_tpu_torch.workloads import RULES, make_template, volume_template

    root = tmp_path_factory.mktemp("ingest")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(SEED)
    for i in range(8192):
        (data / f"t{i:04d}.json").write_text(json.dumps(make_template(rng, i)))
    (data / "volumes.json").write_text(json.dumps(volume_template(6000)))
    (root / "security.guard").write_text(RULES)
    saved = _native_lib.NATIVE_DIR
    _native_lib.NATIVE_DIR = root / "native"
    try:
        native_encoder.build_native()
    finally:
        _native_lib.NATIVE_DIR = saved
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 2])
def test_cuda_native_ingest_matches_tree_encoder(cuda_device, ingest_inputs, monkeypatch,
                                                 workers):
    """Statuses-only validate on the card from the native encoder (in
    this process, or over 2 ingest workers) gives the tree encoder's
    statuses, unsure bits, rim blocks, stdout and kernel launches."""
    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.ops import _native_lib, native_encoder
    from guard_tpu_torch.parallel import ingest
    from guard_tpu_torch.utils.io import Reader, Writer

    monkeypatch.setattr(_native_lib, "_libs", {})
    monkeypatch.setattr(native_encoder, "_configured", None)
    monkeypatch.setenv("GUARD_TPU_TORCH_NATIVE_DIR", str(ingest_inputs / "native"))
    runs = []
    for native_dir, w in ((ingest_inputs / "no_native", 0), (ingest_inputs / "native", workers)):
        monkeypatch.setattr(_native_lib, "NATIVE_DIR", native_dir)
        monkeypatch.setattr(_native_lib, "_libs", {})
        monkeypatch.setattr(native_encoder, "_configured", None)
        cmd = Validate(rules=[str(ingest_inputs / "security.guard")],
                       data=[str(ingest_inputs / "data")], device="cuda",
                       statuses_only=True, ingest_workers=w, result_cache=False)
        w_ = Writer.buffered()
        K.reset_launches()
        rc = cmd.execute(w_, Reader.from_string(""))
        torch.cuda.synchronize()
        runs.append((rc, w_.stripped(), w_.err_to_stripped(), dict(K.LAUNCHES),
                     cmd.last_evaluation))
    ingest.close_shared_pools()
    (tree, native) = runs
    assert tree[4].ingest["path"] == "tree"
    assert native[4].ingest["path"] == ("pool" if workers >= 2 else "native")
    assert tree[:4] == native[:4] and tree[0] == 19 and tree[3]["rim_reduce"] > 0
    for a, b in zip(tree[4].files, native[4].files):
        assert np.array_equal(a.statuses, b.statuses)
        assert np.array_equal(a.unsure, b.unsure)
        for x, y in zip(a.rim, b.rim):
            assert np.array_equal(x, y)


def _registry(n_docs: int):
    """All corpus/rules files and their tests' inputs, replicated in
    order to n_docs documents: the registry configuration."""
    import pathlib

    import yaml

    from guard_tpu_torch.commands.validate import RuleFile
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain

    corpus = pathlib.Path(__file__).resolve().parent.parent / "corpus" / "rules"
    rule_files, inputs = [], []
    for p in sorted(corpus.glob("*.guard")):
        text = p.read_text()
        rule_files.append(RuleFile(p.name, str(p), text, parse_rules_file(text, p.name)))
        spec = corpus / "tests" / f"{p.stem}_tests.yaml"
        inputs += [c["input"] for c in yaml.safe_load(spec.read_text()) or []
                   if isinstance(c, dict) and "input" in c]
    pvs = [from_plain(d) for d in inputs]
    return rule_files, [pvs[i % len(pvs)] for i in range(n_docs)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_docs", [725, 8192])
def test_cuda_packed_registry_matches_per_file_and_cpu(cuda_device, tmp_path, monkeypatch,
                                                       n_docs):
    """The 249 corpus files (245 in one pack of 253 rules) over the
    corpus inputs: the packed evaluation on the card gives the per-file
    evaluation's and the CPU's statuses, unsure bits, rim blocks and
    oracle documents, with one walk and one K3 launch per (pack, bucket)
    where the per-file path launches one per (file, bucket)."""
    from guard_tpu_torch.ops.backend import evaluate
    from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS

    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    rule_files, docs = _registry(n_docs)
    runs = {}
    for label, device, pack in (("packed", "cuda", True), ("per_file", "cuda", False),
                                ("cpu", "cpu", True)):
        K.reset_launches()
        DISPATCH_COUNTERS["dispatches"] = 0
        ev = evaluate(rule_files, docs, device, pack_rules=pack)
        torch.cuda.synchronize()
        runs[label] = (ev, dict(K.LAUNCHES), DISPATCH_COUNTERS["dispatches"])
    packed, per_file, cpu = (runs[k][0] for k in ("packed", "per_file", "cpu"))
    assert [len(p) for p in packed.packs] == [245] and per_file.packs == []
    assert sum(len(fr.compiled.rules) for fr in packed.files if fr.pack == 0) == 253
    n_buckets = len(packed.groups)
    own = sum(len(fr.groups) for fr in packed.files if fr.pack is None and fr.compiled.rules)
    assert runs["packed"][2] == n_buckets + own
    assert runs["packed"][1]["rim_reduce"] == n_buckets + own
    assert runs["per_file"][2] == runs["per_file"][1]["rim_reduce"] == 245 * n_buckets + own
    for other in (per_file, cpu):
        for a, b in zip(packed.files, other.files):
            assert np.array_equal(a.statuses, b.statuses)
            assert np.array_equal(a.unsure, b.unsure)
            assert a.host_docs == b.host_docs
            for x, y in zip(a.rim, b.rim):
                assert x.dtype == y.dtype and np.array_equal(x, y)


def _port_cli(argv):
    """(rc, stdout, stderr) of the port's CLI in this process."""
    from guard_tpu_torch import cli
    from guard_tpu_torch.utils.io import Writer

    w = Writer.buffered()
    rc = cli.run(argv, writer=w)
    return rc, w.stripped(), w.err_to_stripped()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["single-line-summary", "json", "junit"])
def test_cuda_test_command_matches_cpu(cuda_device, fmt):
    """`test --dir corpus/rules` on the card prints what it prints on the
    CPU: 725 cases, most of them answered by the walk on the card (K1
    and K2 launch), and no rim reduction (K3 0)."""
    import pathlib

    from guard_tpu_torch import cli
    from guard_tpu_torch.commands.test import Test

    corpus = pathlib.Path(__file__).resolve().parent.parent / "corpus" / "rules"
    seen = []

    class Recording(Test):
        def execute(self, writer, reader):
            seen.append(self)
            return super().execute(writer, reader)

    outs = {}
    for device in ("cuda", "cpu"):
        K.reset_launches()
        cli_test, cli.Test = cli.Test, Recording
        try:
            outs[device] = _port_cli(["test", "--device", device, "-d", str(corpus), "-o", fmt])
        finally:
            cli.Test = cli_test
        if device == "cuda":
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
    assert outs["cuda"] == outs["cpu"] and outs["cuda"][0] == 0
    routes = seen[0].routes
    assert sum(routes.values()) == 725 and routes["device"] >= 600
    assert launches["gather_rows"] > 0 and launches["segment_sum_rows"] > 0
    assert launches["rim_reduce"] == 0


@pytest.mark.cuda
def test_cuda_warm_run_launches_nothing(cuda_device, report_inputs, tmp_path, monkeypatch):
    """A second run over unchanged documents replays every one from the
    result cache: not one kernel launch, and the first run's bytes,
    which are the bytes of a run without the cache."""
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(tmp_path / "results"))
    args = ["validate", "--device", "cuda", "--statuses-only", "--delta-stats",
            "-r", str(report_inputs / "security.guard"), "-d", str(report_inputs / "data")]
    off = _port_cli([*args, "--no-result-cache"])
    K.reset_launches()
    cold = _port_cli(args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gather_rows"] > 0 and K.LAUNCHES["rim_reduce"] > 0
    K.reset_launches()
    warm = _port_cli(args)
    torch.cuda.synchronize()
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    assert (cold[0], cold[1]) == (warm[0], warm[1]) == (off[0], off[1])
    assert warm[2].endswith("result-cache: 1024/1024 docs cached, 0 dispatched\n")


@pytest.mark.cuda
def test_cuda_no_vector_rim_launches_no_k3(cuda_device, report_inputs):
    """--no-vector-rim on the card: no K3 launch, the vector run's bytes."""
    args = ["validate", "--device", "cuda", "--no-result-cache", "-S", "all",
            "-r", str(report_inputs / "security.guard"), "-d", str(report_inputs / "data")]
    runs = {}
    for label, extra in (("vector", []), ("scalar", ["--no-vector-rim"])):
        K.reset_launches()
        runs[label] = _port_cli([*args, *extra])
        torch.cuda.synchronize()
        runs[label] += (dict(K.LAUNCHES),)
    assert runs["vector"][:3] == runs["scalar"][:3] and runs["vector"][0] == 19
    assert runs["vector"][3]["rim_reduce"] > 0 and runs["scalar"][3]["rim_reduce"] == 0
    assert runs["scalar"][3]["gather_rows"] == runs["vector"][3]["gather_rows"]


@pytest.fixture
def sweep_registry(tmp_path):
    """Eight corpus rule files (one pack) and their test inputs, one
    document a file, twice over (chunks of more than one bucket)."""
    import json
    import pathlib

    import yaml

    corpus = pathlib.Path(__file__).resolve().parent.parent / "corpus" / "rules"
    rules, data = tmp_path / "rules", tmp_path / "data"
    rules.mkdir()
    data.mkdir()
    n = 0
    for src in sorted(corpus.glob("*.guard"))[:8]:
        (rules / src.name).write_text(src.read_text())
        for case in yaml.safe_load((corpus / "tests" / f"{src.stem}_tests.yaml").read_text()):
            for rep in range(2):
                (data / f"d{n:03d}_{rep}.json").write_text(json.dumps(case["input"]))
            n += 1
    return rules, data


@pytest.mark.cuda
@pytest.mark.parametrize("workers", ["0", "1"])
def test_cuda_sweep_matches_cpu(cuda_device, sweep_registry, tmp_path, monkeypatch, workers):
    """`sweep` on the card prints the CPU run's stdout, stderr and
    manifest; its packed path launches K1, K2 and K3, and a warm run
    over a new manifest launches nothing."""
    rules, data = sweep_registry
    monkeypatch.setenv("GUARD_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    manifest = tmp_path / "m.jsonl"
    base = ["sweep", "-c", "16", "--ingest-workers", workers, "-r", str(rules), "-d", str(data),
            "-M", str(manifest)]
    runs = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(tmp_path / f"results_{dev}"))
        manifest.unlink(missing_ok=True)
        K.reset_launches()
        got = _port_cli([*base, "--device", dev])
        torch.cuda.synchronize()
        runs[dev] = got + (manifest.read_bytes(), dict(K.LAUNCHES))
    assert runs["cuda"][:4] == runs["cpu"][:4] and runs["cuda"][0] in (0, 19)
    launched = runs["cuda"][4]
    assert all(launched[k] > 0 for k in ("gather_rows", "segment_sum_rows", "rim_reduce"))
    manifest.unlink()
    K.reset_launches()
    warm = _port_cli([*base, "--device", "cuda", "--delta-stats"])
    torch.cuda.synchronize()
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    assert warm[1] == runs["cuda"][1] and manifest.read_bytes() == runs["cuda"][3]


@pytest.mark.cuda
@pytest.mark.parametrize("out_fmt", ["sarif", "json"])
def test_cuda_coalesced_serve_matches_cpu(cuda_device, sweep_registry, tmp_path, monkeypatch,
                                          out_fmt):
    """A coalesced group of eight requests over eight registry files
    answers on the card, request by request, exactly what a `--device
    cpu` session answers; the group shares its dispatches (fewer than
    requests) and launches K1, K2 and K3."""
    import json
    import threading

    from guard_tpu_torch.commands.serve import Serve
    from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS
    from guard_tpu_torch.utils.telemetry import SERVE_COUNTERS

    rules_dir, data_dir = sweep_registry
    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "200")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.delenv("GUARD_TPU_FAULT", raising=False)
    rules = [p.read_text() for p in sorted(rules_dir.glob("*.guard"))]
    docs = [p.read_text() for p in sorted(data_dir.glob("*.json"))]
    lines = [json.dumps({"rules": rules, "data": docs[i::8], "backend": "tpu",
                         "output_format": out_fmt}) for i in range(8)]
    cpu = Serve(stdio=False, coalesce=False, device="cpu")
    want = [cpu.handle_line(line) for line in lines]
    card = Serve(stdio=False, coalesce=True)
    card.handle_line(lines[0])  # the kernels build and the plan lowers before the group
    got = [None] * 8
    barrier = threading.Barrier(8)

    def one(i):
        barrier.wait(120)
        got[i] = card.handle_line(lines[i])

    K.reset_launches()
    d0, b0 = DISPATCH_COUNTERS["dispatches"], SERVE_COUNTERS["coalesced_batches"]
    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    torch.cuda.synchronize()
    assert got == want and {r["code"] for r in got} <= {0, 19}
    assert SERVE_COUNTERS["coalesced_batches"] > b0
    assert DISPATCH_COUNTERS["dispatches"] - d0 < 8
    assert all(K.LAUNCHES[k] > 0 for k in ("gather_rows", "segment_sum_rows", "rim_reduce"))


def _all_kernels_on(device, rng):
    """Each of K1-K7 once on seeded tensors on `device`: (name, wrapper
    output, plain output on the CPU) triples."""
    d, n, s = 8, 64, 65
    parents = _batch(rng, d, n)
    vec = rng.integers(0, n + 1, size=(d, n)).astype(np.int32)
    val = rng.integers(0, 4, size=(d, n)).astype(np.int32)
    seg = rng.integers(-2, s + 2, size=(d, n)).astype(np.int32)
    org = rng.integers(-1, 3, size=(d, n)).astype(np.int32)
    key = rng.integers(-5, 5, size=(d, n)).astype(np.int32)
    mask = rng.random((d, n)) < 0.8
    statuses, unsure, g_ids, f_ids, l_ids = _rim_case(rng, d, 12, 5, 3)
    cases = {
        "gather_rows": (K.gather_rows, plain.gather_rows, (vec, parents)),
        "segment_sum_rows": (K.segment_sum_rows, plain.segment_sum_rows, (val, seg), (s,)),
        "rim_reduce": (K.rim_reduce, plain.rim_reduce,
                       (statuses, unsure, g_ids, f_ids, l_ids), (5, 3)),
        "set_count_rows": (K.set_count_rows, plain.set_count_rows,
                           (org, key, mask, org[::-1].copy(), key[:, ::-1].copy(), mask)),
        "distinct_first_rows": (K.distinct_first_rows, plain.distinct_first_rows,
                                (org, key, mask)),
        "seg_min_max_rows": (K.seg_min_max_rows, plain.seg_min_max_rows,
                             (seg.clip(-1, 9), mask, key, val), (10,)),
        "rule_summary": (K.rule_summary, plain.rule_summary, (statuses,), (d - 3,)),
    }
    out = []
    for name, (wrapper, ref, arrays, *extra) in cases.items():
        extra = extra[0] if extra else ()
        on_card = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
        on_cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        out.append((name, wrapper(*on_card, *extra), ref(*on_cpu, *extra)))
    return out


@pytest.mark.cuda
def test_cuda_kernels_launch_on_their_tensors_card(cuda_device):
    """K1-K7 on cuda:1 tensors from a thread whose current device is 0:
    each wrapper launches on its tensors' card (the per-card occupancy,
    shared-memory and cluster settings of that card) and equals its
    plain version."""
    import threading

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    card1 = torch.device("cuda", 1)
    result = {}

    def body():
        torch.cuda.set_device(0)
        before = dict(K.LAUNCHES)
        got = _all_kernels_on(card1, np.random.default_rng(SEED))
        torch.cuda.synchronize(card1)
        result["got"] = got
        result["launched"] = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        result["current"] = torch.cuda.current_device()

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert result["current"] == 0
    assert result["launched"] == {name: 1 for name in K.NAMES}
    for name, card, ref in result["got"]:
        card = card if isinstance(card, tuple) else (card,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(card, ref):
            assert a.device == card1, name
            assert torch.equal(a.cpu(), b), name


@pytest.mark.cuda
def test_cuda_sharded_evaluator_over_one_card_twice(cuda_device):
    """The mesh over [cuda:0, cuda:0]: every bucket cut in two slices,
    each on its own stream of the one card; statuses, unsure bits, rim
    blocks and the summed K7 counts equal one device's and the CPU's."""
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_batch
    from guard_tpu_torch.ops.ir import build_rim_spec, compile_rules_file
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
    from guard_tpu_torch.parallel.mesh import ShardedBatchEvaluator
    from guard_tpu_torch.workloads import XREF_RULES, make_xref_template, volume_template

    rng = np.random.default_rng(SEED)
    docs = [make_xref_template(rng, i) for i in range(301)] + [volume_template(2000)]
    batch, interner = encode_batch([from_plain(d) for d in docs])
    compiled = compile_rules_file(parse_rules_file(XREF_RULES, "x.guard"), interner)
    spec = build_rim_spec([compiled.rules])
    card0 = torch.device("cuda", 0)
    mesh = ShardedBatchEvaluator(compiled, [card0, card0], rim_spec=spec)
    assert len(mesh.shards) == 2
    assert mesh.shards[0]._stream is not mesh.shards[1]._stream
    before = dict(K.LAUNCHES)
    got = mesh.evaluate_bucketed(batch)
    assert K.LAUNCHES["rim_reduce"] - before["rim_reduce"] >= 2
    want = DeviceBatchEvaluator(compiled, card0, rim_spec=spec).evaluate_bucketed(batch)
    cpu = DeviceBatchEvaluator(compiled, "cpu", rim_spec=spec).evaluate_bucketed(batch)
    for ref in (want, cpu):
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
        assert got[2] == ref[2]
        for a, b in zip(got[3], ref[3]):
            assert np.array_equal(a, b)
    st, counts = mesh.with_summary(batch)
    st1, counts1 = DeviceBatchEvaluator(compiled, "cpu").with_summary(batch)
    assert np.array_equal(st, st1) and np.array_equal(counts, counts1)
    assert int(counts.sum()) == len(docs) * len(compiled.rules)


_XREF_RANK = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from guard_tpu_torch import kernels as K
from guard_tpu_torch.core.parser import parse_rules_file
from guard_tpu_torch.core.values import from_plain
from guard_tpu_torch.ops.encoder import encode_bucketed
from guard_tpu_torch.ops.ir import compile_rules_file
from guard_tpu_torch.parallel import distributed
from guard_tpu_torch.workloads import XREF_RULES, make_xref_template

rank, world, port, n, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             int(sys.argv[4]), sys.argv[5])
distributed.initialize(f"127.0.0.1:{port}", world, rank, timeout_s=120)
rng = np.random.default_rng(11)
docs = [make_xref_template(rng, i) for i in range(n)]
lo, hi = distributed.process_bounds(n)
groups, oversize, interner = encode_bucketed([from_plain(d) for d in docs[lo:hi]])
assert len(oversize) == 0
compiled = compile_rules_file(parse_rules_file(XREF_RULES, "x.guard"), interner)
ev = distributed.DistributedEvaluator(compiled)
K.reset_launches()
statuses, start, counts = ev.with_summary(groups)
distributed.shutdown()
assert "jax" not in sys.modules and "guard_tpu" not in sys.modules
with open(out, "w") as f:
    json.dump({"lo": lo, "hi": hi, "start": start, "statuses": statuses.tolist(),
               "counts": counts.tolist(), "launches": dict(K.LAUNCHES),
               "devices": [str(d) for d in ev.devices]}, f)
'''


@pytest.mark.cuda
def test_cuda_two_ranks_over_the_xref_policy_match_one_process(cuda_device, tmp_path):
    """Two gloo ranks on the card (every rank on cuda:0 with one card),
    each over its own range of 301 cross-reference templates: the
    concatenated statuses and every rank's all-reduced K7 counts equal
    one process's on the card, and each rank launched K4 and K7."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_batch
    from guard_tpu_torch.ops.ir import compile_rules_file
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
    from guard_tpu_torch.workloads import XREF_RULES, make_xref_template

    n, world = 301, 2
    script = tmp_path / "rank.py"
    script.write_text(_XREF_RANK)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), port, str(n),
                               str(tmp_path / f"rank{r}.json")], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rng = np.random.default_rng(11)
    batch, interner = encode_batch([from_plain(make_xref_template(rng, i)) for i in range(n)])
    compiled = compile_rules_file(parse_rules_file(XREF_RULES, "x.guard"), interner)
    want_st, want_counts = DeviceBatchEvaluator(compiled, cuda_device).with_summary(batch)
    got = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["devices"] == [f"cuda:{r % torch.cuda.device_count()}"]
        assert res["start"] == res["lo"]
        assert np.array_equal(np.asarray(res["counts"]), want_counts)
        assert res["launches"]["set_count_rows"] > 0 and res["launches"]["rule_summary"] > 0
        got.append(np.asarray(res["statuses"], np.int8).reshape(-1, len(compiled.rules)))
    assert np.array_equal(np.concatenate(got), want_st)
    assert int(want_counts.sum()) == n * len(compiled.rules)

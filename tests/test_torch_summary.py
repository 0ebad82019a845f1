"""Per-rule summary counts (kernel K7 `rule_summary`) against numpy and
the JAX package.

  * K7's plain version, which the wrapper runs for CPU tensors, equals a
    numpy count of PASS (0), FAIL (1) and SKIP (2) over the first
    n_valid rows, for empty and non-empty shapes, statuses outside 0..2,
    random int8 matrices (hypothesis), and R 36 to 39 and 1,028 with
    n_valid at every remainder of a 16-row period; on the CPU it
    launches and counts nothing;
  * the port's `DeviceBatchEvaluator(compiled, "cpu").with_summary`
    returns the same (d, R) statuses and (3, R) counts as the JAX
    package's `ShardedBatchEvaluator(compiled, default_mesh())
    .with_summary` on the same documents. The JAX side pads the document
    axis to a multiple of its 8 CPU devices and masks the padding with
    n_valid, so most batches here hold a count of documents that 8 does
    not divide. Cases: the 37 documents of
    tests/test_tpu_backend.py::test_sharded_evaluator_cpu_mesh, the
    flagship example documents as one batch padded to the largest (as
    the dry run encodes them), the security, cross-reference and
    function-variable workloads, and every 10th corpus rules file over
    its own test inputs (each of those 25 lowers a device rule, so none
    is passed over);
  * K7 over `with_summary`'s statuses with n_valid = k counts the
    first k documents only (k clamped to [0, d]): the mask that the JAX
    package's summarize applies to its mesh padding.

Every value is an integer: exact equality, no tolerance.
"""

import pathlib

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import __graft_entry__ as graft
from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.core.values import from_plain as j_from_plain
from guard_tpu.ops.encoder import encode_batch as j_encode
from guard_tpu.ops.fnvars import precompute_fn_values as j_precompute
from guard_tpu.ops.fnvars import precomputable_fn_vars as j_precomputable
from guard_tpu.ops.ir import compile_rules_file as j_compile
from guard_tpu.parallel.mesh import ShardedBatchEvaluator, default_mesh
from guard_tpu_torch import kernels as K
from guard_tpu_torch.core.parser import parse_rules_file as t_parse
from guard_tpu_torch.core.values import from_plain as t_from_plain
from guard_tpu_torch.kernels import plain
from guard_tpu_torch.ops.encoder import encode_batch as t_encode
from guard_tpu_torch.ops.fnvars import precompute_fn_values as t_precompute
from guard_tpu_torch.ops.fnvars import precomputable_fn_vars as t_precomputable
from guard_tpu_torch.ops.ir import compile_rules_file as t_compile
from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
from guard_tpu_torch.workloads import (
    FNVAR_RULES,
    RULES,
    XREF_RULES,
    example_docs,
    make_fnvar_template,
    make_template,
    make_xref_template,
)

CORPUS = pathlib.Path(__file__).resolve().parent.parent / "corpus" / "rules"
# every 10th rules file in sorted order: 25 of the 249
CORPUS_SAMPLE = [p.name for p in sorted(CORPUS.glob("*.guard"))[::10]]


def numpy_counts(statuses: np.ndarray, n_valid: int) -> np.ndarray:
    valid = statuses[:max(n_valid, 0)]
    return np.stack([(valid == k).sum(axis=0) for k in (0, 1, 2)]).astype(np.int32)


# ---------------------------------------------------------------------------
# K7's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [0, 1, 7, 100])
@pytest.mark.parametrize("r", [0, 1, 5, 64])
@pytest.mark.parametrize("valid", ["none", "half", "all"])
def test_rule_summary_plain_matches_numpy(d, r, valid):
    n_valid = {"none": 0, "half": d // 2, "all": d}[valid]
    rng = np.random.default_rng(100 * d + r)
    # mostly statuses, some values outside 0..2 that count nowhere
    statuses = rng.integers(-3, 6, size=(d, r)).astype(np.int8)
    got = K.rule_summary(torch.from_numpy(statuses), n_valid)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, r)
    np.testing.assert_array_equal(got.numpy(), numpy_counts(statuses, n_valid))


@settings(max_examples=60, deadline=None)
@given(
    statuses=hnp.arrays(np.int8, hnp.array_shapes(min_dims=2, max_dims=2,
                                                   min_side=0, max_side=40)),
    n_valid=st.integers(-5, 50),
)
def test_rule_summary_plain_matches_numpy_on_random_int8(statuses, n_valid):
    got = plain.rule_summary(torch.from_numpy(statuses), n_valid).numpy()
    np.testing.assert_array_equal(got, numpy_counts(statuses, min(n_valid, len(statuses))))


@pytest.mark.parametrize("d", [40, 47])
@pytest.mark.parametrize("r", [36, 37, 38, 39, 1028])
def test_rule_summary_plain_at_every_remainder_of_a_period(r, d):
    """R at every R % 4 and a width whose last column tile holds one
    word (1,028): the kernel reads whole periods of 16 / gcd(R, 16) rows
    and the rows that fill no period apart, so n_valid takes every
    remainder of a 16-row period (twice), and D."""
    rng = np.random.default_rng(7 * r + d)
    statuses = rng.integers(-3, 6, size=(d, r)).astype(np.int8)
    t = torch.from_numpy(statuses)
    for n_valid in [*range(33), d]:
        got = plain.rule_summary(t, n_valid)
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, r)
        np.testing.assert_array_equal(got.numpy(), numpy_counts(statuses, n_valid))


def test_rule_summary_on_cpu_launches_nothing():
    statuses = torch.tensor([[0, 1, 2], [2, 2, 7]], dtype=torch.int8)
    before = dict(K.LAUNCHES)
    got = K.rule_summary(statuses, 2)
    assert K.LAUNCHES == before
    assert got.tolist() == [[1, 0, 0], [0, 1, 0], [1, 1, 1]]


# ---------------------------------------------------------------------------
# with_summary against the JAX package
# ---------------------------------------------------------------------------


def _sse_docs():
    """The 37 documents of test_tpu_backend.test_sharded_evaluator_cpu_mesh."""
    return [
        {"Resources": {"b": {"Type": "AWS::S3::Bucket",
                             "Properties": {"Enc": "aws:kms" if i % 3 else "AES256"}}}}
        for i in range(37)
    ]


SSE_RULES = (
    "let buckets = Resources.*[ Type == 'AWS::S3::Bucket' ]\n"
    "rule sse when %buckets !empty {\n"
    "  %buckets.Properties.Enc == 'aws:kms'\n"
    "}\n"
)


def corpus_case(name: str):
    spec = CORPUS / "tests" / f"{pathlib.Path(name).stem}_tests.yaml"
    docs = []
    if spec.exists():
        docs = [c["input"] for c in (yaml.safe_load(spec.read_text()) or [])
                if isinstance(c, dict) and "input" in c]
    return (CORPUS / name).read_text(), docs


def workload_cases():
    rng = np.random.default_rng(41)
    yield "sse37", SSE_RULES, _sse_docs()
    yield "flagship64", graft._RULES, example_docs(64, two_buckets=True)
    yield "security500", RULES, [make_template(rng, i) for i in range(500)]
    yield "xref203", XREF_RULES, [make_xref_template(rng, i) for i in range(203)]
    yield "fnvar203", FNVAR_RULES, [make_fnvar_template(rng, i) for i in range(203)]


WORKLOADS = list(workload_cases())


def jax_summary(text, docs):
    """The JAX package: encode, precompute and re-encode function values
    as its backend's _lower_rules does, compile, with_summary on the
    8-device CPU mesh."""
    rules = j_parse(text, "r.guard")
    pvs = [j_from_plain(d) for d in docs]
    batch, interner = j_encode(pvs)
    if j_precomputable(rules):
        fn_vars, fn_vals, _err = j_precompute(rules, pvs)
        batch, _ = j_encode(pvs, interner, fn_values=fn_vals, fn_var_order=fn_vars)
    compiled = j_compile(rules, interner)
    if not compiled.rules:
        return None
    return ShardedBatchEvaluator(compiled, default_mesh()).with_summary(batch)


def port_evaluator(text, docs):
    """The port's own copy of the same steps; (evaluator, batch)."""
    rules = t_parse(text, "r.guard")
    pvs = [t_from_plain(d) for d in docs]
    batch, interner = t_encode(pvs)
    if t_precomputable(rules):
        fn_vars, fn_vals, _err = t_precompute(rules, pvs)
        batch, _ = t_encode(pvs, interner, fn_values=fn_vals, fn_var_order=fn_vars)
    compiled = t_compile(rules, interner)
    if not compiled.rules:
        return None, batch
    return DeviceBatchEvaluator(compiled, "cpu"), batch


def assert_summary_matches_jax(text, docs):
    want = jax_summary(text, docs)
    ev, batch = port_evaluator(text, docs)
    assert (want is None) == (ev is None), "the two packages lower different rules"
    if ev is None:
        return False
    statuses, counts = ev.with_summary(batch)
    assert statuses.dtype == np.int8 and counts.dtype == np.int32
    assert counts.shape == (3, statuses.shape[1])
    np.testing.assert_array_equal(statuses, want[0])
    np.testing.assert_array_equal(counts, want[1])
    np.testing.assert_array_equal(counts, numpy_counts(statuses, len(docs)))
    assert int(counts.sum()) == len(docs) * statuses.shape[1]
    return True


@pytest.mark.parametrize("name,text,docs", WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_with_summary_matches_jax(name, text, docs):
    assert assert_summary_matches_jax(text, docs)


def test_fnvar_workload_lowers_function_variables():
    ev, _batch = port_evaluator(FNVAR_RULES, WORKLOADS[-1][2])
    assert ev.compiled.fn_vars and ev.compiled.needs_fn_origin


@pytest.mark.parametrize("name", CORPUS_SAMPLE)
def test_with_summary_matches_jax_on_corpus(name):
    """A file whose every rule lands on the host would have nothing to
    count; none of the 25 does, so none is passed over."""
    text, docs = corpus_case(name)
    assert docs, f"{name} has no test inputs"
    assert assert_summary_matches_jax(text, docs), f"{name} lowered no device rule"


def test_corpus_sample_is_every_tenth_file():
    assert len(CORPUS_SAMPLE) == 25


@pytest.mark.parametrize("k", [-5, 0, 1, 17, 36, 37, 38, 50, 1000])
def test_with_summary_counts_the_first_n_valid_documents(k):
    ev, batch = port_evaluator(RULES, [make_template(np.random.default_rng(9), i)
                                       for i in range(37)])
    statuses, counts = ev.with_summary(batch)
    assert statuses.shape == (37, 4)
    np.testing.assert_array_equal(counts, numpy_counts(statuses, 37))
    part = K.rule_summary(torch.from_numpy(statuses), k).numpy()
    valid = min(max(k, 0), 37)
    np.testing.assert_array_equal(part, numpy_counts(statuses, valid))
    assert int(part.sum()) == valid * 4

"""The JAX package's state carries into the port unchanged.

The port keeps its own copies of the parser, encoder and lowering. For
the flagship rules, the 4-rule security policy and slice-grammar files
of corpus/rules, the port's `device_arrays` and `lit_values` must equal
the JAX package's key for key, in dtype and bytes; and the JAX arrays,
carried across by `arrays_from_numpy`, must give the port's walk the
same statuses as the port's own arrays.
"""

import pathlib

import numpy as np
import pytest
import yaml

import bench
import __graft_entry__ as graft
from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.core.values import from_plain as j_from_plain
from guard_tpu.ops.encoder import encode_batch as j_encode
from guard_tpu.ops.ir import compile_rules_file as j_compile
from guard_tpu_torch.core.parser import parse_rules_file as t_parse
from guard_tpu_torch.core.values import from_plain as t_from_plain
from guard_tpu_torch.ops.encoder import encode_batch as t_encode
from guard_tpu_torch.ops.ir import compile_rules_file as t_compile
from guard_tpu_torch.ops.kernels import arrays_from_numpy, build_doc_evaluator
from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
from guard_tpu_torch.workloads import example_docs, make_template

CORPUS = pathlib.Path(__file__).resolve().parent.parent / "corpus" / "rules"
CORPUS_FILES = [
    "filter_type_041.guard", "filter_type_v2_167.guard",
    "conjunction_057.guard", "conjunction_v3_240.guard",
    "disjunction_056.guard", "disjunction_v1_116.guard",
    "block_form_050.guard", "block_form_v2_175.guard",
    # query-RHS compares and `.%var` key interpolation
    "query_vs_query_053.guard", "var_query_rhs_047.guard",
    "var_query_rhs_v2_172.guard", "var_interpolation_048.guard",
    "var_interpolation_v2_173.guard",
]


def corpus_case(name: str):
    spec = CORPUS / "tests" / f"{pathlib.Path(name).stem}_tests.yaml"
    docs = [
        c["input"] for c in (yaml.safe_load(spec.read_text()) or [])
        if isinstance(c, dict) and "input" in c
    ]
    return (CORPUS / name).read_text(), docs


def cases():
    rng = np.random.default_rng(3)
    yield "flagship", graft._RULES, example_docs(12, two_buckets=True)
    yield "security", bench.RULES, [make_template(rng, i) for i in range(40)]
    for name in CORPUS_FILES:
        text, docs = corpus_case(name)
        yield name, text, docs


CASES = list(cases())


def _both(text, docs):
    jb, ji = j_encode([j_from_plain(d) for d in docs])
    tb, ti = t_encode([t_from_plain(d) for d in docs])
    jc = j_compile(j_parse(text, "r.guard"), ji)
    tc = t_compile(t_parse(text, "r.guard"), ti)
    return (jc, jb), (tc, tb)


@pytest.mark.parametrize("name,text,docs", CASES, ids=[c[0] for c in CASES])
def test_device_arrays_and_lits_bit_identical(name, text, docs):
    (jc, jb), (tc, tb) = _both(text, docs)
    assert tc.rules and not tc.host_rules
    ja, ta = jc.device_arrays(jb), tc.device_arrays(tb)
    assert list(ja) == list(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        assert ja[k].shape == ta[k].shape, k
        assert ja[k].tobytes() == ta[k].tobytes(), k
    jl, tl = jc.lit_values(), tc.lit_values()
    assert jl.dtype == tl.dtype and jl.tobytes() == tl.tobytes()


@pytest.mark.parametrize("name,text,docs", CASES, ids=[c[0] for c in CASES])
def test_jax_arrays_drive_the_port_walk(name, text, docs):
    (jc, jb), (tc, tb) = _both(text, docs)
    arrays, lits = arrays_from_numpy(jc.device_arrays(jb), jc.lit_values(), "cpu")
    st, _un = build_doc_evaluator(tc)(arrays, lits)
    own = DeviceBatchEvaluator(tc, "cpu")(tb)
    np.testing.assert_array_equal(st.numpy(), own)


def test_workloads_are_copies_of_the_jax_fixtures():
    from guard_tpu_torch import workloads

    assert workloads.RULES == bench.RULES
    assert workloads.FLAGSHIP_RULES == graft._RULES
    assert workloads.HOST_ORACLE_RULES == graft._DRYRUN_RULES
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    assert [bench.make_template(r1, i) for i in range(30)] == [
        make_template(r2, i) for i in range(30)
    ]
    assert [pv.to_plain() for pv in graft._example_docs(9, two_buckets=True)] == (
        example_docs(9, two_buckets=True)
    )


def _fn_carry_cases():
    from test_torch_fnvars import CASES as FN_CASES

    keep = ("canonical_names", "fnvar_workload", "per_origin_nested_blocks",
            "per_origin_in_membership", "cross_scope_var_ops_and_shadowing",
            "json_parse_subtree_walk", "per_origin_slash_key_path_collision_routes_to_oracle")
    return [c for c in FN_CASES if c[0] in keep]


FN_CARRY = _fn_carry_cases()


def _fn_both(text, docs):
    from guard_tpu.ops.fnvars import precompute_fn_values as j_pre
    from guard_tpu_torch.ops.fnvars import precompute_fn_values as t_pre

    jrf, trf = j_parse(text, "fn.guard"), t_parse(text, "fn.guard")
    jd, td = [j_from_plain(d) for d in docs], [t_from_plain(d) for d in docs]
    jk, jv, je = j_pre(jrf, jd)
    tk, tv, te = t_pre(trf, td)
    jb, ji = j_encode(jd, fn_values=jv, fn_var_order=jk)
    tb, ti = t_encode(td, fn_values=tv, fn_var_order=tk)
    return (j_compile(jrf, ji), jb, ji), (t_compile(trf, ti), tb, ti), (jd, tv, tk)


@pytest.mark.parametrize("name,text,docs", FN_CARRY, ids=[c[0] for c in FN_CARRY])
def test_fn_result_roots_and_origin_carry_bit_identical(name, text, docs):
    """With the same function values, the port's columns carry the
    function-result roots (fn_key_id rows of node_key_id) and the
    fn_origin column exactly as the JAX package's."""
    (jc, jb, _ji), (tc, tb, _ti), _ = _fn_both(text, docs)
    assert tc.needs_fn_origin == jc.needs_fn_origin
    ja, ta = jc.device_arrays(jb), tc.device_arrays(tb)
    assert list(ja) == list(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].tobytes() == ta[k].tobytes(), k
    assert (ta["node_key_id"] < -2).any(), "no function-result root was tagged"
    if tc.needs_fn_origin:
        assert (ta["fn_origin"] >= 0).any()
    np.testing.assert_array_equal(tb.num_exotic, jb.num_exotic)


@pytest.mark.parametrize("name,text,docs", FN_CARRY, ids=[c[0] for c in FN_CARRY])
def test_fn_buckets_carry_the_jax_rows(name, text, docs):
    """The port's per-bucket encode with function values gives each
    document the JAX batch's row, padded only to its own bucket, and
    leaves the same documents to the oracle."""
    from guard_tpu_torch.ops.encoder import encode_bucketed

    (jc, jb, _ji), _t, (_jd, tv, tk) = _fn_both(text, docs)
    groups, host, ti = encode_bucketed([t_from_plain(d) for d in docs],
                                       fn_values=tv, fn_var_order=tk)
    tc = t_compile(t_parse(text, "fn.guard"), ti)
    ja = jc.device_arrays(jb)
    assert sorted(host.tolist()) == np.where(jb.num_exotic)[0].tolist()
    covered = set(host.tolist())
    for batch, idx in groups:
        covered.update(idx.tolist())
        ta = tc.device_arrays(batch)
        assert list(ta) == list(ja)
        w = min(batch.n_nodes, jb.n_nodes)
        for k in ja:
            mine, theirs = ta[k][:, :w], ja[k][idx, :w]
            if k == "struct_id":
                # canonical-class labels are numbered per batch: the same
                # partition of the nodes, up to a relabelling
                pairs = set(zip(mine.ravel().tolist(), theirs.ravel().tolist()))
                assert len({a for a, _ in pairs}) == len({b for _, b in pairs}) == len(pairs)
                continue
            np.testing.assert_array_equal(mine, theirs, err_msg=k)
    assert covered == set(range(len(docs)))

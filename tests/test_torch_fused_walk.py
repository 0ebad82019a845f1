"""The walk as a tape (guard_tpu_torch/ops/tape.py) against the eager walk.

On the CPU the tape runs through the tape kernel's plain version
(`kernels.walk_segment`), instruction by instruction: recorder,
scheduler, workspace and encoding are the card's, only the last step
differs. Statuses and unsure bits must equal the eager walk's bit for
bit, bucket by bucket, over the carried-state cases of
tests/test_torch_carry.py, every corpus rule file over the inputs of
its test suite, and security-policy chunks of 1,023 small templates and
one of 100, 300 or 500 resources. A program whose walk uses an op the
tape does not cover (`.%var[k]`'s running count) takes the eager walk,
and the dispatch counters say which path each walk took; any other
error of a recording propagates and is not kept. A batch whose
workspace would pass the limit replays in slices of rows. A program is
recorded once: the tape it gives any node width equals one recorded at
that width, and the eager walk there.
"""

import pathlib

import numpy as np
import pytest
import torch
import yaml

from guard_tpu_torch.core.parser import parse_rules_file
from guard_tpu_torch.core.values import from_plain
from guard_tpu_torch.ops import kernels as walk
from guard_tpu_torch.ops import tape
from guard_tpu_torch.ops.encoder import NODE_BUCKETS_EXTENDED, encode_batch, split_batch_by_size
from guard_tpu_torch.ops.fnvars import precompute_fn_values
from guard_tpu_torch.ops.ir import compile_rules_file
from guard_tpu_torch.workloads import (
    FLAGSHIP_RULES, FNVAR_RULES, RULES, XREF_RULES, example_docs, make_fnvar_template,
    make_template, make_xref_template,
)
from portbench.harness.record import Run
from portbench.metrics import fused_walk_pct
from portbench.traffic import secpol

CORPUS = pathlib.Path(__file__).resolve().parent.parent / "corpus" / "rules"
# tests/test_torch_carry.py's corpus files
CARRY_FILES = [
    "filter_type_041.guard", "filter_type_v2_167.guard",
    "conjunction_057.guard", "conjunction_v3_240.guard",
    "disjunction_056.guard", "disjunction_v1_116.guard",
    "block_form_050.guard", "block_form_v2_175.guard",
    "query_vs_query_053.guard", "var_query_rhs_047.guard",
    "var_query_rhs_v2_172.guard", "var_interpolation_048.guard",
    "var_interpolation_v2_173.guard",
]
INTERP_FIRST = """
let names = Selection.targets
rule interp_first { Resources.%names[0].Type == 'Bucket' }
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors, many ops: one intra-op thread a worker keeps the
    parallel test workers from starving each other's thread pools."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def corpus_docs(name: str):
    spec = CORPUS / "tests" / f"{pathlib.Path(name).stem}_tests.yaml"
    if not spec.exists():
        return []
    return [c["input"] for c in (yaml.safe_load(spec.read_text()) or [])
            if isinstance(c, dict) and "input" in c]


CORPUS_FILES = sorted(p.name for p in CORPUS.glob("*.guard") if corpus_docs(p.name))


def buckets(text: str, docs, fn: bool = False, sizes=NODE_BUCKETS_EXTENDED):
    """(compiled, [(arrays, lits) per node bucket of `sizes`]) on the CPU."""
    rf = parse_rules_file(text, "r.guard")
    values = [from_plain(d) for d in docs]
    kwargs = {}
    if fn:
        order, fn_values, _errors = precompute_fn_values(rf, values)
        kwargs = {"fn_values": fn_values, "fn_var_order": order}
    batch, interner = encode_batch(values, **kwargs)
    compiled = compile_rules_file(rf, interner)
    groups, _oversize = split_batch_by_size(batch, sizes)
    return compiled, [
        walk.arrays_from_numpy(compiled.device_arrays(sub), compiled.lit_values(), "cpu")
        for sub, _idx in groups
    ]


def assert_tape_equals_eager(text: str, docs, fn: bool = False) -> list:
    compiled, parts = buckets(text, docs, fn=fn)
    assert compiled.rules
    eager = walk.build_doc_evaluator(compiled)
    tapes = []
    for arrays, lits in parts:
        got = tape.tape_for(compiled, arrays, lits)
        assert got is not None, tape.tapes_of(compiled)
        want = eager(arrays, lits)
        st, un = tape.replay(got, arrays, lits)
        assert st.dtype == want[0].dtype and un.dtype == want[1].dtype
        assert torch.equal(st, want[0]) and torch.equal(un, want[1])
        tapes.append(got)
    return tapes


def carry_cases():
    rng = np.random.default_rng(3)
    yield "flagship", FLAGSHIP_RULES, example_docs(12, two_buckets=True)
    yield "security", RULES, [make_template(rng, i) for i in range(40)]
    for name in CARRY_FILES:
        yield name, (CORPUS / name).read_text(), corpus_docs(name)


CARRY = list(carry_cases())


@pytest.mark.parametrize("name,text,docs", CARRY, ids=[c[0] for c in CARRY])
def test_tape_equals_eager_on_the_carried_cases(name, text, docs):
    assert_tape_equals_eager(text, docs)


@pytest.mark.parametrize("name", CORPUS_FILES)
def test_tape_equals_eager_on_each_corpus_file(name):
    assert_tape_equals_eager((CORPUS / name).read_text(), corpus_docs(name))


def secpol_chunk(size: int, seed: int):
    rng = np.random.default_rng(seed)
    return ([secpol.make_template(rng, i) for i in range(1023)]
            + [secpol.large_template(rng, 1023, size)])


@pytest.mark.parametrize("size", [100, 300, 500])
def test_tape_equals_eager_on_secpol_chunks(size):
    tapes = assert_tape_equals_eager(RULES, secpol_chunk(size, size))
    assert len(tapes) == 2
    for got in tapes:
        # K1 and K2 as the eager walk calls them, the rest in a few levels
        assert got.kernel_calls("gather_rows") == 42
        assert got.kernel_calls("segment_sum_rows") == 49
        assert got.launches <= 12


def test_function_variable_arms_count_as_in_the_eager_walk():
    rng = np.random.default_rng(5)
    docs = [make_fnvar_template(rng, i) for i in range(24)]
    compiled, parts = buckets(FNVAR_RULES, docs, fn=True)
    eager = walk.build_doc_evaluator(compiled)
    for arrays, lits in parts:
        got = tape.tape_for(compiled, arrays, lits)
        assert got is not None
        before = dict(walk.FNVAR_STEPS)
        want = eager(arrays, lits)
        eager_steps = {k: walk.FNVAR_STEPS[k] - before[k] for k in before}
        before = dict(walk.FNVAR_STEPS)
        st, un = tape.replay(got, arrays, lits)
        assert {k: walk.FNVAR_STEPS[k] - before[k] for k in before} == eager_steps
        assert torch.equal(st, want[0]) and torch.equal(un, want[1])
    assert_tape_equals_eager(FNVAR_RULES, docs, fn=True)


@pytest.fixture
def tape_on_cpu(monkeypatch):
    """The fused evaluator replays the tape on the CPU too (the plain
    tape kernel), so its choice of path shows here."""
    monkeypatch.setattr(tape, "TAPE_DEVICES", ("cpu",))


def test_an_uncovered_op_takes_the_eager_walk_and_the_counters_say_so(tape_on_cpu):
    docs = [{"Resources": {"a": {"Type": "Bucket"}, "b": {"Type": "Volume"}},
             "Selection": {"targets": [["a"], "b"][i % 2]}} for i in range(6)]
    compiled, parts = buckets(INTERP_FIRST, docs)
    counters = {"walks_fused": 0, "walks_eager": 0}
    fn = tape.build_fused_evaluator(compiled, counters)
    eager = walk.build_doc_evaluator(compiled)
    for arrays, lits in parts:
        st, un = fn(arrays, lits)
        want = eager(arrays, lits)
        assert torch.equal(st, want[0]) and torch.equal(un, want[1])
    assert counters == {"walks_fused": 0, "walks_eager": len(parts)}
    assert all("cumsum" in why for why in tape.tapes_of(compiled).values())


def test_a_recorder_error_raises_and_is_not_kept(tape_on_cpu, monkeypatch):
    """Only the recorder's own Unsupported sends a walk to the eager
    path: a fault of the recorder raises, counts no walk, and the next
    walk records again."""
    compiled, parts = buckets(RULES, [make_template(np.random.default_rng(7), i)
                                      for i in range(6)])
    counters = {"walks_fused": 0, "walks_eager": 0}
    fn = tape.build_fused_evaluator(compiled, counters)
    note = tape.Recorder.note

    def broken(self, func, args, kwargs, out):
        if func == torch.ops.aten.where.self:
            raise RuntimeError("a fault of the recorder")
        return note(self, func, args, kwargs, out)

    monkeypatch.setattr(tape.Recorder, "note", broken)
    arrays, lits = parts[0]
    with pytest.raises(RuntimeError, match="a fault of the recorder"):
        fn(arrays, lits)
    assert counters == {"walks_fused": 0, "walks_eager": 0}
    assert tape.tapes_of(compiled) == {}
    monkeypatch.setattr(tape.Recorder, "note", note)
    st, un = fn(arrays, lits)
    want = walk.build_doc_evaluator(compiled)(arrays, lits)
    assert torch.equal(st, want[0]) and torch.equal(un, want[1])
    assert counters == {"walks_fused": 1, "walks_eager": 0}


@pytest.mark.parametrize("rows", [None, -1, 5, 1])
def test_a_workspace_beyond_the_limit_replays_in_slices_of_rows(tape_on_cpu, monkeypatch, rows):
    """The limit at the batch's workspace (None), one byte below it (-1),
    and at 5 rows and 1 row of workspace: the tape runs in slices of
    rows and equals the eager walk."""
    compiled, parts = buckets(RULES, [make_template(np.random.default_rng(6), i)
                                      for i in range(12)])
    counters = {"walks_fused": 0, "walks_eager": 0}
    fn = tape.build_fused_evaluator(compiled, counters)
    arrays, lits = parts[0]
    got = tape.tape_for(compiled, arrays, lits)
    d = arrays["node_kind"].shape[0]
    limit = {None: got.ws_row * d, -1: got.ws_row * d - 1}.get(rows, got.ws_row * (rows or 0))
    monkeypatch.setattr(tape, "MAX_WORKSPACE", limit)
    slices = []
    replay_on = tape.Replay.__init__

    def noted(self, tp, arrays, lits, outs=None):
        slices.append(arrays["node_kind"].shape[0])
        replay_on(self, tp, arrays, lits, outs)

    monkeypatch.setattr(tape.Replay, "__init__", noted)
    st, un = fn(arrays, lits)
    want = walk.build_doc_evaluator(compiled)(arrays, lits)
    assert torch.equal(st, want[0]) and torch.equal(un, want[1])
    assert counters == {"walks_fused": 1, "walks_eager": 0}
    per = max(1, limit // got.ws_row)
    assert slices == [min(per, d - lo) for lo in range(0, d, per)] and sum(slices) == d


def test_the_tape_is_kept_per_width_and_the_counters_count_each_walk(tape_on_cpu, monkeypatch):
    """One recording of the program (at tape.WIDTHS[0]) serves every
    chunk: chunks of one width reuse its tape, another width gets a tape
    of its own without recording again."""
    recorded = []
    trace = tape._trace
    monkeypatch.setattr(tape, "_trace", lambda *a: recorded.append(a[-1]) or trace(*a))
    rng = np.random.default_rng(9)
    rf = parse_rules_file(RULES, "r.guard")
    first = [make_template(rng, i) for i in range(16)]
    batch, interner = encode_batch([from_plain(d) for d in first])
    compiled = compile_rules_file(rf, interner)
    counters = {"walks_fused": 0, "walks_eager": 0}
    fn = tape.build_fused_evaluator(compiled, counters)
    eager = walk.build_doc_evaluator(compiled)

    def run(docs):
        b, _ = encode_batch([from_plain(d) for d in docs], interner)
        arrays, lits = walk.arrays_from_numpy(compiled.device_arrays(b), compiled.lit_values(), "cpu")
        got, want = fn(arrays, lits), eager(arrays, lits)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        return arrays["node_kind"].shape

    shape_a = run(first)
    programs = tape.tapes_of(compiled)
    assert len(programs) == 1 and recorded == [tape.WIDTHS[0]]
    program = next(iter(programs.values()))
    tape_a = program.tapes[shape_a[1]]
    # another chunk of the same width, other documents and rows
    shape_b = run([make_template(rng, 100 + i) for i in range(9)])
    assert shape_b[1] == shape_a[1] and shape_b[0] != shape_a[0]
    assert program.tapes == {shape_a[1]: tape_a}
    # a wider bucket gets a tape of its own from the same recording
    shape_c = run([secpol.large_template(rng, 0, 100)])
    assert shape_c[1] != shape_a[1] and set(program.tapes) == {shape_a[1], shape_c[1]}
    assert program.tapes[shape_c[1]] is not tape_a
    assert recorded == [tape.WIDTHS[0]] and tape.tapes_of(compiled) is programs
    assert counters == {"walks_fused": 3, "walks_eager": 0}
    # off TAPE_DEVICES the eager walk runs, and counts
    monkeypatch.setattr(tape, "TAPE_DEVICES", ("cuda",))
    b, _ = encode_batch([from_plain(d) for d in first], interner)
    fn(*walk.arrays_from_numpy(compiled.device_arrays(b), compiled.lit_values(), "cpu"))
    assert counters == {"walks_fused": 3, "walks_eager": 1}


def many_rules(n: int) -> str:
    """The security rules `n / 4` times over, each copy renamed: a
    program of n rules, whose outputs' columns run past any width."""
    blocks = RULES.split("rule ")
    head, bodies = blocks[0], blocks[1:]
    out = [head]
    for k in range(n // len(bodies)):
        out += [f"rule r{k}_" + b for b in bodies]
    return "".join(out)


WIDTH_CASES = [
    ("security", RULES, False), ("many_rules", many_rules(80), False),
    ("xref", XREF_RULES, False), ("fnvar", FNVAR_RULES, True),
    ("query_vs_query", (CORPUS / "query_vs_query_053.guard").read_text(), False),
    ("var_query_rhs", (CORPUS / "var_query_rhs_v2_172.guard").read_text(), False),
]


@pytest.mark.parametrize("name,text,fn", WIDTH_CASES, ids=[c[0] for c in WIDTH_CASES])
def test_a_tape_derived_for_a_width_equals_the_eager_walk_there(name, text, fn):
    """At node widths that are and are not multiples of 16 (a sweep's
    large bucket is its node count rounded up to 8), a batch walked in
    one bucket of that width, where one more document of that many
    nodes sets the width, gives the eager walk's statuses and unsure
    bits through the tape derived from the program's one recording."""
    rng = np.random.default_rng(4)
    docs = ([make_fnvar_template(rng, i) for i in range(8)] if fn
            else [make_xref_template(rng, i) for i in range(8)])
    for width in (64, 72, 80, 200, 1024, 2904):
        filler = {"pad": list(range(width - 2))}  # the root, the list, its items
        compiled, parts = buckets(text, docs + [filler], fn=fn, sizes=(width,))
        (arrays, lits), = parts
        assert arrays["node_kind"].shape[1] == width
        got = tape.tape_for(compiled, arrays, lits)
        assert got is not None, (width, tape.tapes_of(compiled))
        st, un = tape.replay(got, arrays, lits)
        want = walk.build_doc_evaluator(compiled)(arrays, lits)
        assert torch.equal(st, want[0]) and torch.equal(un, want[1]), width


@pytest.mark.parametrize("name,text,fn", WIDTH_CASES, ids=[c[0] for c in WIDTH_CASES])
def test_a_tape_derived_for_a_width_equals_one_recorded_there(name, text, fn):
    """The program is recorded at one node width and every other width's
    tape derived from it: at each bucket width that is a multiple of 16
    it equals the tape recorded at that width, word for word and step for
    step. (Elsewhere a recording rounds a row of bytes up to 16 where the
    derived row is 8 bytes shorter: the two tapes differ in their
    workspace offsets, and the test above holds the derived one against
    the eager walk.)"""
    rng = np.random.default_rng(4)
    docs = ([make_fnvar_template(rng, i) for i in range(8)] if fn
            else [make_xref_template(rng, i) for i in range(8)])
    compiled, parts = buckets(text, docs, fn=fn)
    arrays, lits = parts[0]
    columns = {k: v.dtype for k, v in arrays.items()}
    program = tape.Program(compiled, columns, lits.shape[0])
    for width in (64, 80, 128, 256, 1024, 4096):
        derived = program.tape(width)
        recorded = tape.compile_tape(*tape._trace(compiled, columns, lits.shape[0], width))
        assert np.array_equal(derived.prog, recorded.prog), width
        assert tuple(derived.steps) == tuple(recorded.steps), width
        assert (derived.ws_row, derived.zero_row, derived.outs) == (
            recorded.ws_row, recorded.zero_row, recorded.outs), width


def test_the_tape_dies_with_its_program():
    compiled, parts = buckets(RULES, [make_template(np.random.default_rng(2), i) for i in range(4)])
    assert tape.tape_for(compiled, *parts[0]) is not None
    key = id(compiled)
    assert key in tape._TAPES
    del compiled
    import gc

    gc.collect()
    assert key not in tape._TAPES


def test_fused_walk_pct_reads_the_dispatch_counters():
    run = Run(docs=1024, window_s=1.0,
              counters={"dispatch": {"dispatches": 8, "walks_fused": 6, "walks_eager": 2}})
    assert fused_walk_pct.read(run) == pytest.approx(75.0)
    assert fused_walk_pct.read(Run(docs=1024, window_s=1.0)) is None
    # a program without the counters (the parent) reads nothing
    assert fused_walk_pct.read(Run(docs=1024, window_s=1.0,
                                   counters={"dispatch": {"dispatches": 8}})) is None

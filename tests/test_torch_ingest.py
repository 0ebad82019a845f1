"""Host ingest of the port against the JAX package and its own tree
encoder.

* The port's native encoder (ops/native_encoder.py over
  csrc/host/encoder.cpp) returns the bucket groups and the oversize set
  `encoder.encode_bucketed` builds from document trees, column for
  column once intern ids are relabelled through their strings, without
  ever building a (documents x largest document) block.
* The ingest pool (parallel/ingest.py) with 2 and 3 workers gives the
  serial encode's groups; a pool that cannot spawn falls back serially;
  a worker holds no torch, JAX or guard_tpu module.
* `python -m guard_tpu_torch validate --backend tpu --device cpu` prints
  the same stdout and stderr and exits with the same code as `python -m
  guard_tpu.cli validate --backend tpu` over the ingest worker counts,
  both states of the two packages' native encoders, a YAML document in
  the set, the --max-doc-failures settings over a set with an invalid
  document, and GUARD_TPU_FAULT's parse and read points.
* Document trees are built only where something walks them.

Both packages' native libraries are compiled once per source into a
temporary directory (never under native/), and each test points both
packages at one state through their library directories and the
environment (GUARD_TPU_NATIVE_DIR, GUARD_TPU_TORCH_NATIVE_DIR,
GUARD_TPU_INGEST_WORKERS), with the native oracle off on both sides.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import pytest

import bench
import __graft_entry__ as graft
from guard_tpu import cli as jax_cli
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.commands import validate as port_validate
from guard_tpu_torch.core.loader import load_document
from guard_tpu_torch.ops import encoder as enc
from guard_tpu_torch.ops import native_encoder
from guard_tpu_torch.parallel import ingest
from guard_tpu_torch.utils.io import Reader, Writer
from guard_tpu_torch.workloads import (
    example_docs,
    make_fnvar_template,
    make_template,
    make_xref_template,
    volume_template,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent

JAX_ENCODER = "libguard_encoder.so"


# -- native libraries, built once per source --------------------------
def built_library(so_name: str, source: pathlib.Path) -> pathlib.Path:
    """`source` compiled with the port's g++ build into a temporary
    directory keyed by the source's hash (never under native/)."""
    from guard_tpu_torch.ops import _native_lib

    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    d = pathlib.Path(tempfile.gettempdir()) / "guard_tpu_torch_test_native" / digest
    saved = _native_lib.NATIVE_DIR
    _native_lib.NATIVE_DIR = d
    try:
        return _native_lib.build(so_name, source)
    finally:
        _native_lib.NATIVE_DIR = saved


@pytest.fixture(scope="session")
def encoder_dirs(tmp_path_factory):
    """{"jax": dir, "port": dir} holding each package's native encoder
    alone (its native oracle absent)."""
    out = {}
    for pkg, so, src in (
        ("jax", JAX_ENCODER, ROOT / "native" / "encoder.cpp"),
        ("port", native_encoder._SO_NAME, native_encoder.SOURCE),
    ):
        d = tmp_path_factory.mktemp(f"{pkg}_encoder")
        (d / so).symlink_to(built_library(so, src))
        out[pkg] = d
    return out


def set_encoders(monkeypatch, dirs, tmp_path) -> None:
    """Both packages' native encoders built (`dirs` from encoder_dirs)
    or not (None); both native oracles off. Spawned workers see the
    same state through the environment."""
    from guard_tpu.ops import _native_lib as jax_lib
    from guard_tpu.ops import native_encoder as jax_encoder
    from guard_tpu.ops import native_oracle as jax_oracle
    from guard_tpu_torch.ops import _native_lib as port_lib
    from guard_tpu_torch.ops import native_oracle as port_oracle

    empty = tmp_path / "no_native"
    empty.mkdir(exist_ok=True)
    jax_dir = dirs["jax"] if dirs else empty
    port_dir = dirs["port"] if dirs else empty
    monkeypatch.setenv("GUARD_TPU_NATIVE_DIR", str(jax_dir))
    monkeypatch.setenv("GUARD_TPU_TORCH_NATIVE_DIR", str(port_dir))
    monkeypatch.setattr(jax_lib, "NATIVE_DIR", pathlib.Path(jax_dir))
    monkeypatch.setattr(jax_lib, "_libs", {})
    monkeypatch.setattr(port_lib, "NATIVE_DIR", pathlib.Path(port_dir))
    monkeypatch.setattr(port_lib, "_libs", {})
    for mod in (jax_encoder, jax_oracle, native_encoder, port_oracle):
        monkeypatch.setattr(mod, "_configured", None)
    assert native_encoder.native_available() == bool(dirs)
    assert jax_encoder.native_available() == bool(dirs)
    assert not port_oracle.native_available() and not jax_oracle.native_available()


@pytest.fixture(params=["encoder_built", "encoder_absent"])
def encoder_state(request, monkeypatch, tmp_path):
    dirs = request.getfixturevalue("encoder_dirs") if request.param == "encoder_built" else None
    set_encoders(monkeypatch, dirs, tmp_path)
    return request.param


@pytest.fixture
def fresh_pools():
    """Ingest pools spawned by this test only (they see its
    environment), closed after it."""
    from guard_tpu.parallel import ingest as jax_ingest

    ingest.close_shared_pools()
    jax_ingest.close_shared_pools()
    yield
    ingest.close_shared_pools()
    jax_ingest.close_shared_pools()


@pytest.fixture(autouse=True)
def _jax_computed(monkeypatch):
    """The JAX package with its result cache off (output computed, not
    replayed) and no fault injection unless a test sets one."""
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.delenv("GUARD_TPU_FAULT", raising=False)


# -- bucket groups, native against trees ------------------------------
def _deep(depth: int):
    return {"k": _deep(depth - 1)} if depth else "leaf"


def _corpora():
    rng = np.random.default_rng(7)
    fn_exotic = rng.random(24) < 0.25
    return {
        "templates": [make_template(rng, i) for i in range(40)] + [volume_template(300)],
        "xref": [make_xref_template(rng, i) for i in range(30)],
        "fnvar_exotic": [make_fnvar_template(rng, i, exotic=bool(fn_exotic[i]))
                         for i in range(24)],
        "flagship": example_docs(16, two_buckets=True),
        # 40,000 nodes: the 65,536-node bucket, beside small documents
        "doc_40000_nodes": [{"a": 1}, {"L": list(range(39_998))}, {"b": [1, 2]}],
        # beyond the last bucket: oversize
        "doc_70000_nodes": [{"L": list(range(70_000))}, {"x": "y"}],
        "exotic_numbers": [
            {"big": 2**70}, {"neg": -(2**64)}, {"f": 1.5e300, "g": -0.0, "h": 1e-320},
            {"i": 9223372036854775807, "j": -9223372036854775808}, {"e": 1e5, "E": 2E-3},
        ],
        "escapes_and_empties": [
            {"s": 'quote " and \\ slash\nnewline\ttab', "u": "\u00e9\u0041\u4e2d"},
            {}, [], {"a": []}, {"a": {}}, [[[]]], None, True, 3, "str",
            {"dup": [{"k": None}, {"k": False}]}, _deep(40),
        ],
    }


CORPORA = _corpora()


def _relabelled(batch, interner, to: enc.Interner) -> dict:
    """The batch's columns with intern ids relabelled into `to`'s."""
    remap = np.array([to.lookup(s) for s in interner.strings] + [-3], dtype=np.int32)
    cols = dict(batch.arrays())
    for k in ("scalar_id", "edge_key_id", "node_key_id"):
        col = cols[k]
        cols[k] = np.where(col >= 0, remap[np.clip(col, 0, None)], col)
    return cols


def assert_same_groups(got, want) -> None:
    """Two (groups, oversize, interner) triples hold the same batches,
    column for column up to intern-id labels."""
    g_groups, g_over, g_int = got
    w_groups, w_over, w_int = want
    assert list(map(int, g_over)) == list(map(int, w_over))
    assert [(b.n_docs, b.n_nodes, b.n_edges) for b, _ in g_groups] == \
        [(b.n_docs, b.n_nodes, b.n_edges) for b, _ in w_groups]
    assert sorted(g_int.strings) == sorted(w_int.strings)
    for (gb, gi), (wb, wi) in zip(g_groups, w_groups):
        assert np.array_equal(gi, wi)
        g_cols = _relabelled(gb, g_int, w_int)
        for k, w_col in wb.arrays().items():
            assert g_cols[k].dtype == w_col.dtype, k
            assert np.array_equal(g_cols[k], w_col), k
        assert np.array_equal(gb.num_exotic, wb.num_exotic)


def tree_groups(texts):
    return enc.encode_bucketed([load_document(t) for t in texts])


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_native_groups_equal_tree_groups(encoder_dirs, monkeypatch, tmp_path, corpus):
    set_encoders(monkeypatch, encoder_dirs, tmp_path)
    texts = [json.dumps(d) for d in CORPORA[corpus]]
    groups, oversize, interner, err = native_encoder.encode_json_bucketed(texts)
    assert err is None
    assert_same_groups((groups, oversize, interner), tree_groups(texts))


def test_ragged_columns_hold_no_padding(encoder_dirs, monkeypatch, tmp_path):
    """The library returns exactly each document's nodes and edges, and
    each bucket is cut at its own width: a 40,000-node document never
    widens the small documents' batch."""
    set_encoders(monkeypatch, encoder_dirs, tmp_path)
    docs = CORPORA["doc_40000_nodes"]
    texts = [json.dumps(d) for d in docs]
    cols, node_off, edge_off, exotic, _interner, err = native_encoder.encode_json_ragged(texts)
    sizes = [enc.encode_document(load_document(t), enc.Interner()).n_nodes for t in texts]
    assert err is None and not exotic.any()
    assert list(np.diff(node_off)) == sizes
    assert list(np.diff(edge_off)) == [n - 1 for n in sizes]
    assert all(len(c) in (sum(sizes), sum(sizes) - len(sizes)) for c in cols.values())
    groups, _over, _i, _e = native_encoder.encode_json_bucketed(texts)
    assert [(b.n_docs, b.n_nodes) for b, _ in groups] == [(2, 64), (1, 65536)]


def test_invalid_document_is_isolated(encoder_dirs, monkeypatch, tmp_path):
    """encode_json_bucketed_resilient marks an invalid document, encodes
    a `null` in its place and the rest as they are; the first invalid
    document is what encode_json_ragged reports."""
    set_encoders(monkeypatch, encoder_dirs, tmp_path)
    texts = [json.dumps(d) for d in CORPORA["templates"][:6]]
    texts[2] = '{"Resources": {'
    texts[4] = "[1, 2,"
    names = [f"d{i}.json" for i in range(len(texts))]
    assert native_encoder.encode_json_ragged(texts)[-1] == 2
    got, failed, msgs = native_encoder.encode_json_bucketed_resilient(texts, names)
    assert failed == {2, 4}
    assert msgs == ["skipping d2.json: invalid JSON", "skipping d4.json: invalid JSON"]
    fixed = ["null" if i in failed else t for i, t in enumerate(texts)]
    assert_same_groups(got, tree_groups(fixed))


def test_merge_of_shards_equals_one_encode():
    """merge_bucket_groups over contiguous shards, each encoded with its
    own interner and remapped, gives the groups of one encode, at
    every split of a corpus that crosses buckets."""
    docs = CORPORA["templates"][:12] + CORPORA["doc_40000_nodes"] + CORPORA["exotic_numbers"]
    texts = [json.dumps(d) for d in docs]
    want = tree_groups(texts)
    for cuts in ((5,), (12, 14), (1, 2, 3, 17), tuple(range(1, len(texts)))):
        bounds = (0, *cuts, len(texts))
        merged = enc.Interner()
        shards = []
        for lo, hi in zip(bounds, bounds[1:]):
            groups, oversize, interner = tree_groups(texts[lo:hi])
            remap = np.array([merged.intern(s) for s in interner.strings], dtype=np.int32)
            for batch, _idx in groups:
                enc.remap_interned_ids(batch, remap)
            shards.append((groups, oversize, lo))
        groups, oversize = enc.merge_bucket_groups(shards)
        assert_same_groups((groups, oversize, merged), want)


def test_batch_payload_round_trip():
    groups, _o, _i = tree_groups([json.dumps(d) for d in CORPORA["xref"][:5]])
    batch = groups[0][0]
    back = enc.batch_from_payload(enc.batch_payload(batch))
    for k, col in batch.arrays().items():
        assert np.array_equal(back.arrays()[k], col)


# -- the ingest pool ---------------------------------------------------
@pytest.mark.parametrize("workers", [2, 3])
def test_parallel_ingest_equals_serial(encoder_state, fresh_pools, workers):
    """Shards encoded in spawned workers (native encoder or trees, as
    each worker finds the library) merge into the serial encode's
    groups; a YAML document sends every shard to the tree loader."""
    docs = CORPORA["templates"][:20] + CORPORA["doc_40000_nodes"] + CORPORA["exotic_numbers"]
    texts = [json.dumps(d) for d in docs]
    names = [f"d{i:02d}.json" for i in range(len(texts))]
    got = ingest.parallel_encode_documents(names, texts, workers)
    assert got is not None and len(got[3]["shards"]) == workers
    assert all(s["native"] == (encoder_state == "encoder_built") for s in got[3]["shards"])
    assert_same_groups(got[:3], tree_groups(texts))
    texts[3] = "Resources:\n  a:\n    Type: X\n"
    got = ingest.parallel_encode_documents(names, texts, workers)
    assert not any(s["native"] for s in got[3]["shards"])
    assert_same_groups(got[:3], tree_groups(texts))


def test_parallel_ingest_reports_first_parse_error(fresh_pools):
    from guard_tpu_torch.core.errors import GuardError

    texts = [json.dumps({"a": i}) for i in range(9)]
    texts[4] = "a: [1"
    texts[7] = "b: {"
    names = [f"d{i}.yaml" for i in range(9)]
    with pytest.raises(GuardError) as info:
        ingest.parallel_encode_documents(names, texts, 3)
    with pytest.raises(GuardError) as serial:
        load_document(texts[4], names[4])
    assert str(info.value) == str(serial.value)


def test_ingest_worker_holds_no_torch(fresh_pools):
    from guard_tpu_torch.ops.oracle_pool import worker_modules

    texts = [json.dumps({"a": i}) for i in range(4)]
    assert ingest.parallel_encode_documents([f"{i}" for i in range(4)], texts, 2) is not None
    pool = ingest.shared_pool(2)
    assert [pool.submit(worker_modules, None).get(timeout=60) for _ in range(4)] == [[]] * 4


@pytest.mark.parametrize("flag,env,want", [
    (3, "1", 3), (None, "2", 2), (None, "x", min((os.cpu_count() or 1) - 1, 4)),
    (None, None, min((os.cpu_count() or 1) - 1, 4)), (-2, None, 0), (0, "4", 0),
])
def test_resolve_ingest_workers_matches_jax(monkeypatch, flag, env, want):
    from guard_tpu.parallel.ingest import resolve_ingest_workers as jax_resolve

    if env is None:
        monkeypatch.delenv("GUARD_TPU_INGEST_WORKERS", raising=False)
    else:
        monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", env)
    assert ingest.resolve_ingest_workers(flag) == jax_resolve(flag) == want


# -- fault injection ---------------------------------------------------
FAULT_SPECS = [
    "parse:glob=zbad*", "read:nth=2", "encode:rate=0.5:seed=s1",
    "parse:nth=1,encode:glob=*.json", "bogus:nth=1", "parse:nth=x",
    "parse:rate=y", "parse:glob", "parse:seed=1", "parse:color=red",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_grammar_matches_jax(monkeypatch, spec):
    """The same GUARD_TPU_FAULT string parses to the same specs, or
    fails with the same message, and fires on the same calls."""
    from guard_tpu.core.errors import GuardError as JaxGuardError
    from guard_tpu.utils import faults as jax_faults
    from guard_tpu_torch.core.errors import GuardError
    from guard_tpu_torch.utils import faults

    monkeypatch.setenv("GUARD_TPU_FAULT", spec)
    jax_faults.reset_faults()
    faults._STATE["env"] = None
    try:
        want = jax_faults._specs()
    except JaxGuardError as e:
        with pytest.raises(GuardError) as info:
            faults._specs()
        assert str(info.value) == str(e)
        return
    assert faults._specs() == want
    keys = [f"{c}{i}.json" for i in range(12) for c in "az"]
    for point in ("read", "parse", "encode"):
        fired = [faults.should_fire(point, k) for k in keys]
        assert fired == [jax_faults.should_fire(point, k) for k in keys]


# -- the CLI against the JAX package ----------------------------------
class _Recording(port_validate.Validate):
    last = None

    def execute(self, writer, reader):
        _Recording.last = self
        return super().execute(writer, reader)


def run_both(args):
    """(rc, stdout, stderr) of both CLIs with `args` after `validate
    --backend tpu`; the port's on the CPU, with its Evaluation."""
    w = JaxWriter.buffered()
    rc = jax_cli.run(["validate", "--backend", "tpu", *args], writer=w,
                     reader=JaxReader.from_string(""))
    want = (rc, w.stripped(), w.err_to_stripped())
    w = Writer.buffered()
    _Recording.last = None
    with mock.patch.object(port_cli, "Validate", _Recording):
        rc = port_cli.run(["validate", "--no-result-cache", "--backend", "tpu", "--device", "cpu",
                           *args],
                          writer=w, reader=Reader.from_string(""))
    got = (rc, w.stripped(), w.err_to_stripped())
    assert got == want
    return got, _Recording.last.last_evaluation


def write_set(root: pathlib.Path, yaml_doc=False, bad_doc=False) -> list:
    """Security and flagship rules over templates that PASS and FAIL and
    a document of no CloudFormation shape; optionally a YAML template
    and a document that is not valid JSON."""
    (root / "rules").mkdir()
    (root / "rules" / "security.guard").write_text(bench.RULES)
    (root / "rules" / "flagship.guard").write_text(graft._RULES)
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(11)
    for i in range(9):
        (data / f"t{i:02d}.json").write_text(json.dumps(make_template(rng, i)))
    (data / "plain.json").write_text(json.dumps({"a": 1, "b": [1, 2]}))
    if yaml_doc:
        (data / "doc.yaml").write_text(
            "Resources:\n  b:\n    Type: AWS::S3::Bucket\n    Properties:\n"
            "      BucketName: UPPER\n"
        )
    if bad_doc:
        (data / "t04x.json").write_text('{"Resources": {"b": ')
    return ["-r", str(root / "rules"), "-d", str(data)]


OUTPUTS = {"single_line": [], "all": ["-S", "all"],
           "structured_json": ["-z", "-o", "json", "-S", "none"],
           "structured_junit": ["-z", "-o", "junit", "-S", "none"]}


@pytest.mark.parametrize("workers", ["0", "2"])
@pytest.mark.parametrize("docs", ["json", "with_yaml"])
def test_cli_ingest_matches_jax(encoder_state, fresh_pools, monkeypatch, tmp_path,
                                workers, docs):
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", workers)
    args = write_set(tmp_path, yaml_doc=docs == "with_yaml")
    for extra in (OUTPUTS["single_line"], OUTPUTS["structured_json"],
                  ["--statuses-only", "-S", "all"]):
        (rc, out, _err), ev = run_both([*args, *extra])
        assert rc == 19 and out
        path = ev.ingest["path"]
        if workers == "2":
            assert path == "pool"
        else:
            assert path == ("native" if docs == "json" and encoder_state == "encoder_built"
                            else "tree")


@pytest.mark.parametrize("max_df", [None, "0", "1", "-1"])
def test_cli_quarantine_matches_jax(encoder_state, monkeypatch, tmp_path, max_df):
    """One invalid document: without --max-doc-failures the run stops
    (rc 5); with it the document is skipped with a message, left out of
    every report (JUnit suites too), and the run exits 5 only when more
    documents failed than allowed."""
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    args = write_set(tmp_path, bad_doc=True)
    flag = [] if max_df is None else ["--max-doc-failures", max_df]
    for name, extra in OUTPUTS.items():
        (rc, out, err), ev = run_both([*args, *flag, *extra])
        if max_df is None:
            assert rc == 5 and out == "" and "t04x.json" in err
            continue
        assert "skipping t04x.json:" in err and "t04x" not in out
        assert rc == (5 if max_df == "0" else 19)
        assert ev.ingest["path"] == "quarantine"


@pytest.mark.parametrize("fault", ["parse:glob=t0[35]*", "encode:nth=2", "read:nth=1"])
def test_cli_fault_injection_matches_jax(encoder_state, monkeypatch, tmp_path, fault):
    """GUARD_TPU_FAULT under --max-doc-failures: the parse and encode
    points quarantine the documents they fire on; the read point fires
    nowhere in validate, in either package."""
    from guard_tpu.utils import faults as jax_faults
    from guard_tpu_torch.utils import faults

    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    args = write_set(tmp_path)
    for extra in (["--max-doc-failures", "-1"], ["--max-doc-failures", "1", "-S", "all"]):
        monkeypatch.setenv("GUARD_TPU_FAULT", fault)
        jax_faults.reset_faults()
        faults._STATE["env"] = None
        (rc, _out, err), _ev = run_both([*args, *extra])
        skipped = err.count("skipping ")
        assert skipped == {"parse": 2, "encode": 1, "read": 0}[fault.split(":")[0]]
        assert rc == (5 if skipped > int(extra[1]) >= 0 else 19)


def test_spawn_failure_falls_back_serially(monkeypatch, tmp_path, fresh_pools):
    """A pool that cannot spawn degrades to the serial encode, with the
    same output and no error."""
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    args = write_set(tmp_path)
    (_rc, base_out, _e), _ev = run_both([*args, *OUTPUTS["structured_json"]])

    def boom(workers):
        raise OSError("spawn blocked for test")

    monkeypatch.setattr(ingest, "_spawn_pool", boom)
    assert ingest.parallel_encode_documents(["a", "b"], ["{}", "{}"], 2) is None
    w = Writer.buffered()
    rc = port_cli.run(["validate", "--no-result-cache", "--device", "cpu", "--ingest-workers", "4",
                       *args,
                       *OUTPUTS["structured_json"]], writer=w, reader=Reader.from_string(""))
    assert (rc, w.stripped(), w.err_to_stripped()) == (19, base_out, "")


# -- trees only where something walks them ------------------------------
@pytest.mark.parametrize("flags", ["statuses_only", "single_line", "structured_json"])
def test_trees_built_only_for_what_walks_them(encoder_dirs, monkeypatch, tmp_path, flags):
    """On an all-JSON corpus with no function variable, no -i and no -P
    a tree is built, once, for each document the CPU oracle reruns in
    this process (here every failing one, or every one for structured
    output), and for no other: none under --statuses-only, whose
    clause-free reports find the document's shape by a key scan."""
    set_encoders(monkeypatch, encoder_dirs, tmp_path)
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    args = write_set(tmp_path)
    extra = {"statuses_only": ["--statuses-only"], "single_line": [],
             "structured_json": OUTPUTS["structured_json"]}[flags]
    built = []
    real = port_validate.load_document

    def counting(content, name=""):
        built.append(name)
        return real(content, name)

    monkeypatch.setattr(port_validate, "load_document", counting)
    w = Writer.buffered()
    _Recording.last = None
    with mock.patch.object(port_cli, "Validate", _Recording):
        rc = port_cli.run(["validate", "--no-result-cache", "--device", "cpu", *args, *extra],
                          writer=w,
                          reader=Reader.from_string(""))
    ev = _Recording.last.last_evaluation
    assert rc == 19 and ev.ingest["path"] == "native" and ev.seconds["load"] == 0.0
    assert len(built) == len(set(built))
    fail_lines = [l.split()[0] for l in w.stripped().splitlines() if l.endswith("Status = FAIL")]
    inline = ev.reruns["inline"]
    if flags == "statuses_only":
        assert built == [] and inline == 0 and fail_lines
    elif flags == "single_line":
        assert set(built) == set(fail_lines) and inline == len(fail_lines)
    else:
        assert len(built) == ev.n_docs and inline == ev.n_docs * len(ev.files)


def test_no_jax_and_no_torch_in_workers_of_a_cli_run(encoder_dirs, tmp_path):
    """A port process that runs the pool imports no JAX; its workers
    hold no torch."""
    args = write_set(tmp_path)
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        "from guard_tpu_torch.parallel import ingest\n"
        "from guard_tpu_torch.ops.oracle_pool import worker_modules\n"
        "if __name__ == '__main__':\n"
        f"    rc = cli.run(['validate', '--no-result-cache', '--device', 'cpu',\n"
        f"                  '--ingest-workers', '2', *{args!r}])\n"
        "    held = ingest.shared_pool(2).submit(worker_modules, None).get(timeout=60)\n"
        "    ingest.close_shared_pools()\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'guard_tpu')]\n"
        "    print('RESULT', rc, held, bad)\n"
    )
    env = dict(os.environ, GUARD_TPU_TORCH_NATIVE_DIR=str(encoder_dirs["port"]),
               PYTHONPATH=str(ROOT))
    script = tmp_path / "run.py"
    script.write_text(code)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.stdout.strip().splitlines()[-1] == "RESULT 19 [] []", proc.stderr[-2000:]


def test_native_directory_untouched():
    """The port builds nothing under native/ (its libraries live in its
    own directory)."""
    tracked = subprocess.run(["git", "-C", str(ROOT), "status", "--porcelain", "native"],
                             capture_output=True, text=True).stdout
    assert tracked == ""
    assert native_encoder.SOURCE.parent == ROOT / "guard_tpu_torch" / "csrc" / "host"

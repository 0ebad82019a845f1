"""`sweep --follow` of the port (guard_tpu_torch/commands/sweep.py,
streaming CI mode) against the JAX package's, on the CPU.

Documents arrive as JSONL on stdin: envelopes with string and object
content, bare documents, a YAML envelope, lines that do not decode and
documents that do not parse. Both CLIs run in this process on the same
stdin; one result line answers every input line, in order, then one
summary line. Stdout, stderr and the exit code must be equal in every
setting of the micro-batch window (GUARD_TPU_FOLLOW_WAIT_MS) and cap
(GUARD_TPU_FOLLOW_MAX_BATCH): batching changes no byte.
"""

import json

import numpy as np
import pytest

import bench
from guard_tpu_torch.utils.telemetry import ADMISSION_COUNTERS
from test_torch_sweep import Pair
from test_torch_ingest import set_encoders
from test_torch_reports import write_fixture


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_FOLLOW_WAIT_MS", "GUARD_TPU_FOLLOW_MAX_BATCH",
                 "GUARD_TPU_LEDGER_DIR"):
        monkeypatch.delenv(name, raising=False)
    set_encoders(monkeypatch, None, tmp_path)


def stream_lines(n_templates=10):
    """Envelopes, bare documents, a YAML envelope, a line that does not
    decode, a document that does not parse, and a blank line."""
    rng = np.random.default_rng(5)
    lines = []
    for i in range(n_templates):
        doc = bench.make_template(rng, i)
        if i % 3 == 0:
            lines.append(json.dumps({"name": f"t{i:02d}.json", "content": json.dumps(doc)}))
        elif i % 3 == 1:
            lines.append(json.dumps({"name": f"t{i:02d}.json", "content": doc}))
        else:
            lines.append(json.dumps(doc))
    lines.insert(3, "{not json")
    lines.insert(5, "")
    lines.insert(6, json.dumps({"name": "bad.yaml", "content": "Resources: [unclosed"}))
    lines.append(json.dumps({"name": "y.yaml", "content":
                             "Resources:\n  b:\n    Type: AWS::S3::Bucket\n"}))
    lines.append(json.dumps({"content": {"a": 1}}))
    return "\n".join(lines) + "\n"


@pytest.fixture
def pair(tmp_path, monkeypatch):
    root = write_fixture(tmp_path)
    return Pair(tmp_path, monkeypatch, [root / "rules"], [])


def follow(pair, flags=(), **kw):
    return pair.both(["--follow", *flags], stdin=kw.pop("stdin", stream_lines()), **kw)


def result_lines(out):
    return [json.loads(line) for line in out.splitlines()]


@pytest.mark.parametrize("wait_ms,max_batch", [("0", "1"), ("0", "32"), ("5", "1"),
                                               ("5", "3"), ("20", "32"), (None, None)])
def test_window_and_cap_change_no_byte(pair, monkeypatch, wait_ms, max_batch):
    if wait_ms is not None:
        monkeypatch.setenv("GUARD_TPU_FOLLOW_WAIT_MS", wait_ms)
        monkeypatch.setenv("GUARD_TPU_FOLLOW_MAX_BATCH", max_batch)
    got = follow(pair)
    lines = result_lines(got[1])
    assert len(lines) == 15 and lines[-1]["follow"] is True
    assert [ln.get("quarantined", {}).get("stage") for ln in lines[:-1]].count("read") == 1
    assert got[0] == 19


def test_one_line_answers_every_input_line_in_order(pair):
    got = follow(pair)
    names = [ln.get("name") for ln in result_lines(got[1])[:-1]]
    assert names[:4] == ["t00.json", "t01.json", "stream[3]", "stream[4]"]
    assert names[-2:] == ["y.yaml", "stream[14]"]
    summary = result_lines(got[1])[-1]
    assert summary["documents"] == 14
    assert [q["file"] for q in summary["quarantined"]] == ["stream[4]", "bad.yaml"]


def test_batch_cap_one_counts_a_batch_a_line(pair, monkeypatch):
    monkeypatch.setenv("GUARD_TPU_FOLLOW_MAX_BATCH", "1")
    monkeypatch.setenv("GUARD_TPU_FOLLOW_WAIT_MS", "0")
    before = dict(ADMISSION_COUNTERS)
    pair.port(["--follow"], stdin=stream_lines())
    assert ADMISSION_COUNTERS["follow_docs"] - before["follow_docs"] == 14
    assert ADMISSION_COUNTERS["follow_batches"] - before["follow_batches"] == 14


@pytest.mark.parametrize("limit", [None, 0, 1, 2])
def test_max_doc_failures_match_jax(pair, limit):
    flags = [] if limit is None else ["--max-doc-failures", str(limit)]
    got = follow(pair, flags)
    assert got[0] == (5 if limit is not None and limit < 2 else 19)


def test_cpu_backend_matches_jax_and_the_card(pair):
    cpu = follow(pair, backend="cpu")
    tpu = pair.port(["--follow"], stdin=stream_lines())
    assert cpu[:3] == tpu[:3]


@pytest.mark.parametrize("cache", [False, True])
def test_result_cache_changes_no_byte(pair, cache):
    first = follow(pair, ["--delta-stats"], cache=cache)
    again = follow(pair, ["--delta-stats"], cache=cache)
    assert first[1] == again[1]
    if cache:
        assert "result-cache: 12/13 docs cached, 1 dispatched" in again[2]


@pytest.mark.parametrize("flags", [["--no-pack"], ["--no-vector-rim"], ["--no-plan-cache"]])
def test_device_flags_match_jax(pair, flags):
    follow(pair, flags)


def test_read_fault_quarantines_like_jax(pair, monkeypatch):
    monkeypatch.setenv("GUARD_TPU_FAULT", "read:glob=stream[[]2]")
    got = follow(pair)
    assert "injected read fault (stream[2])" in got[2]


def test_statuses_equal_the_batch_sweep(pair, tmp_path):
    """The stream's statuses are the batch sweep's over the same
    documents written as files."""
    rng = np.random.default_rng(5)
    data = tmp_path / "batch_data"
    data.mkdir()
    lines = []
    for i in range(12):
        doc = bench.make_template(rng, i)
        (data / f"t{i:02d}.json").write_text(json.dumps(doc))
        lines.append(json.dumps({"name": f"t{i:02d}.json", "content": doc}))
    streamed = pair.port(["--follow"], stdin="\n".join(lines) + "\n")
    batch = Pair(tmp_path, pair.mp, pair.rules, [data]).port(["-c", "5"])
    s_sum, b_sum = result_lines(streamed[1])[-1], json.loads(batch[1].splitlines()[-1])
    assert s_sum["counts"] == b_sum["counts"] and s_sum["failed"] == b_sum["failed"]
    assert streamed[0] == batch[0]


@pytest.mark.parametrize("case", ["parse_error", "no_rules", "empty_stream"])
def test_edges_match_jax(tmp_path, monkeypatch, case):
    root = write_fixture(tmp_path)
    rules = [root / "rules"]
    stdin = stream_lines()
    if case == "parse_error":
        (root / "rules" / "broken.guard").write_text("rule r {{{ when\n")
        # only documents that load: the quarantined ones' encode-stage
        # error counts are lost in both packages' --follow fold
        # (`err_box[0] += self._eval_tpu(...)` reads err_box[0] before
        # the call adds to it), so with them the parse error would be
        # offset and the run would exit 19
        stdin = "\n".join(ln for ln in stdin.splitlines()
                          if ln.startswith('{"name": "t')) + "\n"
    elif case == "no_rules":
        rules = []
    else:
        stdin = "\n\n"
    pr = Pair(tmp_path, monkeypatch, rules, [])
    got = pr.both(["--follow"], stdin=stdin)
    assert got[0] == {"parse_error": 5, "no_rules": 5, "empty_stream": 0}[case]
    if case == "parse_error":
        assert got[2].startswith("Parse Error on ruleset file broken.guard\n")

"""The port's `sweep` (guard_tpu_torch/commands/sweep.py) against the
JAX package's (guard_tpu/commands/sweep.py), on the CPU.

Both CLIs run in this process over the same files at the same paths, one
after the other, the manifest deleted in between (its chunk signature
hashes path, size and whole-second mtime): the port with `--device cpu`
(the plain versions of the kernels), the JAX package with `--backend
tpu` under JAX_PLATFORMS=cpu, and both with `--backend cpu`. Each
package has its own journal and result-cache directory; the JAX side
runs with its result cache off unless a test is about the cache, and
both native encoders and oracles are off (the tree encoder), so the
quarantine messages are the same. Stdout, stderr, the manifest's bytes
and the exit code must be equal; no tolerance.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.parallel import ingest as jax_ingest
from guard_tpu.utils import faults as jax_faults
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch import kernels as K
from guard_tpu_torch.commands.sweep import Sweep
from guard_tpu_torch.ops import plan as port_plan
from guard_tpu_torch.parallel import ingest as port_ingest
from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS
from guard_tpu_torch.utils import faults as port_faults
from guard_tpu_torch.utils.io import Reader, Writer
from guard_tpu_torch.utils.telemetry import PIPELINE_COUNTERS
from test_torch_ingest import set_encoders
from test_torch_reports import write_fixture

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: corpus rule files with their test inputs (packable files, one with a
#: query-RHS compare) and a function-variable file
CORPUS_FILES = (
    "block_form_050", "filter_conj_042", "in_list_mixed_033", "named_deps_037",
    "ordering_str_062", "query_vs_query_053", "keys_regex_044",
)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_RETRY_BACKOFF", "0")
    # the serial path unless a test names the workers: a spawned pool
    # lives on across tests with the environment it was spawned in
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_LEDGER_DIR", "GUARD_TPU_SWEEP_JOURNAL",
                 "GUARD_TPU_SWEEP_RESUME"):
        monkeypatch.delenv(name, raising=False)
    set_encoders(monkeypatch, None, tmp_path)
    port_plan.clear_plan_memo()
    yield
    port_plan.clear_plan_memo()


class Pair:
    """Both CLIs over one set of files, each package with its own
    journal and result-cache directory and the same manifest path."""

    def __init__(self, tmp_path, monkeypatch, rules, data):
        self.tmp = tmp_path
        self.mp = monkeypatch
        self.rules = [str(r) for r in rules]
        self.data = [str(d) for d in data]
        self.manifest = tmp_path / "out" / "manifest.jsonl"

    def argv(self, flags):
        return ["sweep", "-r", *self.rules, "-d", *self.data, "-M", str(self.manifest), *flags]

    def _run(self, who, flags, stdin, fresh_manifest):
        if fresh_manifest and self.manifest.exists():
            self.manifest.unlink()
        self.mp.setenv("GUARD_TPU_JOURNAL_DIR", str(self.tmp / f"{who}_journal"))
        self.mp.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(self.tmp / f"{who}_results"))
        if who == "jax":
            # the JAX CLI leaves --mesh-shape in GUARD_TPU_MESH
            saved = os.environ.get("GUARD_TPU_MESH")
            jax_faults.reset_faults()
            w = JaxWriter.buffered()
            try:
                rc = jax_cli.run(self.argv(flags), writer=w, reader=JaxReader.from_string(stdin))
            finally:
                if saved is None:
                    os.environ.pop("GUARD_TPU_MESH", None)
                else:
                    os.environ["GUARD_TPU_MESH"] = saved
        else:
            port_faults.reset_faults()
            w = Writer.buffered()
            rc = port_cli.run(self.argv(flags), writer=w, reader=Reader.from_string(stdin))
        manifest = self.manifest.read_bytes() if self.manifest.exists() else None
        return rc, w.stripped(), w.err_to_stripped(), manifest

    def jax(self, flags, backend="tpu", cache=False, stdin="", fresh_manifest=True):
        self.mp.setenv("GUARD_TPU_RESULT_CACHE", "1" if cache else "0")
        return self._run("jax", ["--backend", backend, *flags], stdin, fresh_manifest)

    def port(self, flags, backend="tpu", cache=False, stdin="", fresh_manifest=True):
        extra = ["--device", "cpu"] if backend == "tpu" else []
        if not cache:
            extra.append("--no-result-cache")
        return self._run("port", ["--backend", backend, *extra, *flags], stdin,
                         fresh_manifest)

    def both(self, flags, backend="tpu", **kw):
        # a kept manifest: each package starts from the same bytes
        before = self.manifest.read_bytes() if self.manifest.exists() else None
        want = self.jax(flags, backend, **kw)
        if before is not None:
            self.manifest.write_bytes(before)
        got = self.port(flags, backend, **kw)
        assert got[0] == want[0], (got[2], want[2])
        assert got[2] == want[2]
        assert got[1] == want[1]
        assert got[3] == want[3]
        return got


def fixture_pair(tmp_path, monkeypatch):
    root = write_fixture(tmp_path)
    return Pair(tmp_path, monkeypatch, [root / "rules"], [root / "data"])


@pytest.fixture
def pair(tmp_path, monkeypatch):
    return fixture_pair(tmp_path, monkeypatch)


def write_corpus(root: pathlib.Path):
    """A few corpus/rules files, the function-variable rules, and the
    corpus files' test inputs, one document a file."""
    import yaml

    rules = root / "corpus_rules"
    data = root / "corpus_data"
    rules.mkdir()
    data.mkdir()
    n = 0
    for stem in CORPUS_FILES:
        src = ROOT / "corpus" / "rules" / f"{stem}.guard"
        (rules / src.name).write_text(src.read_text())
        tests = ROOT / "corpus" / "rules" / "tests" / f"{stem}_tests.yaml"
        for case in yaml.safe_load(tests.read_text()):
            (data / f"c{n:03d}.json").write_text(json.dumps(case["input"]))
            n += 1
    (rules / "canonical_names.guard").write_text(
        (ROOT / "examples" / "rules" / "naming" / "canonical_names.guard").read_text()
    )
    return rules, data


@pytest.fixture
def corpus_pair(tmp_path, monkeypatch):
    rules, data = write_corpus(tmp_path)
    return Pair(tmp_path, monkeypatch, [rules], [data])


# -- the flag matrix --------------------------------------------------
FLAG_SETS = {
    "default": [],
    "no_pack": ["--no-pack"],
    "no_vector_rim": ["--no-vector-rim"],
    "no_plan_cache": ["--no-plan-cache"],
    "no_verify_plans": ["--no-verify-plans"],
    "rule_shards_2": ["--rule-shards", "2"],
    "mesh_2x1": ["--mesh-shape", "2x1"],
}


#: (chunk size, flag set) cases of the matrix. The JAX package compiles
#: its programs again for most chunks of one document, so the flags
#: that change the program (--no-pack, --rule-shards) run at chunk
#: size 3 only.
MATRIX = [
    (chunk, flags) for chunk in (1, 3, 1024) for flags in FLAG_SETS
    if flags not in ("no_pack", "rule_shards_2") or chunk == 3
]


@pytest.mark.parametrize("workers", [0, 1])
@pytest.mark.parametrize("chunk,flags", MATRIX)
def test_flag_matrix_matches_jax(pair, chunk, flags, workers):
    """Every chunk size, flag and ingest path: the JAX CLI's bytes."""
    got = pair.both(["-c", str(chunk), "--ingest-workers", str(workers), *FLAG_SETS[flags]])
    assert got[0] == 19
    summary = json.loads(got[1].splitlines()[-1])
    assert summary["chunks"] == -(-15 // chunk) == summary["evaluated"]
    assert summary["counts"]["fail"] > 0


@pytest.mark.parametrize("flags", ["default", "no_vector_rim", "no_plan_cache"])
@pytest.mark.parametrize("chunk", [4])
def test_corpus_registry_matches_jax(corpus_pair, chunk, flags):
    """Corpus rule files (one pack) beside a function-variable file,
    over the corpus files' own test inputs."""
    got = corpus_pair.both(["-c", str(chunk), *FLAG_SETS[flags]])
    assert json.loads(got[1].splitlines()[-1])["documents"] == 16


@pytest.mark.parametrize("chunk", [3, 1024])
def test_cpu_backend_matches_jax(pair, chunk):
    """`--backend cpu` against the JAX package's, and the card's path
    against both."""
    cpu = pair.both(["-c", str(chunk)], backend="cpu")
    tpu = pair.port(["-c", str(chunk)])
    assert tpu == cpu


def test_cpu_backend_imports_no_torch(tmp_path):
    root = write_fixture(tmp_path)
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        f"rc = cli.run(['sweep', '--backend', 'cpu', '-r', {str(root / 'rules')!r}, "
        f"'-d', {str(root / 'data')!r}, '-M', {str(tmp_path / 'm.jsonl')!r}])\n"
        "assert rc == 19, rc\n"
        "assert 'torch' not in sys.modules\n"
        "assert not [m for m in sys.modules if m == 'jax' or m.startswith('guard_tpu.')]\n"
    )
    env = dict(os.environ, GUARD_TPU_JOURNAL_DIR=str(tmp_path / "j"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_spawned_ingest_workers_match_jax(pair, monkeypatch):
    """Two spawned ingest workers per package (fresh pools that see this
    test's environment) against the serial run."""
    port_ingest.close_shared_pools()
    jax_ingest.close_shared_pools()
    try:
        PIPELINE_COUNTERS.update({k: 0 for k in PIPELINE_COUNTERS})
        got = pair.both(["-c", "3", "--ingest-workers", "2"])
        assert PIPELINE_COUNTERS["chunks_prefetched"] == 5
        assert PIPELINE_COUNTERS["encode_dispatch_overlap"] == 4
        assert 1 <= PIPELINE_COUNTERS["max_inflight_chunks"] <= 2
    finally:
        port_ingest.close_shared_pools()
        jax_ingest.close_shared_pools()
    assert got[:3] == pair.port(["-c", "3", "--ingest-workers", "0"])[:3]


# -- the quarantine ---------------------------------------------------
def add_bad_files(data: pathlib.Path) -> None:
    # bytes that do not decode as UTF-8: the read fails (root reads
    # any mode bits, so permissions would not do)
    (data / "t03_unreadable.json").write_bytes(b'{"a": "\xff\xfe"}')
    (data / "t07_malformed.json").write_text('{"Resources": {"x": ')


@pytest.mark.parametrize("workers", [0, 1])
@pytest.mark.parametrize("limit", [None, 0, 1, 2])
def test_max_doc_failures_match_jax(pair, limit, workers):
    add_bad_files(pathlib.Path(pair.data[0]))
    flags = ["-c", "4", "--ingest-workers", str(workers)]
    if limit is not None:
        flags += ["--max-doc-failures", str(limit)]
    got = pair.both(flags)
    summary = json.loads(got[1].splitlines()[-1])
    assert [q["stage"] for q in summary["quarantined"]] == ["read", "parse"]
    assert got[0] == (5 if limit is not None and limit < 2 else 19)


def test_read_fault_quarantines_like_jax(pair, monkeypatch):
    monkeypatch.setenv("GUARD_TPU_FAULT", "read:glob=t1*.json")
    got = pair.both(["-c", "5", "--ingest-workers", "1"])
    assert "injected read fault" in got[2]


def test_worker_crash_retries_inline(pair, monkeypatch):
    """An injected worker crash: the chunk re-encodes in process, the
    pool restarts, the bytes are the unarmed run's."""
    unarmed = pair.port(["-c", "3", "--ingest-workers", "2"])
    monkeypatch.setenv("GUARD_TPU_FAULT", "worker_crash:nth=2")
    port_ingest.close_shared_pools()
    try:
        got = pair.port(["-c", "3", "--ingest-workers", "2"])
        stats = port_faults.fault_stats()
    finally:
        port_ingest.close_shared_pools()
    assert got == unarmed
    assert stats["injected_worker_crash"] == 1 and stats["retries"] == 1
    assert stats["worker_restarts"] == 1


# -- the result cache -------------------------------------------------
@pytest.mark.parametrize("workers", [0, 1])
def test_cache_cold_warm_changed_match_jax(pair, workers):
    flags = ["-c", "4", "--delta-stats", "--ingest-workers", str(workers)]
    off = pair.port(["-c", "4", "--ingest-workers", str(workers)])
    cold = pair.both(flags, cache=True)
    assert "result-cache: 0/15 docs cached, 15 dispatched" in cold[2]
    K.reset_launches()
    DISPATCH_COUNTERS["dispatches"] = 0
    warm = pair.both(flags, cache=True)
    assert DISPATCH_COUNTERS["dispatches"] == 0
    assert "result-cache: 15/15 docs cached, 0 dispatched" in warm[2]
    data = pathlib.Path(pair.data[0])
    doc = json.loads((data / "t05.json").read_text())
    doc["Resources"]["extra"] = {"Type": "AWS::S3::Bucket", "Properties": {}}
    (data / "t05.json").write_text(json.dumps(doc))
    changed = pair.both(flags, cache=True)
    assert "result-cache: 14/15 docs cached, 1 dispatched" in changed[2]
    assert (cold[0], cold[1], cold[3]) == (off[0], off[1], off[3]) == (warm[0], warm[1], warm[3])


def test_cache_store_skipped_when_a_fault_moved(pair, monkeypatch):
    """A chunk during which a fault counter moved stores nothing, as in
    the JAX package: the read fault in chunk 0 quarantines t00.json, and
    chunk 1, partitioned before chunk 0's quarantine was counted, stores
    none of its five; the next run dispatches those six."""
    monkeypatch.setenv("GUARD_TPU_FAULT", "read:glob=t00.json")
    pair.both(["-c", "5", "--delta-stats"], cache=True)
    monkeypatch.delenv("GUARD_TPU_FAULT")
    got = pair.both(["-c", "5", "--delta-stats"], cache=True)
    assert "result-cache: 9/15 docs cached, 6 dispatched" in got[2]


# -- the manifest and the argument errors -----------------------------
def test_manifest_skip_and_changed_chunk_match_jax(pair):
    first = pair.both(["-c", "4"])
    again = pair.both(["-c", "4"], fresh_manifest=False)
    assert json.loads(again[1].splitlines()[-1])["resumed"] == 4
    data = pathlib.Path(pair.data[0])
    path = data / "t09.json"
    os.utime(path, (path.stat().st_atime, path.stat().st_mtime + 5))
    third = pair.both(["-c", "4"], fresh_manifest=False)
    summary = json.loads(third[1].splitlines()[-1])
    assert (summary["evaluated"], summary["resumed"]) == (1, 3)
    assert summary["counts"] == json.loads(first[1].splitlines()[-1])["counts"]


@pytest.mark.parametrize("case", ["no_rules", "no_data", "chunk_zero", "parse_error",
                                  "missing_data"])
def test_errors_match_jax(tmp_path, monkeypatch, case):
    root = write_fixture(tmp_path)
    rules, data = [root / "rules"], [root / "data"]
    flags = []
    if case == "no_rules":
        rules = []
    elif case == "no_data":
        data = []
    elif case == "chunk_zero":
        flags = ["-c", "0"]
    elif case == "parse_error":
        (root / "rules" / "broken.guard").write_text("rule r { Resources.* { x == } \n")
    elif case == "missing_data":
        data = [root / "absent"]
    pr = Pair(tmp_path, monkeypatch, rules, data)
    got = pr.both(flags)
    assert got[0] == 5


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_passing_corpus_exits_0_like_jax(tmp_path, monkeypatch, backend):
    rules, data = tmp_path / "ok.guard", tmp_path / "ok_data"
    rules.write_text("rule has_resources { Resources exists }\n")
    data.mkdir()
    for i in range(5):
        (data / f"p{i}.json").write_text(json.dumps({"Resources": {"r": {"Type": f"T{i}"}}}))
    got = Pair(tmp_path, monkeypatch, [rules], [data]).both(["-c", "2"], backend=backend)
    assert got[0] == 0 and json.loads(got[1].splitlines()[-1])["counts"]["pass"] == 5


# -- the tally's dict-overwrite semantics -----------------------------
def write_overwrite_fixture(root: pathlib.Path):
    """Two rule files that share rule names: within a file the last
    same-name rule wins, across files the later file wins."""
    rules, data = root / "ow_rules", root / "ow_data"
    rules.mkdir()
    data.mkdir()
    (rules / "a.guard").write_text(
        "rule shared { a exists }\nrule own_a { b exists }\nrule shared { c exists }\n"
    )
    (rules / "b.guard").write_text("rule own_b { a == 1 }\nrule shared { d exists }\n")
    docs = [{"a": 1}, {"a": 2, "c": 1}, {"d": 1, "b": 1}, {"a": 1, "b": 1, "c": 1, "d": 1},
            {}, {"c": 1, "d": 1}, [1, 2], {"a": "x", "d": None}]
    for i, doc in enumerate(docs):
        (data / f"o{i}.json").write_text(json.dumps(doc))
    return rules, data


@pytest.mark.parametrize("pack", [True, False])
def test_vectorized_tally_equals_scalar(tmp_path, monkeypatch, pack):
    """_outcomes_vectorized (the K3 last-rule-wins block) against
    _outcomes_scalar (--no-vector-rim) on the same chunk, and both
    against the JAX package."""
    rules, data = write_overwrite_fixture(tmp_path)
    pr = Pair(tmp_path, monkeypatch, [rules], [data])
    extra = [] if pack else ["--no-pack"]
    vec = pr.both(["-c", "3", *extra])
    scalar = pr.both(["-c", "3", "--no-vector-rim", *extra])
    assert vec == scalar


def test_outcomes_functions_agree_directly():
    """The two folds as functions, on hand-built status blocks."""
    from guard_tpu_torch.commands.validate import DataFile
    from guard_tpu_torch.core.qresult import Status

    dfs = [DataFile(name=f"d{i}", content="{}") for i in range(4)]
    name_last = [np.array([[0, 1], [2, 2], [1, 0], [0, 0]], np.int8),
                 np.array([[2], [0], [2], [1]], np.int8)]
    recs = [(["x", "y"], name_last[0], True, set(), [dict() for _ in dfs]),
            (["y"], name_last[1], True, {3}, [dict() for _ in dfs])]
    recs[1][4][3] = {"y": Status.PASS}
    per_doc = [dict() for _ in dfs]
    st = {0: Status.PASS, 1: Status.FAIL, 2: Status.SKIP}
    for names, nl, _dev, host, ow in recs:
        for di in range(4):
            if di not in host:
                for g, n in enumerate(names):
                    per_doc[di][n] = st[int(nl[di, g])]
            per_doc[di].update(ow[di])
    vec = Sweep._outcomes_vectorized(dfs, {"files": recs})
    assert vec == Sweep._outcomes_scalar(dfs, per_doc)
    assert [o["status"] for o in vec] == ["pass", "pass", "fail", "pass"]


# -- the device path's failures ---------------------------------------
def test_malformed_mesh_shape_falls_back_like_jax(pair, caplog):
    got = pair.both(["-c", "3", "--mesh-shape", "bad"])
    assert got[0] == 19
    assert "packed dispatch plane failed" in caplog.text


def test_injected_collect_fault_takes_the_ladder(pair, monkeypatch):
    unarmed = pair.port(["-c", "1024", "--no-journal"])
    monkeypatch.setenv("GUARD_TPU_FAULT", "collect:nth=1")
    got = pair.port(["-c", "1024", "--no-journal"])
    assert got[:2] == unarmed[:2]
    assert port_faults.fault_stats()["dispatch_fallbacks"] == 1


def test_kernel_error_ends_the_run_with_code_5(pair, monkeypatch):
    """A kernel error (here the rim reduction's wrapper raising as a
    failed launch would) is not caught by the sweep: rc 5, no summary."""
    from guard_tpu_torch.parallel import device as port_device

    def broken(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_device.K, "rim_reduce", broken)
    rc, out, err, _m = pair.port(["-c", "1024"])
    assert rc == 5 and out == ""
    assert err.startswith("Error: CUDA error: an illegal memory access")


def test_no_card_without_device_exits_5(pair):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is present")
    w = Writer.buffered()
    rc = port_cli.run(pair.argv(["-c", "4"]), writer=w)
    assert rc == 5 and "CUDA" in w.err_to_stripped() and w.stripped() == ""


def test_sweep_launches_the_packed_kernels(pair):
    """The packed path's kernel wrappers run once per (pack, bucket)
    (their plain versions on the CPU: the counts are of calls)."""
    DISPATCH_COUNTERS["dispatches"] = 0
    pair.port(["-c", "1024"])
    assert DISPATCH_COUNTERS["dispatches"] >= 1


def test_no_jax_in_a_port_sweep(tmp_path):
    root = write_fixture(tmp_path)
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        f"rc = cli.run(['sweep', '--device', 'cpu', '-r', {str(root / 'rules')!r}, "
        f"'-d', {str(root / 'data')!r}, '-M', {str(tmp_path / 'm.jsonl')!r}, '-c', '4'])\n"
        "assert rc == 19, rc\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'guard_tpu' or m.startswith('guard_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, GUARD_TPU_JOURNAL_DIR=str(tmp_path / "j"),
               GUARD_TPU_RESULT_CACHE_DIR=str(tmp_path / "r"), GUARD_TPU_INGEST_WORKERS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr

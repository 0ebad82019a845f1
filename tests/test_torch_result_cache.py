"""The port's result cache (guard_tpu_torch/cache/results.py and the
cache half of ops/backend.tpu_validate) against the JAX package's
(guard_tpu/cache/results.py), on the CPU.

Each package keeps its entries in a directory of its own
(GUARD_TPU_RESULT_CACHE_DIR, set before each run); the JAX package runs
with GUARD_TPU_RESULT_CACHE=1 and its serial encode, both with their
native oracles off. A cold run, a warm run, a run with one document
changed, `--delta-stats`, the `cache` and `store_write` fault points
and a corrupt entry must give the same stdout, stderr and rc in both
packages, and the same stdout and rc as the run without the cache. No
tolerance: the bytes are equal. The JAX package keeps a file per
entry, the port a row per entry in one SQLite database.
"""

import json
import os
import pathlib
import sqlite3
import subprocess
import sys

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.utils import faults as jax_faults
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.cache import results as port_results
from guard_tpu_torch.ops import backend as port_backend
from guard_tpu_torch.ops import plan as port_plan
from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS
from guard_tpu_torch.utils import faults as port_faults
from guard_tpu_torch.utils.io import Writer
from test_torch_reports import set_native, write_fixture

ROOT = pathlib.Path(__file__).resolve().parent.parent

# output flag sets, each keying its own cache entries
FLAG_SETS = {
    "statuses_only": ["--statuses-only"],
    "single_line_all": ["-S", "all"],
    "structured_json": ["-z", "-o", "json", "-S", "none"],
    "structured_yaml": ["-z", "-o", "yaml", "-S", "none"],
    "sarif": ["-z", "-o", "sarif", "-S", "none"],
    "junit": ["-z", "-o", "junit", "-S", "none"],
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    # an rc-5 run dumps here if the flight recorder is armed
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.delenv("GUARD_TPU_FAULT", raising=False)
    set_native(monkeypatch, None)
    port_plan.clear_plan_memo()
    yield
    port_plan.clear_plan_memo()


class Pair:
    """Both CLIs over one fixture, each with its own cache directory."""

    def __init__(self, tmp_path, monkeypatch):
        self.root = write_fixture(tmp_path)
        self.dirs = {"jax": tmp_path / "jax_results", "port": tmp_path / "port_results"}
        self.mp = monkeypatch

    def args(self, flags):
        return ["-r", str(self.root / "rules"), "-d", str(self.root / "data"), *flags]

    def jax(self, args, cache=True):
        self.mp.setenv("GUARD_TPU_RESULT_CACHE", "1" if cache else "0")
        self.mp.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(self.dirs["jax"]))
        jax_faults.reset_faults()
        w = JaxWriter.buffered()
        rc = jax_cli.run(["validate", "--backend", "tpu", *args], writer=w)
        return rc, w.stripped(), w.err_to_stripped()

    def port(self, args, cache=True):
        self.mp.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(self.dirs["port"]))
        port_faults.reset_faults()
        w = Writer.buffered()
        extra = [] if cache else ["--no-result-cache"]
        rc = port_cli.run(["validate", "--device", "cpu", *extra, *args], writer=w)
        return rc, w.stripped(), w.err_to_stripped()

    def both(self, args, cache=True):
        want = self.jax(args, cache)
        got = self.port(args, cache)
        assert got[0] == want[0], (got[2], want[2])
        assert got[2] == want[2]
        assert got[1] == want[1]
        return got

    def entries(self, who="port"):
        """The stored keys, sorted."""
        if who == "jax":
            return sorted(p.name[: -len(".result.json")]
                          for p in self.dirs[who].glob("*.result.json"))
        return db_keys(self.dirs[who])


def db_keys(cache_dir):
    db = cache_dir / port_results.DB_NAME
    if not db.exists():
        return []
    with sqlite3.connect(db) as conn:
        return sorted(k for (k,) in conn.execute("SELECT key FROM entries"))


def set_blob(cache_dir, key, blob):
    with sqlite3.connect(cache_dir / port_results.DB_NAME) as conn:
        conn.execute("UPDATE entries SET blob = ? WHERE key = ?", (blob, key))


@pytest.fixture
def pair(tmp_path, monkeypatch):
    return Pair(tmp_path, monkeypatch)


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_cold_warm_and_off_agree(pair, flags):
    """Cold (every document stored), warm (every document replayed) and
    off: the same bytes in both packages and across the three runs."""
    args = pair.args(FLAG_SETS[flags])
    off = pair.both(args, cache=False)
    port_results.reset_result_cache_stats()
    cold = pair.both(args)
    stats = port_results.result_cache_stats()
    n_docs = len(list((pair.root / "data").iterdir()))
    assert stats["misses"] == n_docs and stats["stores"] == n_docs
    assert len(pair.entries()) == n_docs == len(pair.entries("jax"))
    port_results.reset_result_cache_stats()
    warm = pair.both(args)
    stats = port_results.result_cache_stats()
    assert stats["hits"] == n_docs and stats["misses"] == 0 and stats["stores"] == 0
    assert (cold[0], cold[1]) == (off[0], off[1]) == (warm[0], warm[1])


@pytest.mark.parametrize("flags", ["statuses_only", "single_line_all"])
def test_warm_run_encodes_and_dispatches_nothing(pair, monkeypatch, flags):
    """A 100 %-warm run replays every document: no encode, no
    evaluation, no walk dispatched, and no Evaluation left behind."""
    args = pair.args(FLAG_SETS[flags])
    cold = pair.port(args)

    def forbidden(*a, **k):
        raise AssertionError("a warm run reached the encode or the device")

    monkeypatch.setattr(port_backend, "_encode_docs", forbidden)
    monkeypatch.setattr(port_backend, "evaluate", forbidden)
    DISPATCH_COUNTERS["dispatches"] = 0
    seen = []
    real = port_backend.tpu_validate

    def recording(validate, *a):
        seen.append(validate)
        return real(validate, *a)

    monkeypatch.setattr(port_backend, "tpu_validate", recording)
    assert pair.port(args) == cold
    assert DISPATCH_COUNTERS["dispatches"] == 0
    assert seen and seen[0].last_evaluation is None


def test_one_changed_document_is_the_delta(pair):
    """A changed document is the only one encoded and dispatched; the
    `--delta-stats` line gives the partition, as in the JAX package."""
    args = pair.args(["-S", "all", "--delta-stats"])
    cold = pair.both(args)
    assert cold[2].endswith("result-cache: 0/15 docs cached, 15 dispatched\n")
    doc = pair.root / "data" / "t03.json"
    tpl = json.loads(doc.read_text())
    tpl["Resources"]["ChangedBucket"] = {"Type": "AWS::S3::Bucket", "Properties": {}}
    doc.write_text(json.dumps(tpl))
    seen = []
    real = port_backend.evaluate

    def recording(rule_files, docs, *a, **k):
        seen.append(len(docs))
        return real(rule_files, docs, *a, **k)

    pair.mp.setattr(port_backend, "evaluate", recording)
    got = pair.both(args)
    assert seen == [1]
    assert got[2].endswith("result-cache: 14/15 docs cached, 1 dispatched\n")
    off = pair.both(pair.args(["-S", "all"]), cache=False)
    assert (got[0], got[1]) == (off[0], off[1])


@pytest.mark.parametrize("spec", ["cache:nth=1", "store_write:nth=1", "cache:rate=0.5:seed=3"])
def test_fault_points_keep_the_unarmed_bytes(pair, monkeypatch, spec):
    """An injected fault in a lookup is a miss and in a store a warning:
    the output is the unarmed run's, cold and warm, in both packages."""
    args = pair.args(["-z", "-o", "json", "-S", "none"])
    unarmed = pair.both(args, cache=False)
    monkeypatch.setenv("GUARD_TPU_FAULT", spec)
    for _ in range(2):
        got = pair.both(args)
        assert (got[0], got[1]) == (unarmed[0], unarmed[1])
    assert port_faults.fault_stats()[f"injected_{spec.split(':')[0]}"] >= 1


@pytest.mark.parametrize("how", ["truncated", "not_json", "wrong_key", "wrong_schema"])
def test_corrupt_entry_is_a_miss_and_is_rewritten(pair, how):
    """A damaged entry is a logged miss: the document is computed again
    (the same bytes) and its entry written anew."""
    args = pair.args(["-S", "all"])
    cold = pair.port(args)
    key = pair.entries()[0]
    with sqlite3.connect(pair.dirs["port"] / port_results.DB_NAME) as conn:
        (blob,) = conn.execute("SELECT blob FROM entries WHERE key = ?", (key,)).fetchone()
    blob = bytes(blob).decode()
    doc = json.loads(blob)
    if how == "truncated":
        blob = blob[: len(blob) // 2]
    elif how == "not_json":
        blob = "[1, 2, 3]"
    elif how == "wrong_key":
        doc["key"] = "0" * 64
        blob = json.dumps(doc)
    else:
        doc["schema"] = port_results.RESULT_SCHEMA_VERSION + 1
        blob = json.dumps(doc)
    set_blob(pair.dirs["port"], key, blob.encode())
    port_results.reset_result_cache_stats()
    assert pair.port(args) == cold
    stats = port_results.result_cache_stats()
    assert stats["corrupt_entries"] == 1 and stats["misses"] == 1 and stats["stores"] == 1
    assert port_results.load_entries([(key, None)])[0] is not None
    port_results.reset_result_cache_stats()
    assert pair.port(args) == cold
    assert port_results.result_cache_stats()["hits"] == 15


def test_a_database_that_is_not_one_is_replaced(pair):
    """A cache file that is not a database is a miss for every document
    (no error, the same bytes), and the run's store starts it anew."""
    args = pair.args(["-S", "all"])
    cold = pair.port(args)
    (pair.dirs["port"] / port_results.DB_NAME).write_bytes(b"not a database" * 100)
    port_results.reset_result_cache_stats()
    assert pair.port(args) == cold
    stats = port_results.result_cache_stats()
    assert stats["misses"] == 15 and stats["hits"] == 0 and stats["stores"] == 15
    port_results.reset_result_cache_stats()
    assert pair.port(args) == cold
    assert port_results.result_cache_stats()["hits"] == 15


def test_changed_sources_are_a_miss(pair, monkeypatch):
    """The key holds the port's source digest: the same documents,
    rules and flags under changed sources replay nothing and are stored
    anew, with the same bytes."""
    args = pair.args(["-z", "-o", "json", "-S", "none"])
    cold = pair.port(args)
    before = pair.entries()
    monkeypatch.setattr(port_plan, "_SOURCE_DIGEST", "0" * 64)
    port_plan.clear_plan_memo()
    port_results.reset_result_cache_stats()
    assert pair.port(args) == cold
    stats = port_results.result_cache_stats()
    assert stats["hits"] == 0 and stats["misses"] == 15 and stats["stores"] == 15
    assert len(pair.entries()) == 30 and set(before) < set(pair.entries())


def test_one_read_and_one_write_a_run(pair, monkeypatch):
    """A run reads every entry in one batch and writes its delta in one
    transaction."""
    calls = []
    for name in ("load_entries", "store_entries"):
        real = getattr(port_results, name)
        monkeypatch.setattr(port_results, name,
                            lambda items, _r=real, _n=name: calls.append((_n, len(items)))
                            or _r(items))
    args = pair.args(["--statuses-only"])
    pair.port(args)
    pair.port(args)
    assert calls == [("load_entries", 15), ("store_entries", 15), ("load_entries", 15)]


def test_same_content_under_another_name(pair):
    """A copy of a document under a new name replays the portable entry
    with its own name, as in the JAX package."""
    args = pair.args(["-z", "-o", "json", "-S", "none"])
    pair.both(args)
    data = pair.root / "data"
    (data / "t99.json").write_text((data / "t02.json").read_text())
    got = pair.both(args)
    assert '"name": "t99.json"' in got[1]


def test_no_key_is_shared_between_the_cpu_and_the_card(monkeypatch):
    """The key goes through plan.plan_digest, which holds the device
    census: the CPU's entries and a card's never collide."""
    from guard_tpu_torch.commands.validate import RuleFile
    from guard_tpu_torch.core.parser import parse_rules_file

    text = "rule a { a exists }\n"
    rf = RuleFile(name="r.guard", full_name="r.guard", content=text,
                  rules=parse_rules_file(text, "r.guard"))
    doc = port_results.doc_digest('{"a": 1}')
    cfg = port_results.config_hash(mode="validate")
    port_plan.clear_plan_memo()
    cpu = port_results.result_key(port_plan.plan_digest([rf], "cpu"), doc, cfg)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    port_plan.clear_plan_memo()
    card = port_results.result_key(port_plan.plan_digest([rf], "cuda"), doc, cfg)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    port_plan.clear_plan_memo()
    four = port_results.result_key(port_plan.plan_digest([rf], "cuda"), doc, cfg)
    assert len({cpu, card, four}) == 3


def test_payload_and_input_params_bypass_the_cache(pair, tmp_path):
    """Merged and stdin documents are not content-addressable files:
    neither package stores them."""
    params = tmp_path / "params.json"
    params.write_text('{"extra": 1}')
    pair.both(pair.args(["-i", str(params)]))
    assert pair.entries() == [] and pair.entries("jax") == []


def test_default_directory_is_the_ports(monkeypatch, tmp_path):
    monkeypatch.delenv("GUARD_TPU_RESULT_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert port_results.result_cache_dir() == (
        tmp_path / "home" / ".cache" / "guard_tpu_torch" / "results")


def test_a_warm_run_imports_no_jax(tmp_path):
    """A process that runs cold and then warm imports no JAX and no
    module of the JAX package."""
    root = write_fixture(tmp_path)
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        "from guard_tpu_torch.utils.io import Writer\n"
        f"args = ['validate', '--device', 'cpu', '-r', {str(root / 'rules')!r},\n"
        f"        '-d', {str(root / 'data')!r}]\n"
        "rcs = [cli.run(args, writer=Writer.buffered()) for _ in range(2)]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'guard_tpu'))\n"
        "print('RESULT', rcs, bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(GUARD_TPU_RESULT_CACHE_DIR=str(tmp_path / "rc"), GUARD_TPU_INGEST_WORKERS="0",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")]
    assert line == ["RESULT [19, 19] []"], proc.stderr[-2000:]
    assert len(db_keys(tmp_path / "rc")) == 15

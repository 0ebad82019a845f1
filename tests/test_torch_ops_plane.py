"""The port's operations plane on the CPU: the run ledger
(guard_tpu_torch/utils/ledger.py and cli._session_epilogue), `report`
(commands/ops_report.py) and `gc` (commands/gc.py).

`report` must print the JAX package's bytes on the same ledger file;
the ledger's records keep the JAX layout with the port's version and
device census; `gc` evicts the oldest entries of the port's three
stores (plan artifacts, the result database, the journals) and always
exits 0.
"""

import json
import os
import pathlib
import sqlite3
import subprocess
import sys
import time

import pytest

from guard_tpu import cli as jax_cli
from guard_tpu.utils import ledger as jax_ledger
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import __version__
from guard_tpu_torch import cli as port_cli
from guard_tpu_torch.cache import results as port_results
from guard_tpu_torch.commands import gc as port_gc
from guard_tpu_torch.utils import faults as port_faults
from guard_tpu_torch.utils import ledger
from guard_tpu_torch.utils import telemetry
from guard_tpu_torch.utils.io import Writer
from guard_tpu_torch.utils.telemetry import PIPELINE_COUNTERS
from guard_tpu_torch.parallel.device import EFFICIENCY_COUNTERS
from test_torch_reports import write_fixture

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(tmp_path / "results"))
    monkeypatch.setenv("GUARD_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    monkeypatch.delenv("GUARD_TPU_FAULT", raising=False)
    monkeypatch.delenv("GUARD_TPU_LEDGER_DIR", raising=False)
    port_faults.reset_faults()
    telemetry.reset_metrics()


def gc_stats() -> dict:
    return telemetry.REGISTRY.group_stats("gc")


# -- ledger records ---------------------------------------------------
def test_record_layout_is_the_jax_packages_with_the_ports_version():
    rec = ledger.build_record("sweep", headline={"metric": "m", "value": 1.5, "unit": "s"},
                              config={"b": 1, "a": 2}, exit_code=19)
    want = jax_ledger.build_record("sweep", headline={"metric": "m", "value": 1.5, "unit": "s"},
                                   config={"a": 2, "b": 1}, exit_code=19)
    assert list(rec) == list(want) == list(ledger.RECORD_KEYS)
    assert rec["config_hash"] == want["config_hash"]
    assert rec["guard_tpu_version"] == __version__
    assert rec["device_census"] == {"backend": "cpu", "device_count": 1}
    assert ledger.check_record(rec) == [] == jax_ledger.check_record(rec)
    assert ledger.LEDGER_SCHEMA_VERSION == jax_ledger.LEDGER_SCHEMA_VERSION


@pytest.mark.parametrize("mutate,problem", [
    (lambda r: r.pop("kind"), "missing key 'kind'"),
    (lambda r: r.update(schema_version=9), "schema_version 9 != 1"),
    (lambda r: r.update(kind="serve2"), "unknown kind 'serve2'"),
    (lambda r: r.update(ts="now"), "ts is not numeric"),
    (lambda r: r.update(device_census={"backend": "cuda"}), "device_census must carry"),
    (lambda r: r.update(headline={"metric": 1}), "headline must be null or"),
    (lambda r: r.update(extra=[]), "extra is not an object"),
])
def test_check_record_names_the_problem(mutate, problem):
    rec = ledger.build_record("validate", capture_metrics=False)
    mutate(rec)
    got = ledger.check_record(rec)
    assert got == jax_ledger.check_record(rec)
    assert any(problem in p for p in got)


def test_append_and_read_round_trip(tmp_path):
    path = str(tmp_path / "l" / "ledger.jsonl")
    recs = [ledger.append_record("bench", headline={"metric": "x", "value": v, "unit": "docs/s"},
                                 path=path, capture_metrics=False) for v in (1, 2)]
    assert ledger.read_ledger(path) == recs
    with open(path, "a") as f:
        f.write("{torn\n")
    with pytest.raises(ValueError, match="ledger.jsonl:3: corrupt ledger line"):
        ledger.read_ledger(path)


def test_append_is_opt_in(tmp_path):
    assert not ledger.ledger_enabled()
    assert ledger.append_record("validate") is None


def test_store_write_fault_drops_the_record(tmp_path, monkeypatch):
    monkeypatch.setenv("GUARD_TPU_FAULT", "store_write:nth=1")
    path = tmp_path / "ledger.jsonl"
    assert ledger.append_record("validate", path=str(path)) is None
    assert not path.exists()
    assert port_faults.fault_stats()["injected_store_write"] == 1


@pytest.mark.parametrize("values,unit,status", [
    ([100, 110, 105, 80], "docs/s", "regressed"),
    ([100, 110, 105, 100], "docs/s", "ok"),
    ([2.0, 1.8, 1.9, 2.5], "seconds", "regressed"),
    ([2.0, 1.8, 1.9, 1.9], "seconds", "ok"),
    ([5.0], "seconds", "insufficient"),
])
def test_regression_check_matches_jax(values, unit, status):
    recs = [ledger.build_record("bench", headline={"metric": "m", "value": v, "unit": unit},
                                capture_metrics=False) for v in values]
    got = ledger.regression_check(recs, "m")
    assert got == jax_ledger.regression_check(recs, "m")
    assert got["status"] == status


def test_diff_records_matches_jax():
    a = ledger.build_record("sweep", headline={"metric": "m", "value": 2.0, "unit": "seconds"},
                            config={"x": 1})
    PIPELINE_COUNTERS["chunks_prefetched"] += 3
    b = ledger.build_record("sweep", headline={"metric": "m", "value": 3.0, "unit": "seconds"},
                            config={"x": 1})
    got = ledger.diff_records(a, b)
    assert got == jax_ledger.diff_records(a, b)
    assert got["headline_ratio"] == 1.5 and got["same_config"]
    assert got["counters"]["pipeline.chunks_prefetched"] == {"a": 0, "b": 3}


def test_backfill_matches_the_jax_tool(tmp_path):
    """The port's backfill of the committed bench artifacts writes the
    JAX tool's records, less the version and the census."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from perf_ledger import backfill as jax_backfill
    finally:
        sys.path.remove(str(ROOT / "tools"))
    arts = sorted(ROOT.glob("bench_all_r1*.json"))[:3]
    n = ledger.backfill(arts, ledger_file=str(tmp_path / "port.jsonl"))
    assert n == jax_backfill(arts, ledger_file=str(tmp_path / "jax.jsonl")) > 0
    port = ledger.read_ledger(str(tmp_path / "port.jsonl"))
    jax = jax_ledger.read_ledger(str(tmp_path / "jax.jsonl"))
    for p, j in zip(port, jax):
        assert {k: v for k, v in p.items() if k not in ("guard_tpu_version", "device_census")} \
            == {k: v for k, v in j.items() if k not in ("guard_tpu_version", "device_census")}


# -- report -----------------------------------------------------------
def write_ledger(path: pathlib.Path, kinds=("validate", "sweep", "sweep")) -> None:
    """Records of both packages' writers: session records with counter
    snapshots, a resumed and a drained sweep, efficiency counters."""
    for i, kind in enumerate(kinds):
        telemetry.reset_metrics()
        EFFICIENCY_COUNTERS["docs_real"] = 100 * (i + 1)
        EFFICIENCY_COUNTERS["pack_rule_slots_used"] = 253
        EFFICIENCY_COUNTERS["pack_rule_slots_capacity"] = 512
        port_results.RESULT_COUNTERS["hits"] = 7 * i
        port_results.RESULT_COUNTERS["misses"] = 3
        extra = {"delta_docs": 3, "total_docs": 10, "delta_fraction": 0.3}
        if kind == "sweep" and i == 1:
            extra.update(resumed_from="ab" * 32, chunks_replayed=8)
        if kind == "sweep" and i == 2:
            extra["drained"] = True
        writer = jax_ledger if i % 2 else ledger
        writer.append_record(kind, headline={"metric": f"{kind}_session_seconds",
                                             "value": 1.25 + i, "unit": "seconds"},
                             config={"rules": ["r"], "i": i % 2}, exit_code=19,
                             extra=extra, ts=1_700_000_000 + i, path=str(path))


def run_report(args):
    outs = []
    for cli, w in ((jax_cli, JaxWriter.buffered()), (port_cli, Writer.buffered())):
        rc = cli.run(["report", *args], writer=w)
        outs.append((rc, w.stripped(), w.err_to_stripped()))
    return outs


@pytest.mark.parametrize("case", ["diff", "efficiency", "check_ok", "check_missing",
                                  "baseline", "window_1", "one_record", "empty", "absent",
                                  "corrupt", "malformed", "check_regressed"])
def test_report_matches_jax_bytes(tmp_path, case):
    path = tmp_path / "ledger.jsonl"
    args = ["--ledger", str(path)]
    write_ledger(path)
    if case == "efficiency":
        args.append("--efficiency")
    elif case == "check_ok":
        args += ["--check", "sweep_session_seconds", "--tolerance", "0.9"]
    elif case == "check_regressed":
        args += ["--check", "sweep_session_seconds", "--tolerance", "0.05"]
    elif case == "check_missing":
        args += ["--check", "no_such_metric"]
    elif case == "baseline":
        base = tmp_path / "base.jsonl"
        write_ledger(base, kinds=("sweep",))
        args += ["--baseline", str(base)]
    elif case == "window_1":
        args += ["--check", "sweep_session_seconds", "--window", "1"]
    elif case == "one_record":
        path.write_text(path.read_text().splitlines()[0] + "\n")
    elif case == "empty":
        path.write_text("")
    elif case == "absent":
        path.unlink()
    elif case == "corrupt":
        with path.open("a") as f:
            f.write("{nope\n")
    elif case == "malformed":
        with path.open("a") as f:
            f.write(json.dumps({"kind": "sweep"}) + "\n")
    jax, port = run_report(args)
    assert port == jax
    want_rc = {"diff": 0, "efficiency": 0, "check_ok": 0, "check_regressed": 19,
               "baseline": 0, "window_1": 19}.get(case, 5)
    assert port[0] == want_rc


def test_report_reads_the_ledger_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("GUARD_TPU_LEDGER_DIR", str(tmp_path))
    write_ledger(tmp_path / "ledger.jsonl")
    jax, port = run_report([])
    assert port == jax and "resume rate: 50.0% (1/2 sweep sessions resumed, 8 chunks" in port[1]


# -- the session epilogue ---------------------------------------------
def test_sessions_append_records(tmp_path, monkeypatch):
    """validate and sweep each append one record: the port's version
    and census, the session's seconds, the cache's delta fraction."""
    root = write_fixture(tmp_path)
    monkeypatch.setenv("GUARD_TPU_LEDGER_DIR", str(tmp_path / "ledger"))
    args = ["-r", str(root / "rules"), "-d", str(root / "data")]
    assert port_cli.run(["validate", "--device", "cpu", *args],
                        writer=Writer.buffered()) == 19
    assert port_cli.run(["sweep", "--device", "cpu", "-M", str(tmp_path / "m.jsonl"), *args],
                        writer=Writer.buffered()) == 19
    assert port_cli.run(["report", "--efficiency"], writer=Writer.buffered()) == 0
    recs = ledger.read_ledger()
    assert [r["kind"] for r in recs] == ["validate", "sweep"]
    for rec in recs:
        assert ledger.check_record(rec) == []
        assert rec["guard_tpu_version"] == __version__ and rec["exit_code"] == 19
        assert rec["headline"]["metric"] == f"{rec['kind']}_session_seconds"
        assert rec["extra"]["total_docs"] == 15
        assert rec["metrics"]["schema_version"] == telemetry.SCHEMA_VERSION
    assert recs[1]["metrics"]["counters"]["pipeline"]["chunks_prefetched"] == 0


def test_resumed_and_drained_sessions_are_marked(tmp_path, monkeypatch):
    from guard_tpu_torch.utils import journal as jn

    root = write_fixture(tmp_path)
    monkeypatch.setenv("GUARD_TPU_LEDGER_DIR", str(tmp_path / "ledger"))
    argv = ["sweep", "--device", "cpu", "--no-result-cache", "-c", "4", "-r",
            str(root / "rules"), "-d", str(root / "data"), "-M", str(tmp_path / "m.jsonl")]
    monkeypatch.setenv("GUARD_TPU_FAULT", "journal:nth=3")
    assert port_cli.run(argv, writer=Writer.buffered()) == 5
    monkeypatch.delenv("GUARD_TPU_FAULT")
    (tmp_path / "m.jsonl").unlink()
    assert port_cli.run([*argv, "--resume"], writer=Writer.buffered()) == 19
    (tmp_path / "m.jsonl").unlink()
    orig = jn.DrainLatch.tripped
    monkeypatch.setattr(jn.DrainLatch, "tripped", lambda self: True)
    assert port_cli.run([*argv, "--no-journal"], writer=Writer.buffered()) == 75
    monkeypatch.setattr(jn.DrainLatch, "tripped", orig)
    recs = ledger.read_ledger()
    assert [r["exit_code"] for r in recs] == [5, 19, 75]
    assert recs[1]["extra"]["chunks_replayed"] == 2 and len(recs[1]["extra"]["resumed_from"]) == 64
    assert recs[2]["extra"]["drained"] is True
    jax, port = run_report([])
    assert port == jax and "drained sessions: 1" in port[1]


# -- gc ---------------------------------------------------------------
def age(path: pathlib.Path, seconds_ago: float) -> None:
    t = time.time() - seconds_ago
    os.utime(path, (t, t))


def fill_file_stores(tmp_path):
    plans, journal = tmp_path / "plans", tmp_path / "journal"
    plans.mkdir()
    journal.mkdir()
    for i in range(4):
        for p in (plans / f"p{i}.plan", journal / f"j{i}.journal.jsonl"):
            p.write_bytes(b"x" * 1000)
            age(p, 1000 - i * 100)  # p0 oldest
    (plans / "p1.sigs.json").write_bytes(b"s" * 100)
    age(plans / "p1.sigs.json", 850)
    (plans / "notes.txt").write_text("not an entry")
    return plans, journal


def store_results(n, blob_bytes=2000):
    entries = [(f"key{i:03d}", {"name": f"d{i}", "sweep": {"status": "pass", "fails": []},
                                "pad": "p" * blob_bytes}) for i in range(n)]
    assert port_results.store_entries(entries) == n


def run_gc(*args):
    w = Writer.buffered()
    rc = port_cli.run(["gc", *args], writer=w)
    assert rc == 0 and w.err_to_stripped() == ""
    return json.loads(w.stripped())


def test_gc_evicts_the_oldest_files_first(tmp_path):
    plans, journal = fill_file_stores(tmp_path)
    got = run_gc("--max-bytes", "2500")
    assert got["max_bytes"] == 2500 and got["dry_run"] is False
    assert got["gc"]["plan"] == {"dir": str(plans), "bytes_before": 4100, "bytes_after": 2100,
                                 "evicted": 2, "tmps_reaped": 0}
    assert sorted(p.name for p in plans.iterdir()) == [
        "notes.txt", "p1.sigs.json", "p2.plan", "p3.plan"]
    assert sorted(p.name for p in journal.iterdir()) == ["j2.journal.jsonl", "j3.journal.jsonl"]
    assert gc_stats()["files_evicted"] == 4 and gc_stats()["runs"] == 1


def test_gc_dry_run_deletes_nothing(tmp_path):
    plans, _journal = fill_file_stores(tmp_path)
    store_results(20)
    before = sorted(p.name for p in plans.iterdir())
    rows = len(port_results.load_entries([(f"key{i:03d}", None) for i in range(20)]))
    got = run_gc("--max-bytes", "0", "--dry-run")
    assert got["dry_run"] is True and got["gc"]["plan"]["evicted"] == 5
    assert got["gc"]["result"]["evicted"] == 20 and got["gc"]["result"]["bytes_after"] == 0
    assert sorted(p.name for p in plans.iterdir()) == before and rows == 20
    assert all(port_results.load_entries([(f"key{i:03d}", None) for i in range(20)]))
    assert gc_stats()["files_evicted"] == 0


def test_gc_evicts_the_oldest_result_rows(tmp_path):
    """Rows leave in rowid order; a rewritten entry (INSERT OR REPLACE)
    is new again."""
    store_results(30)
    store_results(1)  # key000 rewritten: now the newest row
    db = port_results.db_path()
    size = db.stat().st_size
    got = run_gc("--max-bytes", str(size // 2))
    res = got["gc"]["result"]
    assert res["bytes_before"] == size and 0 < res["bytes_after"] <= size // 2
    with sqlite3.connect(db) as conn:
        kept = sorted(k for (k,) in conn.execute("SELECT key FROM entries"))
    assert res["evicted"] == 30 - len(kept) > 0
    assert "key000" in kept and "key001" not in kept
    assert kept[-1] == "key029"


def test_gc_cap_zero_empties_every_store(tmp_path):
    fill_file_stores(tmp_path)
    store_results(5)
    got = run_gc("--max-bytes", "0")
    assert all(s["bytes_after"] == 0 for s in got["gc"].values())
    assert not port_results.db_path().exists()


def test_gc_reaps_only_aged_orphan_tmps(tmp_path):
    plans, journal = fill_file_stores(tmp_path)
    old, young = plans / "x.plan.tmp.123", journal / "j.tmp.456"
    old.write_bytes(b"o")
    young.write_bytes(b"y")
    age(old, 3600)
    got = run_gc()
    assert got["gc"]["plan"]["tmps_reaped"] == 1 and got["gc"]["journal"]["tmps_reaped"] == 0
    assert not old.exists() and young.exists()
    assert got["gc"]["plan"]["evicted"] == 0 and gc_stats()["orphan_tmps_reaped"] == 1


def test_gc_evicts_a_corrupt_database_whole(tmp_path):
    results = tmp_path / "results"
    results.mkdir()
    port_results.db_path().write_bytes(b"this is not a database" * 100)
    got = run_gc("--max-bytes", "10")
    assert got["gc"]["result"]["evicted"] == 1 and not port_results.db_path().exists()


def test_gc_undeletable_entry_is_counted_and_exits_0(tmp_path, monkeypatch):
    plans, _journal = fill_file_stores(tmp_path)
    real = pathlib.Path.unlink

    def unlink(self, *a, **k):
        if self.name == "p0.plan":
            raise PermissionError("read-only")
        return real(self, *a, **k)

    monkeypatch.setattr(pathlib.Path, "unlink", unlink)
    got = run_gc("--max-bytes", "2500")
    assert (plans / "p0.plan").exists() and gc_stats()["evict_errors"] == 1
    assert got["gc"]["plan"]["bytes_after"] <= 2500 + 1000


def test_gc_default_cap_and_missing_stores(tmp_path):
    got = run_gc()
    assert got["max_bytes"] == port_gc.cache_max_bytes() == 1 << 30
    assert all(s["bytes_before"] == 0 and s["evicted"] == 0 for s in got["gc"].values())


def test_gc_default_dirs_are_the_ports(monkeypatch):
    for name in ("GUARD_TPU_PLAN_CACHE_DIR", "GUARD_TPU_RESULT_CACHE_DIR", "GUARD_TPU_JOURNAL_DIR"):
        monkeypatch.delenv(name)
    dirs = {name: d for name, d, _pat in port_gc._store_dirs()}
    assert all(d.parts[-3:-1] == (".cache", "guard_tpu_torch") for d in dirs.values())


def test_report_and_gc_import_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from guard_tpu_torch import cli\n"
        f"assert cli.run(['gc', '--dry-run']) == 0\n"
        f"assert cli.run(['report', '--ledger', {str(tmp_path / 'none.jsonl')!r}]) == 5\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'guard_tpu' or m.startswith('guard_tpu.') or m == 'torch']\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, GUARD_TPU_JOURNAL_DIR=str(tmp_path / "j"),
               GUARD_TPU_RESULT_CACHE_DIR=str(tmp_path / "r"),
               GUARD_TPU_PLAN_CACHE_DIR=str(tmp_path / "p"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

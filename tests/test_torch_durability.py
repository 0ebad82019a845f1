"""The port's durability plane (guard_tpu_torch/utils/journal.py and the
journal half of commands/sweep.py) against the JAX package's, on the CPU.

Journal units (the run key, torn and mismatched journals), a crash at a
chunk's checkpoint (the `journal` fault point) and `--resume`, the
drain latch and its exit code 75, and the journal's degradation on a
store that cannot be written. Resume legs compared with the JAX package
run it with `--ingest-workers 0`: its pipelined path assigns its own
chunk count to `evaluated` on a resume (guard_tpu/commands/sweep.py:365)
and drops the replayed chunks, which the port counts (a test below shows
both). Bytes are compared exactly.
"""

import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys

import pytest

from guard_tpu.commands.sweep import Sweep as JaxSweep
from guard_tpu.utils import journal as jax_jn
from guard_tpu.utils.faults import reset_faults as jax_reset_faults
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch.commands.sweep import Sweep
from guard_tpu_torch.ops import plan as port_plan
from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS
from guard_tpu_torch.utils import journal as jn
from guard_tpu_torch.utils import telemetry
from guard_tpu_torch.utils.faults import reset_faults
from guard_tpu_torch.utils.io import Reader, Writer
from test_torch_sweep import fixture_pair
from test_torch_ingest import set_encoders

ROOT = pathlib.Path(__file__).resolve().parent.parent

RULES = (
    "let b = Resources.*[ Type == 'AWS::S3::Bucket' ]\n"
    "rule sse when %b !empty { %b.Properties.Enc == true }\n"
)
# EMPTY on an int raises in the oracle: the document's stderr line
# re-emits on every run, so a replay must reproduce it from the journal
RULES_ERR = "rule em { Resources.R1.Properties.X !empty }\n"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_SWEEP_JOURNAL", "GUARD_TPU_SWEEP_RESUME",
                 "GUARD_TPU_LEDGER_DIR"):
        monkeypatch.delenv(name, raising=False)
    set_encoders(monkeypatch, None, tmp_path)
    port_plan.clear_plan_memo()
    telemetry.reset_metrics()
    yield
    port_plan.clear_plan_memo()


def resume_stats() -> dict:
    return telemetry.REGISTRY.group_stats("resume")


def mk_corpus(tmp_path, n=12, fail=(3,), err=(), rules=RULES):
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    rp = tmp_path / "rules.guard"
    rp.write_text(rules)
    for i in range(n):
        doc = {"Resources": {f"b{i}": {"Type": "AWS::S3::Bucket",
                                        "Properties": {"Enc": i not in fail}}}}
        if i in err:
            doc["Resources"]["R1"] = {"Properties": {"X": 7}}
        (data / f"d{i:02d}.json").write_text(json.dumps(doc))
    return [str(rp)], data


def port_sweep(rules, data, manifest, **kw):
    kw.setdefault("chunk_size", 4)
    kw.setdefault("result_cache", False)
    kw.setdefault("ingest_workers", 0)
    w = Writer.buffered()
    cmd = Sweep(rules=rules, data=[str(data)], manifest=str(manifest), device="cpu", **kw)
    rc = cmd.execute(w, Reader.from_string(""))
    return rc, w.out.getvalue(), w.err.getvalue()


def jax_sweep(rules, data, manifest, **kw):
    kw.setdefault("chunk_size", 4)
    kw.setdefault("result_cache", False)
    kw.setdefault("ingest_workers", 0)
    w = JaxWriter.buffered()
    cmd = JaxSweep(rules=rules, data=[str(data)], manifest=str(manifest), backend="tpu", **kw)
    rc = cmd.execute(w, JaxReader.from_string(""))
    return rc, w.out.getvalue(), w.err.getvalue()


# -- the run key ------------------------------------------------------
class _RF:
    def __init__(self, content):
        self.content = content


def _key(tmp_path, rules=RULES, docs=("{}", '{"x": 1}'), order=(0, 1), cfg="cfg0",
         census="cudaxH100x1", source="src0"):
    paths = []
    for i in order:
        p = tmp_path / f"d{i}.json"
        p.write_text(docs[i])
        paths.append(p)
    return jn.run_key(jn.rules_digest([_RF(rules)]), jn.doc_manifest_digest(paths), cfg,
                      census, source=source)


@pytest.mark.parametrize("part", ["rules", "doc_content", "doc_order", "config",
                                  "source_digest", "device_census"])
def test_run_key_sensitive_to_every_part(tmp_path, part):
    base = _key(tmp_path)
    assert base == _key(tmp_path)
    changed = {
        "rules": {"rules": RULES + "\n# changed\n"},
        "doc_content": {"docs": ("{}", '{"x": 2}')},
        "doc_order": {"order": (1, 0)},
        "config": {"cfg": "cfg1"},
        "source_digest": {"source": "src1"},
        "device_census": {"census": "cpux1"},
    }[part]
    assert _key(tmp_path, **changed) != base


def test_run_key_holds_the_ports_source_digest(tmp_path, monkeypatch):
    """By default the key reads ops/plan.source_digest(): an edit to any
    of the port's sources turns every journal into a cold start."""
    paths = [tmp_path / "d.json"]
    paths[0].write_text("{}")
    args = (jn.rules_digest([_RF(RULES)]), jn.doc_manifest_digest(paths), "cfg", "cpux1")
    monkeypatch.setattr(port_plan, "_SOURCE_DIGEST", "a" * 64)
    first = jn.run_key(*args)
    assert first == jn.run_key(*args, source="a" * 64)
    monkeypatch.setattr(port_plan, "_SOURCE_DIGEST", "b" * 64)
    assert jn.run_key(*args) != first


def test_run_key_is_not_the_jax_packages(tmp_path):
    paths = [tmp_path / "d.json"]
    paths[0].write_text("{}")
    rules, docs = jn.rules_digest([_RF(RULES)]), jn.doc_manifest_digest(paths)
    assert rules == jax_jn.rules_digest([_RF(RULES)])
    assert jn.run_key(rules, docs, "cfg", "cpux1") != jax_jn.run_key(rules, docs, "cfg")


# -- journal files ----------------------------------------------------
def test_journal_round_trip():
    j = jn.SweepJournal("k1", 3)
    j.append_chunk(0, {"chunk": 0, "counts": {"pass": 1}}, "", {})
    j.append_chunk(2, {"chunk": 2, "counts": {"fail": 1}}, "err line\n", {"retries": 1})
    j.close()
    replay = jn.load_journal("k1", n_chunks=3)
    assert sorted(replay) == [0, 2]
    assert replay[2]["stderr"] == "err line\n" and replay[2]["faults"] == {"retries": 1}
    assert resume_stats()["chunks_journaled"] == 2


def test_journal_torn_tail_truncated():
    j = jn.SweepJournal("k2", 2)
    j.append_chunk(0, {"chunk": 0}, "", {})
    j.close()
    with jn.journal_path("k2").open("a") as f:
        f.write('{"kind": "chunk", "chunk": 1, "rec": {"chu')
    assert sorted(jn.load_journal("k2", n_chunks=2)) == [0]
    assert resume_stats()["torn_records_dropped"] == 1


def test_journal_garbage_mid_file_truncates_rest():
    j = jn.SweepJournal("k3", 3)
    j.append_chunk(0, {"chunk": 0}, "", {})
    j.close()
    with jn.journal_path("k3").open("a") as f:
        f.write("not json\n")
        f.write(json.dumps({"kind": "chunk", "chunk": 1, "rec": {"chunk": 1}}) + "\n")
    assert sorted(jn.load_journal("k3", n_chunks=3)) == [0]


@pytest.mark.parametrize("field,value", [("schema", 99), ("run_key", "other"), ("chunks", 7)])
def test_journal_header_mismatch_is_cold_start(field, value):
    j = jn.SweepJournal("k4", 2)
    j.append_chunk(0, {"chunk": 0}, "", {})
    j.close()
    path = jn.journal_path("k4")
    lines = path.read_text().splitlines()
    header = json.loads(lines[0])
    header[field] = value
    path.write_text("\n".join([json.dumps(header), *lines[1:]]) + "\n")
    assert jn.load_journal("k4", n_chunks=2) == {}


def test_journal_last_record_wins():
    j = jn.SweepJournal("k5", 1)
    j.append_chunk(0, {"chunk": 0, "v": 1}, "", {})
    j.append_chunk(0, {"chunk": 0, "v": 2}, "", {})
    j.close()
    assert jn.load_journal("k5", n_chunks=1)[0]["rec"]["v"] == 2


def test_default_journal_dir_is_the_ports(monkeypatch):
    monkeypatch.delenv("GUARD_TPU_JOURNAL_DIR")
    assert jn.journal_dir().parts[-3:] == (".cache", "guard_tpu_torch", "journal")


# -- crash and resume -------------------------------------------------
@pytest.mark.parametrize("port_workers", [0, 1])
@pytest.mark.parametrize("chunk,nth", [(3, 2), (3, 4), (5, 1)])
def test_crash_resume_matches_jax(tmp_path, monkeypatch, chunk, nth, port_workers):
    """Uninterrupted, then a run killed at chunk nth's checkpoint (the
    `journal` fault point: rc 5, the injected line), then --resume: the
    resumed run prints the uninterrupted run's stdout, stderr and
    manifest in both packages."""
    pair = fixture_pair(tmp_path, monkeypatch)
    flags = ["-c", str(chunk)]
    full = pair.both([*flags, "--ingest-workers", "0"])
    for who in ("jax", "port"):
        shutil.rmtree(tmp_path / f"{who}_journal")
    monkeypatch.setenv("GUARD_TPU_FAULT", f"journal:nth={nth}")
    j_crash = pair.jax([*flags, "--ingest-workers", "0"])
    p_crash = pair.port([*flags, "--ingest-workers", str(port_workers)])
    assert p_crash == j_crash
    assert p_crash[0] == 5 and p_crash[1] == ""
    assert p_crash[2].endswith(f"Error: injected journal fault (chunk{nth - 1})\n")
    monkeypatch.delenv("GUARD_TPU_FAULT")
    pair.manifest.write_bytes(j_crash[3])
    j_res = pair.jax([*flags, "--ingest-workers", "0", "--resume"], fresh_manifest=False)
    telemetry.reset_metrics()
    pair.manifest.write_bytes(p_crash[3])
    p_res = pair.port([*flags, "--ingest-workers", str(port_workers), "--resume"],
                      fresh_manifest=False)
    assert j_res == full
    assert p_res == full
    assert resume_stats()["chunks_replayed"] == nth - 1
    # a crash at the first checkpoint journaled nothing: a cold start
    assert resume_stats()["runs_resumed"] == (nth > 1)
    assert resume_stats()["stale_cold_starts"] == (nth == 1)


def test_pipelined_resume_keeps_evaluated(tmp_path, monkeypatch):
    """The documented contract: a resumed run's summary is the
    uninterrupted run's. The port keeps it on the pipelined path
    (--ingest-workers 1); the JAX package's prints only the chunks it
    evaluated after the resume there."""
    pair = fixture_pair(tmp_path, monkeypatch)
    flags = ["-c", "4", "--ingest-workers", "1"]
    full = pair.both(flags)
    for who in ("jax", "port"):
        shutil.rmtree(tmp_path / f"{who}_journal")
    monkeypatch.setenv("GUARD_TPU_FAULT", "journal:nth=3")
    crash = {"jax": pair.jax(flags), "port": pair.port(flags)}
    monkeypatch.delenv("GUARD_TPU_FAULT")
    pair.manifest.write_bytes(crash["jax"][3])
    j_res = pair.jax([*flags, "--resume"], fresh_manifest=False)
    pair.manifest.write_bytes(crash["port"][3])
    p_res = pair.port([*flags, "--resume"], fresh_manifest=False)
    assert p_res == full
    want = json.loads(full[1].splitlines()[-1])
    got_jax = json.loads(j_res[1].splitlines()[-1])
    assert want["evaluated"] == 4
    assert got_jax["evaluated"] == 2
    assert {**got_jax, "evaluated": 4} == want


def test_full_replay_launches_nothing(tmp_path):
    rules, data = mk_corpus(tmp_path)
    manifest = tmp_path / "m.jsonl"
    want = port_sweep(rules, data, manifest)
    manifest.unlink()
    DISPATCH_COUNTERS["dispatches"] = 0
    got = port_sweep(rules, data, manifest, resume=True)
    assert got == want
    assert DISPATCH_COUNTERS["dispatches"] == 0
    assert resume_stats()["chunks_replayed"] == 3


def test_resume_replays_journaled_stderr_like_jax(tmp_path, monkeypatch):
    rules, data = mk_corpus(tmp_path, err=(1, 6), rules=RULES_ERR)
    manifest = tmp_path / "m.jsonl"
    runs = {}
    for who, fn in (("jax", jax_sweep), ("port", port_sweep)):
        monkeypatch.setenv("GUARD_TPU_JOURNAL_DIR", str(tmp_path / f"{who}_journal"))
        manifest.unlink(missing_ok=True)
        full = fn(rules, data, manifest)
        manifest.unlink()
        monkeypatch.setenv("GUARD_TPU_FAULT", "journal:nth=3")
        jax_reset_faults()
        reset_faults()
        with pytest.raises(Exception, match="injected journal fault"):
            fn(rules, data, manifest)
        monkeypatch.delenv("GUARD_TPU_FAULT")
        resumed = fn(rules, data, manifest, resume=True)
        runs[who] = (full, resumed)
    assert runs["port"] == runs["jax"]
    full, resumed = runs["port"]
    assert resumed == full and full[0] == 5 and full[2].count("vs rules.guard") == 2


def test_stale_journal_is_a_cold_start(tmp_path):
    rules, data = mk_corpus(tmp_path)
    manifest = tmp_path / "m.jsonl"
    port_sweep(rules, data, manifest)
    (data / "d05.json").write_text('{"Resources": {}}')
    manifest.unlink()
    DISPATCH_COUNTERS["dispatches"] = 0
    got = port_sweep(rules, data, manifest, resume=True)
    assert got[0] == 19
    assert resume_stats()["stale_cold_starts"] == 1
    assert resume_stats()["chunks_replayed"] == 0
    assert DISPATCH_COUNTERS["dispatches"] >= 3


def test_no_journal_writes_nothing(tmp_path):
    rules, data = mk_corpus(tmp_path)
    port_sweep(rules, data, tmp_path / "m.jsonl", journal=False)
    assert not (tmp_path / "journal").exists()


def test_unwritable_journal_degrades_to_journal_off(tmp_path, monkeypatch):
    """A journal store that cannot be written (its directory is a file)
    logs once, counts a degradation and changes no byte of the run."""
    rules, data = mk_corpus(tmp_path)
    off = port_sweep(rules, data, tmp_path / "m0.jsonl", journal=False)
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where the journal directory should be")
    monkeypatch.setenv("GUARD_TPU_JOURNAL_DIR", str(blocker / "journal"))
    got = port_sweep(rules, data, tmp_path / "m1.jsonl")
    assert (got[0], got[2]) == (off[0], off[2])
    assert got[1].replace("m1.jsonl", "m0.jsonl") == off[1]
    assert resume_stats()["journal_degraded"] == 1


# -- the drain latch --------------------------------------------------
class _TripAfter(jn.DrainLatch):
    """A latch that trips itself after `n` polls."""

    def __init__(self, n):
        super().__init__()
        self._left = n

    def tripped(self) -> bool:
        if not self._ev.is_set():
            self._left -= 1
            if self._left < 0:
                self.trip("test")
        return super().tripped()


@pytest.mark.parametrize("workers", [0, 1])
def test_drain_finishes_the_chunk_then_exits_75(tmp_path, workers):
    rules, data = mk_corpus(tmp_path)
    manifest = tmp_path / "m.jsonl"
    full = port_sweep(rules, data, manifest, ingest_workers=workers)
    manifest.unlink()
    rc, out, _err = port_sweep(rules, data, manifest, ingest_workers=workers,
                               drain_latch=_TripAfter(1))
    assert rc == jn.DRAIN_EXIT_CODE == 75
    summary = json.loads(out.splitlines()[-1])
    assert summary["evaluated"] == 1 and summary["chunks"] == 3
    assert resume_stats()["drained_sessions"] == 1
    assert port_sweep(rules, data, manifest, ingest_workers=workers, resume=True) == full


def test_drain_matches_jax(tmp_path, monkeypatch):
    rules, data = mk_corpus(tmp_path)
    manifest = tmp_path / "m.jsonl"
    runs = {}
    for who, fn in (("jax", jax_sweep), ("port", port_sweep)):
        monkeypatch.setenv("GUARD_TPU_JOURNAL_DIR", str(tmp_path / f"{who}_journal"))
        manifest.unlink(missing_ok=True)
        drained = fn(rules, data, manifest, drain_latch=_TripAfter(2))
        runs[who] = (drained, manifest.read_bytes(), fn(rules, data, manifest, resume=True))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][0] == 75


def test_sigterm_mid_run_drains_and_resumes(tmp_path):
    """SIGTERM to a CLI process after its first manifest row: rc 75,
    then --resume prints the uninterrupted run's bytes."""
    rules, data = mk_corpus(tmp_path, n=20)
    manifest = tmp_path / "m.jsonl"
    base = ["sweep", "--device", "cpu", "--no-result-cache", "--ingest-workers", "0", "-c", "4",
            "-r", *rules, "-d", str(data), "-M", str(manifest)]
    env = dict(os.environ)
    # SIGTERM from inside the first checkpoint: the latch trips there
    code = (
        "import os, signal, sys\n"
        "from guard_tpu_torch import cli\n"
        "from guard_tpu_torch.commands import sweep\n"
        "orig = sweep.Sweep._checkpoint\n"
        "def hooked(self, *a):\n"
        "    orig(self, *a)\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "sweep.Sweep._checkpoint = hooked\n"
        "sys.exit(cli.run(sys.argv[1:]))\n"
    )
    drained = subprocess.run([sys.executable, "-c", code, *base], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
    assert drained.returncode == 75, drained.stderr
    assert len(manifest.read_text().splitlines()) == 1
    resumed = subprocess.run([sys.executable, "-m", "guard_tpu_torch", *base, "--resume"],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    manifest_resumed = manifest.read_bytes()
    manifest.unlink()
    env["GUARD_TPU_JOURNAL_DIR"] = str(tmp_path / "journal_full")
    full = subprocess.run([sys.executable, "-m", "guard_tpu_torch", *base], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert (resumed.returncode, resumed.stdout, resumed.stderr) == (
        full.returncode, full.stdout, full.stderr)
    assert manifest_resumed == manifest.read_bytes()


def test_sigterm_handler_trips_the_latch():
    latch = jn.DrainLatch()
    restore = jn.install_signal_drain(latch)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert latch.tripped() and latch.reason == "SIGTERM"
    finally:
        restore()


def test_install_signal_drain_restores_handlers():
    before = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    restore = jn.install_signal_drain(jn.DrainLatch())
    assert signal.getsignal(signal.SIGTERM) is not before[0]
    restore()
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before

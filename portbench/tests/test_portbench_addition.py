"""A later change adds a cell, a configuration, a generator and a
per-layer metric as new files plus BENCHMARK.json entries: the harness
finds them by name and runs them, and no file that was there changes."""

import hashlib
import json
import shutil

from portbench.harness import bench
from portbench.harness import spec as spec_mod
from portbench.tests.conftest import ROOT, tiny

GENERATOR = '''"""Tiny templates: one S3 bucket each."""
import json


def documents(config, rng, first, n):
    return [json.dumps({"Resources": {"b": {"Type": "AWS::S3::Bucket", "Properties": {
        "BucketName": f"tiny-{first + i}",
        "AccessControl": str(rng.choice(["Private", "PublicRead"]))}}}})
        for i in range(n)]
'''

METRIC = '''"""Documents of the window, as a count."""


def read(run):
    return float(run.docs)
'''


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_editing_any(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "build").symlink_to(ROOT / "build", target_is_directory=True)
    pkg = root / "portbench"
    before = digest(pkg)

    (pkg / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "generator": "tiny", "rules": "configs/secpol/rules",
        "fleet_documents": 1200, "reduced": ["fleet_documents"]}))
    (pkg / "traffic" / "tiny.py").write_text(GENERATOR)
    (pkg / "cells" / "tiny.sweep.json").write_text(json.dumps({
        "name": "tiny.sweep", "docs_per_invocation": 600, "pool_dirs": 2, "warm_docs": 600,
        "check_chunks": 1}))
    (pkg / "metrics" / "tiny_docs.py").write_text(METRIC)
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    bench_json["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                                  "file": "portbench/configs/tiny.json",
                                  "reduced": ["fleet_documents"], "why": "a test"})
    bench_json["workloads"].append({"name": "tiny.sweep", "config": "tiny",
                                    "traffic": "org_sweep", "chips": 1, "why": "a test"})
    bench_json["per_layer"].append({"name": "tiny_docs", "unit": "docs", "better": "higher",
                                    "source": "host_clock", "layer": "sweep",
                                    "moves": "card_ms_per_kdoc"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))

    spec = spec_mod.load(root, "tiny.sweep", pkg=pkg)
    assert [m.name for m in spec.per_layer][-1] == "tiny_docs"
    out = bench.run(tiny(spec, chunks=1), 77, 0.5, True, "cpu", workdir_root=str(tmp_path))
    assert out["correct"] is True
    assert out["metrics"]["tiny_docs"]["value"] == float(out["attempted"]) >= 600
    assert "dispatch_ms_per_kdoc" in out["metrics"]

    after = digest(pkg)
    assert {k: after[k] for k in before} == before

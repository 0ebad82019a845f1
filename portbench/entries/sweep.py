"""The entry the window drives: the port's `sweep` command.

Each invocation goes through `guard_tpu_torch.cli` as the command line
parses `sweep -r <rules dir> -d <documents dir> -M <manifest>`, in this
process, with every other setting at the user's default. Each gets
empty journal and result-cache directories of its own and starts
without the plan memo of the invocation before it, loading the plan
from its disk cache as a new process would, so each is a first sweep of
its documents. (A plan in memory gains the strings of every chunk it
relocates, so a memo kept across invocations grows from one to the
next.) What it prints (its stdout summary, its stderr, its exit code)
and the manifest it writes are what the check reads.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path


class Entry:
    def __init__(self, spec, workdir: Path, device: str):
        self.spec = spec
        self.workdir = workdir
        self.device = device
        self.rules_dir = spec.rules_dir()

    def prepare(self) -> None:
        """What installing the port does once: build its native encoder
        and oracle (g++, into the fixed build directory)."""
        from guard_tpu_torch.ops import native_encoder, native_oracle

        native_encoder.build_native()
        native_oracle.build_native()

    def invoke(self, label: str, docdir: Path) -> dict:
        from guard_tpu_torch import cli
        from guard_tpu_torch.ops.plan import clear_plan_memo
        from guard_tpu_torch.utils.io import Reader, Writer

        clear_plan_memo()
        store = self.workdir / "stores" / label
        store.mkdir(parents=True)
        os.environ["GUARD_TPU_JOURNAL_DIR"] = str(store / "journal")
        os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = str(store / "results")
        manifest = store / "manifest.jsonl"
        argv = ["sweep", "-r", str(self.rules_dir), "-d", str(docdir), "-M", str(manifest)]
        if self.device != "cuda":
            argv[1:1] = ["--device", self.device]
        argv += list(self.spec.traffic.get("args", ()))
        writer = Writer.buffered()
        t0 = time.perf_counter()
        rc = cli.run(argv, writer=writer, reader=Reader.from_string(""))
        seconds = time.perf_counter() - t0
        out = writer.stripped()
        summary = None
        if out.strip():
            try:
                summary = json.loads(out.splitlines()[-1])
            except json.JSONDecodeError:
                summary = None
        return {
            "label": label,
            "docdir": docdir,
            "rc": rc,
            "seconds": seconds,
            "summary": summary,
            "stderr": writer.err_to_stripped(),
            "manifest": manifest,
        }

    def chunks(self, inv: dict) -> list:
        """The invocation's answers chunk by chunk, from its manifest:
        each chunk's documents (sweep cuts the sorted documents in
        order), counts, failing documents with their failing rules, and
        errors."""
        names = sorted(p.name for p in Path(inv["docdir"]).iterdir())
        records = {}
        if inv["manifest"].exists():
            for line in inv["manifest"].read_text().splitlines():
                if line.strip():
                    rec = json.loads(line)
                    records[rec["chunk"]] = rec
        out, at = [], 0
        for ci in sorted(records):
            rec = records[ci]
            out.append({
                "docs": names[at: at + rec["files"]],
                "counts": rec["counts"],
                "failed": {f["data"]: f["rules"] for f in rec["failed"]},
                "errors": rec["errors"],
            })
            at += rec["files"]
        return out

    def documents(self, inv: dict) -> int:
        return sum(1 for _ in Path(inv["docdir"]).iterdir())

    def problems(self, inv: dict) -> list:
        """How an invocation fell short of a sweep that answers: its
        exit code, a summary missing or not counting every document, a
        quarantined document."""
        out = []
        if inv["rc"] not in (0, 19):
            out.append(f"exit code {inv['rc']}: {inv['stderr'][-2000:]}")
        s = inv["summary"]
        if s is None:
            return out + ["no summary line on stdout"]
        n = self.documents(inv)
        counted = sum(s["counts"].values())
        if s["documents"] != n or counted != n or s["evaluated"] != s["chunks"]:
            out.append(f"{s['documents']} documents, {counted} counted, {s['evaluated']} of "
                       f"{s['chunks']} chunks evaluated, for {n} files")
        if s.get("quarantined"):
            out.append(f"{len(s['quarantined'])} documents quarantined")
        return out

    def failed_documents(self, inv: dict) -> int:
        """Documents the invocation did not answer."""
        if inv["rc"] not in (0, 19) or inv["summary"] is None:
            return self.documents(inv)
        return len(inv["summary"].get("quarantined", ()))

    def ingest_pools(self) -> list:
        """(pool, workers) of the ingest pool the invocations started (a
        pipelined sweep's, which stays up for the next invocation)."""
        from guard_tpu_torch.parallel import ingest
        from guard_tpu_torch.utils.telemetry import PIPELINE_COUNTERS

        workers = ingest.resolve_ingest_workers(None)
        if workers < 2 or not PIPELINE_COUNTERS.get("chunks_prefetched"):
            return []
        pool = ingest.shared_pool(workers)
        return [(pool, workers)] if pool is not None else []

    def warm_workers(self, docdir: Path, docs: int = 64) -> None:
        """Give every ingest worker one chunk job of the warm-up's
        documents, so that none pays its first job's imports and loads in
        the window (the warm-up invocation reaches only as many workers
        as it has chunks)."""
        from guard_tpu_torch.parallel.ingest import _chunk_job
        from portbench.harness.pools import each_worker

        paths = [str(p) for p in sorted(Path(docdir).iterdir())[:docs]]
        for pool, workers in self.ingest_pools():
            each_worker(pool, workers, _chunk_job, (0, paths))

    def close(self) -> None:
        """Stop every process the invocations started."""
        from guard_tpu_torch.parallel import ingest

        ingest.close_shared_pools()

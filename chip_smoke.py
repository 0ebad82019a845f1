#!/usr/bin/env python3
"""Smoke run of the torch port (guard_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):

1. Card and build: print the card's name and power limit
   (nvidia-smi), build the seven CUDA kernels from
   guard_tpu_torch/csrc/guard_kernels.cu (K1-K3, K7) and
   guard_tpu_torch/csrc/guard_joins.cu (K4-K6) and the tape kernel
   from guard_tpu_torch/csrc/guard_walk.cu, one nvcc per source,
   started together, and beside them the native oracle
   (native/oracle.cpp, ops/native_oracle.build_native) and the native
   encoder (guard_tpu_torch/csrc/host/encoder.cpp,
   ops/native_encoder.build_native) with g++.
2. Kernels against their plain PyTorch versions on the card, on seeded
   inputs: K1-K3 at N in {64, 1024, 8192, 65536} with D chosen so each
   (D, N) int32 tensor holds at least 64 MB, K2 also at D 1 x N 65,536
   with S in {N, N + 1, (N + 1) * 5} (the one-document bucket), K4-K6 at
   N in {64, 1024, 65536} with 16 MB per (D, N) column, K4 also at D 1
   x N 65,536 with Ns in {N, 2N} and with every key equal, K3 at D x R
   x G x F in {1048576 x 64 x 41 x 1, 262144 x 256 x 130 x 4, 65536 x
   512 x 512 x 64, 1024 x 0 x 0 x 1} with and without unsure bits, K7 at
   D in {1, 4096, 65536, 1048576} x R in {1, 4, 5, 36, 37, 38, 39, 512,
   1024, 1028} (every R % 4, up to two column tiles) with n_valid in {0,
   D - 3, D} and statuses outside 0..2, K5 and K6 also at D 1 x N 65,536
   and with every key equal:
   outputs must be equal (exact integer results, tolerance 0); kernel
   and plain times are CUDA-event medians of 20 runs; a kernel's
   device time (`device_ms`) is that of 20 calls captured into one CUDA
   graph and replayed, without the wrapper's host cost.
3. The slice at real size, through the user's entry point
   (commands.validate.Validate, statuses-only): the 4-rule security
   policy over 65,536 seeded templates plus one 12,000-volume template
   (the 65,536-node bucket), with every kernel launch counter set to 0
   just before and read just after, encoded from document trees in
   this process (the tree encoder: the native encoder off,
   --ingest-workers 0). Statuses, unsure bits and rim blocks must equal
   a CPU evaluation of the same batch. Then the same files through the
   host ingest (phase `ingest`): the native encoder (i) in this
   process, the files read inside the run, (ii) over the auto count of
   ingest workers and (iii) over 4 workers (left out where the auto
   count is 4: a repeat of (ii)), both on the texts (i) read, counters
   set to 0 just before and read just after: statuses, unsure bits, rim
   blocks and stdout equal
   to the tree-encoder run's, launches equal to it (K1 84, K2 98, K3 2),
   each run's seconds per stage and peak host RSS printed; run (i) is
   traced as --trace-out and --metrics-out trace a run
   (cli.telemetry_export): the trace must be Chrome trace_event JSON on
   the lanes of telemetry._LANE_ORDER, the snapshot must pass
   guard_tpu_torch.tools.check_metrics_schema in a subprocess, and each
   stage's span total is printed; then path (ii) with one template
   made invalid JSON under --max-doc-failures 1 (rc 19, one `skipping
   ...: invalid JSON` line, the template absent from stdout, every
   other template's statuses as before) and, over the first 2,048
   templates, 0 (rc 5). Then the same 65,537 texts
   under this slice's flags (phase `flags`), every counter set to 0
   just before each run and read just after: (a) the result cache:
   the run with --no-result-cache, then in a fresh directory with
   --delta-stats cold (65,537 entries stored), warm (every document
   replayed: no evaluation, no kernel launch) and with one template's
   bytes changed (a delta of one document: K3 once), each with the
   no-cache run's stdout and rc, and their walls beside the no-cache
   run's; (b) --no-vector-rim: the same stdout, no K3 launch, 65,537
   documents materialized; (c) --mesh-shape 2x1 over the security
   policy and the flagship rules (one pack of two files), over the
   first 16,384 texts: the stdout and the launches of the same run
   without the flag (one card runs every shape unsharded). Then full
   reports of the first 8,192 of the same documents and the volume
   template (phase `report`, their trees reused)
   through Validate on the card without --statuses-only: (a) the
   single-line report (on the tree encoder) and (b) the structured
   JSON, with the native oracle built, each with every counter set to 0
   just before and read just after, and (a) again on ingest path (ii)
   over the same texts with no tree built, byte-identical to (a): rc
   19, the FAIL set
   of the statuses-only run, every
   report's rule statuses equal to the rim's, the first 2,048 reports
   equal to the CPU evaluator's (simplified_report_from_root), and at
   least one report built by the native oracle; then on the first 4,096
   templates (c) the same two runs with the native oracle off, whose
   reruns must go through the spawn pool, byte-identical to the first
   4,096 documents of (a) and (b), and (d) SARIF and JUnit, which must
   parse and equal the same runs on the CPU; then (e) the single-line
   run over all of them with the native oracle off, every FAIL rerun in
   the pool, byte-identical to (a). Then the
   cross-reference policy (workloads.XREF_RULES: query-RHS compares and
   `.%var` interpolation, kernels K4-K6) the same way over 16,384 seeded
   make_xref_template templates plus the volume template, with its own
   counters set to 0 just before and read just after, on the tree
   encoder, then on ingest path (ii) (DocBatch.struct_ids on the native
   batch), which must give the same statuses, unsure bits, rim blocks,
   stdout and launches (K1 174, K2 183, K3 3, K4 24, K5 3, K6 9).
   Neither may send a document to the CPU oracle. Then the backends off
   the device (phase `backends`): the first 2,048 security templates
   through Validate with --backend cpu, native and auto, `-S all` and
   `-z -o json -S none`: rc 19 and stdout byte-identical to the tpu
   run's (the JAX package's cpu and tpu runs agree on these flags);
   and -v and -p over 64 templates, cpu and native byte-identical.
   Then the function-variable policy
   (workloads.FNVAR_RULES: the rules of canonical_names.guard, a
   function let and an inline call, run through the walk's StepFnVar
   arm) the same way over 16,384 seeded make_fnvar_template templates,
   about 0.5 % of them holding a number with no exact device encoding,
   plus the volume template: the CPU oracle must rerun exactly those
   templates, and the per-rule statuses of 2,048 templates must equal
   the port's CPU evaluator (core/evaluator.eval_rules_file). Then the flagship
   rules over the example documents, and all 249 rules files of
   corpus/rules over the corpus's own test inputs, each on the card and
   on the CPU, exactly equal; then each of them through Validate over
   its own tests' inputs, the single-line report with `-S all` and the
   structured JSON, on the card and on the CPU, byte-equal. Then (phase
   `test`) `test --dir corpus/rules` through the port's CLI on the card
   and with --backend cpu, single-line, JSON and JUnit: equal stdout
   and rc, 249 files and 725 cases, no K3 launch.
   Then the registry (phase `packing`): all 249 corpus files over the
   corpus's 725 test inputs replicated in order to N_PACKING documents,
   through backend.evaluate packed and with packing off on the card and
   packed on the CPU, the counters set to 0 just before the packed run
   and read just after: 245 files in one pack of 253 rules, one walk and
   one K3 launch per (pack, bucket) against one per (file, bucket), and
   per file equal statuses, unsure bits, rim blocks and oracle
   documents; the pack's columnarization and walk; the CLI over every
   twelfth of the 725 inputs (`-S all`, `-z -o json -S none`) packed, --no-pack,
   --no-plan-cache and in a process that loads the plan artifact, each
   in a process of its own, all with the same stdout, stderr and rc;
   --statuses-only over N_PACKING_STATUSES documents, packed; and the
   fault legs over 16 inputs (dispatch:nth=1 and collect:nth=1 print the
   unarmed run's bytes and count a fallback, the unarmed run none;
   oracle:nth=1 with the native oracle off exits 5 with the injected
   line).
   Then `sweep` over the same registry (phase `sweep`): all 249 files
   over the first N_SWEEP (6,144) of the same documents written as
   files, in chunks of 1,024, ingest workers on auto: (a) a fresh run (new result-cache and
   journal directories), traced, its K3 launches one per (chunk,
   bucket); (b) --no-result-cache --no-journal --ingest-workers 0: (a)'s
   stdout, stderr and manifest; (c) a warm run over a new manifest: the
   same bytes, only the documents the cache never stores dispatched (an
   oracle pass that raised, a document the card does not hold), and a
   warm run over 1,024 stored documents launches nothing; (d)
   GUARD_TPU_FAULT=journal:nth=5 stops a run (rc 5), --resume replays 4
   chunks, launches K3 for the other 2 only and prints (a)'s bytes; (e)
   SIGTERM to a CLI process after its first manifest row: rc 75, and
   --resume prints (a)'s bytes; (f) --follow over 1,024 JSONL lines
   (envelopes, bare documents, 8 malformed): one result line per input
   line in order, and the counts and failures of the batch sweep over
   the same documents. Over the first 64 documents the card's bytes
   equal the plain kernels' (--device cpu) and its failing rules those
   of `--backend cpu` on every document that raised on neither, and (a)'s
   tallies equal those folded from --follow on the CPU over the 725
   distinct inputs.
   Then `serve` (phase `serve`, on the same registry files): (a) 256
   tagged requests from 16 client threads through Serve.handle_line,
   alternating the security policy and the cross-reference policy, two
   templates each, with coalescing on (and off over the first 64): every
   answer equals a fresh session's untagged one-at-a-time answer byte
   for byte, with
   fewer dispatches a request with coalescing on (p50/p99, dispatches a
   request, coalesced batches and the launches of K1-K6 printed); (b)
   the 249 files as the webhook registry of a `python -m
   guard_tpu_torch serve --listen 127.0.0.1:0 --rules ...` process: 32
   client threads POST 256 AdmissionReviews wrapping the corpus inputs
   in order, every 8th answer equal to a `--no-coalesce` session's, the
   metrics document read over HTTP, K3 once per dispatch; (c) a
   poisoned request among 15 clean peers answers its own code-5
   envelope and the peers are unchanged, and with
   GUARD_TPU_FAULT=serve_batch:nth=1 the group re-fires solo with the
   same bytes; (d) SIGTERM to (b)'s listener under load: exit 75, the
   requests in flight finish, and a stdio session drained with 48
   requests queued exits 75, the queued ones answering Draining;
   (e) a Lambda "documents" event on the card answers the session's
   bytes. Each leg prints one JSON line; no listener imports jax or
   guard_tpu (`-X importtime`).
   Then the multi-card half (phase `multicard`) over every visible card,
   or with one card over a list naming it twice (the slicing, the
   per-entry streams, the concatenation and the summed K7 counts still
   run; `cards_visible` and the list are printed on a line of their
   own): the registry's 249 files over 4,096 of its documents through
   backend.evaluate under --mesh-shape auto, RxC with a column per entry
   and the report path's rim profile, 2,048 slice templates through
   the sharded with_summary, `sweep --rule-shards 2` and `sweep
   --mesh-shape auto` over 1,024 registry documents, and
   dryrun_multichip, each equal to the unsharded run on one card
   (statuses, unsure bits, rim blocks, counts, stdout, stderr,
   manifest, rc); then `lint` over corpus/rules and `completions
   bash`.
   Then multi-process runs (phase `distributed`,
   parallel/distributed.py): the registry's pack (245 files, 253 rules)
   over N_DISTRIBUTED (8,192) of its documents, cut by process_bounds
   over max(2, min(4, cards)) rank processes (two on cuda:0 with one
   card) joined by gloo over an ephemeral port on 127.0.0.1, the
   kernels built and the plan saved before any rank starts; each rank
   encodes only its range and runs DistributedEvaluator.with_summary
   over its buckets on its card (K1, K2, K4, K5 in the walk, K7 once a
   bucket), its counters set to 0 just before and read just after,
   under a timeout, and imports no JAX: the concatenated statuses equal
   a one-process run of the same pack over the same documents in this
   process, every rank's all-reduced counts its counts, and the counts
   cover every (document, rule) pair. Each rank's walls, launches and
   the median time of the (3, R) all-reduce alone are printed.
   Then the per-rule summary (phase `summary`): the security policy over
   65,536 seeded templates plus the volume template, built in memory,
   encoded per bucket and counted by DeviceBatchEvaluator.with_summary
   (the walk, then K7) bucket by bucket, with every counter set to 0
   just before and read just after: K7 launches once per bucket, and
   the counts equal numpy's counts of the statuses with_summary returned
   and of the bucketed evaluation's statuses; the first 2,048 templates
   equal a CPU evaluation. Then the entry points (phase
   `entry`): guard_tpu_torch.entry.entry()'s forward against the CPU,
   and dryrun(). Then the kernel-vs-oracle differential fuzzer (phase
   `kernel_fuzz`, guard_tpu_torch/tools/kernel_fuzz.py) for 60 s from
   SEED: random rule files of the tagged grammar over random documents,
   every 17th trial one bucket-crossing document and every fifth a
   corpus rules file, each trial held card against CPU bit for bit
   (statuses, unsure bits, rim blocks, K7 counts), against the CPU
   oracle, against the native oracle (trials of small documents), and
   tiled to 1,100 rows against its untiled rows, every counter set to 0
   just before and read just after: no divergence, every kernel of
   K1-K7 launched, K3 in its block form and in another; its JSON line
   (trials, checked cells, tags, launches, each kernel's forms) is
   printed before the kernels line, and a divergence's reproducer lands
   in kernel_fuzz_crashes/.
4. The CLI: `python -m guard_tpu_torch validate --statuses-only` in a
   subprocess over one PASS and one FAIL template: rc 19 and the
   expected stdout bytes; then `validate -z -o json -S none` over the
   same two: rc 19 and the CPU evaluator's reports.
5. No JAX and no guard_tpu module was imported, and a worker of the
   oracle rerun pool and one of the ingest pool hold no torch, JAX or
   guard_tpu module.

The line before the last is a JSON object {"kernels": [...]} with each
kernel's launches (every kernel twice: at the main shape and at the
one-document 65,536-node bucket's heaviest shape; K3 also at the
registry pack's shape) on its main path
(K1-K3 the security policy's, K4-K6
the cross-reference policy's, K7 the summary's; every path's in
`launches_by_path`, the report phase's run (a), the packed
registry's, the sweep's run (a), the cache's three runs, the scalar rim's, the mesh's,
the `test` command's, serve's legs (a) and (b), the distributed
ranks' summed and the fuzzer's among them, and for K1 the launches made
by the StepFnVar arm), its error against the plain version, its
time (`ms`, host cost included, and `device_ms`, the card's alone), the
plain version's, the bound (bytes over the card's memory rate) and a
library call's time where one computes the same function (also both
ways). The tape kernel's two entries (`walk_segment`) hold the
heaviest level of the security policy's tape at D 1,023 x N 64 and at
the volume template alone in the 65,536-node bucket, replayed on the card up to that
level: the card's launch against the plain version on the same buffers
and workspace, and the bound from the bytes the level reads and writes;
its launches must be those of 10 levels a security walk and 13 a
cross-reference walk. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

These modes print one JSON line and skip the phases above:

    python3 chip_smoke.py --design-sweep [CHECKOUT]
    python3 chip_smoke.py --compare-designs OTHER_CHECKOUT
    python3 chip_smoke.py --phase serve
    python3 chip_smoke.py --phase multicard
    python3 chip_smoke.py --phase distributed
    python3 chip_smoke.py --phase kernel_fuzz [--fuzz-time S]

`--design-sweep` times K2, K4, K5, K6, K3 and K7 at the main path's
shapes (K3 and K7 also at their sweep shapes) through the public
wrappers of CHECKOUT's guard_tpu_torch (default: this one), K6 beside
scatter_reduce_, and, where CHECKOUT has the forced-form entries, each
K2 geometry and K3, K4, K5, K6 and K7 form at the shapes around the
launchers' thresholds. `--compare-designs` runs the
design sweep of OTHER_CHECKOUT (an older design, unpacked with `git
archive`) and of this checkout in turns, other, this, this, other, one
process each. `--phase serve` builds, then runs phase `serve` alone on
the registry's files (its legs' line, then the card); `--phase
multicard` and `--phase distributed` do the same for their phases, and
`--phase kernel_fuzz` for the fuzzer, S seconds long (default 60;
`--fuzz-time 420` is the nightly tier on the card).
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
N_TEMPLATES = 65536
N_VOLUMES = 12000
EXOTIC_SHARE = 0.005  # fnvar templates holding an integer beyond 64 bits
N_FNVAR_CHECK = 2048  # fnvar templates held against the CPU evaluator
SWEEP_N = (64, 1024, 8192, 65536)
SWEEP_BYTES = 64 << 20
JOIN_SWEEP_N = (64, 1024, 65536)
JOIN_SWEEP_BYTES = 16 << 20
WIDE_N = 65536  # the one-document bucket of the volume template
SUMMARY_SWEEP_D = (1, 4096, 65536, 1 << 20)
# every R % 4 (R 36-39), full packs (512) and a last tile of one word (1,028)
SUMMARY_SWEEP_R = (1, 4, 5, 36, 37, 38, 39, 512, 1024, 1028)
N_SUMMARY_CHECK = 2048  # summary templates held against the CPU
N_BACKEND = 2048  # templates of the backends phase
# depths cut from 65,536 to keep the smoke in its time limit beside
# phase `packing`: the fnvar and xref templates, and the slice
# templates the report phase reports (16,384, then 8,192 beside phase
# `serve`; each phase keeps the volume template as well)
N_FNVAR_TEMPLATES = 16384
N_XREF_TEMPLATES = 16384
N_REPORT_DOCS = 8192
N_VERBOSE = 64  # templates printed with -v and -p
QUARANTINE_DOC = 1234  # the template the quarantine runs make invalid JSON
# registry documents: the corpus's test inputs replicated in order. Cut
# from 65,536, the packed --statuses-only run (pass B's 249 files a
# document) from 8,192, and the CLI's plan-layer states from all 725
# inputs to every third: with the first two uncut the whole smoke took
# 1,344 s on a slow host, and 1,083 s with them cut, against the
# 1,200 s limit (PERF.md §6). Since phase `sweep` (140-195 s) joined
# the smoke, the CLI's states take every twelfth input and the
# statuses-only run 1,024 documents, and since phase `serve` (140 s)
# joined it (1,129 s in all, PERF.md §6) every forty-eighth input; and
# since phase `multicard` (25 s) joined it (1,079 s in all, PERF.md §6)
# 8,192 documents (PERF.md §4)
N_PACKING = 8192
N_PACKING_STATUSES = 1024
N_PACKING_CLI_STRIDE = 48
N_PACKING_FAULT = 16  # registry documents of the fault legs (inline oracle reruns)
# launches of the statuses-only runs on the tree encoder (the native
# buckets must give the same)
# (the tape kernel: 10 levels a walk of the security policy's tape, 13
# of the cross-reference policy's)
EXPECTED_LAUNCHES = {
    "security": {"gather_rows": 84, "segment_sum_rows": 98, "rim_reduce": 2,
                 "walk_segment": 20},
    "xref": {"gather_rows": 174, "segment_sum_rows": 183, "rim_reduce": 3,
             "set_count_rows": 24, "distinct_first_rows": 3, "seg_min_max_rows": 9,
             "walk_segment": 39},
}
# the ingest paths: (label, --ingest-workers)
INGEST_PATHS = (("i_inline", 0), ("ii_auto", None), ("iii_four", 4))
REPS = 20
SOURCES = {
    "gather_rows": "guard_tpu_torch/csrc/guard_kernels.cu",
    "segment_sum_rows": "guard_tpu_torch/csrc/guard_kernels.cu",
    "rim_reduce": "guard_tpu_torch/csrc/guard_kernels.cu",
    "set_count_rows": "guard_tpu_torch/csrc/guard_joins.cu",
    "distinct_first_rows": "guard_tpu_torch/csrc/guard_joins.cu",
    "seg_min_max_rows": "guard_tpu_torch/csrc/guard_joins.cu",
    "rule_summary": "guard_tpu_torch/csrc/guard_kernels.cu",
    "walk_segment": "guard_tpu_torch/csrc/guard_walk.cu",
}
REPLACES = {
    "gather_rows": "guard_tpu/ops/kernels.py:208",  # _parent_select (+ _select_at :349)
    "segment_sum_rows": "guard_tpu/ops/kernels.py:218",  # _count_children (+ :233, :287)
    "rim_reduce": "guard_tpu/ops/kernels.py:2015",  # rim_reduce via mesh._rim_device
    "set_count_rows": "guard_tpu/ops/kernels.py:926",  # _set_count_sorted (+ _runs :914, _in_set_sorted :967)
    "distinct_first_rows": "guard_tpu/ops/kernels.py:978",  # _distinct_first_sorted
    "seg_min_max_rows": "guard_tpu/ops/kernels.py:993",  # _seg_min_max_keys
    # _shared_evaluator_fns.summarize (:338-349) via with_summary (:540)
    "rule_summary": "guard_tpu/parallel/mesh.py:338",
    # run_step's arms (:359-613) and the eval_* combinators (:1619-1910),
    # recorded from the torch walk and run a dataflow level a launch
    "walk_segment": "guard_tpu/ops/kernels.py:359",
}
JOINS = ("set_count_rows", "distinct_first_rows", "seg_min_max_rows")
# the kernels of the walk and the rim; K7 runs only behind with_summary
WALK_KERNELS = tuple(name for name in SOURCES if name != "rule_summary")
# the form a K4-K6 launch shape takes (0: tables in global memory)
BRANCH = {
    "set_count_rows": lambda lib, shape: lib.guard_set_count_branch(shape[0], shape[2]),
    "distinct_first_rows": lambda lib, shape: lib.guard_distinct_first_branch(*shape),
    "seg_min_max_rows": lambda lib, shape: lib.guard_seg_min_max_branch(*shape),
}


def check(ok, msg: str) -> None:
    """Fail the run (unlike `assert`, this holds under `python -O`)."""
    if not ok:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    """Peak device-memory rate from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    return 3.35e12  # H100 SXM


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int = REPS) -> float:
    """Device time of one call without its host cost: `reps` calls
    captured into one CUDA graph, the graph replayed between CUDA events,
    the median of 5 replays divided by `reps`. For the kernel wrappers
    only: a plain version that waits on the card cannot be captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# seeded kernel inputs
# ---------------------------------------------------------------------------


def tree_rows(gen, d: int, n: int, device, fill: float = 0.9):
    """(D, N) int32 parent columns of random trees: node 0 is the root
    (-1), node i > 0 has a parent in [0, i), and the last ~10% of each
    row is padding (-1), as the encoder lays documents out."""
    import torch

    i = torch.arange(n, device=device)
    r = torch.rand((d, n), generator=gen, device=device)
    parent = (r * i.clamp(min=1)).long().to(torch.int32)
    parent[:, 0] = -1
    real = int(max(1, fill * n))
    parent[:, real:] = -1
    return parent.contiguous()


def k1_inputs(gen, d: int, n: int, device):
    import torch

    vec = torch.randint(0, n + 1, (d, n), generator=gen, device=device, dtype=torch.int32)
    return vec, tree_rows(gen, d, n, device)


def k2_inputs(gen, d: int, n: int, s: int, device, valid_only: bool = False):
    import torch

    val = torch.randint(0, 3, (d, n), generator=gen, device=device, dtype=torch.int32)
    lo = 0 if valid_only else -1
    seg = torch.randint(lo, s, (d, n), generator=gen, device=device, dtype=torch.int32)
    return val, seg


def k3_inputs(gen, d: int, r: int, g: int, f: int, device):
    import torch

    statuses = torch.randint(0, 3, (d, r), generator=gen, device=device).to(torch.int8)
    unsure = torch.rand((d, r), generator=gen, device=device) < 0.05
    # every group but the last non-empty, the last group empty; files
    # in contiguous runs (a packed rule axis); last = final rule
    group_ids = (torch.arange(r, device=device) % max(g - 1, 1)).to(torch.int32)
    file_ids = (torch.arange(r, device=device) * f // max(r, 1)).to(torch.int32)
    last = torch.zeros(g, dtype=torch.int32, device=device)
    for i, gi in enumerate(group_ids.tolist()):
        last[gi] = i
    return statuses, unsure, group_ids, file_ids, last


def join_inputs(gen, d: int, n: int, width: int, device):
    """(org, key, mask) join rows: origins in [-1, n/8), keys from a few
    values including INT32_MIN and INT32_MAX, so pairs repeat."""
    import torch

    org = torch.randint(-1, max(2, n // 8), (d, width), generator=gen, device=device,
                        dtype=torch.int32)
    keys = torch.tensor([-(2 ** 31), 2 ** 31 - 1, -7, 0, 1, 2, 3, 99],
                        dtype=torch.int32, device=device)
    key = keys[torch.randint(0, len(keys), (d, width), generator=gen, device=device)]
    mask = torch.rand((d, width), generator=gen, device=device) < 0.7
    return org, key, mask


def equal_key_inputs(d: int, width: int, device):
    """(org, key, mask) join rows in which every entry is the same pair:
    org 0, key 7, all masked in."""
    import torch

    org = torch.zeros((d, width), dtype=torch.int32, device=device)
    return org, torch.full_like(org, 7), torch.ones((d, width), dtype=torch.bool, device=device)


def k6_inputs(gen, d: int, n: int, device):
    """(seg, mask, hi, lo) with S = (N+1)*5: a few origins per row, so
    most segments stay empty, and extreme keys."""
    import torch

    seg = (torch.randint(0, 8, (d, n), generator=gen, device=device) * 5
           + torch.randint(0, 5, (d, n), generator=gen, device=device)).to(torch.int32)
    mask = torch.rand((d, n), generator=gen, device=device) < 0.6
    hi = torch.randint(-(2 ** 31), 2 ** 31 - 1, (d, n), generator=gen, device=device,
                       dtype=torch.int32)
    lo = torch.randint(-(2 ** 31), 2 ** 31 - 1, (d, n), generator=gen, device=device,
                       dtype=torch.int32)
    return seg, mask, hi, lo, (n + 1) * 5


def k6_segments(gen, d: int, n: int, s: int, device, how: str):
    """(seg, mask, hi, lo) of k6_inputs with the segment ids spread `how`
    (K6_SEGMENTS): its 40 segments; the 5 kind classes of origin 1, as a
    shared query RHS labels every entry (ops/kernels.py:806); or uniform
    over [-1, S), a segment of its own for nearly every entry. Every
    segment id lies in [0, S) but the uniform spread's -1 entries, which
    are masked out."""
    import torch

    seg, mask, hi, lo, _s = k6_inputs(gen, d, n, device)
    if how == "shared":
        seg = 5 + seg % 5
    elif how == "uniform":
        seg = torch.randint(-1, s, (d, n), generator=gen, device=device, dtype=torch.int32)
        mask = mask & (seg >= 0)
    return seg % s if how == "40" else seg, mask, hi, lo


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


def _max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(_max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def k1_bytes(d, n, s=None):
    # vec (D, S) read once, idx read and out written (D, N)
    return 4 * d * (n if s is None else s) + 8 * d * n


def k2_bytes(d, n, s):
    return 8 * d * n + 4 * d * s


def k3_bytes(d, r, g, f, with_unsure=True):
    return d * r * (2 if with_unsure else 1) + 8 * r + 4 * g + d * (3 * g + 3 * f)


def k4_bytes(d, nq, ns):
    # queries and set: org, key int32 and a bool mask; counts written
    return 13 * d * nq + 9 * d * ns


def k5_bytes(d, n):
    return 10 * d * n


def k6_bytes(d, n, s):
    # seg, hi, lo int32 and a bool mask read; four int32 per segment written
    return 13 * d * n + 16 * d * s


def k7_bytes(n_valid, r):
    # the valid rows' int8 statuses read, three int32 counts per rule written
    return n_valid * r + 12 * r


def np_counts(statuses):
    """numpy's per-rule PASS, FAIL and SKIP counts of (D, R) statuses."""
    import numpy as np

    return np.stack([(statuses == k).sum(axis=0) for k in (0, 1, 2)])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def k2_sweep_row(gen, d: int, n: int, s: int, device) -> dict:
    """K2 against its plain version at (D, N, S), with seg lanes at -1,
    and its times; raises where they differ."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    val, seg = k2_inputs(gen, d, n, s, device)
    ok = _equal(K.segment_sum_rows(val, seg, s), plain.segment_sum_rows(val, seg, s))
    if not ok:
        raise AssertionError(f"segment_sum_rows differs from plain at D={d} N={n} S={s}")
    return {
        "N": n, "D": d, "S": s, "equal": ok,
        "branch": K._lib().guard_segment_sum_branch(d, n, s),
        "ms": cuda_ms(lambda: K.segment_sum_rows(val, seg, s)),
        "device_ms": graph_ms(lambda: K.segment_sum_rows(val, seg, s)),
        "plain_ms": cuda_ms(lambda: plain.segment_sum_rows(val, seg, s)),
        "bytes": k2_bytes(d, n, s),
    }


def k4_sweep_row(q, st, device) -> dict:
    """K4 against its plain version on queries q and set st, and its
    times; raises where they differ."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    d, nq = q[0].shape
    ns = st[0].shape[1]
    ok = _equal(K.set_count_rows(*q, *st), plain.set_count_rows(*q, *st))
    if not ok:
        raise AssertionError(f"set_count_rows differs from plain at D={d} Nq={nq} Ns={ns}")
    return {
        "N": nq, "D": d, "Ns": ns, "equal": ok,
        "branch": K._lib().guard_set_count_branch(d, ns),
        "ms": cuda_ms(lambda: K.set_count_rows(*q, *st)),
        "device_ms": graph_ms(lambda: K.set_count_rows(*q, *st)),
        "plain_ms": cuda_ms(lambda: plain.set_count_rows(*q, *st)),
        "bytes": k4_bytes(d, nq, ns),
    }


def k5_sweep_row(q, device) -> dict:
    """K5 against its plain version on rows q, and its times; raises
    where they differ."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    d, n = q[0].shape
    ok = _equal(K.distinct_first_rows(*q), plain.distinct_first_rows(*q))
    if not ok:
        raise AssertionError(f"distinct_first_rows differs from plain at D={d} N={n}")
    return {
        "N": n, "D": d, "equal": ok,
        "branch": K._lib().guard_distinct_first_branch(d, n),
        "ms": cuda_ms(lambda: K.distinct_first_rows(*q)),
        "device_ms": graph_ms(lambda: K.distinct_first_rows(*q)),
        "plain_ms": cuda_ms(lambda: plain.distinct_first_rows(*q)),
        "bytes": k5_bytes(d, n),
    }


def k6_sweep_row(args, s: int, device) -> dict:
    """K6 against its plain version on (seg, mask, hi, lo) with S
    segments, and its times; raises where they differ."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    d, n = args[0].shape
    ok = _equal(K.seg_min_max_rows(*args, s), plain.seg_min_max_rows(*args, s))
    if not ok:
        raise AssertionError(f"seg_min_max_rows differs from plain at D={d} N={n} S={s}")
    return {
        "N": n, "D": d, "S": s, "equal": ok,
        "branch": K._lib().guard_seg_min_max_branch(d, n, s),
        "ms": cuda_ms(lambda: K.seg_min_max_rows(*args, s)),
        "device_ms": graph_ms(lambda: K.seg_min_max_rows(*args, s)),
        "plain_ms": cuda_ms(lambda: plain.seg_min_max_rows(*args, s), reps=5),
        "bytes": k6_bytes(d, n, s),
    }


def phase_kernel_sweep(device) -> dict:
    """Every kernel against its plain version at the sweep shapes."""
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    sweep = {name: [] for name in K.NAMES}
    for n in SWEEP_N:
        d = -(-SWEEP_BYTES // (4 * n))
        vec, idx = k1_inputs(gen, d, n, device)
        got, ref = K.gather_rows(vec, idx), plain.gather_rows(vec, idx)
        ok = _equal(got, ref)
        sweep["gather_rows"].append({
            "N": n, "D": d, "equal": ok,
            "ms": cuda_ms(lambda: K.gather_rows(vec, idx)),
            "plain_ms": cuda_ms(lambda: plain.gather_rows(vec, idx)),
            "bytes": k1_bytes(d, n),
        })
        if not ok:
            raise AssertionError(f"gather_rows differs from plain at N={n}")
        del vec, idx, got, ref
        for s in (n, n + 1):
            sweep["segment_sum_rows"].append(k2_sweep_row(gen, d, n, s, device))
        torch.cuda.empty_cache()
    # the one-document bucket, also at the query-RHS width (N + 1) * 5
    for s in (WIDE_N, WIDE_N + 1, (WIDE_N + 1) * 5):
        sweep["segment_sum_rows"].append(k2_sweep_row(gen, 1, WIDE_N, s, device))
    # K1 over a (D, S) source, as the query-RHS compares read it
    for n in (64, 1024):
        s = (n + 1) * 5
        d = -(-SWEEP_BYTES // (4 * n))
        vec = torch.randint(0, 1000, (d, s), generator=gen, device=device, dtype=torch.int32)
        idx = torch.randint(-1, s + 1, (d, n), generator=gen, device=device, dtype=torch.int32)
        ok = _equal(K.gather_rows(vec, idx), plain.gather_rows(vec, idx))
        sweep["gather_rows"].append({
            "N": n, "D": d, "S": s, "equal": ok,
            "ms": cuda_ms(lambda: K.gather_rows(vec, idx)),
            "plain_ms": cuda_ms(lambda: plain.gather_rows(vec, idx)),
            "bytes": k1_bytes(d, n, s),
        })
        if not ok:
            raise AssertionError(f"gather_rows differs from plain at N={n} S={s}")
        del vec, idx
    for n in JOIN_SWEEP_N:
        d = -(-JOIN_SWEEP_BYTES // (4 * n))
        q = join_inputs(gen, d, n, n, device)
        for ns in (n, 2 * n):
            st = join_inputs(gen, d, n, ns, device)
            sweep["set_count_rows"].append(k4_sweep_row(q, st, device))
            del st
        sweep["distinct_first_rows"].append(k5_sweep_row(q, device))
        del q
        *args, s = k6_inputs(gen, d, n, device)
        sweep["seg_min_max_rows"].append(k6_sweep_row(args, s, device))
        del args
        torch.cuda.empty_cache()
    # the one-document bucket; then every key equal (one hash slot), with
    # org all 0 as the `.%var` key match calls it (ops/kernels.py:501)
    q = join_inputs(gen, 1, WIDE_N, WIDE_N, device)
    for ns in (WIDE_N, 2 * WIDE_N):
        sweep["set_count_rows"].append(k4_sweep_row(q, join_inputs(gen, 1, WIDE_N, ns, device),
                                                    device))
    sweep["distinct_first_rows"].append(k5_sweep_row(q, device))
    *args, s = k6_inputs(gen, 1, WIDE_N, device)
    sweep["seg_min_max_rows"].append(k6_sweep_row(args, s, device))
    for d, n in ((48694, 64), (1, WIDE_N)):
        q = equal_key_inputs(d, n, device)
        row = k4_sweep_row(q, equal_key_inputs(d, 2 * n, device), device)
        sweep["set_count_rows"].append({**row, "keys": "all equal"})
        sweep["distinct_first_rows"].append({**k5_sweep_row(q, device), "keys": "all equal"})
        # every entry in segment 0 with the same key
        seg = torch.zeros_like(q[0])
        row = k6_sweep_row((seg, q[2], q[1], q[1]), (n + 1) * 5, device)
        sweep["seg_min_max_rows"].append({**row, "keys": "all equal"})
    del q, args, seg
    torch.cuda.empty_cache()
    # a full pack (512 rules of 64 files); the last shape is a rules file
    # with no device rule: every doc SKIP
    for d, r, g, f in ((1 << 20, 64, 41, 1), (1 << 18, 256, 130, 4), (65536, 512, 512, 64),
                       (1024, 0, 0, 1)):
        args = k3_inputs(gen, d, r, g, f, device)
        for with_unsure in (True, False):
            a = args if with_unsure else (args[0], None) + args[2:]
            got, ref = K.rim_reduce(*a, g, f), plain.rim_reduce(*a, g, f)
            ok = _equal(got, ref)
            sweep["rim_reduce"].append({
                "D": d, "R": r, "G": g, "F": f, "unsure": with_unsure,
                "equal": ok, "branch": K._lib().guard_rim_reduce_branch(d, r, g, f),
                "ms": cuda_ms(lambda: K.rim_reduce(*a, g, f)),
                "device_ms": graph_ms(lambda: K.rim_reduce(*a, g, f)),
                "plain_ms": cuda_ms(lambda: plain.rim_reduce(*a, g, f), reps=5),
                "bytes": k3_bytes(d, r, g, f, with_unsure),
            })
            if not ok:
                raise AssertionError(f"rim_reduce differs from plain at D={d} R={r}")
        del args
    torch.cuda.empty_cache()
    sweep["rule_summary"] = rule_summary_sweep(device, gen)
    return sweep


def rule_summary_sweep(device, gen) -> list:
    """K7 against its plain version at every (D, R) of the sweep and
    n_valid in {0, D - 3, D}, with values outside 0..2; times at n_valid
    D. Takes only the kernels' public wrappers, so it also times another
    checkout's K7 (one imported ahead of this one on sys.path)."""
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    rows = []
    for d in SUMMARY_SWEEP_D:
        for r in SUMMARY_SWEEP_R:
            # statuses and values outside 0..2, which count nowhere
            st = torch.randint(-3, 6, (d, r), generator=gen, device=device, dtype=torch.int8)
            for n_valid in sorted({0, max(d - 3, 0), d}):
                ok = _equal(K.rule_summary(st, n_valid), plain.rule_summary(st, n_valid))
                if not ok:
                    raise AssertionError(
                        f"rule_summary differs from plain at D={d} R={r} n_valid={n_valid}"
                    )
            rows.append({
                "D": d, "R": r, "n_valid": [0, max(d - 3, 0), d], "equal": True,
                "ms": cuda_ms(lambda: K.rule_summary(st, d)),
                "device_ms": graph_ms(lambda: K.rule_summary(st, d)),
                "plain_ms": cuda_ms(lambda: plain.rule_summary(st, d)),
                "bytes": k7_bytes(d, r),
            })
            del st
        torch.cuda.empty_cache()
    return rows


def write_corpus(dirpath: Path, docs) -> None:
    for i, doc in enumerate(docs):
        (dirpath / f"t{i:06d}.json").write_text(json.dumps(doc))


def read_templates(data: Path) -> list:
    """The data files of a directory, read as `-d` reads them."""
    from guard_tpu_torch.commands.files import DATA_FILE_EXTENSIONS, gather
    from guard_tpu_torch.commands.validate import DataFile

    return [DataFile(name=f.name, content=f.read_text())
            for f in gather([str(data)], DATA_FILE_EXTENSIONS)]


def fresh_files(data_files) -> list:
    """New data files over the same texts, with no tree built: a run on
    them pays what a run that read the files pays, but the read."""
    from guard_tpu_torch.commands.validate import DataFile

    return [DataFile(name=df.name, content=df.content) for df in data_files]


def rss_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


class PeakRss:
    """This process's resident set in MiB: at the start of the block and
    its peak inside it, sampled every 5 ms from /proc/self/statm. The
    objects alive at the start (the trees and batches of earlier phases)
    are frozen out of the garbage collector's passes until the block
    ends, so that a timed run inside it pays what a fresh process would,
    not for traversing what the smoke keeps for later checks."""

    def __enter__(self):
        gc.freeze()
        self.start = self.peak = rss_mib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, rss_mib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_mib())
        gc.unfreeze()


@contextlib.contextmanager
def native_encoder_off(tmp: Path):
    """The native encoder as if it were not built (the tree encoder
    runs), until the block ends."""
    from guard_tpu_torch.ops import _native_lib, native_encoder

    saved = (_native_lib.NATIVE_DIR, _native_lib._libs, native_encoder._configured)
    empty = tmp / "native_encoder_off"
    empty.mkdir(exist_ok=True)
    oracle = saved[0] / "libguard_oracle.so"
    if oracle.exists() and not (empty / oracle.name).exists():
        (empty / oracle.name).symlink_to(oracle)  # the oracle stays on
    _native_lib.NATIVE_DIR, _native_lib._libs, native_encoder._configured = empty, {}, None
    try:
        check(not native_encoder.native_available(), "the native encoder is still on")
        yield
    finally:
        _native_lib.NATIVE_DIR, _native_lib._libs, native_encoder._configured = saved


TREE_PATH = {"ingest_workers": 0}  # with native_encoder_off: the tree encoder


def compare_on_cpu(evaluation) -> None:
    """Re-evaluate every file of a device evaluation on the CPU (plain
    kernel versions) and require identical statuses, unsure bits and
    rim blocks."""
    from guard_tpu_torch.ops.ir import build_rim_spec
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator, evaluate_groups

    for fr in evaluation.files:
        if not fr.compiled.rules:
            continue
        ev = DeviceBatchEvaluator(
            fr.compiled, "cpu", rim_spec=build_rim_spec([fr.compiled.rules])
        )
        groups = fr.groups if fr.groups is not None else evaluation.groups
        st, un, _host, rim = evaluate_groups(
            ev, len(fr.compiled.rules), groups, (), evaluation.n_docs,
        )
        check((st == fr.statuses).all(), f"{fr.rule_file.name}: statuses differ")
        check((un == fr.unsure).all(), f"{fr.rule_file.name}: unsure differs")
        for k, (a, b) in enumerate(zip(rim, fr.rim)):
            check(a.dtype == b.dtype and (a == b).all(), (
                f"{fr.rule_file.name}: rim block {k} differs"
            ))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def drive_validate(device, tmp: Path, name: str, rules_text: str, docs,
                   per_rule: bool = False, oracle_docs=(), **flags):
    """Write `docs` as a directory of templates and run the user's entry
    point (commands.validate.Validate, statuses-only) over them on the
    card, every kernel counter set to 0 just before and read just after.
    Checks the result (with `per_rule`, that every rule both PASSes and
    FAILs somewhere; that the CPU oracle reran exactly the documents
    `oracle_docs` names), then compares it with a CPU evaluation.
    Returns (info, evaluation, data files); the data files hold the
    trees the run built, for a later run over the same documents.
    `flags` go to Validate."""
    import numpy as np
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.ops import kernels as walk
    from guard_tpu_torch.ops.ir import FAIL, PASS, SKIP
    from guard_tpu_torch.utils.io import Reader, Writer

    data = tmp / f"{name}_templates"
    data.mkdir()
    write_corpus(data, docs)
    n_expect = len(docs)
    rules = tmp / f"{name}.guard"
    rules.write_text(rules_text)
    del docs

    writer = Writer.buffered()
    K.reset_launches()
    fnvar_before = dict(walk.FNVAR_STEPS)
    sync(device)
    with PeakRss() as rss:
        t0 = time.perf_counter()
        # the files are read here, as `-d` would read them, inside the run
        data_files = read_templates(data)
        read_s = time.perf_counter() - t0
        cmd = Validate(rules=[str(rules)], prepared_data=data_files, statuses_only=True,
                       device=str(device), result_cache=False, **flags)
        rc = cmd.execute(writer, Reader())
        sync(device)
        wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    fnvar_steps = {k: walk.FNVAR_STEPS[k] - fnvar_before[k] for k in fnvar_before}
    shapes = {k: dict(v) for k, v in K.SHAPES.items()}
    err = writer.err_to_stripped()
    check(rc in (0, 19), f"{name}: validate rc {rc}: {err}")
    ev = cmd.last_evaluation
    n_docs = ev.n_docs
    check(n_docs == n_expect, f"{name}: evaluated {n_docs} documents")
    fr = ev.files[0]
    st = fr.statuses
    n_rules = len(fr.compiled.rules)
    check(st.shape == (n_docs, n_rules) and st.dtype == np.int8, f"statuses {st.shape} {st.dtype}")
    check(set(np.unique(st).tolist()) <= {PASS, FAIL, SKIP}, "status outside PASS/FAIL/SKIP")
    check((st == FAIL).any() and (st == PASS).any(), f"{name}: degenerate statuses")
    for r in range(n_rules if per_rule else 0):
        col = st[:, r]
        check((col == FAIL).any() and (col == PASS).any(),
              f"{name}: rule {fr.compiled.rules[r].name} has degenerate statuses")
    check(not fr.unsure.any(), f"{name}: documents flagged unsure")
    check((fr.rim[3][:, 0] == (st == FAIL).any(axis=1)).all(), "any_fail disagrees with statuses")
    check(sorted(fr.host_docs) == sorted(oracle_docs),
          f"{name}: {len(fr.host_docs)} documents left to the oracle, "
          f"{len(oracle_docs)} expected")
    check(ev.oracle_docs == len(oracle_docs),
          f"{name}: {ev.oracle_docs} oracle reruns, {len(oracle_docs)} expected")
    out = writer.stripped()
    fail_lines = out.count("Status = FAIL")
    device_fails = int((fr.rim[2][:, 0] == FAIL).sum())
    # the FAILs of the oracle's reruns print too
    check(device_fails <= fail_lines <= device_fails + len(oracle_docs),
          "summary lines disagree with doc statuses")
    check(rc == (19 if fail_lines else 0), f"rc {rc} disagrees with statuses")
    n_big = max(int((b.node_kind >= 0).sum(axis=1).max()) for b, _ in fr.groups)
    check(n_big > 32768, f"volume template has only {n_big} nodes")
    t0 = time.perf_counter()
    compare_on_cpu(ev)
    cpu_s = time.perf_counter() - t0
    secs = ev.seconds
    return {
        "docs": n_docs, "rc": rc, "wall_s": wall, "read_s": read_s,
        "rss_start_mib": rss.start, "rss_peak_mib": rss.peak,
        "largest_doc_nodes": n_big,
        "fail_docs": int((fr.rim[2][:, 0] == FAIL).sum()),
        "encode_docs_per_s": n_docs / secs["encode"],
        "lower_docs_per_s": n_docs / secs["lower"],
        "device_docs_per_s": n_docs / secs["device"],
        "seconds": secs, "cpu_compare_s": cpu_s, "oracle_docs": ev.oracle_docs,
        "ingest": ev.ingest.get("path"),
        "stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
        "launches": launches, "fnvar_steps": fnvar_steps, "shapes": shapes,
    }, ev, data_files


def phase_slice(device, tmp: Path):
    """Slice 1's main path: the security policy at real size."""
    import numpy as np

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.workloads import RULES, make_template, volume_template

    rng = np.random.default_rng(SEED)
    docs = [make_template(rng, i) for i in range(N_TEMPLATES)]
    docs.append(volume_template(N_VOLUMES))
    with native_encoder_off(tmp):
        info, ev, data_files = drive_validate(device, tmp, "security", RULES, docs, **TREE_PATH)
    check(info["ingest"] == "tree", f"the slice ran the {info['ingest']} path")
    if device.type != "cuda":
        return info, ev, data_files  # a CPU rehearsal launches no kernel
    lib = K._lib()
    split_launches = sum(
        c for (d, n, s), c in info["shapes"]["segment_sum_rows"].items()
        if lib.guard_segment_sum_branch(d, n, s) == 0
    )
    check(split_launches > 0, "K2's split branch never ran")
    info["k2_split_branch_launches"] = split_launches
    for name in ("gather_rows", "segment_sum_rows", "rim_reduce", "walk_segment"):
        check(info["launches"][name] > 0, f"kernel {name} never launched on the main path")
    check(launch_counts(info["launches"], "security") == EXPECTED_LAUNCHES["security"],
          f"slice launches {info['launches']}")
    return info, ev, data_files


def launch_counts(launches: dict, path: str) -> dict:
    return {k: launches[k] for k in EXPECTED_LAUNCHES[path]}


def same_evaluation(ev, base, label: str, skip=()) -> None:
    """Statuses, unsure bits, rim blocks and the documents left to the
    oracle equal `base`'s (which equal the CPU's), outside `skip`."""
    import numpy as np

    keep = np.ones(base.n_docs, bool)
    keep[list(skip)] = False
    check(ev.n_docs == base.n_docs and len(ev.files) == len(base.files), f"{label}: shape")
    for fr, br in zip(ev.files, base.files):
        check((fr.statuses[keep] == br.statuses[keep]).all(), f"{label}: statuses differ")
        check((fr.unsure[keep] == br.unsure[keep]).all(), f"{label}: unsure differs")
        for k, (a, b) in enumerate(zip(fr.rim, br.rim)):
            check(a.dtype == b.dtype and (a[keep] == b[keep]).all(),
                  f"{label}: rim block {k} differs")
        check(set(fr.host_docs) - set(skip) == set(br.host_docs) - set(skip),
              f"{label}: oracle documents differ")


def run_ingest(device, rules: Path, data: Path, data_files=None, trace_out=None,
               metrics_out=None, **flags) -> dict:
    """One statuses-only run of Validate over the templates of `data`,
    read inside the timed run (unless `data_files` are given: read_s is
    then 0), every kernel counter set to 0 just before and read just
    after, and the peak host RSS sampled throughout. `trace_out` and
    `metrics_out` trace the run as the CLI's --trace-out and
    --metrics-out do (cli.telemetry_export)."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.cli import telemetry_export
    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.utils.io import Reader, Writer

    writer = Writer.buffered()
    K.reset_launches()
    sync(device)
    with PeakRss() as rss, telemetry_export(trace_out, metrics_out):
        t0 = time.perf_counter()
        files = read_templates(data) if data_files is None else data_files
        read_s = time.perf_counter() - t0
        cmd = Validate(rules=[str(rules)], prepared_data=files, statuses_only=True,
                       device=str(device), **{"result_cache": False, **flags})
        rc = cmd.execute(writer, Reader())
        sync(device)
        wall = time.perf_counter() - t0
    ev = cmd.last_evaluation
    out = writer.stripped()
    stats = ev.ingest.get("stats", {})
    return {
        "rc": rc, "out": out, "err": writer.err_to_stripped(), "ev": ev, "files": files,
        "summary": {
            "rc": rc, "wall_s": wall, "read_s": read_s, "seconds": dict(ev.seconds),
            "ingest": ev.ingest.get("path"), "workers": ev.ingest.get("workers"),
            "shard_encode_s": [sh["encode_s"] for sh in stats.get("shards", [])],
            "shards_native": [sh["native"] for sh in stats.get("shards", [])],
            "rss_start_mib": rss.start, "rss_peak_mib": rss.peak,
            "worker_rss_mib": stats.get("worker_max_rss_kb", 0) / 1024,
            "trees_built": sum(df._pv is not None for df in files),
            "stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
            "launches": dict(K.LAUNCHES),
        },
    }


def phase_ingest(device, tmp: Path, slice_info: dict, slice_ev):
    """The slice's files through the host ingest: the native encoder in
    this process (i), over the auto count of ingest workers (ii) and
    over 4 (iii), each equal to the tree-encoder run (and so to the
    CPU) with its launches; then the quarantine on path (ii). Run (i)
    is traced (leg (d): `check_trace`). Returns (info, the texts run (i)
    read)."""
    from guard_tpu_torch.ops import native_encoder
    from guard_tpu_torch.parallel.ingest import resolve_ingest_workers

    check(native_encoder.native_available(), "the native encoder is not built")
    rules, data = tmp / "security.guard", tmp / "security_templates"
    auto = resolve_ingest_workers(None)
    out = {"auto_workers": auto}
    texts = None
    for label, workers in INGEST_PATHS:
        if workers is not None and workers > 0 and workers == auto:
            out[label] = {"same_as": "ii_auto"}  # a repeat of (ii) on this host
            continue
        # (i) reads the files inside its run; the others take the same
        # texts, so that the file system's read is paid once
        traced = {}
        if texts is None:
            traced = {"trace_out": tmp / "ingest_i.trace.json",
                      "metrics_out": tmp / "ingest_i.metrics.json"}
        run = run_ingest(device, rules, data, ingest_workers=workers,
                         data_files=None if texts is None else fresh_files(texts), **traced)
        texts = texts or run["files"]
        info = run["summary"]
        pooled = resolve_ingest_workers(workers) >= 2
        check(info["ingest"] == ("pool" if pooled else "native"),
              f"ingest {label}: the {info['ingest']} path ran")
        check(all(info["shards_native"]), f"ingest {label}: a shard fell back to trees")
        check(run["rc"] == slice_info["rc"] and run["err"] == "", f"ingest {label}: rc {run['rc']}")
        check(info["stdout_sha256"] == slice_info["stdout_sha256"], f"ingest {label}: stdout differs")
        same_evaluation(run["ev"], slice_ev, f"ingest {label}")
        if device.type == "cuda":
            check(info["launches"] == slice_info["launches"],
                  f"ingest {label}: launches {info['launches']} against {slice_info['launches']}")
        if traced:
            info["telemetry"] = check_trace(traced["trace_out"], traced["metrics_out"], run["ev"])
        out[label] = info
        log(f"ingest {label}: {json.dumps(info)}")
        del run

    # the quarantine: one template made invalid JSON
    files = fresh_files(texts)
    bad = files[QUARANTINE_DOC]
    bad.content = bad.content[: len(bad.content) // 2]
    run = run_ingest(device, rules, data, data_files=files, max_doc_failures=1)
    check(run["rc"] == 19, f"quarantine: rc {run['rc']}: {run['err'][-500:]}")
    check(run["err"] == f"skipping {bad.name}: invalid JSON\n", f"quarantine: stderr {run['err']!r}")
    check(bad.name not in run["out"], "quarantine: the invalid template is reported")
    check(run["ev"].ingest["path"] == "quarantine", "quarantine: path")
    same_evaluation(run["ev"], slice_ev, "quarantine", skip=(QUARANTINE_DOC,))
    out["quarantine_1"] = run["summary"]
    # the exit rule on the first N_BACKEND templates, the invalid one
    # among them
    files = fresh_files(texts[:N_BACKEND])
    files[QUARANTINE_DOC].content = bad.content
    run = run_ingest(device, rules, data, data_files=files, max_doc_failures=0)
    check(run["rc"] == 5, f"quarantine 0: rc {run['rc']}")
    check(run["err"] == f"skipping {bad.name}: invalid JSON\n", f"quarantine 0: {run['err']!r}")
    out["quarantine_0"] = run["summary"]
    return out, texts


def check_trace(trace_out: Path, metrics_out: Path, ev) -> dict:
    """Leg (d): the traced run's trace is Chrome trace_event JSON on the
    lanes of telemetry._LANE_ORDER (and the instant-event lane), its
    metrics snapshot passes guard_tpu_torch.tools.check_metrics_schema
    run as a subprocess, and each stage's span total is printed."""
    from guard_tpu_torch.utils.telemetry import _LANE_ORDER

    trace = json.loads(trace_out.read_text())
    events = trace["traceEvents"]
    check(isinstance(events, list) and events, "trace: no traceEvents")
    check({e["ph"] for e in events} <= {"M", "X", "i"}, "trace: unknown event phases")
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "thread_name"}
    check(lanes <= set(_LANE_ORDER) | {"events"}, f"trace: lanes {sorted(lanes)}")
    # one rules file: the per-file path, whose `dispatch` span holds the
    # wait for the card (a packed run adds the `collect` lane)
    check({"rules", "ingest", "dispatch", "rim"} <= lanes, f"trace: lanes {sorted(lanes)}")
    proc = subprocess.run([sys.executable, "-m", "guard_tpu_torch.tools.check_metrics_schema",
                           str(metrics_out)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    check(proc.returncode == 0, f"metrics snapshot: {proc.stderr[-1000:]}")
    # this run's spans, from its trace (the snapshot's roll-ups hold the
    # whole process's, the earlier phases' flight-recorder spans among
    # them)
    spans: dict = {}
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
    log(f"ingest (i) span totals (s): {json.dumps(spans)}")
    check(spans.get("dispatch", 0.0) > 0 and spans.get("report", 0.0) > 0,
          "trace: no dispatch or report span")
    return {"lanes": sorted(lanes), "span_s": spans,
            "events": len(events), "device_s": ev.seconds["device"],
            "trace_bytes": trace_out.stat().st_size}


CACHE_CHANGED_DOC = 7  # the template whose bytes the cache's third run changes
N_MESH_TEXTS = 16384  # the mesh legs run over the first 16,384 of the slice's texts


def run_flagged(device, rules, files, **flags) -> dict:
    """One statuses-only Validate run over `files` with `flags`, every
    kernel counter and the rim counters set to 0 just before and read
    just after."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.ops.backend import RIM_COUNTERS
    from guard_tpu_torch.utils.io import Reader, Writer

    writer = Writer.buffered()
    for key in RIM_COUNTERS:
        RIM_COUNTERS[key] = 0
    K.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    cmd = Validate(rules=[str(r) for r in rules], prepared_data=files, statuses_only=True,
                   device=str(device), **flags)
    rc = cmd.execute(writer, Reader())
    sync(device)
    wall = time.perf_counter() - t0
    out = writer.stripped()
    ev = cmd.last_evaluation
    return {
        "rc": rc, "out": out, "err": writer.err_to_stripped(), "ev": ev,
        "summary": {
            "rc": rc, "wall_s": wall, "docs": len(files),
            "seconds": None if ev is None else dict(ev.seconds),
            "stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
            "launches": dict(K.LAUNCHES), "rim": dict(RIM_COUNTERS),
        },
    }


def phase_slice_flags(device, tmp: Path, slice_info: dict, texts) -> dict:
    """The slice's 65,537 documents (the texts the ingest run (i) read)
    under the flags of this slice, statuses-only, each run's counters
    set to 0 just before and read just after:

    (a) the result cache: the run with --no-result-cache, then in a
        fresh GUARD_TPU_RESULT_CACHE_DIR, with --delta-stats: cold
        (every document stored), warm (every one replayed: no encode,
        no launch of any kernel), and with one template's bytes changed
        (a delta of 1: the launches of that template's bucket only);
        each run's stdout and rc are the no-cache slice run's, and each
        wall is set beside the no-cache run's (`vs_no_cache`);
    (b) --no-vector-rim: the slice's stdout, no K3 launch, and every
        document materialized;
    (c) --mesh-shape 2x1 over the security policy and the flagship rules
        (one pack of two files): the stdout and the launches of the same
        run without the flag, since one card runs every shape
        unsharded."""
    from guard_tpu_torch.cache import results as rcache
    from guard_tpu_torch.workloads import FLAGSHIP_RULES

    rules = tmp / "security.guard"
    n_docs = len(texts)
    want_out = slice_info["stdout_sha256"]
    out = {"docs": n_docs, "launches": {}}
    zero = {name: 0 for name in slice_info["launches"]}

    # (a) the result cache, beside the same run without it
    run = run_flagged(device, [rules], fresh_files(texts), delta_stats=True,
                      result_cache=False)
    check(run["rc"] == slice_info["rc"] and run["summary"]["stdout_sha256"] == want_out
          and run["err"] == "", "cache_off: rc, stdout or stderr differs from the slice's")
    off_wall = run["summary"]["wall_s"]
    out["cache_off"] = run["summary"]
    out["launches"]["cache_off"] = run["summary"]["launches"]
    log(f"cache_off: {json.dumps(run['summary'])}")
    del run
    saved_dir = os.environ.get("GUARD_TPU_RESULT_CACHE_DIR")
    os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = str(tmp / "results")
    files = fresh_files(texts)
    changed = fresh_files(texts)
    changed[CACHE_CHANGED_DOC].content += "\n "
    legs = (("cache_cold", files, 0), ("cache_warm", fresh_files(texts), n_docs),
            ("cache_delta", changed, n_docs - 1))
    for label, run_files, hits in legs:
        rcache.reset_result_cache_stats()
        run = run_flagged(device, [rules], run_files, delta_stats=True)
        info = run["summary"]
        info["cache"] = rcache.result_cache_stats()
        info["vs_no_cache"] = info["wall_s"] / off_wall
        check(run["rc"] == slice_info["rc"] and info["stdout_sha256"] == want_out,
              f"{label}: rc {run['rc']} or stdout differs from the run without the cache")
        check(run["err"] == f"result-cache: {hits}/{n_docs} docs cached, "
                            f"{n_docs - hits} dispatched\n", f"{label}: stderr {run['err']!r}")
        check(info["cache"]["hits"] == hits and info["cache"]["stores"] == n_docs - hits,
              f"{label}: cache counters {info['cache']}")
        if label == "cache_warm":
            check(run["ev"] is None, "cache_warm: an evaluation ran")
            if device.type == "cuda":
                check(info["launches"] == zero, f"cache_warm: launches {info['launches']}")
        if label == "cache_delta":
            check(run["ev"].n_docs == 1 and len(run["ev"].groups) == 1,
                  "cache_delta: more than one document evaluated")
            if device.type == "cuda":
                check(info["launches"]["rim_reduce"] == 1
                      and 0 < info["launches"]["gather_rows"]
                      < slice_info["launches"]["gather_rows"],
                      f"cache_delta: launches {info['launches']}")
        out[label] = info
        out["launches"][label] = info["launches"]
        log(f"{label}: {json.dumps(info)}")
        del run
    if saved_dir is None:
        os.environ.pop("GUARD_TPU_RESULT_CACHE_DIR")
    else:
        os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = saved_dir

    # (b) the scalar rim
    run = run_flagged(device, [rules], fresh_files(texts), vector_rim=False, result_cache=False)
    info = run["summary"]
    check(run["rc"] == slice_info["rc"] and info["stdout_sha256"] == want_out,
          "no_vector_rim: stdout differs from the vector rim's")
    check(info["rim"] == {"docs_materialized": n_docs, "docs_settled": 0},
          f"no_vector_rim: rim counters {info['rim']}")
    if device.type == "cuda":
        check(info["launches"]["rim_reduce"] == 0, f"no_vector_rim: K3 launched {info}")
    out["no_vector_rim"] = info
    out["launches"]["no_vector_rim"] = info["launches"]
    log(f"no_vector_rim: {json.dumps(info)}")
    del run

    # (c) the mesh, over a pack of two files
    flagship = tmp / "flagship.guard"
    flagship.write_text(FLAGSHIP_RULES)
    runs = {}
    for label, shape in (("mesh_off", "off"), ("mesh_2x1", "2x1")):
        runs[label] = run_flagged(device, [rules, flagship], fresh_files(texts[:N_MESH_TEXTS]),
                                  mesh_shape=shape, result_cache=False)
    base, mesh = runs["mesh_off"], runs["mesh_2x1"]
    check((mesh["rc"], mesh["out"]) == (base["rc"], base["out"]) and mesh["err"] == "",
          "mesh_2x1: stdout or rc differs from the unsharded run")
    ev = mesh["ev"]
    check([len(p) for p in ev.packs] == [2], f"mesh_2x1: packs {ev.packs}")
    if device.type == "cuda":
        check(mesh["summary"]["launches"] == base["summary"]["launches"]
              and base["summary"]["launches"]["rim_reduce"] == len(ev.groups),
              f"mesh_2x1: launches {mesh['summary']['launches']} against "
              f"{base['summary']['launches']} unsharded")
    for label, run in runs.items():
        out[label] = run["summary"]
        out["launches"][label] = run["summary"]["launches"]
        log(f"{label}: {json.dumps(out[label])}")
    return out


def phase_xref_ingest(device, tmp: Path, xref_info: dict, xref_ev, xref_files) -> dict:
    """The xref files (the texts the tree run read) on ingest path
    (ii): struct ids on the native batch, K4-K6 as on the tree
    encoder."""
    run = run_ingest(device, tmp / "xref.guard", tmp / "xref_templates",
                     data_files=fresh_files(xref_files))
    info = run["summary"]
    check(run["rc"] == xref_info["rc"] and run["err"] == "", f"xref ingest: rc {run['rc']}")
    check(info["stdout_sha256"] == xref_info["stdout_sha256"], "xref ingest: stdout differs")
    same_evaluation(run["ev"], xref_ev, "xref ingest")
    if device.type == "cuda":
        check(info["launches"] == xref_info["launches"],
              f"xref ingest: launches {info['launches']} against {xref_info['launches']}")
        check(launch_counts(info["launches"], "xref") == EXPECTED_LAUNCHES["xref"],
              f"xref ingest: launches {info['launches']}")
    return info


def phase_backends(device, tmp: Path) -> dict:
    """The backends off the device over the first N_BACKEND security
    templates: cpu, native and auto print what the tpu run prints
    (`-S all` and `-z -o json -S none`), and -v and -p over N_VERBOSE
    templates print the same on cpu and native."""
    import shutil

    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.utils.io import Reader, Writer

    rules = tmp / "security.guard"
    names = sorted(p.name for p in (tmp / "security_templates").glob("*.json"))
    dirs = {}
    for label, n in (("backends", N_BACKEND), ("verbose", N_VERBOSE)):
        d = dirs[label] = tmp / f"{label}_templates"
        d.mkdir()
        for name in names[:n]:
            shutil.copyfile(tmp / "security_templates" / name, d / name)

    def run(backend, data, **flags):
        writer = Writer.buffered()
        cmd = Validate(rules=[str(rules)], data=[str(data)], backend=backend,
                       device=str(device), result_cache=False, **flags)
        t0 = time.perf_counter()
        rc = cmd.execute(writer, Reader())
        sync(device)
        return rc, writer.stripped(), writer.err_to_stripped(), time.perf_counter() - t0

    out = {}
    for label, flags in (("single_line_all", SINGLE_LINE_ALL), ("structured_json", STRUCTURED_JSON)):
        rc, want, err, secs = run("tpu", dirs["backends"], **flags)
        check(rc == 19 and err == "", f"backends {label}: tpu rc {rc}")
        out[label] = {"tpu_s": secs, "bytes": len(want.encode())}
        for backend in ("cpu", "native", "auto"):
            got = run(backend, dirs["backends"], **flags)
            check(got[:3] == (19, want, ""), f"backends {label}: {backend} differs from tpu")
            out[label][f"{backend}_s"] = got[3]
    for label, flags in (("verbose", {"verbose": True}), ("print_json", {"print_json": True})):
        cpu = run("cpu", dirs["verbose"], **flags)
        native = run("native", dirs["verbose"], **flags)
        check(cpu[0] == 19 and cpu[:3] == native[:3], f"backends {label}: cpu and native differ")
        head = "\n".join(cpu[1].splitlines()[:8])
        log(f"backends {label} over {N_VERBOSE} templates ({len(cpu[1].encode())} bytes):\n{head}")
        out[label] = {"bytes": len(cpu[1].encode()), "cpu_s": cpu[3], "native_s": native[3]}
    return out


def phase_xref(device, tmp: Path):
    """Slice 2's main path: the cross-reference policy (query-RHS
    compares, `.%var` interpolation) at real size. Every kernel must
    launch, K4-K6 also on their global-memory branches."""
    import numpy as np

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.workloads import XREF_RULES, make_xref_template, volume_template

    rng = np.random.default_rng(SEED + 2)
    docs = [make_xref_template(rng, i) for i in range(N_XREF_TEMPLATES)]
    docs.append(volume_template(N_VOLUMES))
    with native_encoder_off(tmp):
        info, ev, files = drive_validate(device, tmp, "xref", XREF_RULES, docs, per_rule=True,
                                         **TREE_PATH)
    check(info["ingest"] == "tree", f"xref ran the {info['ingest']} path")
    if device.type != "cuda":
        return info, ev, files  # a CPU rehearsal launches no kernel
    for name in WALK_KERNELS:
        check(info["launches"][name] > 0, f"kernel {name} never launched on the xref path")
    lib = K._lib()
    info["global_branch_launches"] = {}
    for name in JOINS:
        n_global = sum(
            c for shape, c in info["shapes"][name].items() if BRANCH[name](lib, shape) == 0
        )
        check(n_global > 0, f"{name}'s global-memory branch never ran")
        info["global_branch_launches"][name] = n_global
    return info, ev, files


def phase_fnvar(device, tmp: Path):
    """Slice 3's main path: function variables at real size. The
    function values are precomputed on the host per document and
    selected on the card by the walk's StepFnVar arm; the templates with
    a number the card cannot encode exactly rerun on the CPU oracle, and
    no other document does. The per-rule statuses of the first
    N_FNVAR_CHECK templates must equal the port's CPU evaluator."""
    import numpy as np

    from guard_tpu_torch.commands.report import rule_statuses_from_root
    from guard_tpu_torch.core.evaluator import eval_rules_file
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.scopes import RootScope
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.backend import STATUS
    from guard_tpu_torch.workloads import FNVAR_RULES, make_fnvar_template, volume_template

    n = N_FNVAR_TEMPLATES
    rng = np.random.default_rng(SEED + 3)
    exotic = rng.random(n) < EXOTIC_SHARE
    docs = [make_fnvar_template(rng, i, exotic=bool(exotic[i])) for i in range(n)]
    docs.append(volume_template(N_VOLUMES))
    sample = docs[:N_FNVAR_CHECK]
    exotic_idx = np.where(exotic)[0].tolist()
    check(exotic_idx, "no exotic template: the oracle would not run")
    info, ev, _files = drive_validate(device, tmp, "fnvar", FNVAR_RULES, docs, per_rule=True,
                                      oracle_docs=exotic_idx)
    del docs, _files
    fr = ev.files[0]
    check(fr.compiled.fn_vars and fr.compiled.needs_fn_origin and not fr.compiled.host_rules,
          "FNVAR_RULES did not lower to per-origin function variables")

    rules = parse_rules_file(FNVAR_RULES, "fnvar.guard")
    t0 = time.perf_counter()
    checked = 0
    for di, doc in enumerate(sample):
        if di in fr.host_docs:
            continue  # rerun by the same evaluator
        scope = RootScope(rules, from_plain(doc))
        status = eval_rules_file(rules, scope, "doc")
        want = rule_statuses_from_root(scope.reset_recorder().extract())
        got = {name: STATUS[int(fr.rim[0][di, g])] for g, name in enumerate(fr.names)}
        check(got == want, f"fnvar template {di}: card {got} vs CPU evaluator {want}")
        check(STATUS[int(fr.rim[2][di, 0])] == status, f"fnvar template {di}: doc status")
        checked += 1
    info["evaluator_check"] = {"docs": checked, "seconds": time.perf_counter() - t0}
    info["exotic_docs"] = len(exotic_idx)
    if device.type != "cuda":
        return info, ev  # a CPU rehearsal launches no kernel
    steps = info["fnvar_steps"]
    check(steps["per_origin"] > 0, "the StepFnVar arm never ran per origin")
    check(steps["k1_launches"] == steps["per_origin"],
          f"StepFnVar launched K1 {steps['k1_launches']} times in {steps['per_origin']} arms")
    for name in ("gather_rows", "segment_sum_rows", "rim_reduce"):
        check(info["launches"][name] > 0, f"kernel {name} never launched on the fnvar path")
    return info, ev


N_REPORT_CHECK = 2048  # full reports held against the CPU evaluator's
N_REPORT_SUBSET = 4096  # templates of the native-off, SARIF and JUnit runs
SINGLE_LINE = {"show_summary": ["fail"]}
SINGLE_LINE_ALL = {"show_summary": ["all"]}
STRUCTURED_JSON = {"structured": True, "output_format": "json", "show_summary": ["none"]}


@contextlib.contextmanager
def native_oracle_off(tmp: Path):
    """The native oracle as if it were not built: its library directory
    pointed at an empty one and its caches cleared, until the block
    ends."""
    from guard_tpu_torch.ops import _native_lib, native_oracle

    saved = (_native_lib.NATIVE_DIR, _native_lib._libs, native_oracle._configured)
    empty = tmp / "native_off"
    empty.mkdir(exist_ok=True)
    _native_lib.NATIVE_DIR, _native_lib._libs, native_oracle._configured = empty, {}, None
    try:
        check(not native_oracle.native_available(), "the native oracle is still on")
        yield
    finally:
        _native_lib.NATIVE_DIR, _native_lib._libs, native_oracle._configured = saved


def run_report(device, rules: Path, data_files, **flags) -> dict:
    """One full-report run of the user's entry point
    (commands.validate.Validate) over data files already read, every
    kernel counter set to 0 just before and read just after."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.commands.validate import Validate
    from guard_tpu_torch.utils.io import Reader, Writer

    cmd = Validate(rules=[str(rules)], prepared_data=data_files, device=str(device),
                   result_cache=False, **flags)
    writer = Writer.buffered()
    K.reset_launches()
    sync(device)
    with PeakRss() as rss:
        t0 = time.perf_counter()
        rc = cmd.execute(writer, Reader.from_string(""))
        sync(device)
        wall = time.perf_counter() - t0
    return {"rc": rc, "out": writer.stripped(), "err": writer.err_to_stripped(),
            "ev": cmd.last_evaluation, "launches": dict(K.LAUNCHES), "wall_s": wall,
            "rss_peak_mib": rss.peak, "rss_start_mib": rss.start}


def report_summary(run: dict) -> dict:
    """A run's seconds per stage, rerun counts, report bytes and
    kernel launches."""
    ev = run["ev"]
    return {"rc": run["rc"], "wall_s": run["wall_s"], "seconds": dict(ev.seconds),
            "ingest": ev.ingest.get("path"), "rss_start_mib": run["rss_start_mib"],
            "rss_peak_mib": run["rss_peak_mib"],
            "reruns": dict(ev.reruns), "oracle_docs": ev.oracle_docs,
            "report_bytes": len(run["out"].encode()), "launches": run["launches"]}


def phase_report(device, tmp: Path, data_files, slice_ev, rows) -> dict:
    """Slice 8's main path: full reports of the slice's documents (the
    trees its run built; `rows` are their positions in the slice's
    evaluation) through Validate on the card, without
    --statuses-only: (a) the single-line report and (b) the structured
    JSON, with the native oracle built. The FAIL set equals the
    statuses-only run's, every report's statuses equal the rim's
    (already held against the CPU), the first N_REPORT_CHECK reports
    equal the CPU evaluator's, and the native oracle built reports.
    Then on the first N_REPORT_SUBSET templates (c) the same two runs
    with the native oracle off, whose reruns go through the spawn
    pool, byte-identical to the native runs' first documents, and (d)
    SARIF and JUnit, which parse and equal the same runs on the CPU;
    then (e) the single-line run over every template with the native
    oracle off, byte-identical to (a)."""
    import re
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from guard_tpu_torch.commands.report import simplified_report_from_root
    from guard_tpu_torch.commands.reporters.structured import _strip_locations
    from guard_tpu_torch.core.evaluator import eval_rules_file
    from guard_tpu_torch.core.scopes import RootScope
    from guard_tpu_torch.ops import native_oracle
    from guard_tpu_torch.ops.backend import STATUS
    from guard_tpu_torch.ops.ir import FAIL

    rules = tmp / "security.guard"
    check(native_oracle.native_available(), "the native oracle is not built")
    fr = slice_ev.files[0]
    n = len(data_files)
    names = [df.name for df in data_files]
    want_fail = {names[i] for i in np.nonzero(fr.rim[2][rows, 0] == FAIL)[0]}
    out = {"docs": n, "fail_docs": len(want_fail)}

    with native_encoder_off(tmp):
        single = run_report(device, rules, data_files, **SINGLE_LINE, **TREE_PATH)
    check(single["rc"] == 19, f"report (a): rc {single['rc']}: {single['err'][-500:]}")
    # (a) again on ingest path (ii), over the same texts with no tree
    again = run_report(device, rules, fresh_files(data_files), **SINGLE_LINE)
    check(again["ev"].ingest["path"] in ("pool", "native"), "report (a'): ingest path")
    check((again["rc"], again["out"], again["err"]) == (single["rc"], single["out"], single["err"]),
          "report (a'): the ingest path's single-line report differs from (a)")
    out["single_line_ingest"] = report_summary(again)
    del again
    failed = set(re.findall(r"^(\S+) Status = FAIL$", single["out"], re.M))
    check(failed == want_fail, f"report (a): {len(failed)} FAIL documents, "
          f"the statuses-only run had {len(want_fail)}")
    structured = run_report(device, rules, data_files, **STRUCTURED_JSON)
    check(structured["rc"] == 19, f"report (b): rc {structured['rc']}")
    reports = json.loads(structured["out"])
    check([r["name"] for r in reports] == names, "report (b): documents out of order")
    for di, rep in enumerate(reports):
        got = {r["Rule"]["name"]: "FAIL" for r in rep["not_compliant"]}
        got.update({nm: "SKIP" for nm in rep["not_applicable"]})
        got.update({nm: "PASS" for nm in rep["compliant"]})
        want = {nm: STATUS[int(fr.rim[0][rows[di], g])].value
                for g, nm in enumerate(fr.names)}
        check(got == want, f"report (b) of {names[di]}: {got} against the rim's {want}")
        check(rep["status"] == STATUS[int(fr.rim[2][rows[di], 0])].value,
              f"report (b) of {names[di]}: status {rep['status']}")
    rf = structured["ev"].files[0].rule_file.rules
    t0 = time.perf_counter()
    for di in range(min(N_REPORT_CHECK, n)):
        df = data_files[di]
        scope = RootScope(rf, df.path_value)
        eval_rules_file(rf, scope, df.name)
        want = _strip_locations(simplified_report_from_root(scope.reset_recorder().extract(),
                                                            df.name))
        check(reports[di] == want, f"report (b) of {df.name} differs from the CPU evaluator's")
    out["cpu_check"] = {"docs": min(N_REPORT_CHECK, n), "seconds": time.perf_counter() - t0}
    for label, run in (("single_line", single), ("structured_json", structured)):
        check(run["ev"].reruns["native_reports"] > 0, f"report {label}: no native report")
        out.setdefault("ingest_paths", {})[label] = run["ev"].ingest.get("path")
        if device.type == "cuda":
            for name in ("gather_rows", "segment_sum_rows", "rim_reduce"):
                check(run["launches"][name] > 0, f"report {label}: {name} never launched")
        out[label] = report_summary(run)

    k = min(N_REPORT_SUBSET, n - 1)
    subset = data_files[:k]
    with native_oracle_off(tmp):
        off_single = run_report(device, rules, subset, **SINGLE_LINE)
        off_structured = run_report(device, rules, subset, **STRUCTURED_JSON)
    for label, run in (("native_off_single_line", off_single),
                       ("native_off_structured_json", off_structured)):
        counts = run["ev"].reruns
        check(run["rc"] == 19 and counts["native_reports"] == 0, f"report {label}")
        check(counts["pooled"] > 0 and counts["pool_failures"] == 0,
              f"report {label}: the pool did not run ({counts})")
        out[label] = report_summary(run)
    # the first k documents' reports, byte for byte
    check(single["out"].startswith(off_single["out"]), "report (c): single-line bytes differ")
    rest = single["out"][len(off_single["out"]):]
    head = re.match(r"(\S+) Status = FAIL\n", rest)
    check(rest == "" or (head is not None and names.index(head.group(1)) >= k),
          "report (c): the native-off run stops inside a document")
    check(json.dumps(reports[:k], indent=2) == off_structured["out"],
          "report (c): structured JSON bytes differ")
    del reports

    for fmt in ("sarif", "junit"):
        flags = {"structured": True, "output_format": fmt, "show_summary": ["none"]}
        card = run_report(device, rules, subset, **flags)
        cpu = run_report(torch.device("cpu"), rules, subset, **flags)
        check((card["rc"], card["out"], card["err"]) == (cpu["rc"], cpu["out"], cpu["err"]),
              f"report (d): {fmt} on the card differs from the CPU's")
        check(card["rc"] == 19 and card["err"] == "", f"report (d): {fmt} rc {card['rc']}")
        if fmt == "sarif":
            check(json.loads(card["out"])["runs"][0]["results"], "report (d): no SARIF result")
        else:
            check(ET.fromstring(card["out"].encode()).tag == "testsuites", "report (d): JUnit")
        out[fmt] = report_summary(card)
    # (e) the pool at full size: every failing template rerun on the CPU
    # evaluator, the same bytes as (a)
    with native_oracle_off(tmp):
        off_full = run_report(device, rules, data_files, **SINGLE_LINE)
    counts = off_full["ev"].reruns
    check(counts["pooled"] == len(want_fail) and counts["pool_failures"] == 0,
          f"report (e): {counts['pooled']} pooled reruns, {len(want_fail)} FAIL documents")
    check((off_full["rc"], off_full["out"], off_full["err"]) ==
          (single["rc"], single["out"], single["err"]),
          "report (e): the native-off single-line report differs from (a)")
    out["native_off_single_line_all"] = report_summary(off_full)
    del off_full
    out["launches"] = single["launches"]
    return out


def phase_breakdown(device, evaluation) -> list:
    """Where the device phase of the main path goes, per bucket: the
    host's canonical struct ids (DocBatch.struct_ids, computed once per
    batch for rules with query-RHS compares and cached by the validate
    run, so timed here on a copy with the cache cleared), host
    columnarization (device_arrays), the host-to-device copy, the host's
    time to enqueue one walk, the walk plus K3 on the card (CUDA events),
    and from a torch.profiler trace of one walk the card's kernel time,
    launch count and the kernels that take the most of it. The busy
    share is kernel time over the walk's event time. `port_kernels` lists
    the hand-written kernels' entries of the same trace."""
    import copy

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.ops.ir import build_rim_spec
    from guard_tpu_torch.ops.kernels import arrays_from_numpy
    from guard_tpu_torch.parallel.device import build_walk

    fr = evaluation.files[0]
    compiled = fr.compiled
    spec = build_rim_spec([compiled.rules])
    ids = [
        torch.from_numpy(np.asarray(a, np.int32)).to(device)
        for a in (spec.group_ids, spec.file_ids, spec.last_ids)
    ]
    fn = build_walk(compiled)
    out = []
    for batch, _idx in (fr.groups if fr.groups is not None else evaluation.groups):
        canon_s = None
        if compiled.needs_struct_ids:
            fresh = copy.copy(batch)
            fresh._struct_ids = None
            t0 = time.perf_counter()
            fresh.struct_ids()
            canon_s = time.perf_counter() - t0
            del fresh
        t0 = time.perf_counter()
        arrays, lits = compiled.device_arrays(batch), compiled.lit_values()
        cols_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_arrays, t_lits = arrays_from_numpy(arrays, lits, device)
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0

        def walk():
            st, un = fn(t_arrays, t_lits)
            return K.rim_reduce(
                st, un if compiled.needs_unsure else None, *ids,
                spec.n_groups, spec.n_files,
            )

        walk_ms = cuda_ms(walk, reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walk()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            walk()
            torch.cuda.synchronize()
        kernels = [
            e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ]
        kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out.append({
            "D": batch.n_docs, "N": batch.n_nodes,
            "struct_ids_s": canon_s, "columnarize_s": cols_s, "h2d_s": h2d_s,
            "h2d_bytes": sum(v.numel() * v.element_size() for v in t_arrays.values()),
            "enqueue_s": enqueue_s, "walk_ms": walk_ms,
            "profiled_kernel_ms": kernel_ms if kernels else None,
            "profiled_launches": sum(e.count for e in kernels) if kernels else None,
            "busy_share": kernel_ms / walk_ms if kernels and walk_ms else None,
            "top_kernels": [
                {"name": e.key[:80], "count": e.count,
                 "ms": e.self_device_time_total / 1e3}
                for e in top
            ],
            # every hand-written kernel: csrc/*.cu defines them in an
            # anonymous namespace and names nothing of PyTorch's at::
            "port_kernels": [
                {"name": e.key[:80], "count": e.count,
                 "ms": e.self_device_time_total / 1e3}
                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
                if e.key.startswith(("(anonymous namespace)::", "void (anonymous namespace)::"))
                and "at::" not in e.key
            ],
        })
    return out


def phase_flagship(device) -> dict:
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.commands.validate import RuleFile
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.backend import evaluate
    from guard_tpu_torch.ops.ir import FAIL
    from guard_tpu_torch.workloads import FLAGSHIP_RULES, example_docs

    rf = RuleFile("flagship.guard", "flagship.guard", FLAGSHIP_RULES,
                  parse_rules_file(FLAGSHIP_RULES, "flagship.guard"))
    docs = [from_plain(d) for d in example_docs(64, two_buckets=True)]
    K.reset_launches()
    ev = evaluate([rf], docs, device)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    compare_on_cpu(ev)
    st = ev.files[0].statuses
    # the sse rule FAILs exactly on the docs whose bucket lost its
    # encryption (every third), in both node buckets
    expect = [i % 3 == 0 for i in range(64)]
    check([bool(x) for x in (st[:, 0] == FAIL)] == expect, "flagship statuses")
    check([b.n_nodes for b, _ in ev.groups] == [64, 128], "flagship buckets")
    return {"docs": 64, "launches": launches}


def corpus_cases():
    """Each rules file of corpus/rules with the inputs of its tests."""
    import yaml

    corpus = ROOT / "corpus" / "rules"
    cases = []
    for p in sorted(corpus.glob("*.guard")):
        spec = corpus / "tests" / f"{p.stem}_tests.yaml"
        docs = []
        if spec.exists():
            docs = [case["input"] for case in yaml.safe_load(spec.read_text()) or []
                    if isinstance(case, dict) and "input" in case]
        cases.append((p, docs))
    return cases


def corpus_inputs():
    cases = corpus_cases()
    return [p for p, _ in cases], [doc for _, docs in cases for doc in docs]


def phase_corpus(device) -> dict:
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.backend import Evaluation, FileResult
    from guard_tpu_torch.ops.encoder import encode_bucketed
    from guard_tpu_torch.ops.ir import build_rim_spec, compile_rules_file
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator, evaluate_groups

    paths, plain_docs = corpus_inputs()
    groups, _oversize, interner = encode_bucketed([from_plain(d) for d in plain_docs])
    n_docs = len(plain_docs)
    K.reset_launches()
    files, refused = [], 0
    t0 = time.perf_counter()
    for p in paths:
        rules = parse_rules_file(p.read_text(), p.name)
        if rules is None:
            refused += 1
            continue
        compiled = compile_rules_file(rules, interner)
        if compiled.host_rules or compiled.fn_vars or not compiled.rules:
            refused += 1
            continue
        spec = build_rim_spec([compiled.rules])
        ev = DeviceBatchEvaluator(compiled, device, rim_spec=spec)
        st, un, _host, rim = evaluate_groups(ev, len(compiled.rules), groups, (), n_docs)
        files.append(FileResult(p, compiled, st, un, rim, spec.file_group_names[0]))
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    compare_on_cpu(Evaluation(groups, n_docs, interner, files, device))
    check(refused == 0 and len(files) == len(paths) == 249,
          f"{len(files)} of {len(paths)} corpus files ran, {refused} refused")
    reports = corpus_reports(device)
    return {"files": len(files), "refused": refused, "docs": n_docs,
            "device_s": device_s, "launches": launches, "reports": reports}


def corpus_reports(device) -> dict:
    """Every corpus rules file over its own tests' inputs through
    Validate, the single-line report with `-S all` and the structured
    JSON, on the card and on the CPU: the same rc, stdout and stderr."""
    import torch

    from guard_tpu_torch.commands.validate import DataFile

    t0 = time.perf_counter()
    runs = native = 0
    for path, docs in corpus_cases():
        data_files = [DataFile(f"case{i:02d}.json", json.dumps(doc)) for i, doc in enumerate(docs)]
        for flags in (SINGLE_LINE_ALL, STRUCTURED_JSON):
            card = run_report(device, path, data_files, **flags)
            cpu = run_report(torch.device("cpu"), path, data_files, **flags)
            check((card["rc"], card["out"], card["err"]) == (cpu["rc"], cpu["out"], cpu["err"]),
                  f"corpus {path.name} {flags}: the card's report differs from the CPU's")
            check(card["rc"] in (0, 19, 5), f"corpus {path.name}: rc {card['rc']}")
            runs += 1
            if card["ev"] is not None:
                native += card["ev"].reruns["native_reports"]
    check(native > 0, "the native oracle built no corpus report")
    return {"runs": runs, "native_reports": native, "seconds": time.perf_counter() - t0}


def phase_test_command(device) -> dict:
    """Leg (e): `test --dir corpus/rules` through the port's CLI in this
    process, on the card (`--backend tpu`, the default) and with
    `--backend cpu`, in the single-line, JSON and JUnit formats: the
    same stdout and rc, all 249 files and their 725 cases, most of them
    answered by the walk on the card, every kernel counter set to 0
    just before each card run and read just after."""
    from guard_tpu_torch import cli
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.commands.test import Test
    from guard_tpu_torch.utils.io import Writer

    corpus = ROOT / "corpus" / "rules"
    seen = []

    class Recording(Test):
        def execute(self, writer, reader):
            seen.append(self)
            return super().execute(writer, reader)

    out = {}
    launches = None
    cli.Test, real = Recording, cli.Test
    try:
        for fmt in ("single-line-summary", "json", "junit"):
            runs = {}
            for backend, extra in (("tpu", ["--device", str(device)]), ("cpu", ["--backend", "cpu"])):
                w = Writer.buffered()
                K.reset_launches()
                sync(device)
                t0 = time.perf_counter()
                rc = cli.run(["test", "-d", str(corpus), "-o", fmt, *extra], writer=w)
                sync(device)
                runs[backend] = {"rc": rc, "out": w.stripped(), "err": w.err_to_stripped(),
                                 "wall_s": time.perf_counter() - t0,
                                 "launches": dict(K.LAUNCHES), "routes": seen[-1].routes}
            tpu, cpu = runs["tpu"], runs["cpu"]
            check((tpu["rc"], tpu["out"], tpu["err"]) == (cpu["rc"], cpu["out"], cpu["err"]),
                  f"test {fmt}: the card's run differs from --backend cpu")
            check(tpu["rc"] == 0 and sum(tpu["routes"].values()) == 725,
                  f"test {fmt}: rc {tpu['rc']}, routes {tpu['routes']}")
            check(tpu["routes"]["device"] >= 600, f"test {fmt}: routes {tpu['routes']}")
            if fmt == "single-line-summary":
                files = tpu["out"].count("Testing Guard File ")
                check(files == 249, f"test: {files} files tested")
                launches = tpu["launches"]
                if device.type == "cuda":
                    check(launches["gather_rows"] > 0 and launches["rim_reduce"] == 0,
                          f"test: launches {launches}")
            out[fmt] = {b: {k: v for k, v in r.items() if k not in ("out", "err")}
                        for b, r in runs.items()}
            out[fmt]["bytes"] = len(tpu["out"].encode())
    finally:
        cli.Test = real
    out["launches"] = launches
    return out


def phase_cli(tmp: Path) -> dict:
    from guard_tpu_torch.workloads import FLAGSHIP_RULES, example_docs

    d = tmp / "cli"
    (d / "data").mkdir(parents=True)
    docs = example_docs(2)  # doc 0 lacks encryption (FAIL), doc 1 passes
    (d / "data" / "a_fail.json").write_text(json.dumps(docs[0]))
    (d / "data" / "b_pass.json").write_text(json.dumps(docs[1]))
    (d / "flagship.guard").write_text(FLAGSHIP_RULES)
    proc = subprocess.run(
        [sys.executable, "-m", "guard_tpu_torch", "validate", "--statuses-only",
         "-r", str(d / "flagship.guard"), "-d", str(d / "data")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    # the rule column is padded to the longest rule name plus 4
    width = len("s3_bucket_name_compliant") + 4
    want = (
        "a_fail.json Status = FAIL\n"
        "FAILED rules\n"
        f"flagship.guard/{'s3_bucket_sse'.ljust(width)}FAIL\n"
        "---\n"
        "Evaluating data a_fail.json against rules flagship.guard\n"
        "Number of non-compliant resources 0\n"
    )
    check(proc.returncode == 19, f"cli rc {proc.returncode}: {proc.stderr}")
    check(proc.stdout == want, f"cli stdout {proc.stdout!r}")
    structured = subprocess.run(
        [sys.executable, "-m", "guard_tpu_torch", "validate", "-z", "-o", "json", "-S", "none",
         "-r", str(d / "flagship.guard"), "-d", str(d / "data")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    check(structured.returncode == 19, f"cli -z rc {structured.returncode}: {structured.stderr}")
    check(json.loads(structured.stdout) == cli_expected_reports(d),
          f"cli -z stdout {structured.stdout[:500]!r}")
    return {"rc": proc.returncode, "stdout_lines": len(proc.stdout.splitlines()),
            "structured_rc": structured.returncode,
            "structured_bytes": len(structured.stdout.encode())}


def cli_expected_reports(d: Path) -> list:
    """The structured reports of the CLI phase's documents, from the
    port's CPU evaluator."""
    from guard_tpu_torch.commands.report import simplified_report_from_root
    from guard_tpu_torch.commands.reporters.structured import _strip_locations
    from guard_tpu_torch.core.evaluator import eval_rules_file
    from guard_tpu_torch.core.loader import load_document
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.scopes import RootScope

    rules = parse_rules_file((d / "flagship.guard").read_text(), "flagship.guard")
    out = []
    for p in sorted((d / "data").iterdir()):
        scope = RootScope(rules, load_document(p.read_text(), p.name))
        eval_rules_file(rules, scope, p.name)
        out.append(simplified_report_from_root(scope.reset_recorder().extract(), p.name))
    return _strip_locations(out)


def phase_summary(device) -> dict:
    """Slice 4's main path: the per-rule counts of the security policy
    at real size through DeviceBatchEvaluator.with_summary, one bucket
    at a time, every kernel counter set to 0 just before and read just
    after. The templates are built in memory (no files to parse)."""
    import numpy as np
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_bucketed, take_doc_subset
    from guard_tpu_torch.ops.ir import FAIL, PASS, compile_rules_file
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator, evaluate_groups
    from guard_tpu_torch.workloads import RULES, make_template, volume_template

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 4)
    docs = [from_plain(make_template(rng, i)) for i in range(N_TEMPLATES)]
    docs.append(from_plain(volume_template(N_VOLUMES)))
    n_docs = len(docs)
    t0 = time.perf_counter()
    groups, oversize, interner = encode_bucketed(docs)
    encode_s = time.perf_counter() - t0
    del docs
    check(len(oversize) == 0, f"{len(oversize)} documents left to the host")
    compiled = compile_rules_file(parse_rules_file(RULES, "security.guard"), interner)
    n_rules = len(compiled.rules)
    check(n_rules == 4 and not compiled.host_rules, "RULES did not lower to 4 device rules")
    ev = DeviceBatchEvaluator(compiled, device)

    K.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    results = [ev.with_summary(batch) for batch, _idx in groups]
    sync(device)
    summary_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    shapes = {k: dict(v) for k, v in K.SHAPES.items()}

    statuses = np.zeros((n_docs, n_rules), np.int8)
    counts = np.zeros((3, n_rules), np.int64)
    for (batch, idx), (st, c) in zip(groups, results):
        check(st.shape == (batch.n_docs, n_rules) and st.dtype == np.int8,
              f"with_summary statuses {st.shape} {st.dtype}")
        check(c.shape == (3, n_rules) and c.dtype == np.int32, f"counts {c.shape} {c.dtype}")
        statuses[idx] = st
        counts += c
    check(np.array_equal(counts, np_counts(statuses)),
          "summed counts differ from the statuses' counts")
    check(int(counts.sum()) == n_docs * n_rules, "counts do not cover every pair")
    check(counts[PASS].sum() > 0 and counts[FAIL].sum() > 0, "degenerate counts")
    bucketed = evaluate_groups(ev, n_rules, groups, (), n_docs)[0]
    check(np.array_equal(bucketed, statuses), "with_summary and bucketed statuses differ")
    check(np.array_equal(np_counts(bucketed), counts),
          "counts differ from the bucketed evaluation's")
    n_big = max(b.n_nodes for b, _ in groups)
    check(n_big == 65536, f"largest bucket {n_big} nodes")

    # the first templates on the CPU, bucket by bucket
    cpu = DeviceBatchEvaluator(compiled, "cpu")
    checked = 0
    for (batch, idx), (st, _c) in zip(groups, results):
        sel = np.where(idx < N_SUMMARY_CHECK)[0]
        if len(sel) == 0:
            continue
        cpu_st, cpu_c = cpu.with_summary(take_doc_subset(batch, sel))
        check(np.array_equal(cpu_st, st[sel]), "statuses differ from the CPU's")
        check(np.array_equal(cpu_c, np_counts(cpu_st)), "CPU counts differ from its statuses")
        checked += len(sel)
    check(checked == min(N_SUMMARY_CHECK, n_docs), f"{checked} templates held against the CPU")

    buckets = []
    for (batch, _idx), (st, c) in zip(groups, results):
        entry = {"D": batch.n_docs, "N": batch.n_nodes, "counts": c.tolist()}
        if device.type == "cuda":
            t_st = torch.from_numpy(st).to(device)
            entry["k7_ms"] = cuda_ms(lambda: K.rule_summary(t_st, batch.n_docs))
        buckets.append(entry)
    info = {
        "docs": n_docs, "rules": n_rules, "counts": counts.tolist(),
        "buckets": buckets, "encode_s": encode_s, "summary_s": summary_s,
        "cpu_checked_docs": checked, "wall_s": time.perf_counter() - t_phase,
        "launches": launches, "shapes": shapes,
    }
    if device.type != "cuda":
        return info  # a CPU rehearsal launches no kernel
    check(launches["rule_summary"] == len(groups),
          f"K7 launched {launches['rule_summary']} times for {len(groups)} buckets")
    for name in ("gather_rows", "segment_sum_rows"):
        check(launches[name] > 0, f"kernel {name} never launched on the summary path")
    return info


def phase_entry(device) -> dict:
    """The entry points: entry()'s forward on the card against
    the CPU, then dryrun() (its own checks, the CPU parity among them),
    every kernel counter set to 0 just before and read just after."""
    import contextlib
    import io

    import numpy as np

    from guard_tpu_torch import entry as port_entry
    from guard_tpu_torch import kernels as K

    K.reset_launches()
    sync(device)
    forward, args = port_entry.entry(device)
    statuses, _unsure = forward(*args)
    card = statuses.cpu().numpy()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _st, counts = port_entry.dryrun(device)
    sync(device)
    launches = dict(K.LAUNCHES)
    cpu_forward, cpu_args = port_entry.entry("cpu")
    cpu = cpu_forward(*cpu_args)[0].numpy()
    check(card.shape == cpu.shape and card.shape[0] == 8, f"entry statuses {card.shape}")
    check(np.array_equal(card, cpu), "entry statuses differ from the CPU's")
    line = out.getvalue().strip()
    check(line.startswith("dryrun OK"), f"dryrun printed {line!r}")
    if device.type == "cuda":
        check(launches["rule_summary"] == 1, "dryrun's with_summary did not launch K7")
    return {"entry_statuses": card.tolist(), "dryrun": line,
            "counts": counts.tolist(), "launches": launches}


# ---------------------------------------------------------------------------
# the kernel-vs-oracle differential fuzzer (phase `kernel_fuzz`)
# ---------------------------------------------------------------------------

# the phase's budget in the whole smoke; `--phase kernel_fuzz --fuzz-time
# 420` is the nightly tier on the card
FUZZ_SECONDS = 60.0
# the phase's reproducers, one directory a divergence
FUZZ_CRASH_DIR = ROOT / "kernel_fuzz_crashes"
# K3's block form (a block a row, up to 1,024 rows; guard_kernels.cu)
K3_BLOCK_FORM = "block"


def phase_kernel_fuzz(device, seconds: float = FUZZ_SECONDS) -> tuple:
    """guard_tpu_torch.tools.kernel_fuzz for `seconds` from the smoke's
    SEED, big-document and corpus trials on: every trial held card
    against CPU bit for bit (statuses, unsure bits, rim blocks, K7
    counts), against the CPU oracle and the native oracle, and tiled
    past K3's block form, with every kernel counter set to 0 just before
    and read just after. Fails on any divergence, on a kernel of K1-K7
    launched no time, and unless K3 ran both in its block form and in
    another. Returns (the phase's line, its launches)."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.tools import kernel_fuzz

    K.reset_launches()
    sync(device)
    summary = kernel_fuzz.fuzz(seconds, SEED, device, corpus=True, crash_dir=FUZZ_CRASH_DIR)
    sync(device)
    launches = dict(K.LAUNCHES)
    check(summary["divergences"] == 0,
          "kernel_fuzz: divergence\n" + "\n---\n".join(summary["first_divergences"]))
    if device.type == "cuda":
        never = [name for name in K.NAMES if launches[name] == 0]
        check(not never, f"kernel_fuzz: {never} never launched")
        k3 = summary["forms"]["rim_reduce"]
        check(K3_BLOCK_FORM in k3 and set(k3) - {K3_BLOCK_FORM},
              f"kernel_fuzz: K3 ran in the forms {k3}, not in its block form and another")
    info = {k: v for k, v in summary.items() if k not in ("first_divergences", "reproducers")}
    info.update(launches=launches, trials_per_s=summary["trials"] / summary["seconds"])
    return info, launches


# ---------------------------------------------------------------------------
# the packed registry (phase `packing`)
# ---------------------------------------------------------------------------


def registry_files(tmp: Path):
    """The 249 corpus rule files (as RuleFile objects and copied into a
    rules directory) and the corpus's test inputs written once each into
    a data directory: the registry configuration's files."""
    from guard_tpu_torch.commands.validate import RuleFile
    from guard_tpu_torch.core.parser import parse_rules_file

    paths, plain = corpus_inputs()
    rules_dir, data_dir = tmp / "registry_rules", tmp / "registry_data"
    rules_dir.mkdir()
    data_dir.mkdir()
    rule_files = []
    for p in paths:
        text = p.read_text()
        (rules_dir / p.name).write_text(text)
        rule_files.append(RuleFile(p.name, str(p), text, parse_rules_file(text, p.name)))
    for i, doc in enumerate(plain):
        (data_dir / f"d{i:04d}.json").write_text(json.dumps(doc))
    return rule_files, plain, rules_dir, data_dir


def packing_columns(device, evaluation, rule_files) -> dict:
    """The 253-rule pack's host columnarization (device_arrays) of the
    largest bucket, its copy to the card and its walk with K3 behind it
    (CUDA events), as the packed run issued them."""
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.ops import plan as plan_mod
    from guard_tpu_torch.ops.kernels import arrays_from_numpy
    from guard_tpu_torch.parallel.device import build_walk

    (_pos, packed, spec), = plan_mod.get_plan(rule_files, device=device).packs
    compiled = packed.compiled
    batch = max(evaluation.groups, key=lambda g: g[0].n_docs * g[0].n_nodes)[0]
    t0 = time.perf_counter()
    arrays, lits = compiled.device_arrays(batch), compiled.lit_values()
    cols_s = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    t_arrays, t_lits = arrays_from_numpy(arrays, lits, device)
    sync(device)
    h2d_s = time.perf_counter() - t0
    fn = build_walk(compiled)
    ids = [torch.from_numpy(a).to(device) for a in (spec.group_ids, spec.file_ids, spec.last_ids)]

    def walk():
        st, un = fn(t_arrays, t_lits)
        return K.rim_reduce(st, un if compiled.needs_unsure else None, *ids,
                            spec.n_groups, spec.n_files)

    info = {"D": batch.n_docs, "N": batch.n_nodes, "rules": len(compiled.rules),
            "columns": len(arrays), "columnarize_s": cols_s, "h2d_s": h2d_s,
            "h2d_bytes": sum(v.numel() * v.element_size() for v in t_arrays.values())}
    if device.type == "cuda":
        info["walk_ms"] = cuda_ms(walk, reps=3)
    return info


# `python -m guard_tpu_torch validate ARGS`, then the plan layer's
# counters as the last line of stderr
_CLI_WITH_PLAN_STATS = (
    "import json, sys\n"
    "from guard_tpu_torch import cli\n"
    "from guard_tpu_torch.ops import plan\n"
    "rc = cli.run(sys.argv[1:])\n"
    "sys.stdout.flush()\n"
    "print(json.dumps(plan.plan_stats()), file=sys.stderr)\n"
    "sys.exit(rc)\n"
)


def run_cli_states(argvs: dict, plan_dir: Path, module: bool = False) -> dict:
    """Each argv of `argvs` through the CLI in a process of its own, all
    started together, with the plan artifacts in `plan_dir`: per key its
    rc, stdout, stderr, wall and plan counters (with `module`, as
    `python -m guard_tpu_torch`, which prints no counters)."""
    # serial encode: 725 documents do not pay for spawning an ingest pool
    env = dict(os.environ, GUARD_TPU_PLAN_CACHE_DIR=str(plan_dir), GUARD_TPU_INGEST_WORKERS="0")
    entry = ["-m", "guard_tpu_torch"] if module else ["-c", _CLI_WITH_PLAN_STATS]
    procs = {}
    for key, argv in argvs.items():
        procs[key] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, *entry, *argv], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    out = {}
    for key, (t0, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for _t, other in procs.values():
                other.kill()
            raise
        err, stats = stderr, None
        if not module:
            err, _, stats = stderr.rstrip("\n").rpartition("\n")
            err, stats = (err + "\n" if err else ""), json.loads(stats)
        out[key] = {"rc": proc.returncode, "out": stdout, "err": err,
                    "wall_s": time.perf_counter() - t0, "plan": stats}
    return out


def phase_packing(device, tmp: Path) -> dict:
    """The registry configuration (BASELINE.json config 5 cut to one
    card): all 249 corpus files over the corpus's 725 test inputs
    replicated in order to N_PACKING documents. (1) backend.evaluate
    packed and with packing off on the card and packed on the CPU: equal
    statuses, unsure bits, rim blocks and oracle documents per file, one
    walk and one K3 launch per (pack, bucket) against one per (file,
    bucket); (2) the pack's columnarization and walk; (3) `validate`
    over every N_PACKING_CLI_STRIDE-th of the 725 inputs, `-S all` and
    `-z -o json`, packed, --no-pack,
    --no-plan-cache and on a warm plan cache (a disk hit): the same
    stdout and rc, and the module entry point's equal to them; (4)
    --statuses-only over N_PACKING_STATUSES documents, packed; (5) the
    fault legs: dispatch:nth=1 and collect:nth=1 print the unarmed run's
    stdout and rc and count a dispatch fallback, the unarmed run none,
    and oracle:nth=1 (native oracle off) exits 5 with the injected line.
    Every kernel counter is set to 0 just before the packed run (1) and
    read just after it."""
    import shutil

    import numpy as np
    import torch

    from guard_tpu_torch import cli
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.commands.validate import DataFile, Validate
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops import plan as plan_mod
    from guard_tpu_torch.ops.backend import evaluate
    from guard_tpu_torch.ops.native_encoder import encode_json_bucketed
    from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS, EFFICIENCY_COUNTERS
    from guard_tpu_torch.utils import faults
    from guard_tpu_torch.utils.io import Reader, Writer

    rule_files, plain, rules_dir, data_dir = registry_files(tmp)
    texts = [json.dumps(d) for d in plain]
    pvs = [from_plain(d) for d in plain]
    docs = [pvs[i % len(pvs)] for i in range(N_PACKING)]
    doc_texts = [texts[i % len(texts)] for i in range(N_PACKING)]
    out = {"files": len(rule_files), "inputs": len(plain), "docs": N_PACKING}

    # (1) the evaluation, packed and per file on the card, and packed on
    # the CPU over the distinct inputs (document i is input i % 725)
    runs = {}
    for label, dev, pack in (("packed", device, True), ("per_file", device, False),
                             ("cpu", torch.device("cpu"), True)):
        run_docs, run_texts = (pvs, texts) if label == "cpu" else (docs, doc_texts)
        t0 = time.perf_counter()
        groups, oversize, interner, err = encode_json_bucketed(run_texts)
        check(err is None, f"packing: the native encoder failed: {err}")
        encode_s = time.perf_counter() - t0
        faults.reset_faults()
        DISPATCH_COUNTERS["dispatches"] = 0
        for key in EFFICIENCY_COUNTERS:
            EFFICIENCY_COUNTERS[key] = 0
        K.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        ev = evaluate(rule_files, run_docs, dev, shared=(groups, oversize, interner),
                      pack_rules=pack)
        sync(device)
        wall = time.perf_counter() - t0
        check(faults.FAULT_COUNTERS["dispatch_fallbacks"] == 0
              and faults.FAULT_COUNTERS["oracle_fallbacks"] == 0,
              f"packing {label}: an unarmed run fell back")
        runs[label] = {
            "ev": ev, "wall_s": wall, "encode_s": encode_s, "seconds": dict(ev.seconds),
            "dispatches": DISPATCH_COUNTERS["dispatches"], "launches": dict(K.LAUNCHES),
            "shapes": {k: dict(v) for k, v in K.SHAPES.items()},
            "pack_rule_slots": dict(EFFICIENCY_COUNTERS),
        }
        log(f"packing {label}: wall {wall:.2f}s {json.dumps(ev.seconds)}")
    packed, per_file, cpu = (runs[k]["ev"] for k in ("packed", "per_file", "cpu"))
    check([len(p) for p in packed.packs] == [245] and per_file.packs == [],
          f"packing: packs {[len(p) for p in packed.packs]}")
    n_rules = sum(len(fr.compiled.rules) for fr in packed.files if fr.pack == 0)
    check(n_rules == 253, f"packing: the pack holds {n_rules} rules")
    n_buckets = len(packed.groups)
    own = sum(len(fr.groups) for fr in packed.files if fr.pack is None and fr.compiled.rules)
    check(runs["packed"]["dispatches"] == n_buckets + own,
          f"packing: {runs['packed']['dispatches']} packed walks")
    check(runs["per_file"]["dispatches"] == 245 * n_buckets + own,
          f"packing: {runs['per_file']['dispatches']} per-file walks")
    if device.type == "cuda":
        check(runs["packed"]["launches"]["rim_reduce"] == n_buckets + own,
              f"packing: K3 launched {runs['packed']['launches']['rim_reduce']} times packed")
        check(runs["per_file"]["launches"]["rim_reduce"] == 245 * n_buckets + own,
              "packing: per-file K3 launches")
    tile = np.arange(N_PACKING) % len(plain)
    for label, other, rows in (("per_file", per_file, slice(None)), ("cpu", cpu, tile)):
        for a, b in zip(packed.files, other.files):
            name = a.rule_file.name
            check((a.statuses == b.statuses[rows]).all() and (a.unsure == b.unsure[rows]).all(),
                  f"packing {label}: {name} statuses or unsure differ")
            want = b.host_docs if label == "per_file" else set(
                np.nonzero(np.isin(tile, sorted(b.host_docs)))[0].tolist())
            check(a.host_docs == want, f"packing {label}: {name} oracle docs differ")
            for k, (x, y) in enumerate(zip(a.rim, b.rim)):
                check(x.dtype == y.dtype and x.shape[1] == y.shape[1] and (x == y[rows]).all(),
                      f"packing {label}: {name} rim block {k} differs")
    pack_files = [fr for fr in packed.files if fr.pack == 0]
    spec_ids = plan_mod.get_plan(rule_files, device=device).packs[0][2]
    out.update({
        "buckets": [(b.n_docs, b.n_nodes) for b, _ in packed.groups],
        "packs": [len(p) for p in packed.packs], "pack_rules": n_rules,
        "fail_cells": int(sum((fr.statuses == 1).sum() for fr in pack_files)),
        "host_docs": len(set().union(*(fr.host_docs for fr in packed.files))),
        "runs": {k: {kk: vv for kk, vv in v.items() if kk not in ("ev", "shapes")}
                 for k, v in runs.items()},
    })
    info = {"launches": runs["packed"]["launches"], "shapes": runs["packed"]["shapes"],
            "rim_spec": spec_ids}
    del runs, per_file, cpu

    # (2) the pack's columnarization and walk
    out["pack_bucket"] = packing_columns(device, packed, rule_files)
    del packed
    log(f"packing columns: {json.dumps(out['pack_bucket'])}")

    # (3) the CLI over every N_PACKING_CLI_STRIDE-th input, in four
    # states of the plan layer: the packed runs first, `python -m
    # guard_tpu_torch validate` with a cold plan cache (each saves the
    # artifact), then the other states of both flag sets side by side,
    # the warm one a new process that loads the artifact
    cli_data = tmp / "registry_cli_data"
    cli_data.mkdir()
    for i in range(0, len(texts), N_PACKING_CLI_STRIDE):
        shutil.copyfile(data_dir / f"d{i:04d}.json", cli_data / f"d{i:04d}.json")
    out["cli_inputs"] = len(range(0, len(texts), N_PACKING_CLI_STRIDE))
    cli_dir = tmp / "registry_plans"
    base = ["validate", "--no-result-cache", "--device", str(device),
            "-r", str(rules_dir), "-d", str(cli_data)]
    flag_sets = {"show_all": ["-S", "all"],
                 "structured_json": ["-z", "-o", "json", "-S", "none"]}
    states = {"no_pack": ["--no-pack"], "no_plan_cache": ["--no-plan-cache"], "warm": []}
    cold = run_cli_states({f: base + flags for f, flags in flag_sets.items()}, cli_dir,
                          module=True)
    rest = run_cli_states({(f, st): base + flags + extra for f, flags in flag_sets.items()
                           for st, extra in states.items()}, cli_dir)
    out["cli"] = {}
    for fname in flag_sets:
        first = cold[fname]
        # a few corpus inputs raise in other files' rules (rc 5, their
        # messages on stderr), as on the JAX package
        check(first["rc"] in (19, 5) and first["out"], f"packing cli {fname}: rc {first['rc']}")
        for st in states:
            run = rest[(fname, st)]
            check((run["rc"], run["out"], run["err"]) == (first["rc"], first["out"], first["err"]),
                  f"packing cli {fname}: {st} differs from packed")
        warm = rest[(fname, "warm")]["plan"]
        check(warm["hits"] == 1 and warm["misses"] == 0 and warm["bytes_loaded"] > 0,
              f"packing cli {fname}: the warm run missed: {warm}")
        out["cli"][fname] = {
            "rc": first["rc"], "bytes": len(first["out"].encode()),
            "stderr_lines": len(first["err"].splitlines()), "packed_s": first["wall_s"],
            **{f"{st}_s": rest[(fname, st)]["wall_s"] for st in states},
        }

    # (4) --statuses-only over N_PACKING_STATUSES documents, packed
    files = [DataFile(name=f"d{i:06d}.json", content=doc_texts[i % len(doc_texts)])
             for i in range(N_PACKING_STATUSES)]
    writer = Writer.buffered()
    cmd = Validate(rules=[str(rules_dir)], prepared_data=files, statuses_only=True,
                   device=str(device), result_cache=False)
    K.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    rc = cmd.execute(writer, Reader())
    sync(device)
    wall = time.perf_counter() - t0
    ev = cmd.last_evaluation
    check(rc in (19, 5) and [len(p) for p in ev.packs] == [245],
          f"packing statuses-only: rc {rc}, packs {[len(p) for p in ev.packs]}")
    out["statuses_only"] = {"docs": N_PACKING_STATUSES, "rc": rc, "wall_s": wall,
                            "stderr_lines": len(writer.err_to_stripped().splitlines()),
                            "seconds": dict(ev.seconds), "ingest": ev.ingest.get("path"),
                            "bytes": len(writer.stripped().encode()),
                            "launches": dict(K.LAUNCHES)}
    del files, ev, cmd

    # (5) the fault legs, over the first N_PACKING_FAULT inputs
    fault_data = tmp / "registry_fault_data"
    fault_data.mkdir()
    for i, text in enumerate(texts[:N_PACKING_FAULT]):
        (fault_data / f"d{i:04d}.json").write_text(text)
    fault_args = ["validate", "--no-result-cache", "--device", str(device), "-S", "all",
                  "-r", str(rules_dir), "-d", str(fault_data)]

    def armed(spec):
        if spec:
            os.environ["GUARD_TPU_FAULT"] = spec
        faults.reset_faults()
        writer = Writer.buffered()
        try:
            rc = cli.run(fault_args, writer=writer)
        finally:
            os.environ.pop("GUARD_TPU_FAULT", None)
        return rc, writer.stripped(), writer.err_to_stripped(), faults.fault_stats()

    unarmed = armed(None)
    check(unarmed[0] in (19, 5) and unarmed[3]["dispatch_fallbacks"] == 0
          and unarmed[3]["oracle_fallbacks"] == 0, f"packing faults: unarmed {unarmed[3]}")
    out["faults"] = {}
    for spec in ("dispatch:nth=1", "collect:nth=1"):
        got = armed(spec)
        check(got[:3] == unarmed[:3], f"packing faults: {spec} changed the output")
        check(got[3]["dispatch_fallbacks"] >= 1, f"packing faults: {spec} did not fall back")
        out["faults"][spec] = {k: got[3][k] for k in ("dispatch_fallbacks", "oracle_fallbacks")}
    with native_oracle_off(tmp):
        got = armed("oracle:nth=1")
    check(got[0] == 5 and "injected oracle fault" in got[2]
          and "injected oracle fault" not in unarmed[2],
          f"packing faults: oracle rc {got[0]}: {got[2][-300:]}")
    out["faults"]["oracle:nth=1"] = {"rc": got[0], "injected": got[3]["injected_oracle"]}
    return out, info


# the sweep phase: the registry's documents in chunks of N_SWEEP_CHUNK;
# leg (d) stops the run at the checkpoint of chunk SWEEP_FAULT_NTH - 1;
# leg (f) streams N_FOLLOW lines, N_FOLLOW_MALFORMED of them malformed;
# the CPU holds the first N_SWEEP_PREFIX documents' bytes
N_SWEEP = 6144  # the registry documents the sweep writes (6 chunks)
N_SWEEP_CHUNK = 1024
SWEEP_FAULT_NTH = 5
N_FOLLOW = 1024
N_FOLLOW_MALFORMED = 8
N_SWEEP_PREFIX = 64


def run_sweep(argv, stdin: str = "") -> dict:
    """`sweep ARGV` through the port's CLI in this process, every
    counter set to 0 just before and read just after: rc, stdout,
    stderr, wall, kernel launches, and the resume and pipeline
    counters."""
    from guard_tpu_torch import cli
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.utils import faults, telemetry
    from guard_tpu_torch.utils.io import Reader, Writer

    telemetry.reset_metrics()
    faults.reset_faults()
    K.reset_launches()
    writer = Writer.buffered()
    t0 = time.perf_counter()
    rc = cli.run(["sweep", *argv], writer=writer, reader=Reader.from_string(stdin))
    wall = time.perf_counter() - t0
    return {"rc": rc, "out": writer.stripped(), "err": writer.err_to_stripped(),
            "wall_s": wall, "launches": dict(K.LAUNCHES),
            "resume": telemetry.REGISTRY.group_stats("resume"),
            "pipeline": telemetry.REGISTRY.group_stats("pipeline"),
            "admission": telemetry.REGISTRY.group_stats("admission"),
            "faults": faults.fault_stats()}


def sweep_stores(tmp: Path, label: str) -> None:
    """Fresh journal and result-cache directories for one leg."""
    os.environ["GUARD_TPU_JOURNAL_DIR"] = str(tmp / f"sweep_journal_{label}")
    os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = str(tmp / f"sweep_results_{label}")


def follow_stream(texts: list) -> tuple:
    """N_FOLLOW JSONL lines over the inputs in order: envelopes (even
    lines) and bare documents, N_FOLLOW_MALFORMED lines malformed.
    Returns (stdin, per line its input index or None, per line the name
    its result line must carry)."""
    bad = {k * (N_FOLLOW // N_FOLLOW_MALFORMED) + 7 for k in range(N_FOLLOW_MALFORMED)}
    lines, index, names = [], [], []
    j = 0
    for k in range(N_FOLLOW):
        if k in bad:
            lines.append('{"malformed": ')
            index.append(None)
            names.append(f"stream[{k + 1}]")
            continue
        text = texts[j % len(texts)]
        if k % 2 == 0:
            lines.append(json.dumps({"name": f"f{j:05d}.json", "content": text}))
            names.append(f"f{j:05d}.json")
        else:
            lines.append(text)
            names.append(f"stream[{k + 1}]")
        index.append(j)
        j += 1
    return "\n".join(lines) + "\n", index, names


def phase_sweep(device, tmp: Path):
    """`sweep` on the card over the registry (phase `packing`'s files):
    all 249 corpus rule files over N_SWEEP documents, the corpus's 725
    test inputs replicated in order, in chunks of N_SWEEP_CHUNK, ingest
    workers on auto. (a) a fresh run (new result-cache and journal
    directories), traced; (b) --no-result-cache --no-journal
    --ingest-workers 0: (a)'s stdout, stderr and manifest; (c) a warm
    run over a new manifest: the same bytes, only the documents the
    cache never stores (an oracle pass that raised, a document the card
    does not hold) dispatched, and over N_SWEEP_CHUNK stored documents
    no kernel launch; (d) the
    `journal` fault at checkpoint SWEEP_FAULT_NTH stops a run (rc 5),
    and --resume replays SWEEP_FAULT_NTH - 1 chunks, launches K3 for the
    rest only and prints (a)'s bytes; (e) SIGTERM to a CLI process after
    its first manifest row: rc 75, and --resume prints (a)'s bytes; (f)
    --follow over N_FOLLOW lines: one result line per input line in
    order, the counts and failures of the batch sweep over the same
    documents. The CPU holds the card: over the first N_SWEEP_PREFIX
    documents the card's stdout, stderr and manifest equal those of the
    plain kernels (--device cpu), and its failing rules equal
    `--backend cpu`'s on every document that raised on neither backend;
    (a)'s counts and failed list equal those folded from a --follow run
    on the CPU over the 725 distinct inputs. Every kernel counter is set to 0 just before each
    run and read just after."""
    import signal

    import numpy as np

    from guard_tpu_torch.ops.native_encoder import encode_json_bucketed

    _paths, plain = corpus_inputs()
    texts = [json.dumps(d) for d in plain]
    n_in = len(texts)
    rules_dir = tmp / "registry_rules"
    check(len(list(rules_dir.glob("*.guard"))) == 249, "sweep: the registry's rules are missing")
    data = tmp / "sweep_data"
    data.mkdir()
    for i in range(N_SWEEP):
        (data / f"d{i:05d}.json").write_text(texts[i % n_in])
    # K3 launches once per (pack, bucket) of a chunk: the distinct
    # buckets of the chunk's documents (the oversize ones have none)
    groups, _over, _interner, err = encode_json_bucketed(texts)
    check(err is None, f"sweep: the native encoder failed: {err}")
    bucket_of = np.full(n_in, -1)
    for sub, idx in groups:
        bucket_of[idx] = sub.n_nodes
    n_chunks = -(-N_SWEEP // N_SWEEP_CHUNK)

    def k3_for(chunks) -> int:
        total = 0
        for c in chunks:
            ids = np.arange(c * N_SWEEP_CHUNK, min((c + 1) * N_SWEEP_CHUNK, N_SWEEP)) % n_in
            b = bucket_of[ids]
            total += len(set(b[b >= 0].tolist()))
        return total

    manifest = tmp / "sweep_manifest.jsonl"
    dev = str(device)
    base = ["--device", dev, "-c", str(N_SWEEP_CHUNK), "-r", str(rules_dir), "-d", str(data),
            "-M", str(manifest)]
    out = {"docs": N_SWEEP, "chunks": n_chunks, "chunk_size": N_SWEEP_CHUNK}

    def note(label, run, **extra):
        out[label] = {"rc": run["rc"], "wall_s": run["wall_s"], "launches": run["launches"],
                      **extra}
        log(f"sweep ({label}): rc {run['rc']} in {run['wall_s']:.2f}s, launches "
            f"{json.dumps(run['launches'])}")

    def same(run, label, manifest_bytes):
        check((run["rc"], run["out"], run["err"]) == (a["rc"], a["out"], a["err"]),
              f"sweep ({label}): stdout, stderr or rc differ from (a)")
        check(manifest_bytes == a_manifest, f"sweep ({label}): the manifest differs from (a)")

    # (a) a fresh run, traced
    sweep_stores(tmp, "a")
    trace_out, metrics_out = tmp / "sweep_trace.json", tmp / "sweep_metrics.json"
    a = run_sweep([*base, "--trace-out", str(trace_out), "--metrics-out", str(metrics_out)])
    a_manifest = manifest.read_bytes()
    summary = json.loads(a["out"].splitlines()[-1])
    check(a["rc"] in (19, 5) and summary["chunks"] == n_chunks == summary["evaluated"]
          and summary["documents"] == N_SWEEP, f"sweep (a): rc {a['rc']}, {summary}")
    # the CPU launches no kernel (a rehearsal there skips these checks)
    on_card = device.type == "cuda"
    check(not on_card or a["launches"]["rim_reduce"] == k3_for(range(n_chunks)),
          f"sweep (a): K3 launched {a['launches']['rim_reduce']} times, "
          f"want {k3_for(range(n_chunks))}")
    check(not on_card or (a["launches"]["gather_rows"] > 0
                          and a["launches"]["segment_sum_rows"] > 0),
          "sweep (a): K1 or K2 never launched")
    events = json.loads(trace_out.read_text())["traceEvents"]
    spans: dict = {}
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
    proc = subprocess.run([sys.executable, "-m", "guard_tpu_torch.tools.check_metrics_schema",
                           str(metrics_out)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    check(proc.returncode == 0, f"sweep (a): metrics snapshot: {proc.stderr[-1000:]}")
    check(a["pipeline"]["chunks_prefetched"] + a["pipeline"]["encode_seconds"] > 0,
          f"sweep (a): no ingest in the pipeline counters: {a['pipeline']}")
    note("a_fresh", a, span_s=spans, pipeline=a["pipeline"],
         counts=summary["counts"], errors=summary["errors"], failed=len(summary["failed"]),
         stdout_bytes=len(a["out"].encode()), stderr_lines=len(a["err"].splitlines()))

    # (b) nothing on
    manifest.unlink()
    b = run_sweep([*base, "--no-result-cache", "--no-journal", "--ingest-workers", "0"])
    same(b, "b", manifest.read_bytes())
    note("b_nothing_on", b)

    # (c) warm, over a new manifest. The cache never stores a document
    # whose oracle pass raised or that the card does not hold (its
    # stderr line must come again, its statuses are not the card's):
    # those, and only those, dispatch again. Over the documents that
    # stored, a warm run launches nothing.
    raised = {line.split(" vs ", 1)[0] for line in a["err"].splitlines() if " vs " in line}
    unstored = {i for i in range(N_SWEEP)
                if f"d{i:05d}.json" in raised or bucket_of[i % n_in] < 0}
    manifest.unlink()
    c = run_sweep([*base, "--delta-stats"])
    want = (f"result-cache: {N_SWEEP - len(unstored)}/{N_SWEEP} docs cached, "
            f"{len(unstored)} dispatched\n")
    check(c["err"].endswith(want), f"sweep (c): {c['err'][-200:]!r}, want {want!r}")
    c["err"] = c["err"][: -len(want)]
    same(c, "c", manifest.read_bytes())
    stored = tmp / "sweep_stored"
    stored.mkdir()
    for i in sorted(set(range(N_SWEEP)) - unstored)[:N_SWEEP_CHUNK]:
        (stored / f"d{i:05d}.json").write_text(texts[i % n_in])
    stored_args = ["--device", dev, "-c", str(N_SWEEP_CHUNK), "-r", str(rules_dir),
                   "-d", str(stored), "-M", str(tmp / "sweep_stored.jsonl")]
    (tmp / "sweep_stored.jsonl").unlink(missing_ok=True)
    c_off = run_sweep([*stored_args, "--no-result-cache"])
    (tmp / "sweep_stored.jsonl").unlink()
    c_all = run_sweep(stored_args)
    check((c_all["rc"], c_all["out"]) == (c_off["rc"], c_off["out"]),
          "sweep (c): the warm run over stored documents differs from the run without the cache")
    check(all(v == 0 for v in c_all["launches"].values()),
          f"sweep (c): a run over stored documents launched {c_all['launches']}")
    note("c_warm", c, unstored=len(unstored), raised=len(raised),
         stored_docs_wall_s=c_all["wall_s"], stored_docs_no_cache_wall_s=c_off["wall_s"],
         stored_docs_launches=c_all["launches"])

    # (d) a crash at a checkpoint, then --resume
    sweep_stores(tmp, "d")
    manifest.unlink()
    os.environ["GUARD_TPU_FAULT"] = f"journal:nth={SWEEP_FAULT_NTH}"
    try:
        crash = run_sweep(base)
    finally:
        os.environ.pop("GUARD_TPU_FAULT", None)
    check(crash["rc"] == 5 and crash["out"] == ""
          and f"injected journal fault (chunk{SWEEP_FAULT_NTH - 1})" in crash["err"],
          f"sweep (d): the armed run: rc {crash['rc']}: {crash['err'][-300:]}")
    resumed = run_sweep([*base, "--resume"])
    same(resumed, "d", manifest.read_bytes())
    check(resumed["resume"]["chunks_replayed"] == SWEEP_FAULT_NTH - 1,
          f"sweep (d): replayed {resumed['resume']}")
    want_k3 = k3_for(range(SWEEP_FAULT_NTH - 1, n_chunks))
    check(not on_card or resumed["launches"]["rim_reduce"] == want_k3,
          f"sweep (d): K3 launched {resumed['launches']['rim_reduce']} times, want {want_k3}")
    note("d_crash", crash)
    note("d_resume", resumed, resume=resumed["resume"])

    # (e) SIGTERM after the first manifest row, then --resume
    sweep_stores(tmp, "e")
    manifest.unlink()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "guard_tpu_torch", "sweep", *base,
                             "--no-result-cache"], cwd=ROOT, env=dict(os.environ),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while proc.poll() is None and not (
                manifest.exists() and manifest.read_bytes().count(b"\n") >= 1):
            check(time.perf_counter() - t0 < 600, "sweep (e): no manifest row in 600 s")
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        _o, drain_err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rows = manifest.read_bytes().count(b"\n")
    check(proc.returncode == 75 and 1 <= rows < n_chunks,
          f"sweep (e): rc {proc.returncode} with {rows} rows: {drain_err[-300:]}")
    drain_s = time.perf_counter() - t0
    drained = run_sweep([*base, "--no-result-cache", "--resume"])
    same(drained, "e", manifest.read_bytes())
    check(drained["resume"]["chunks_replayed"] == rows, f"sweep (e): {drained['resume']}")
    out["e_drain"] = {"rc": proc.returncode, "wall_s": drain_s, "rows": rows}
    note("e_resume", drained, resume=drained["resume"])

    # (f) --follow over N_FOLLOW lines, and the batch sweep over the
    # same documents
    sweep_stores(tmp, "f")
    stdin, index, names = follow_stream(texts)
    follow = run_sweep(["--follow", "--device", dev, "-r", str(rules_dir)], stdin=stdin)
    lines = [json.loads(ln) for ln in follow["out"].splitlines()]
    check(len(lines) == N_FOLLOW + 1 and lines[-1].get("follow") is True,
          f"sweep (f): {len(lines)} lines for {N_FOLLOW} inputs")
    check([ln["name"] for ln in lines[:-1]] == names, "sweep (f): result lines out of order")
    check(sum("quarantined" in ln for ln in lines[:-1]) == N_FOLLOW_MALFORMED,
          "sweep (f): malformed lines not quarantined")
    follow_data = tmp / "follow_data"
    follow_data.mkdir()
    for j in sorted({j for j in index if j is not None}):
        (follow_data / f"f{j:05d}.json").write_text(texts[j % n_in])
    follow_manifest = tmp / "follow_manifest.jsonl"
    batch = run_sweep(["--device", dev, "-c", str(N_SWEEP_CHUNK), "--no-result-cache",
                       "-r", str(rules_dir), "-d", str(follow_data), "-M", str(follow_manifest)])
    b_sum = json.loads(batch["out"].splitlines()[-1])
    by_name = {name: j for name, j in zip(names, index)}
    f_sum = lines[-1]
    f_failed = [{"data": f"f{by_name[x['data']]:05d}.json", "rules": x["rules"]}
                for x in f_sum["failed"]]
    check(f_sum["counts"] == b_sum["counts"] and f_failed == b_sum["failed"],
          "sweep (f): the stream's statuses differ from the batch sweep's")
    note("f_follow", follow, batches=follow["admission"]["follow_batches"],
         counts=f_sum["counts"], batch_wall_s=batch["wall_s"])

    # the CPU: the first N_SWEEP_PREFIX documents' bytes, and the full
    # run's tallies folded from the 725 distinct inputs' outcomes
    prefix = tmp / "sweep_prefix"
    prefix.mkdir()
    for i in range(N_SWEEP_PREFIX):
        (prefix / f"d{i:05d}.json").write_text(texts[i % n_in])
    pre = {}
    for label, extra in (("card", ["--device", dev]), ("plain", ["--device", "cpu"]),
                         ("cpu", ["--backend", "cpu"])):
        manifest.unlink(missing_ok=True)
        pre[label] = run_sweep([*extra, "--no-result-cache", "-c", str(N_SWEEP_PREFIX),
                                "-r", str(rules_dir), "-d", str(prefix), "-M", str(manifest)])
        pre[label]["manifest"] = manifest.read_bytes()
    check(all(pre["card"][k] == pre["plain"][k] for k in ("rc", "out", "err", "manifest")),
          "sweep: the card's prefix differs from the plain kernels' on the CPU")
    # `--backend cpu` evaluates every (document, rules file) pair on the
    # CPU evaluator, where a few corpus inputs raise in other files'
    # rules and lose those files' statuses; the card's path reruns only
    # the documents it cannot settle. So stderr, the counts and the exit
    # code differ between the backends (the JAX package's backends
    # differ the same way); the failing rules of every document that
    # raised on neither must not.
    def failing(run, skip):
        summary = json.loads(run["out"].splitlines()[-1])
        return [f for f in summary["failed"] if f["data"] not in skip]

    raised = {line.split(" vs ", 1)[0] for r in pre.values()
              for line in r["err"].splitlines() if " vs " in line}
    check(failing(pre["card"], raised) == failing(pre["cpu"], raised),
          "sweep: the card's failing rules differ from --backend cpu's")
    env_saved = {k: os.environ.get(k) for k in ("GUARD_TPU_FOLLOW_MAX_BATCH",
                                                 "GUARD_TPU_FOLLOW_WAIT_MS")}
    os.environ.update(GUARD_TPU_FOLLOW_MAX_BATCH=str(n_in), GUARD_TPU_FOLLOW_WAIT_MS="2000")
    try:
        fold = run_sweep(["--follow", "--device", "cpu", "--no-result-cache",
                          "-r", str(rules_dir)],
                         stdin="".join(json.dumps({"name": f"i{i}", "content": t}) + "\n"
                                       for i, t in enumerate(texts)))
    finally:
        for k, v in env_saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    outcome = [json.loads(ln) for ln in fold["out"].splitlines()[:-1]]
    check(len(outcome) == n_in and all("status" in o for o in outcome),
          "sweep: the CPU fold lost an input")
    counts = {k: 0 for k in ("pass", "fail", "skip")}
    failed = []
    for i in range(N_SWEEP):
        o = outcome[i % n_in]
        counts[o["status"]] += 1
        if o["fails"]:
            failed.append({"data": f"d{i:05d}.json", "rules": o["fails"]})
    check(counts == summary["counts"] and failed == summary["failed"],
          "sweep (a): the card's tallies differ from the CPU's fold")
    out["cpu"] = {"prefix_card_s": pre["card"]["wall_s"], "prefix_cpu_s": pre["cpu"]["wall_s"],
                  "prefix_errors": {k: json.loads(r["out"].splitlines()[-1])["errors"]
                                    for k, r in pre.items()},
                  "prefix_raised_docs": len(raised),
                  "fold_s": fold["wall_s"]}
    info = {"launches": a["launches"]}
    return out, info


# -- phase serve: the serving plane on the card ------------------------------

N_SERVE_REQUESTS = 256  # leg (a): tagged requests, two documents each
N_SERVE_OFF = 32  # leg (a) with coalescing off: the first 32 of them
N_SERVE_CLIENTS = 16
# leg (b): AdmissionReviews over HTTP (cut from 512 when phase
# `multicard` joined the smoke: 1,079 s in all, PERF.md §4)
N_WEBHOOK = 256
N_WEBHOOK_CLIENTS = 32
WEBHOOK_CHECK_STRIDE = 8  # every 8th review is held against a --no-coalesce listener
N_ISOLATION = 16  # leg (c): one poisoned request among 15 clean peers
POISONED = 5
N_DRAIN_CLIENTS = 32  # leg (d)
DRAIN_AFTER_S = 1.0
N_STDIO_DRAIN = 64  # leg (d): tagged lines read before the stdio session's latch trips
SERVE_SEED = 20261018


def pct(values, q: float) -> float:
    """The q-quantile (nearest rank) of `values`, in milliseconds."""
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(round(q * len(s))) - 1))] * 1e3


def serve_lines(n: int):
    """n request lines alternating the slice's security policy and the
    cross-reference policy, two templates each (ids tagged), and the
    same lines untagged."""
    import numpy as np

    from guard_tpu_torch import workloads

    rng = np.random.default_rng(SERVE_SEED)
    tagged, untagged = [], []
    for i in range(n):
        xref = i % 2 == 1
        make = workloads.make_xref_template if xref else workloads.make_template
        body = {"rules": [workloads.XREF_RULES if xref else workloads.RULES],
                "data": [json.dumps(make(rng, 2 * i + k)) for k in range(2)],
                "backend": "tpu"}
        untagged.append(json.dumps(body))
        tagged.append(json.dumps({**body, "id": i}))
    return tagged, untagged


def drive_clients(answer, n: int, n_clients: int):
    """`answer(i)` for i in range(n) from n_clients threads (client c
    takes i = c, c + n_clients, ...), released together: the answers
    and each one's wall in seconds."""
    results = [None] * n
    lat = [0.0] * n
    barrier = threading.Barrier(n_clients)
    errors = []

    def client(c):
        try:
            barrier.wait(120)
            for i in range(c, n, n_clients):
                t0 = time.perf_counter()
                results[i] = answer(i)
                lat[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    check(not errors and all(not t.is_alive() for t in threads),
          f"serve: a client failed or hung: {errors[:3]}")
    return results, lat


def http_call(port: int, method: str, path: str, body=None, timeout: float = 120):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def start_listener(device, tmp: Path, label: str, rules, *flags):
    """`python -X importtime -m guard_tpu_torch serve --listen
    127.0.0.1:0 --rules ...` in a process of its own (the card unless
    the phase runs on the CPU): the process and the file its stderr goes
    to (the announcement and every module it imports)."""
    err_path = tmp / f"listener_{label}.err"
    argv = [sys.executable, "-X", "importtime", "-m", "guard_tpu_torch", "serve",
            "--listen", "127.0.0.1:0", *flags, "--rules", *[str(p) for p in rules]]
    if device.type != "cuda":
        argv[6:6] = ["--device", str(device)]
    env = {k: v for k, v in os.environ.items() if k != "GUARD_TPU_FAULT"}
    err = open(err_path, "w")
    proc = subprocess.Popen(argv, cwd=str(ROOT), env=env, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    return proc, err_path


def listener_port(proc, err_path: Path, label: str) -> int:
    """The port a started listener announced on stderr."""
    deadline = time.monotonic() + 300
    prefix = "guard-tpu serve: listening on 127.0.0.1:"
    while time.monotonic() < deadline:
        for line in err_path.read_text().splitlines():
            if line.startswith(prefix):
                return int(line[len(prefix):])
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    proc.wait(30)
    check(False, f"serve ({label}): the listener did not announce itself: "
                 f"{err_path.read_text()[-2000:]}")


def imported_forbidden(err_path: Path) -> list:
    """The jax and guard_tpu modules a `-X importtime` process imported."""
    names = []
    for line in err_path.read_text().splitlines():
        if line.startswith("import time:") and "|" in line:
            names.append(line.rsplit("|", 1)[1].strip())
    return sorted(n for n in names if n == "jax" or n.startswith(("jax.", "jaxlib"))
                  or n == "guard_tpu" or n.startswith("guard_tpu."))


def stop_listener(proc) -> int:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(30)


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def phase_serve(device, tmp: Path) -> tuple:
    """`serve` on the card (after phase `sweep`, on its registry files):
    (a) 256 tagged requests from 16 client threads through
    Serve.handle_line, alternating the security and cross-reference
    policies, two templates each, with coalescing on (and off over the
    first 64): every answer the bytes of a fresh session's untagged
    one-at-a-time run; fewer dispatches per request with coalescing on;
    (b) the 249-file
    registry as the webhook of a `serve --listen` process: 32 client
    threads POST 256 AdmissionReviews wrapping the corpus's inputs in
    order, every 8th held against a `--no-coalesce` session's answer
    (in this process, while the listener starts), the listener's
    metrics document read over HTTP (K3 once per dispatch);
    (c) a poisoned request among 15 clean peers answers its own code-5
    envelope and the peers are unchanged, and an injected serve_batch
    fault re-fires the group solo with the same bytes; (d) SIGTERM to
    (b)'s listener under load: exit 75, the requests in flight finish,
    later connections are refused; then a stdio session drained with
    requests queued: exit 75, the queued ones answer the Draining
    envelope; (e) one Lambda "documents"
    event on the card answers the session's bytes. One JSON line per
    leg on stdout. No listener imports jax or guard_tpu."""
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch import lambda_handler, workloads
    from guard_tpu_torch.commands.serve import Serve
    from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS
    from guard_tpu_torch.utils import faults
    from guard_tpu_torch.utils.telemetry import SERVE_COUNTERS

    on_card = device.type == "cuda"
    dev = None if on_card else str(device)
    info: dict = {}
    t_phase = time.perf_counter()

    # (a) the stdio session's handler, two digests
    t0 = time.perf_counter()
    tagged, untagged = serve_lines(N_SERVE_REQUESTS)
    ref_srv = Serve(stdio=False, coalesce=False, device=dev)
    ref = [ref_srv.handle_line(line) for line in untagged]
    ref_s = time.perf_counter() - t0
    check(all(r["code"] in (0, 19) for r in ref),
          f"serve (a): the sequential run answered {[r for r in ref if r['code'] == 5][:1]}")
    runs = {}
    for label, coalesce, n in (("on", True, N_SERVE_REQUESTS), ("off", False, N_SERVE_OFF)):
        srv = Serve(stdio=False, coalesce=coalesce, device=dev)
        srv.handle_line(untagged[0])  # the session warms before its clients
        K.reset_launches()
        d0, s0 = DISPATCH_COUNTERS["dispatches"], dict(SERVE_COUNTERS)
        t1 = time.perf_counter()
        got, lat = drive_clients(lambda i, srv=srv: srv.handle_line(tagged[i]), n,
                                 N_SERVE_CLIENTS)
        if on_card:
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        bad = [i for i in range(n) if got[i] != ref[i]]
        check(not bad, f"serve (a, coalesce {label}): {len(bad)} answers differ from the "
                       f"sequential session's, first {bad[:4]}")
        runs[label] = {
            "requests": n, "wall_s": wall, "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99),
            "dispatches_per_request": (DISPATCH_COUNTERS["dispatches"] - d0) / n,
            "coalesced_batches": SERVE_COUNTERS["coalesced_batches"] - s0["coalesced_batches"],
            "coalesced_requests": SERVE_COUNTERS["coalesced_requests"]
            - s0["coalesced_requests"],
            "launches": dict(K.LAUNCHES),
        }
    check(runs["on"]["dispatches_per_request"] < runs["off"]["dispatches_per_request"],
          f"serve (a): {runs['on']['dispatches_per_request']} dispatches a request with "
          f"coalescing on, {runs['off']['dispatches_per_request']} off")
    launches_a = runs["on"]["launches"]
    check(not on_card or all(launches_a[k] > 0 for k in WALK_KERNELS),
          f"serve (a): a kernel of the path never launched: {launches_a}")
    info["a"] = {"requests": N_SERVE_REQUESTS, "clients": N_SERVE_CLIENTS,
                 "sequential_s": ref_s, "wall_s": time.perf_counter() - t0, **runs}
    print(json.dumps({"serve_leg": "a", **info["a"]}), flush=True)
    log(f"serve (a): on {json.dumps({k: v for k, v in runs['on'].items() if k != 'launches'})}"
        f", off {json.dumps({k: v for k, v in runs['off'].items() if k != 'launches'})}")

    # (b) the registry's webhook over HTTP
    t0 = time.perf_counter()
    rules = sorted((tmp / "registry_rules").glob("*.guard"))
    check(len(rules) == 249, "serve (b): the registry's rules are missing")
    _paths, plain = corpus_inputs()
    reviews = [json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                           "request": {"uid": f"r{i}", "object": plain[i % len(plain)]}})
               for i in range(N_WEBHOOK)]
    proc, err_on = start_listener(device, tmp, "coalesce", rules)
    try:
        # while the listener starts, a --no-coalesce session in this
        # process answers every 8th review (the reference of (b))
        t1 = time.perf_counter()
        off = Serve(stdio=False, coalesce=False, rules=[str(p) for p in rules], device=dev)
        want_b = {i: off.handle_webhook(reviews[i])
                  for i in range(0, N_WEBHOOK, WEBHOOK_CHECK_STRIDE)}
        check_s = time.perf_counter() - t1
        port = listener_port(proc, err_on, "coalesce")
        warm_status, _ = http_call(port, "POST", "/webhook", reviews[0], timeout=600)
        check(warm_status == 200, f"serve (b): the first review answered {warm_status}")
        _s, m0 = http_call(port, "GET", "/metrics")
        t1 = time.perf_counter()
        answers, lat = drive_clients(lambda i: http_call(port, "POST", "/webhook", reviews[i]),
                                     N_WEBHOOK, N_WEBHOOK_CLIENTS)
        wall_b = time.perf_counter() - t1
        _s, m1 = http_call(port, "GET", "/metrics")
        check(all(st == 200 and doc["response"]["uid"] == f"r{i}"
                  for i, (st, doc) in enumerate(answers)),
              "serve (b): a review did not answer 200 with its uid")
        check(not any("fail-open" in doc["response"]["status"].get("message", "")
                      for _st, doc in answers), "serve (b): an evaluation error failed open")
        for i, want in want_b.items():
            check(answers[i] == want, f"serve (b): review {i} differs from --no-coalesce's")
        c0, c1 = m0["metrics"]["counters"], m1["metrics"]["counters"]
        launches_b = launch_delta(m0.get("launches", {}), m1.get("launches", {}))
        dispatches = c1["dispatch"]["dispatches"] - c0["dispatch"]["dispatches"]
        batches = c1["serve"]["coalesced_batches"] - c0["serve"]["coalesced_batches"]
        singles = c1["serve"]["singleton_batches"] - c0["serve"]["singleton_batches"]
        check(not on_card or launches_b.get("rim_reduce") == dispatches > 0,
              f"serve (b): K3 launched {launches_b.get('rim_reduce')} times over "
              f"{dispatches} dispatches")
        allowed = sum(1 for _st, doc in answers if doc["response"]["allowed"])
        info["b"] = {
            "reviews": N_WEBHOOK, "clients": N_WEBHOOK_CLIENTS, "rule_files": len(rules),
            "wall_s": wall_b, "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99),
            "allowed": allowed, "denied": N_WEBHOOK - allowed,
            "dispatches": dispatches, "coalesced_batches": batches,
            "singleton_batches": singles,
            "dispatches_per_evaluation": dispatches / max(1, batches + singles),
            "launches": launches_b, "checked_against_no_coalesce": len(want_b),
            "no_coalesce_s": check_s,
            "metrics_histograms": {
                k: m1["metrics"]["histograms"].get(k, {}).get("count")
                for k in ("serve_request_seconds", "serve_queue_wait_seconds",
                          "serve_dispatch_seconds")},
        }
        print(json.dumps({"serve_leg": "b", **info["b"]}), flush=True)
        log(f"serve (b) in {time.perf_counter() - t0:.1f}s: "
            f"{json.dumps({k: v for k, v in info['b'].items() if k != 'launches'})}")

        # (d) SIGTERM to the listener of (b) while requests are in flight,
        # then a stdio session whose latch trips with requests queued
        info["d"] = drain_leg(proc, port, untagged[0], ref[0])
        info["d"]["stdio"] = stdio_drain_leg(dev, tagged, ref)
        print(json.dumps({"serve_leg": "d", **info["d"]}), flush=True)
        log(f"serve (d): {json.dumps(info['d'])}")
    finally:
        stop_listener(proc)
    leaked = imported_forbidden(err_on)
    check(not leaked, f"serve: the listener imported {leaked[:5]}")

    # (c) isolation on the card
    t0 = time.perf_counter()
    security = [i for i in range(N_SERVE_REQUESTS) if i % 2 == 0][:N_ISOLATION]
    lines_c = [untagged[i] for i in security]
    body = json.loads(lines_c[POISONED])
    body["data"][0] = body["data"][0][: len(body["data"][0]) // 2]
    lines_c[POISONED] = json.dumps(body)
    want_c = [ref[i] for i in security]
    want_c[POISONED] = Serve(stdio=False, coalesce=False, device=dev).handle_line(
        lines_c[POISONED])
    check(want_c[POISONED]["code"] == 5 and want_c[POISONED]["error_class"] == "ParseError",
          f"serve (c): the poisoned request answered {want_c[POISONED]}")
    srv = Serve(stdio=False, device=dev)
    b0 = SERVE_COUNTERS["coalesced_batches"]
    got, _lat = drive_clients(lambda i: srv.handle_line(lines_c[i]), N_ISOLATION, N_ISOLATION)
    check(got == want_c, "serve (c): the poisoned group's answers differ from sequential")
    poisoned_batches = SERVE_COUNTERS["coalesced_batches"] - b0
    faults.reset_faults()
    os.environ["GUARD_TPU_FAULT"] = "serve_batch:nth=1"
    try:
        r0 = SERVE_COUNTERS["isolation_refires"]
        srv = Serve(stdio=False, device=dev)
        clean = [untagged[i] for i in security]
        got, _lat = drive_clients(lambda i: srv.handle_line(clean[i]), N_ISOLATION,
                                  N_ISOLATION)
        refires = SERVE_COUNTERS["isolation_refires"] - r0
        injected = faults.FAULT_COUNTERS["injected_serve_batch"]
    finally:
        del os.environ["GUARD_TPU_FAULT"]
        faults.reset_faults()
    check(got == [ref[i] for i in security], "serve (c): the re-fired group's answers differ")
    check(refires > 0 and injected == 1, f"serve (c): {refires} re-fires, {injected} faults")
    info["c"] = {"requests": N_ISOLATION, "poisoned_index": POISONED,
                 "poisoned_group_batches": poisoned_batches, "isolation_refires": refires,
                 "wall_s": time.perf_counter() - t0}
    print(json.dumps({"serve_leg": "c", **info["c"]}), flush=True)

    # (e) the Lambda face on the card
    t0 = time.perf_counter()
    first = json.loads(untagged[0])
    lambda_handler._SESSION = None
    if not on_card:
        lambda_handler._SESSION = Serve(stdio=False, device=dev)
    got_e = lambda_handler.handler({"documents": first["data"], "rules": first["rules"]})
    check(got_e == ref[0], "serve (e): the Lambda answer differs from the session's")
    check(lambda_handler._SESSION.device == dev, "serve (e): the Lambda session left the card")
    lambda_handler._SESSION = None
    info["e"] = {"code": got_e["code"], "wall_s": time.perf_counter() - t0}
    print(json.dumps({"serve_leg": "e", **info["e"]}), flush=True)
    info["wall_s"] = time.perf_counter() - t_phase
    all_launches = {"serve": {"launches": launches_a},
                    "serve_webhook": {"launches": {k: launches_b.get(k, 0) for k in K.NAMES}}}
    return info, all_launches


def stdio_drain_leg(dev, tagged: list, ref: list) -> dict:
    """(d), the stdio session: N_STDIO_DRAIN tagged lines are read (16
    run on the pool, the rest queue behind them), then the drain latch
    trips and one more line arrives. The session exits 75; the late
    line and every request still queued answer the Draining envelope,
    and every request that had started answers its own bytes."""
    import io

    from guard_tpu_torch.commands.serve import Serve
    from guard_tpu_torch.utils.io import Reader, Writer
    from guard_tpu_torch.utils.journal import DrainLatch

    latch = DrainLatch()

    class TrippingReader(Reader):
        def stream(self):
            for line in tagged[:N_STDIO_DRAIN]:
                yield line + "\n"
            latch.trip("smoke")
            yield tagged[N_STDIO_DRAIN] + "\n"

    w = Writer.buffered()
    t0 = time.perf_counter()
    rc = Serve(stdio=True, device=dev, drain_latch=latch).execute(
        w, TrippingReader(io.StringIO("")))
    wall = time.perf_counter() - t0
    resps = [json.loads(line) for line in w.out.getvalue().splitlines()]
    draining = [r for r in resps if r.get("error_class") == "Draining"]
    answered = [r for r in resps if r.get("error_class") != "Draining"]
    check(rc == 75, f"serve (d, stdio): the session exited {rc}, not 75")
    check(sorted(r["id"] for r in resps) == list(range(N_STDIO_DRAIN + 1)),
          "serve (d, stdio): a request got no answer, or two")
    check(N_STDIO_DRAIN in {r["id"] for r in draining} and len(draining) > 1,
          f"serve (d, stdio): {len(draining)} Draining answers")
    check(all({k: v for k, v in r.items() if k != "id"} == ref[r["id"]] for r in answered),
          "serve (d, stdio): a started request's answer differs from the sequential one")
    return {"rc": rc, "requests": N_STDIO_DRAIN + 1, "answered": len(answered),
            "draining": len(draining), "wall_s": wall}


def drain_leg(proc, port: int, line: str, want: dict) -> dict:
    """(d): N_DRAIN_CLIENTS clients POST `line` to /validate in a loop;
    after DRAIN_AFTER_S the listener gets SIGTERM. It must exit 75, and
    every request whose connection was made before the signal must come
    back whole: its verdict, or the Draining envelope if it reached the
    session after the latch tripped. After the stop, connections are
    refused."""
    import http.client
    import signal

    stop = threading.Event()
    sig_at = [None]
    outcomes = []
    lock = threading.Lock()

    def one():
        """(kind, sent, connected or None, done, status, body or error)"""
        t_send = time.monotonic()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            try:
                conn.connect()
            except OSError as e:
                return ("refused", t_send, None, time.monotonic(), None, repr(e))
            t_conn = time.monotonic()
            try:
                conn.request("POST", "/validate", body=line,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                return ("answer", t_send, t_conn, time.monotonic(), resp.status, body)
            except (OSError, http.client.HTTPException, ValueError) as e:
                return ("error", t_send, t_conn, time.monotonic(), None, repr(e))
        finally:
            conn.close()

    def client(_c):
        deadline = time.monotonic() + 120
        while not stop.is_set() and time.monotonic() < deadline:
            rec = one()
            with lock:
                outcomes.append(rec)
            if rec[0] != "answer" and sig_at[0] is not None:
                return

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(N_DRAIN_CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(DRAIN_AFTER_S)
    sig_at[0] = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(120)
    except subprocess.TimeoutExpired:
        rc = None
    stop.set()
    for t in threads:
        t.join(120)
    t_sig = sig_at[0]
    answers = [o for o in outcomes if o[0] == "answer"]
    verdicts = [o for o in answers if o[5].get("error_class") is None]
    draining = [o for o in answers if o[5].get("error_class") == "Draining"]
    other = [o for o in answers if o not in verdicts and o not in draining]
    cut = [o for o in outcomes if o[0] != "answer" and o[2] is not None and o[2] < t_sig]
    finished = [o for o in verdicts if o[2] < t_sig < o[3]]
    check(rc == 75, f"serve (d): the listener exited {rc}, not 75")
    check(not other and all(o[4] == 200 and {k: o[5][k] for k in want} == want
                            for o in verdicts),
          f"serve (d): answers other than the verdict or Draining: {other[:2]}")
    check(not cut, f"serve (d): connections made before the signal got no answer: {cut[:2]}")
    check(finished, "serve (d): no request was in flight at the signal")
    return {"rc": rc, "requests": len(outcomes), "verdicts": len(verdicts),
            "finished_after_signal": len(finished), "draining": len(draining),
            "refused_after_stop": sum(o[0] == "refused" for o in outcomes),
            "reset_after_signal": sum(o[0] == "error" for o in outcomes)}


def main_shape(shapes: dict, name: str):
    """The launch shape of a kernel that moved the most elements on the
    main path."""
    def volume(item):
        shape, count = item
        return count * shape[0] * shape[1]

    return max(shapes[name].items(), key=volume)[0]


def wide_shape(shapes: dict, name: str):
    """The launch shape of a kernel in the widest bucket of the main path
    (the one-document 65,536-node bucket) that launched most often, the
    wider output first among equals."""
    widest = max(shape[1] for shape in shapes[name])
    return max((item for item in shapes[name].items() if item[0][1] == widest),
               key=lambda item: (item[1], item[0][-1]))[0]


def seg_min_max_library(seg, mask, hi, lo, s: int):
    """One PyTorch call per extreme that computes K6's function, as
    packed int64 keys: scatter_reduce_ amin and amax into tables filled
    with the empty-segment sentinels. Every segment id must lie in
    [0, s)."""
    import torch

    from guard_tpu_torch.kernels import plain

    d = seg.shape[0]
    packed = plain.pack_key(hi, lo)
    at = torch.where(mask, seg, 0).long()
    lo_keys = torch.where(mask, packed, (1 << 63) - 1)
    hi_keys = torch.where(mask, packed, -(1 << 63))

    def library():
        mn = torch.full((d, s), (1 << 63) - 1, dtype=torch.int64, device=seg.device)
        mx = torch.full((d, s), -(1 << 63), dtype=torch.int64, device=seg.device)
        mn.scatter_reduce_(1, at, lo_keys, "amin")
        mx.scatter_reduce_(1, at, hi_keys, "amax")
        return mn, mx

    return library


def k3_packed_row(device, gen, pk: dict, rate: float) -> dict:
    """K3 at the registry pack's launch shape, on the pack's own group,
    file and last-rule ids and seeded statuses and unsure bits, against
    its plain version."""
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    spec = pk["rim_spec"]
    d, r, g, f = main_shape(pk["shapes"], "rim_reduce")
    check((r, g, f) == (len(spec.group_ids), spec.n_groups, spec.n_files),
          f"the packed K3 shape {(d, r, g, f)} is not the pack's")
    args = k3_inputs(gen, d, r, g, f, device)[:2] + tuple(
        torch.from_numpy(a).to(device) for a in (spec.group_ids, spec.file_ids, spec.last_ids))
    return {
        "name": "rim_reduce", "path": "packing",
        "shape": {"D": d, "R": r, "G": g, "F": f},
        "shape_launches": pk["shapes"]["rim_reduce"][(d, r, g, f)],
        "branch": K._lib().guard_rim_reduce_branch(d, r, g, f),
        "max_abs_err": _max_abs_err(K.rim_reduce(*args, g, f), plain.rim_reduce(*args, g, f)),
        "ms": cuda_ms(lambda: K.rim_reduce(*args, g, f)),
        "device_ms": graph_ms(lambda: K.rim_reduce(*args, g, f)),
        "plain_ms": cuda_ms(lambda: plain.rim_reduce(*args, g, f), reps=3),
        "bound_ms": k3_bytes(d, r, g, f) / rate * 1e3,
        "library_ms": None,
    }


# phase `multicard`: the registry's documents through the packed mesh,
# the slice's templates through the sharded with_summary, and the
# registry documents of the --rule-shards sweep (depth cut, full width)
N_MULTICARD_DOCS = 4096
N_MULTICARD_SUMMARY = 2048
N_MULTICARD_SWEEP = 1024


def multicard_devices() -> tuple:
    """(cards visible, the mesh's device list): every card when two or
    more are visible, else the one card named twice, so the slicing,
    the per-entry streams, the concatenation and the summed K7 counts
    still run."""
    import torch

    k = torch.cuda.device_count()
    if k >= 2:
        return k, [torch.device("cuda", i) for i in range(k)]
    return k, [torch.device("cuda", 0)] * 2


@contextlib.contextmanager
def walk_tally():
    """Count every DeviceBatchEvaluator walk by card while the block
    runs, with its host seconds: columnarize (CompiledRules.
    device_arrays), the copy to the card (arrays_from_numpy), the rest
    of the walk's enqueue, and the collects (the wait for the card and
    the copies back). Yields {card: {...}}, which the caller may clear."""
    from guard_tpu_torch.ops.ir import CompiledRules
    from guard_tpu_torch.parallel import device as device_mod

    tally: dict = {}
    here = threading.local()
    saved = (device_mod.DeviceBatchEvaluator._walk, device_mod.DeviceBatchEvaluator.collect,
             device_mod.DeviceBatchEvaluator.summary_collect, device_mod.arrays_from_numpy,
             CompiledRules.device_arrays)
    walk0, collect0, summary0, h2d0, columns0 = saved

    def card(ev):
        return tally.setdefault(str(ev.device), dict.fromkeys(
            ("walks", "walk_s", "columnarize_s", "h2d_s", "collect_s"), 0))

    def timed(fn, key):
        def run(*a, **kw):
            t = getattr(here, "card", None)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if t is not None:
                    t[key] += time.perf_counter() - t0
        return run

    def walk(self, batch):
        here.card = t = card(self)
        t0 = time.perf_counter()
        try:
            return walk0(self, batch)
        finally:
            here.card = None
            t["walks"] += 1
            t["walk_s"] += time.perf_counter() - t0

    def collected(fn):
        def run(self, handle):
            t0 = time.perf_counter()
            try:
                return fn(self, handle)
            finally:
                card(self)["collect_s"] += time.perf_counter() - t0
        return run

    device_mod.DeviceBatchEvaluator._walk = walk
    device_mod.DeviceBatchEvaluator.collect = collected(collect0)
    device_mod.DeviceBatchEvaluator.summary_collect = collected(summary0)
    device_mod.arrays_from_numpy = timed(h2d0, "h2d_s")
    CompiledRules.device_arrays = timed(columns0, "columnarize_s")
    try:
        yield tally
    finally:
        (device_mod.DeviceBatchEvaluator._walk, device_mod.DeviceBatchEvaluator.collect,
         device_mod.DeviceBatchEvaluator.summary_collect, device_mod.arrays_from_numpy,
         CompiledRules.device_arrays) = saved


def phase_multicard(device, tmp: Path, devices=None) -> tuple:
    """The multi-card half (parallel/mesh.py, mesh2d.py, rules.py) over
    a device list (multicard_devices(), or `devices`), each result held
    equal to the unsharded run on one device: (a) the registry (249
    files, one pack of 253 rules over 245 files) over N_MULTICARD_DOCS
    of its documents through backend.evaluate, unsharded and under
    --mesh-shape auto (2x1; twice, the first run being the first use of
    the list's cards) and RxC with a column per entry: statuses,
    unsure bits, rim blocks and oracle documents per file; (b)
    N_MULTICARD_SUMMARY slice templates through the sharded
    with_summary, bucket by bucket: statuses and summed K7 counts; (c)
    `sweep --rule-shards 2` and `sweep --mesh-shape auto` over
    N_MULTICARD_SWEEP registry documents: the stdout, stderr, manifest
    and rc of the one-device run with one group; (d) dryrun_multichip
    over the list; (e) `lint` over corpus/rules and `completions bash`,
    host commands. The mesh sees the list through
    mesh.visible_devices.

    Every run is a leg of its own: every kernel counter, the walk tally
    (walk_tally) and the shard prefetcher's counters are set to 0 just
    before it and read just after. The sharded legs' launches add up to
    the phase's; the one-device references (the unsharded registry run,
    the one-card with_summary, the one-group sweep, dryrun_multichip's
    single-device pass) are counted apart and printed beside them. Each
    sharded leg must have walked on every card of the list, more often
    than its reference, and launched its kernels: K1 and K2, and K3
    once per walk, on the registry; K7 once per walk in with_summary.
    The registry legs print each card's host seconds (walk_tally).
    Returns (info, launches)."""
    import numpy as np
    import torch

    from guard_tpu_torch import cli
    from guard_tpu_torch import entry as port_entry
    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.backend import evaluate
    from guard_tpu_torch.ops.encoder import encode_bucketed
    from guard_tpu_torch.ops.ir import compile_rules_file
    from guard_tpu_torch.ops.native_encoder import encode_json_bucketed
    from guard_tpu_torch.parallel import mesh
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator
    from guard_tpu_torch.utils import faults
    from guard_tpu_torch.utils.io import Reader, Writer
    from guard_tpu_torch.utils.telemetry import PIPELINE_COUNTERS
    from guard_tpu_torch.workloads import RULES, make_template

    if devices is None:
        cards, devices = multicard_devices()
    else:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
    one = [devices[0]]
    cards_of_list = {str(d) for d in devices}
    print(json.dumps({"cards_visible": cards, "devices": [str(d) for d in devices]}),
          flush=True)
    real_visible = mesh.visible_devices
    out = {"cards_visible": cards, "devices": [str(d) for d in devices]}
    legs, refs = {}, {}
    launches = dict.fromkeys(K.LAUNCHES, 0)

    def sync_all():
        if device.type == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def run_leg(label, fn, devs, reference=False, breakdown=False):
        """One leg over `devs`, its counts read from 0: a reference's
        go to `refs`, a sharded leg's to `legs` and the phase's launches."""
        mesh.visible_devices = lambda device=None, devs=devs: list(devs)
        faults.reset_faults()
        sync_all()
        K.reset_launches()
        tally.clear()
        PIPELINE_COUNTERS["shards_prefetched"] = 0
        PIPELINE_COUNTERS["shard_prefetch_stall_seconds"] = 0.0
        t0 = time.perf_counter()
        result = fn()
        sync_all()
        rec = {"s": time.perf_counter() - t0,
               "launches": {k: v for k, v in K.LAUNCHES.items() if v},
               "walks": {c: t["walks"] for c, t in tally.items()}}
        if breakdown:
            rec["host_s"] = {c: {"walks": t["walks"],
                                 "columnarize": t["columnarize_s"], "h2d": t["h2d_s"],
                                 "enqueue": t["walk_s"] - t["columnarize_s"] - t["h2d_s"],
                                 "collect": t["collect_s"]}
                             for c, t in tally.items()}
            rec["host_sum_s"] = sum(t["walk_s"] + t["collect_s"] for t in tally.values())
            rec["shards_prefetched"] = PIPELINE_COUNTERS["shards_prefetched"]
            rec["shard_prefetch_stall_s"] = PIPELINE_COUNTERS["shard_prefetch_stall_seconds"]
        check(faults.FAULT_COUNTERS["dispatch_fallbacks"] == 0,
              f"multicard ({label}): an unarmed run fell back")
        if reference:
            refs[label] = rec
        else:
            legs[label] = rec
            for k, v in K.LAUNCHES.items():
                launches[k] += v
        return result

    def held(label, ref, *kernels, per_walk=None):
        """A sharded leg walked on every card of the list, more often
        than its one-device reference, and launched `kernels`;
        `per_walk` launched once per walk."""
        if device.type != "cuda":
            return
        rec, walks = legs[label], sum(legs[label]["walks"].values())
        check(set(rec["walks"]) == cards_of_list,
              f"multicard ({label}): walks by card {rec['walks']}, want every card of the list")
        check(walks > sum(refs[ref]["walks"].values()),
              f"multicard ({label}): {walks} walks, no more than the one-device run")
        for name in kernels:
            check(rec["launches"].get(name, 0) > 0, f"multicard ({label}): {name} never launched")
        if per_walk is not None:
            check(rec["launches"].get(per_walk, 0) == walks,
                  f"multicard ({label}): {per_walk} {rec['launches'].get(per_walk, 0)} "
                  f"launches for {walks} walks")

    t_phase = time.perf_counter()
    with walk_tally() as tally:
        try:
            # (a) the registry through the packed mesh
            rules_dir = tmp / "registry_rules"
            paths = sorted(rules_dir.glob("*.guard"))
            check(len(paths) == 249, "multicard: the registry's rules are missing")
            from guard_tpu_torch.commands.validate import RuleFile

            rule_files = [RuleFile(p.name, str(p), p.read_text(),
                                   parse_rules_file(p.read_text(), p.name)) for p in paths]
            _paths, plain = corpus_inputs()
            texts = [json.dumps(plain[i % len(plain)]) for i in range(N_MULTICARD_DOCS)]
            pvs = [from_plain(d) for d in plain]
            docs = [pvs[i % len(pvs)] for i in range(N_MULTICARD_DOCS)]
            runs = {}
            for label, devs, shape, profile in (
                    ("one", one, "off", None), ("auto", devices, "auto", None),
                    ("auto_warm", devices, "auto", None),
                    ("columns", devices, f"2x{len(devices)}", None),
                    ("validate_profile", devices, "auto", "validate")):
                groups, oversize, interner, err = encode_json_bucketed(texts)
                check(err is None, f"multicard: the native encoder failed: {err}")
                runs[label] = run_leg(
                    f"registry_{label}",
                    lambda: evaluate(rule_files, docs, device,
                                     shared=(groups, oversize, interner),
                                     mesh_shape=shape, profile=profile),
                    devs, reference=label == "one", breakdown=True)
            base = runs["one"]
            check([len(p) for p in base.packs] == [245], f"multicard: packs {base.packs}")
            for label in ("auto", "auto_warm", "columns", "validate_profile"):
                held(f"registry_{label}", "registry_one", "gather_rows", "segment_sum_rows",
                     per_walk="rim_reduce")
                ev = runs[label]
                check(ev.packs == base.packs, f"multicard ({label}): the packs differ")
                rim_only = label == "validate_profile"
                for a, b in zip(base.files, ev.files):
                    name = a.rule_file.name
                    narrowed = rim_only and b.pack is not None
                    if narrowed:
                        # the report path's profile: the statuses stay on the
                        # cards, rim blocks 0-4 come back
                        check(b.statuses is None and b.rim[5] is None,
                              f"multicard ({label}) {name}: more than the profile came back")
                    else:
                        check(np.array_equal(a.statuses, b.statuses),
                              f"multicard ({label}) {name}: statuses")
                        check(np.array_equal(a.unsure, b.unsure),
                              f"multicard ({label}) {name}: unsure")
                    check(a.host_docs == b.host_docs, f"multicard ({label}) {name}: oracle documents")
                    check((a.rim is None) == (b.rim is None)
                          and (a.rim is None or all(y is None or np.array_equal(x, y)
                                                    for x, y in zip(a.rim, b.rim))),
                          f"multicard ({label}) {name}: rim blocks")
            out["registry_docs"] = N_MULTICARD_DOCS

            # (b) the slice's templates through the sharded with_summary
            rng = np.random.default_rng(SEED)
            tdocs = [from_plain(make_template(rng, i)) for i in range(N_MULTICARD_SUMMARY)]
            groups, _over, interner = encode_bucketed(tdocs)
            compiled = compile_rules_file(parse_rules_file(RULES, "security.guard"), interner)
            sharded = mesh.ShardedBatchEvaluator(compiled, devices)
            single = DeviceBatchEvaluator(compiled, devices[0])
            got = run_leg("summary", lambda: [sharded.with_summary(sub) for sub, _i in groups],
                          devices)
            want = run_leg("summary_one", lambda: [single.with_summary(sub) for sub, _i in groups],
                           one, reference=True)
            held("summary", "summary_one", per_walk="rule_summary")
            totals = np.zeros((3, len(compiled.rules)), np.int64)
            for (sub, _idx), (st, counts), (st1, counts1) in zip(groups, got, want):
                check(np.array_equal(st, st1) and np.array_equal(counts, counts1),
                      f"multicard: with_summary differs over a {sub.n_docs}-document bucket")
                totals += counts
            check(int(totals.sum()) == N_MULTICARD_SUMMARY * len(compiled.rules),
                  "multicard: the summed counts miss documents")
            out["summary_counts"] = totals.sum(axis=1).tolist()

            # (c) sweep --rule-shards 2 over the registry's documents
            data = tmp / "multicard_data"
            data.mkdir()
            for i in range(N_MULTICARD_SWEEP):
                (data / f"d{i:05d}.json").write_text(texts[i])
            manifest = tmp / "multicard_manifest.jsonl"

            def sweep(flags):
                if manifest.exists():
                    manifest.unlink()
                w = Writer.buffered()
                rc = cli.run(["sweep", "--device", str(device), "-r", str(rules_dir),
                              "-d", str(data), "-M", str(manifest), "--no-result-cache",
                              "--no-journal", "--ingest-workers", "0", *flags],
                             writer=w, reader=Reader.from_string(""))
                return rc, w.stripped(), w.err_to_stripped(), manifest.read_bytes()

            sweeps = {}
            for label, devs, flags in (("one", one, ["--rule-shards", "1"]),
                                       ("rule_shards_2", devices, ["--rule-shards", "2"]),
                                       ("mesh_auto", devices, ["--mesh-shape", "auto"])):
                sweeps[label] = run_leg(f"sweep_{label}", lambda: sweep(flags), devs,
                                        reference=label == "one")
            for label in ("rule_shards_2", "mesh_auto"):
                held(f"sweep_{label}", "sweep_one", "gather_rows", "rim_reduce")
                check(sweeps[label] == sweeps["one"],
                      f"multicard: sweep ({label}) differs from the one-device run")
            check(sweeps["one"][0] in (19, 5), f"multicard: sweep rc {sweeps['one'][0]}")
            out["sweep_rc"] = sweeps["one"][0]

            # (d) the multichip dry run over the list; its single-device
            # parity pass is a reference, counted apart
            class Reference(DeviceBatchEvaluator):
                def evaluate_bucketed(self, batch):
                    before, walked = dict(K.LAUNCHES), {c: dict(t) for c, t in tally.items()}
                    try:
                        return super().evaluate_bucketed(batch)
                    finally:
                        refs["dryrun_single"] = {
                            "launches": {k: v - before[k] for k, v in K.LAUNCHES.items()
                                         if v - before[k]},
                            "walks": {c: t["walks"] - walked.get(c, {}).get("walks", 0)
                                      for c, t in tally.items()}}
                        K.LAUNCHES.update(before)
                        tally.clear()
                        tally.update(walked)

            port_entry.DeviceBatchEvaluator = Reference
            try:
                _st, counts = run_leg(
                    "dryrun", lambda: port_entry.dryrun_multichip(len(devices), devices),
                    real_visible(device))
            finally:
                port_entry.DeviceBatchEvaluator = DeviceBatchEvaluator
            held("dryrun", "dryrun_single", "rule_summary")
            out["dryrun_counts"] = counts.sum(axis=1).tolist()
        finally:
            mesh.visible_devices = real_visible
    if device.type == "cuda":
        for name in ("gather_rows", "segment_sum_rows", "rim_reduce", "rule_summary"):
            check(launches[name] > 0, f"multicard: {name} never launched")
    out["legs"] = legs
    out["references"] = refs

    # (e) the host commands
    w = Writer.buffered()
    rc = cli.run(["lint", "-r", str(ROOT / "corpus" / "rules")], writer=w, reader=Reader())
    check(rc == 0 and w.err_to_stripped().startswith("lint: 249 file(s), 0 error(s), 0 warning(s)"),
          f"multicard: lint rc {rc}: {w.err_to_stripped()[:200]}")
    out["lint_findings"] = len(w.stripped().splitlines())
    w = Writer.buffered()
    rc = cli.run(["completions", "--shell", "bash"], writer=w, reader=Reader())
    script = w.out.getvalue()
    check(rc == 0 and "complete -F _guard_tpu guard-tpu-torch" in script
          and " lint)" in script and "--rule-shards" in script,
          f"multicard: completions rc {rc}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"multicard: {json.dumps(out)}")
    return out, launches


# phase `distributed`: the registry over N_DISTRIBUTED documents cut by
# distributed.process_bounds over rank processes (gloo, 127.0.0.1)
N_DISTRIBUTED = N_PACKING
DISTRIBUTED_RANK_TIMEOUT_S = 600
DISTRIBUTED_ALLREDUCE_REPS = 20
# the pack's walk (K1, K2, K4, K5) and K7 behind it
DISTRIBUTED_KERNELS = ("gather_rows", "segment_sum_rows", "set_count_rows",
                       "distinct_first_rows", "rule_summary")

# One rank: join the group, load the plan the parent saved, encode its
# range natively, relocate it into the plan and run DistributedEvaluator.
# with_summary over its buckets on its card, its kernel counters set to 0
# just before and read just after; then time the (3, R) all-reduce alone.
# It imports guard_tpu_torch and nothing of JAX, and writes one JSON file.
_DISTRIBUTED_RANK = r'''
import base64, json, os, statistics, sys, time
t_start = time.perf_counter()
sys.path.insert(0, sys.argv[1])
spec = json.load(open(sys.argv[2]))
rank = int(sys.argv[3])
import numpy as np
import torch
import torch.distributed as dist
from guard_tpu_torch import kernels as K
from guard_tpu_torch.commands.validate import RuleFile
from guard_tpu_torch.core.parser import parse_rules_file
from guard_tpu_torch.ops import plan as plan_mod
from guard_tpu_torch.ops.native_encoder import encode_json_bucketed
from guard_tpu_torch.parallel import distributed

walls = {"import_s": time.perf_counter() - t_start}
t0 = time.perf_counter()
distributed.initialize(spec["address"], spec["world"], rank, timeout_s=spec["timeout_s"])
walls["join_s"] = time.perf_counter() - t0
devices = distributed.local_devices(spec["device"])
t0 = time.perf_counter()
rule_files = []
for name, path in spec["rules"]:
    text = open(path).read()
    rule_files.append(RuleFile(name, path, text, parse_rules_file(text, name)))
plan = plan_mod.get_plan(rule_files, device=devices[0])
stats = plan_mod.plan_stats()
(_pos, packed, _spec), = plan.packs
walls["plan_s"] = time.perf_counter() - t0
with open(spec["docs"]) as f:
    texts = f.read().splitlines()
lo, hi = distributed.process_bounds(len(texts))
t0 = time.perf_counter()
groups, oversize, interner, err = encode_json_bucketed(texts[lo:hi])
assert err is None and len(oversize) == 0, (err, len(oversize))
plan_mod.relocate_batch(plan, [sub for sub, _idx in groups], interner)
walls["encode_s"] = time.perf_counter() - t0
ev = distributed.DistributedEvaluator(packed.compiled, devices)
cards = [d for d in devices if d.type == "cuda"]
for d in cards:
    torch.cuda.synchronize(d)
K.reset_launches()
t0, window = time.perf_counter(), [time.time()]
statuses, start, counts = ev.with_summary(groups)
for d in cards:
    torch.cuda.synchronize(d)
walls["with_summary_s"] = time.perf_counter() - t0
window.append(time.time())
launches = {k: v for k, v in K.LAUNCHES.items() if v}
# the all-reduce alone, at the summary's (3, R) int64
probe = torch.zeros((3, len(packed.compiled.rules)), dtype=torch.int64)
dist.barrier()
times = []
for _ in range(spec["allreduce_reps"]):
    t0 = time.perf_counter()
    dist.all_reduce(probe, op=dist.ReduceOp.SUM)
    times.append((time.perf_counter() - t0) * 1e3)
distributed.shutdown()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "guard_tpu"))
assert "jax" not in sys.modules and not leaked, leaked
walls["rank_s"] = time.perf_counter() - t_start
with open(spec["out"] % rank, "w") as f:
    json.dump({
        "rank": rank, "lo": lo, "hi": hi, "start": start, "devices": [str(d) for d in devices],
        "buckets": len(groups), "rules": len(packed.compiled.rules),
        "statuses": base64.b64encode(np.ascontiguousarray(statuses).tobytes()).decode(),
        "counts": counts.tolist(), "launches": launches, "walls": walls, "window": window,
        "allreduce_ms": statistics.median(times), "allreduce_min_ms": min(times),
        "plan_stats": stats,
    }, f)
'''


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_distributed(device, tmp: Path) -> tuple:
    """Multi-process runs (parallel/distributed.py) over the registry:
    the 249 corpus files' pack (245 files, 253 rules, from the plan
    layer) over N_DISTRIBUTED of its documents, cut by process_bounds
    over max(2, min(4, cards)) rank processes joined by gloo over an
    ephemeral port on 127.0.0.1 (every rank on cuda:0 with one card).
    The kernels are built before any rank starts (the ranks load them),
    and the plan is saved for the ranks to load. Each rank runs
    DistributedEvaluator.with_summary over its buckets with its counters
    set to 0 just before and read just after (the walk launches K1, K2,
    K4 and K5; K7 once per bucket), under a timeout. The concatenated
    statuses must equal a one-process run of the same pack over the same
    documents in this process, every rank's counts its counts, and the
    counts cover every (document, rule) pair. Returns (info, launches
    summed over the ranks)."""
    import base64

    import numpy as np
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.commands.validate import RuleFile
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.kernels.build import load
    from guard_tpu_torch.ops import plan as plan_mod
    from guard_tpu_torch.ops.native_encoder import encode_json_bucketed
    from guard_tpu_torch.parallel.device import DeviceBatchEvaluator

    t_phase = time.perf_counter()
    if device.type == "cuda":
        load()  # built here: the ranks only load the libraries
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    world = max(2, min(4, cards))
    paths = sorted((tmp / "registry_rules").glob("*.guard"))
    check(len(paths) == 249, "distributed: the registry's rules are missing")
    rule_files = [RuleFile(p.name, str(p), p.read_text(),
                           parse_rules_file(p.read_text(), p.name)) for p in paths]
    plan = plan_mod.get_plan(rule_files, device=device)  # saved for the ranks
    (pos, packed, _spec), = plan.packs
    compiled = packed.compiled
    _paths, plain = corpus_inputs()
    texts = [json.dumps(plain[i % len(plain)]) for i in range(N_DISTRIBUTED)]
    docs_path = tmp / "distributed_docs.jsonl"
    docs_path.write_text("\n".join(texts) + "\n")
    spec_path = tmp / "distributed_spec.json"
    spec_path.write_text(json.dumps({
        "address": f"127.0.0.1:{free_port()}", "world": world,
        "timeout_s": DISTRIBUTED_RANK_TIMEOUT_S / 2, "rules": [[p.name, str(p)] for p in paths],
        "docs": str(docs_path), "out": str(tmp / "distributed_rank%d.json"),
        "allreduce_reps": DISTRIBUTED_ALLREDUCE_REPS,
        # a CPU rehearsal's ranks run the plain kernels
        "device": None if device.type == "cuda" else "cpu",
    }))
    rank_py = tmp / "distributed_rank.py"
    rank_py.write_text(_DISTRIBUTED_RANK)
    t_ranks = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(rank_py), str(ROOT), str(spec_path), str(r)],
                              cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            try:
                outs.append(proc.communicate(timeout=DISTRIBUTED_RANK_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"distributed: rank {r} did not end in "
                                     f"{DISTRIBUTED_RANK_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks_s = time.perf_counter() - t_ranks
    for r, (proc, out) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0, f"distributed: rank {r} exited {proc.returncode}:\n"
                                    f"{out[-4000:]}")
    results = [json.loads((tmp / f"distributed_rank{r}.json").read_text()) for r in range(world)]

    # the one-process run of the same pack over the same documents
    t0 = time.perf_counter()
    groups, oversize, interner, err = encode_json_bucketed(texts)
    check(err is None and len(oversize) == 0, f"distributed: the encode left {len(oversize)} out")
    plan_mod.relocate_batch(plan, [sub for sub, _idx in groups], interner)
    single = DeviceBatchEvaluator(compiled, device)
    n_rules = len(compiled.rules)
    want = np.zeros((N_DISTRIBUTED, n_rules), np.int8)
    want_counts = np.zeros((3, n_rules), np.int64)
    for sub, idx in groups:
        st, c = single.with_summary(sub)
        want[idx] = st
        want_counts += c
    one_process_s = time.perf_counter() - t0
    check(np.array_equal(want_counts, np_counts(want)),
          "distributed: the one-process counts differ from its statuses")

    launches = dict.fromkeys(K.LAUNCHES, 0)
    covered, rows = 0, []
    for r, res in enumerate(results):
        check(res["lo"] == covered == res["start"], f"distributed: rank {r} range {res['lo']}")
        check(res["rules"] == n_rules, f"distributed: rank {r} has {res['rules']} rules")
        check(res["plan_stats"]["misses"] == 0,
              f"distributed: rank {r} built the plan ({res['plan_stats']})")
        st = np.frombuffer(base64.b64decode(res["statuses"]), np.int8).reshape(-1, n_rules)
        check(st.shape[0] == res["hi"] - res["lo"], f"distributed: rank {r} statuses {st.shape}")
        check(np.array_equal(st, want[res["lo"]:res["hi"]]),
              f"distributed: rank {r}'s statuses differ from one process's")
        check(np.array_equal(np.asarray(res["counts"]), want_counts),
              f"distributed: rank {r}'s counts differ from one process's")
        if device.type == "cuda":
            for name in DISTRIBUTED_KERNELS:
                check(res["launches"].get(name, 0) > 0, f"distributed: rank {r} never launched {name}")
            check(res["launches"]["rule_summary"] == res["buckets"] * len(res["devices"]),
                  f"distributed: rank {r} launched K7 {res['launches']['rule_summary']} times "
                  f"for {res['buckets']} buckets")
        for k, v in res["launches"].items():
            launches[k] += v
        covered = res["hi"]
        rows.append({k: res[k] for k in ("rank", "lo", "hi", "devices", "buckets", "launches",
                                         "walls", "allreduce_ms", "allreduce_min_ms",
                                         "plan_stats")})
    check(covered == N_DISTRIBUTED, f"distributed: the ranks cover {covered} documents")
    # the wall-clock seconds in which every rank was inside with_summary
    overlap = (min(res["window"][1] for res in results)
               - max(res["window"][0] for res in results))
    check(int(want_counts.sum()) == N_DISTRIBUTED * n_rules,
          "distributed: the counts miss (document, rule) pairs")
    info = {"world": world, "cards_visible": cards, "docs": N_DISTRIBUTED, "rules": n_rules,
            "files_in_pack": len(pos), "ranks": rows, "ranks_s": ranks_s,
            "one_process_s": one_process_s, "with_summary_overlap_s": overlap,
            "counts": want_counts.sum(axis=1).tolist(),
            "phase_s": time.perf_counter() - t_phase,
            "launches": {k: v for k, v in launches.items() if v}}
    log(f"distributed: {json.dumps(info)}")
    return info, launches


def contract_kernels(device, infos: dict, sweep: dict, card: str) -> list:
    """Each kernel at its main-path shape (K1-K3 from the security
    policy's run, K4-K6 from the cross-reference policy's, K7 from the
    summary's), each also at its shape in the one-document bucket (K3
    and K7 at their launch with the fewest documents): error against plain,
    times (CUDA events around one call, and the device time of a graph
    replay), bound and library time (both ways where a library call
    computes the same function).
    `infos` maps each path's name to its phase's result."""
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    slice_info, xref_info = infos["security"], infos["xref"]
    rate = hbm_bytes_per_s(card)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    out = []

    for d, n, s in (main_shape(slice_info["shapes"], "gather_rows"),
                    wide_shape(slice_info["shapes"], "gather_rows")):
        vec = torch.randint(0, n + 1, (d, s), generator=gen, device=device, dtype=torch.int32)
        idx = tree_rows(gen, d, n, device)
        out.append({
            "name": "gather_rows", "shape": {"D": d, "N": n, "S": s},
            "shape_launches": slice_info["shapes"]["gather_rows"][(d, n, s)],
            "max_abs_err": _max_abs_err(K.gather_rows(vec, idx), plain.gather_rows(vec, idx)),
            "ms": cuda_ms(lambda: K.gather_rows(vec, idx)),
            "device_ms": graph_ms(lambda: K.gather_rows(vec, idx)),
            "plain_ms": cuda_ms(lambda: plain.gather_rows(vec, idx)),
            "bound_ms": k1_bytes(d, n, s) / rate * 1e3,
            # torch.gather does not mask negative indices: no one call
            # computes this function
            "library_ms": None,
        })

    for d, n, s in (main_shape(slice_info["shapes"], "segment_sum_rows"),
                    wide_shape(slice_info["shapes"], "segment_sum_rows")):
        val, seg = k2_inputs(gen, d, n, s, device, valid_only=True)
        seg_long = seg.long()

        def library():
            # every segment id valid here, so scatter_add_ computes the same
            return torch.zeros((d, s), dtype=torch.int32, device=device).scatter_add_(
                1, seg_long, val)

        out.append({
            "name": "segment_sum_rows", "shape": {"D": d, "N": n, "S": s},
            "shape_launches": slice_info["shapes"]["segment_sum_rows"][(d, n, s)],
            "branch": K._lib().guard_segment_sum_branch(d, n, s),
            "max_abs_err": _max_abs_err(
                K.segment_sum_rows(val, seg, s), plain.segment_sum_rows(val, seg, s)
            ),
            "ms": cuda_ms(lambda: K.segment_sum_rows(val, seg, s)),
            "device_ms": graph_ms(lambda: K.segment_sum_rows(val, seg, s)),
            "plain_ms": cuda_ms(lambda: plain.segment_sum_rows(val, seg, s)),
            "bound_ms": k2_bytes(d, n, s) / rate * 1e3,
            "library_ms": cuda_ms(library),
            "library_device_ms": graph_ms(library),
        })
        del val, seg, seg_long

    # the rim of the largest bucket, then of the one-document bucket
    for d, r, g, f in (main_shape(slice_info["shapes"], "rim_reduce"),
                       min(slice_info["shapes"]["rim_reduce"])):
        args = k3_inputs(gen, d, r, g, f, device)
        out.append({
            "name": "rim_reduce", "shape": {"D": d, "R": r, "G": g, "F": f},
            "shape_launches": slice_info["shapes"]["rim_reduce"][(d, r, g, f)],
            "branch": K._lib().guard_rim_reduce_branch(d, r, g, f),
            "max_abs_err": _max_abs_err(K.rim_reduce(*args, g, f),
                                        plain.rim_reduce(*args, g, f)),
            "ms": cuda_ms(lambda: K.rim_reduce(*args, g, f)),
            "device_ms": graph_ms(lambda: K.rim_reduce(*args, g, f)),
            "plain_ms": cuda_ms(lambda: plain.rim_reduce(*args, g, f)),
            "bound_ms": k3_bytes(d, r, g, f) / rate * 1e3,
            "library_ms": None,
        })
    # the rim of the registry's pack (phase `packing`)
    if "packing" in infos:
        out.append(k3_packed_row(device, gen, infos["packing"], rate))
    del vec, idx, args

    for d, nq, ns in (main_shape(xref_info["shapes"], "set_count_rows"),
                      wide_shape(xref_info["shapes"], "set_count_rows")):
        q = join_inputs(gen, d, nq, nq, device)
        st = join_inputs(gen, d, nq, ns, device)
        out.append({
            "name": "set_count_rows", "shape": {"D": d, "Nq": nq, "Ns": ns},
            "shape_launches": xref_info["shapes"]["set_count_rows"][(d, nq, ns)],
            "branch": K._lib().guard_set_count_branch(d, ns),
            "max_abs_err": _max_abs_err(K.set_count_rows(*q, *st),
                                        plain.set_count_rows(*q, *st)),
            "ms": cuda_ms(lambda: K.set_count_rows(*q, *st)),
            "device_ms": graph_ms(lambda: K.set_count_rows(*q, *st)),
            "plain_ms": cuda_ms(lambda: plain.set_count_rows(*q, *st)),
            "bound_ms": k4_bytes(d, nq, ns) / rate * 1e3,
            "library_ms": None,
            "library_note": "no one PyTorch call counts equal (org, key) pairs of one "
                            "set per query row",
        })
        del q, st

    xref_shapes = xref_info["shapes"]
    for d, n in (main_shape(xref_shapes, "distinct_first_rows"),
                 wide_shape(xref_shapes, "distinct_first_rows")):
        q = join_inputs(gen, d, n, n, device)
        out.append({
            "name": "distinct_first_rows", "shape": {"D": d, "N": n},
            "shape_launches": xref_shapes["distinct_first_rows"][(d, n)],
            "branch": K._lib().guard_distinct_first_branch(d, n),
            "max_abs_err": _max_abs_err(K.distinct_first_rows(*q),
                                        plain.distinct_first_rows(*q)),
            "ms": cuda_ms(lambda: K.distinct_first_rows(*q)),
            "device_ms": graph_ms(lambda: K.distinct_first_rows(*q)),
            "plain_ms": cuda_ms(lambda: plain.distinct_first_rows(*q)),
            "bound_ms": k5_bytes(d, n) / rate * 1e3,
            "library_ms": None,
            "library_note": "torch.unique has no per-row form and does not mark the "
                            "lowest index",
        })
        del q

    for d, n, s in (main_shape(xref_shapes, "seg_min_max_rows"),
                    wide_shape(xref_shapes, "seg_min_max_rows")):
        seg, mask, hi, lo, _s = k6_inputs(gen, d, n, device)
        seg = seg % s
        library = seg_min_max_library(seg, mask, hi, lo, s)
        out.append({
            "name": "seg_min_max_rows", "shape": {"D": d, "N": n, "S": s},
            "shape_launches": xref_shapes["seg_min_max_rows"][(d, n, s)],
            "branch": K._lib().guard_seg_min_max_branch(d, n, s),
            "max_abs_err": _max_abs_err(K.seg_min_max_rows(seg, mask, hi, lo, s),
                                        plain.seg_min_max_rows(seg, mask, hi, lo, s)),
            "ms": cuda_ms(lambda: K.seg_min_max_rows(seg, mask, hi, lo, s)),
            "device_ms": graph_ms(lambda: K.seg_min_max_rows(seg, mask, hi, lo, s)),
            "plain_ms": cuda_ms(lambda: plain.seg_min_max_rows(seg, mask, hi, lo, s)),
            "bound_ms": k6_bytes(d, n, s) / rate * 1e3,
            # scatter_reduce_ amin + amax over the packed int64 keys
            "library_ms": cuda_ms(library),
            "library_device_ms": graph_ms(library),
        })
        del seg, mask, hi, lo, library
        torch.cuda.empty_cache()

    # the summary of the largest bucket, then of the one-document bucket
    summary_shapes = infos["summary"]["shapes"]["rule_summary"]
    for d, r, n_valid in (main_shape(infos["summary"]["shapes"], "rule_summary"),
                          min(summary_shapes)):
        st = torch.randint(0, 3, (d, r), generator=gen, device=device, dtype=torch.int8)
        out.append({
            "name": "rule_summary", "shape": {"D": d, "R": r, "n_valid": n_valid},
            "shape_launches": summary_shapes[(d, r, n_valid)],
            "branch": K._lib().guard_rule_summary_branch(d, r, n_valid),
            "max_abs_err": _max_abs_err(K.rule_summary(st, n_valid),
                                        plain.rule_summary(st, n_valid)),
            "ms": cuda_ms(lambda: K.rule_summary(st, n_valid)),
            "device_ms": graph_ms(lambda: K.rule_summary(st, n_valid)),
            "plain_ms": cuda_ms(lambda: plain.rule_summary(st, n_valid)),
            "bound_ms": k7_bytes(n_valid, r) / rate * 1e3,
            "library_ms": None,
            "library_note": "no single PyTorch call computes masked per-column counts "
                            "of three values",
        })
    out.extend(walk_segment_rows(device, rate))
    main_path = {"rule_summary": "summary", **{name: "xref" for name in JOINS}}
    for entry in out:
        name = entry["name"]
        entry.update({
            "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": infos[entry.get("path") or main_path.get(name, "security")][
                "launches"][name],
            "bound_by": "bytes",
            "launches_by_path": {path: info["launches"][name] for path, info in infos.items()},
            "sweep": sweep[name],
        })
        check(sum(entry["launches_by_path"].values()) > 0, f"{name} never launched")
        if name == "gather_rows":
            # run_step StepFnVar (guard_tpu/ops/kernels.py:387): one K1
            # launch per per-origin arm on the fnvar path
            entry["stepfnvar_launches"] = infos["fnvar"]["fnvar_steps"]["k1_launches"]
        if entry["max_abs_err"] != 0:
            raise AssertionError(f"{name} differs from plain at its main-path shape")
    return out


def walk_level_bytes(prog, step, d: int) -> int:
    """The bytes one launch of the tape kernel must move at least: each
    buffer, workspace row range or fixed column its instructions read or
    write, once, at its widest access."""
    import numpy as np

    from guard_tpu_torch.kernels import plain as isa

    words = prog[step.start * isa.TAPE_WORDS:(step.start + step.n_instr) * isa.TAPE_WORDS]
    size = {isa.E_U8: 1, isa.E_I8: 1, isa.E_I32: 4}
    regions = {}
    for op, width, _reg, aux, mode, x, _y, z in np.asarray(words).reshape(-1, isa.TAPE_WORDS):
        kind = int(op) & 0xFF
        if kind == isa.I_ALU or int(mode) & 0xFF not in (isa.M_MEM, isa.M_WS):
            continue
        fixed = (int(mode) >> 16) & 0xFF == isa.C_FIXED
        if kind == isa.I_GROUP:
            cols = max(int(width), 1) * int(aux)
        elif fixed or kind in (isa.I_RED_SUM, isa.I_RED_OR):
            cols = 1
        else:
            cols = max(int(width), 1)
        key = (int(mode) & 0xFF, int(x), int(z) if fixed else None)
        regions[key] = max(regions.get(key, 0), cols * size[(int(mode) >> 8) & 0xFF])
    return d * sum(regions.values())


def walk_segment_rows(device, rate: float) -> list:
    """The tape kernel at the security policy's two walks of the main
    path, D 1,023 templates x N 64 and the volume template alone in the
    65,536-node bucket (its width the template's nodes, rounded up to
    8): the tape's heaviest level, its buffers and
    workspace as the replay leaves them on the card before that level.
    Error of the card's launch against the plain version on the same
    buffers (every byte the two write), times and the bound from the
    level's bytes."""
    import numpy as np
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.core.parser import parse_rules_file
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.kernels import plain
    from guard_tpu_torch.ops import tape as tape_mod
    from guard_tpu_torch.ops.encoder import (
        NODE_BUCKETS_EXTENDED, encode_batch, split_batch_by_size,
    )
    from guard_tpu_torch.ops.ir import compile_rules_file
    from guard_tpu_torch.ops.kernels import arrays_from_numpy
    from guard_tpu_torch.workloads import RULES, make_template, volume_template

    rng = np.random.default_rng(SEED + 2)
    docs = [make_template(rng, i) for i in range(1023)] + [volume_template(N_VOLUMES)]
    batch, interner = encode_batch([from_plain(d) for d in docs])
    compiled = compile_rules_file(parse_rules_file(RULES, "security.guard"), interner)
    groups, oversize = split_batch_by_size(batch, NODE_BUCKETS_EXTENDED)
    shapes = [(g.n_docs, g.n_nodes) for g, _ in groups]
    check(len(oversize) == 0 and len(shapes) == 2 and shapes[0] == (1023, 64)
          and shapes[1][0] == 1 and shapes[1][1] > 32768, f"walk_segment buckets {shapes}")
    out = []
    for sub, _idx in groups:
        arrays, lits = arrays_from_numpy(compiled.device_arrays(sub), compiled.lit_values(),
                                         device)
        tape = tape_mod.tape_for(compiled, arrays, lits)
        check(tape is not None, f"the security policy has no tape: {tape_mod.tapes_of(compiled)}")
        levels = [i for i, st in enumerate(tape.steps) if isinstance(st, tape_mod.LaunchStep)]
        at = max(levels, key=lambda i: tape.steps[i].n_instr)
        run = tape_mod.Replay(tape, arrays, lits)
        for st in tape.steps[:at]:
            run.run(st)
        step, d = tape.steps[at], sub.n_docs
        bufs = [run.tensor(b) for b in step.bufs]
        zero = d * tape.zero_row if step.zero else 0
        prog = run.prog
        words = prog[step.start * plain.TAPE_WORDS:(step.start + step.n_instr) * plain.TAPE_WORDS]
        state = [run.ws] + bufs
        before = [t.clone() for t in state]

        def card():
            K.walk_segment(prog, step.start, step.n_instr, bufs, run.ws, lits, d,
                           step.width, step.n_regs, zero)

        def by_plain():
            run.ws[:zero].zero_()
            plain.walk_segment(words, step.n_instr, bufs, run.ws, lits, d, step.width)

        got = {}
        for label, fn in (("card", card), ("plain", by_plain)):
            for t, b in zip(state, before):
                t.copy_(b)
            fn()
            got[label] = tuple(t.clone() for t in state)
        out.append({
            "name": "walk_segment",
            "shape": {"D": d, "N": sub.n_nodes, "W": step.width, "level": levels.index(at),
                      "levels": len(levels), "instructions": step.n_instr,
                      "buffers": len(bufs), "registers": step.n_regs},
            # the main path's buckets hold 65,536 templates, not 1,023
            "shape_launches": None,
            "max_abs_err": _max_abs_err(got["card"], got["plain"]),
            "ms": cuda_ms(card),
            "device_ms": graph_ms(card),
            "plain_ms": cuda_ms(by_plain, reps=3),
            "bound_ms": walk_level_bytes(tape.prog, step, d) / rate * 1e3,
            "library_ms": None,
            "library_note": "an interpreter of the walk's recorded ops: no library call "
                            "runs a tape",
        })
        del run, bufs, state, before, got
    return out


# K2 (D, N, S) and K4 (D, Nq, Ns) at the main path's shapes (the main
# shape, the 64-node bucket's other width, the one-document 65,536-node
# bucket), then at phase 2's sweep shapes
DESIGN_K2 = ((65536, 64, 65), (65536, 64, 64), (1, WIDE_N, WIDE_N), (1, WIDE_N, WIDE_N + 1),
             (1, WIDE_N, (WIDE_N + 1) * 5),
             (262144, 64, 65), (16384, 1024, 1025), (2048, 8192, 8193), (256, WIDE_N, WIDE_N))
DESIGN_K4 = ((48694, 64, 128), (48694, 64, 64), (1, WIDE_N, WIDE_N), (1, WIDE_N, 2 * WIDE_N),
             (65536, 64, 128), (4096, 1024, 2048), (64, WIDE_N, 2 * WIDE_N))
# K5 (D, N) and K6 (D, N, S) at the xref path's three shapes, then at
# phase 2's widest sweep shape
DESIGN_K5 = ((48694, 64), (16842, 128), (1, WIDE_N), (64, WIDE_N))
DESIGN_K6 = ((48694, 64, 325), (16842, 128, 645), (1, WIDE_N, (WIDE_N + 1) * 5),
             (64, WIDE_N, (WIDE_N + 1) * 5))
# K3 (D, R, G, F) at the main path's shapes (the security policy's
# 64-node bucket, the xref and fnvar policies' 64-, 128- and 64-node
# buckets, the one-document bucket), then at phase 2's sweep shapes and
# a full pack
DESIGN_K3 = ((65536, 4, 4, 1), (48694, 5, 5, 1), (16842, 5, 5, 1), (64985, 5, 5, 1),
             (1, 4, 4, 1), (1, 5, 5, 1),
             (1 << 20, 64, 41, 1), (1 << 18, 256, 130, 4), (65536, 512, 512, 64))
# K7 (D, R, n_valid) at the summary's two buckets and the entry point's
# batch, then over 1,048,576 rows at every R % 4 and the widths of the
# phase 2 sweep, and a full pack of 512 rules at 65,536 rows
DESIGN_K7 = ((65536, 4, 65536), (1, 4, 1), (8, 2, 8),
             *(((1 << 20), r, 1 << 20) for r in (4, 5, 36, 37, 38, 39, 512, 1024, 1028)),
             (65536, 512, 65536))
# K3 forms: 1 a thread a row, 32 a warp a row, 256 a block a row
K3_BRANCHES = (
    ((1, 4, 4, 1), (1, 32, 256)),
    ((64, 5, 5, 1), (1, 32, 256)),
    ((256, 5, 5, 1), (1, 32, 256)),
    ((1024, 5, 5, 1), (1, 32, 256)),
    ((4096, 5, 5, 1), (1, 32, 256)),
    ((8192, 5, 5, 1), (1, 32)),
    ((16842, 5, 5, 1), (1, 32, 256)),
    ((65536, 4, 4, 1), (1, 32, 256)),
    ((65536, 5, 5, 1), (1, 32, 256)),
    ((65536, 16, 8, 2), (1, 32)),
    ((65536, 32, 24, 8), (1, 32)),
    ((65536, 64, 41, 1), (1, 32)),
    ((65536, 64, 64, 4), (1, 32)),
    ((1 << 20, 64, 41, 1), (1, 32)),
    ((65536, 128, 20, 2), (1, 32)),
    ((65536, 256, 64, 4), (1, 32)),
    ((16384, 1024, 64, 8), (1, 32)),
    ((65536, 256, 65, 4), (32, 256)),
    ((1 << 18, 256, 130, 4), (32, 256)),
    ((65536, 512, 512, 64), (32, 256)),
)
# K7 forms: 1 one block writes every counter, 2 one cluster of 16 blocks
# whose block 0 writes every counter; 8 or 16 a grid that reads words of
# that many bytes and adds into the zeroed output
K7_BRANCHES = (
    ((1, 4, 1), (1, 2, 8)),
    ((8, 2, 8), (1, 2, 8)),
    ((1024, 4, 1024), (1, 2, 8)),
    ((4096, 4, 4096), (1, 2, 8)),
    ((16384, 4, 16384), (1, 2, 8)),
    ((65536, 4, 65536), (2, 8, 16)),
    ((131072, 4, 131072), (2, 8, 16)),
    ((262144, 4, 262144), (2, 8, 16)),
    ((64, 37, 64), (1, 2, 8)),
    ((1024, 37, 1024), (1, 2, 8)),
    ((16384, 37, 16384), (2, 8, 16)),
    ((64, 512, 64), (1, 2, 8)),
    ((1024, 512, 1024), (2, 8, 16)),
    ((65536, 512, 65536), (8, 16)),
    ((1 << 20, 4, 1 << 20), (8, 16)),
    ((1 << 20, 5, 1 << 20), (8, 16)),
    ((1 << 20, 36, 1 << 20), (8, 16)),
    ((1 << 20, 37, 1 << 20), (8, 16)),
    ((1 << 20, 512, 1 << 20), (8, 16)),
    ((1 << 20, 1024, 1 << 20), (8, 16)),
    ((1 << 20, 1028, 1 << 20), (8, 16)),
)
# how K6's segment ids spread, as k6_segments makes them: 40 segments
# (k6_inputs), the 5 of a shared RHS, or uniform over [-1, S)
K6_SEGMENTS = ("40", "shared", "uniform")
# geometries to time K2 on around the launcher's thresholds: lanes per row
# (8, 16, 32), 256 a block-per-row, 0 split
K2_BRANCHES = (
    ((65536, 64, 65), (16, 32, 256, 0)),
    ((65536, 64, 325), (16, 32, 256, 0)),
    ((65536, 128, 129), (32, 256)),
    ((65536, 256, 257), (32, 256)),
    ((32768, 512, 513), (32, 256)),
    ((16384, 1024, 1025), (32, 256, 0)),
    ((8192, 2048, 2049), (32, 256, 0)),
    ((1, 2048, 2049), (32, 256, 0)),
    ((4, 2048, 2049), (32, 256, 0)),
    ((16, 2048, 2049), (32, 256, 0)),
    ((1, 8192, 8193), (256, 0)),
    ((2, 8192, 8193), (256, 0)),
    ((4, 8192, 8193), (256, 0)),
    ((8, 8192, 8193), (256, 0)),
    ((64, 8192, 8193), (256, 0)),
    ((132, 8192, 8193), (256, 0)),
    ((1, 16384, 16385), (256, 0)),
    ((4, 16384, 16385), (256, 0)),
    ((16, 16384, 16385), (256, 0)),
)
# K4 forms: 32 a warp's table, 256 a block's table, 0 tables in global
# scratch
K4_BRANCHES = (
    ((48694, 64, 64), (32, 256)),
    ((48694, 64, 128), (32, 256)),
    ((16842, 128, 256), (32, 256)),
    ((1, 1024, 2048), (256, 0)),
    ((16, 1024, 2048), (256, 0)),
    ((132, 1024, 2048), (256, 0)),
    ((528, 1024, 2048), (256, 0)),
    ((4096, 1024, 2048), (256, 0)),
    ((1, 4096, 8192), (256, 0)),
    ((132, 4096, 8192), (256, 0)),
    ((528, 4096, 8192), (256, 0)),
)
# K5 forms, as K4's: 32 a warp's table, 256 a block's, 0 global tables
K5_BRANCHES = (
    ((1, 64), (32, 256, 0)),
    ((132, 64), (32, 0)),
    ((48694, 64), (32, 256)),
    ((16842, 128), (32, 256)),
    ((16842, 256), (32, 256)),
    ((1, 1024), (256, 0)),
    ((16, 1024), (256, 0)),
    ((132, 1024), (256, 0)),
    ((528, 1024), (256, 0)),
    ((4096, 1024), (256, 0)),
    ((1, 2048), (256, 0)),
    ((16, 2048), (256, 0)),
    ((1, 4096), (256, 0)),
    ((16, 4096), (256, 0)),
    ((132, 4096), (256, 0)),
    ((528, 4096), (256, 0)),
)
# K6 forms: 256 a block's table per row in shared memory, 0 the grid
# over global tables
K6_BRANCHES = (
    ((1, 64, 325), (256, 0)),
    ((16, 64, 325), (256, 0)),
    ((132, 64, 325), (256, 0)),
    ((528, 64, 325), (256, 0)),
    ((48694, 64, 325), (256, 0)),
    ((16842, 128, 645), (256, 0)),
    ((1, 1024, 5125), (256, 0)),
    ((16, 1024, 5125), (256, 0)),
    ((132, 1024, 5125), (256, 0)),
    ((528, 1024, 5125), (256, 0)),
    ((4096, 1024, 5125), (256, 0)),
    ((1, 1536, 7685), (256, 0)),
    ((16, 1536, 7685), (256, 0)),
    ((1, 2048, 10245), (256, 0)),
    ((16, 2048, 10245), (256, 0)),
    ((132, 2048, 10245), (256, 0)),
    ((528, 2048, 10245), (256, 0)),
)


def current_stream() -> int:
    """PyTorch's current stream, read at the call (a graph captures on
    its own stream)."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def design_sweep(device) -> dict:
    """K2, K4, K5, K6, K3 and K7 against their plain versions at
    DESIGN_K2, DESIGN_K4, DESIGN_K5, DESIGN_K6 (K6 beside
    scatter_reduce_), DESIGN_K3 and DESIGN_K7, through the public
    wrappers only (so it also runs on an older checkout's package), with
    their times; where the library has the forced-form entries, also
    each K3 form at K3_BRANCHES and each K7 form at K7_BRANCHES, each K5
    form at K5_BRANCHES and each K6 form at K6_BRANCHES, and each K2
    geometry at K2_BRANCHES and each K4 form at K4_BRANCHES."""
    import torch

    from guard_tpu_torch import kernels as K
    from guard_tpu_torch.kernels import plain

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    out = {"segment_sum_rows": [], "set_count_rows": []}
    for d, n, s in DESIGN_K2:
        val, seg = k2_inputs(gen, d, n, s, device)
        check(_equal(K.segment_sum_rows(val, seg, s), plain.segment_sum_rows(val, seg, s)),
              f"segment_sum_rows differs from plain at D={d} N={n} S={s}")
        out["segment_sum_rows"].append({
            "D": d, "N": n, "S": s, "bound_ms": k2_bytes(d, n, s) / 3.35e9,
            "ms": cuda_ms(lambda: K.segment_sum_rows(val, seg, s)),
            "device_ms": graph_ms(lambda: K.segment_sum_rows(val, seg, s)),
        })
    for d, nq, ns in DESIGN_K4:
        q = join_inputs(gen, d, nq, nq, device)
        st = join_inputs(gen, d, nq, ns, device)
        check(_equal(K.set_count_rows(*q, *st), plain.set_count_rows(*q, *st)),
              f"set_count_rows differs from plain at D={d} Nq={nq} Ns={ns}")
        out["set_count_rows"].append({
            "D": d, "Nq": nq, "Ns": ns, "bound_ms": k4_bytes(d, nq, ns) / 3.35e9,
            "ms": cuda_ms(lambda: K.set_count_rows(*q, *st)),
            "device_ms": graph_ms(lambda: K.set_count_rows(*q, *st)),
        })
    del val, seg, q, st
    out["distinct_first_rows"] = []
    for d, n in DESIGN_K5:
        q = join_inputs(gen, d, n, n, device)
        check(_equal(K.distinct_first_rows(*q), plain.distinct_first_rows(*q)),
              f"distinct_first_rows differs from plain at D={d} N={n}")
        out["distinct_first_rows"].append({
            "D": d, "N": n, "bound_ms": k5_bytes(d, n) / 3.35e9,
            "ms": cuda_ms(lambda: K.distinct_first_rows(*q)),
            "device_ms": graph_ms(lambda: K.distinct_first_rows(*q)),
        })
        del q
    out["seg_min_max_rows"] = []
    for d, n, s in DESIGN_K6:
        # every spread of segment ids at the one-document shape
        for how in K6_SEGMENTS if d == 1 else K6_SEGMENTS[:1]:
            seg, mask, hi, lo = k6_segments(gen, d, n, s, device, how)
            check(_equal(K.seg_min_max_rows(seg, mask, hi, lo, s),
                         plain.seg_min_max_rows(seg, mask, hi, lo, s)),
                  f"seg_min_max_rows differs from plain at D={d} N={n} S={s} ({how})")
            library = seg_min_max_library(seg, mask, hi, lo, s)
            out["seg_min_max_rows"].append({
                "D": d, "N": n, "S": s, "segments": how,
                "bound_ms": k6_bytes(d, n, s) / 3.35e9,
                "ms": cuda_ms(lambda: K.seg_min_max_rows(seg, mask, hi, lo, s)),
                "device_ms": graph_ms(lambda: K.seg_min_max_rows(seg, mask, hi, lo, s)),
                # scatter_reduce_ amin + amax over the packed int64 keys
                "library_device_ms": graph_ms(library),
            })
            del seg, mask, hi, lo, library
            torch.cuda.empty_cache()
    out["rim_reduce"] = []
    for d, r, g, f in DESIGN_K3:
        args = k3_inputs(gen, d, r, g, f, device)
        check(_equal(K.rim_reduce(*args, g, f), plain.rim_reduce(*args, g, f)),
              f"rim_reduce differs from plain at D={d} R={r} G={g} F={f}")
        out["rim_reduce"].append({
            "D": d, "R": r, "G": g, "F": f, "bound_ms": k3_bytes(d, r, g, f) / 3.35e9,
            "ms": cuda_ms(lambda: K.rim_reduce(*args, g, f)),
            "device_ms": graph_ms(lambda: K.rim_reduce(*args, g, f)),
        })
        del args
    out["rule_summary"] = []
    for d, r, n_valid in DESIGN_K7:
        st = torch.randint(-3, 6, (d, r), generator=gen, device=device, dtype=torch.int8)
        check(_equal(K.rule_summary(st, n_valid), plain.rule_summary(st, n_valid)),
              f"rule_summary differs from plain at D={d} R={r} n_valid={n_valid}")
        out["rule_summary"].append({
            "D": d, "R": r, "n_valid": n_valid, "bound_ms": k7_bytes(n_valid, r) / 3.35e9,
            "ms": cuda_ms(lambda: K.rule_summary(st, n_valid)),
            "device_ms": graph_ms(lambda: K.rule_summary(st, n_valid)),
        })
        del st
    torch.cuda.empty_cache()
    lib = K._lib()
    if hasattr(lib, "guard_rim_reduce_as"):
        out.update(rim_summary_form_sweep(lib, gen, device))
    if hasattr(lib, "guard_distinct_first_rows_as"):
        out.update(join_form_sweep(lib, gen, device))
    if not hasattr(lib, "guard_segment_sum_rows_as"):
        return out
    out["segment_sum_branches"] = []
    for (d, n, s), branches in K2_BRANCHES:
        val, seg = k2_inputs(gen, d, n, s, device)
        ref = plain.segment_sum_rows(val, seg, s)
        row = {"D": d, "N": n, "S": s, "picked": lib.guard_segment_sum_branch(d, n, s)}
        for b in branches:
            def run(b=b):
                o = torch.empty((d, s), dtype=torch.int32, device=device)
                rc = lib.guard_segment_sum_rows_as(b, val.data_ptr(), seg.data_ptr(),
                                                   o.data_ptr(), d, n, s, current_stream())
                check(rc == 0, f"K2 branch {b} refused (cudaError {rc})")
                return o
            check(_equal(run(), ref), f"K2 branch {b} differs at D={d} N={n} S={s}")
            row[str(b)] = graph_ms(run)
        out["segment_sum_branches"].append(row)
        del val, seg, ref
    out["set_count_branches"] = []
    for (d, nq, ns), branches in K4_BRANCHES:
        q = join_inputs(gen, d, nq, nq, device)
        st = join_inputs(gen, d, nq, ns, device)
        ref = plain.set_count_rows(*q, *st)
        row = {"D": d, "Nq": nq, "Ns": ns, "picked": lib.guard_set_count_branch(d, ns)}
        for b in branches:
            def run(b=b):
                o = torch.empty((d, nq), dtype=torch.int32, device=device)
                scratch = (torch.empty(lib.guard_set_count_scratch(d, ns), dtype=torch.uint8,
                                       device=device).data_ptr() if b == 0 else None)
                rc = lib.guard_set_count_rows_as(b, *(t.data_ptr() for t in (*q, *st)),
                                                 o.data_ptr(), scratch, d, nq, ns,
                                                 current_stream())
                check(rc == 0, f"K4 form {b} refused (cudaError {rc})")
                return o
            check(_equal(run(), ref), f"K4 form {b} differs at D={d} Nq={nq} Ns={ns}")
            row[str(b)] = graph_ms(run)
        out["set_count_branches"].append(row)
        del q, st, ref
    torch.cuda.empty_cache()
    return out


def rim_summary_form_sweep(lib, gen, device) -> dict:
    """Each K3 form at K3_BRANCHES and each K7 form at K7_BRANCHES
    against the plain versions, with their device times."""
    import torch

    from guard_tpu_torch.kernels import plain

    out = {"rim_reduce_branches": [], "rule_summary_branches": []}
    for (d, r, g, f), forms in K3_BRANCHES:
        args = k3_inputs(gen, d, r, g, f, device)
        ref = plain.rim_reduce(*args, g, f)
        row = {"D": d, "R": r, "G": g, "F": f,
               "picked": lib.guard_rim_reduce_branch(d, r, g, f)}
        for form in forms:
            def run(form=form):
                o = tuple(torch.empty((d, w), dtype=torch.int8, device=device)
                          for w in (g, g, f, f, f, g))
                rc = lib.guard_rim_reduce_as(form, *(t.data_ptr() for t in args),
                                             *(t.data_ptr() for t in o), d, r, g, f,
                                             current_stream())
                check(rc == 0, f"K3 form {form} refused (cudaError {rc})")
                return tuple(t.view(torch.bool) if i in (1, 3, 4) else t
                             for i, t in enumerate(o))
            check(_equal(run(), ref), f"K3 form {form} differs at D={d} R={r} G={g} F={f}")
            row[str(form)] = graph_ms(run)
        out["rim_reduce_branches"].append(row)
        del args, ref
    for (d, r, n_valid), forms in K7_BRANCHES:
        st = torch.randint(-3, 6, (d, r), generator=gen, device=device, dtype=torch.int8)
        ref = plain.rule_summary(st, n_valid)
        row = {"D": d, "R": r, "n_valid": n_valid,
               "picked": lib.guard_rule_summary_branch(d, r, n_valid)}
        for form in forms:
            def run(form=form):
                o = torch.empty((3, r), dtype=torch.int32, device=device)
                rc = lib.guard_rule_summary_as(form, st.data_ptr(), o.data_ptr(), d, r,
                                               n_valid, current_stream())
                check(rc == 0, f"K7 form {form} refused (cudaError {rc})")
                return o
            check(_equal(run(), ref), f"K7 form {form} differs at D={d} R={r}")
            row[str(form)] = graph_ms(run)
        out["rule_summary_branches"].append(row)
        del st, ref
    torch.cuda.empty_cache()
    return out


def join_form_sweep(lib, gen, device) -> dict:
    """Each K5 form at K5_BRANCHES and each K6 form at K6_BRANCHES
    against the plain versions, with their device times."""
    import torch

    from guard_tpu_torch.kernels import plain

    out = {"distinct_first_branches": [], "seg_min_max_branches": []}
    for (d, n), forms in K5_BRANCHES:
        q = join_inputs(gen, d, n, n, device)
        ref = plain.distinct_first_rows(*q)
        scratch = torch.empty(lib.guard_distinct_first_scratch(d, n), dtype=torch.uint8,
                              device=device)
        row = {"D": d, "N": n, "picked": lib.guard_distinct_first_branch(d, n)}
        for form in forms:
            def run(form=form):
                o = torch.empty((d, n), dtype=torch.bool, device=device)
                rc = lib.guard_distinct_first_rows_as(
                    form, *(t.data_ptr() for t in q), o.data_ptr(),
                    scratch.data_ptr() if form == 0 else None, d, n, current_stream())
                check(rc == 0, f"K5 form {form} refused (cudaError {rc})")
                return o
            check(_equal(run(), ref), f"K5 form {form} differs at D={d} N={n}")
            row[str(form)] = graph_ms(run)
        out["distinct_first_branches"].append(row)
        del q, ref, scratch
    for (d, n, s), forms in K6_BRANCHES:
        seg, mask, hi, lo, _s = k6_inputs(gen, d, n, device)
        args = (seg % s, mask, hi, lo)
        ref = plain.seg_min_max_rows(*args, s)
        scratch = torch.empty(lib.guard_seg_min_max_scratch(d, s), dtype=torch.uint8,
                              device=device)
        row = {"D": d, "N": n, "S": s, "picked": lib.guard_seg_min_max_branch(d, n, s)}
        for form in forms:
            def run(form=form):
                o = tuple(torch.empty((d, s), dtype=torch.int32, device=device)
                          for _ in range(4))
                rc = lib.guard_seg_min_max_rows_as(
                    form, *(t.data_ptr() for t in (*args, *o)),
                    scratch.data_ptr() if form == 0 else None, d, n, s, current_stream())
                check(rc == 0, f"K6 form {form} refused (cudaError {rc})")
                return o
            check(_equal(run(), ref), f"K6 form {form} differs at D={d} N={n} S={s}")
            row[str(form)] = graph_ms(run)
        out["seg_min_max_branches"].append(row)
        del seg, mask, hi, lo, args, ref, scratch
    torch.cuda.empty_cache()
    return out


def design_main(checkout: Path) -> int:
    """--design-sweep: the design sweep of CHECKOUT's package, as one
    JSON line."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    sys.path.insert(0, str(checkout))
    import guard_tpu_torch

    pkg = Path(guard_tpu_torch.__file__).resolve()
    check(checkout.resolve() in pkg.parents, f"imported {pkg}, not {checkout}'s package")
    from guard_tpu_torch.kernels.build import load

    load()
    result = design_sweep(torch.device("cuda"))
    print(json.dumps({"checkout": str(checkout), "card": card_line(), **result}))
    return 0


def compare_main(other: Path) -> int:
    """--compare-designs: the design sweeps of OTHER and of this
    checkout in turns (other, this, this, other), one process each."""
    runs = []
    for checkout in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--design-sweep", str(checkout)],
            capture_output=True, text=True, timeout=900,
        )
        sys.stderr.write(proc.stderr[-4000:])
        check(proc.returncode == 0, f"design sweep of {checkout} exited {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"compare_designs": runs}))
    return 0


def pool_worker_modules() -> list:
    """What two workers of the oracle rerun pool hold of torch, JAX and
    the JAX package (each must answer [])."""
    import multiprocessing as mp

    from guard_tpu_torch.ops.oracle_pool import _oracle_pool_init, worker_modules

    with mp.get_context("spawn").Pool(2, initializer=_oracle_pool_init,
                                      initargs=([],)) as pool:
        return pool.map(worker_modules, range(2))


def ingest_worker_modules() -> list:
    """What the workers of the ingest pool hold of torch, JAX and the
    JAX package (each answer must be [])."""
    from guard_tpu_torch.ops.oracle_pool import worker_modules
    from guard_tpu_torch.parallel.ingest import shared_pool

    pool = shared_pool(2)
    check(pool is not None, "the ingest pool did not start")
    return [pool.submit(worker_modules, None).get(timeout=120) for _ in range(4)]


def build_all() -> tuple:
    """Build the kernels (nvcc, one process a source) while g++ builds
    the native oracle and encoder; a failed build raises. Returns each
    build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from guard_tpu_torch.kernels.build import load
    from guard_tpu_torch.ops import native_encoder, native_oracle

    def build_host(module):
        t1 = time.perf_counter()
        path = module.build_native()
        return path, time.perf_counter() - t1

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        oracle_build = pool.submit(build_host, native_oracle)
        encoder_build = pool.submit(build_host, native_encoder)
        load()
        build_s = time.perf_counter() - t0
        oracle_path, oracle_build_s = oracle_build.result()
        encoder_path, encoder_build_s = encoder_build.result()
    check(native_oracle.native_available(), f"the native oracle at {oracle_path} does not load")
    check(native_encoder.native_available(), f"the native encoder at {encoder_path} does not load")
    log(f"kernels built in {build_s:.1f}s, the native oracle in {oracle_build_s:.1f}s, "
        f"the native encoder in {encoder_build_s:.1f}s")
    return build_s, oracle_build_s, encoder_build_s


def serve_main() -> int:
    """`--phase serve`: the build and phase `serve` alone, on the
    registry's files; one JSON line of the legs, then the card."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    sys.path.insert(0, str(ROOT))
    card = card_line()
    build_s = build_all()[0]
    with tempfile.TemporaryDirectory(prefix="guard_smoke_") as td:
        tmp = Path(td)
        os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(tmp / "plans")
        os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = str(tmp / "results_default")
        os.environ["GUARD_TPU_FLIGHTREC_DIR"] = str(tmp / "flightrec")
        registry_files(tmp)
        t0 = time.perf_counter()
        info, launches = phase_serve(torch.device("cuda"), tmp)
        wall = time.perf_counter() - t0
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "guard_tpu" or m.startswith("guard_tpu."))
    check(not leaked, f"imported {leaked}")
    print(json.dumps({"serve": info, "launches_by_path": launches, "phase_s": wall,
                      "build_s": build_s, "card": card}))
    print(card)
    return 0


def multicard_main() -> int:
    """`--phase multicard`: the build and phase `multicard` alone, on
    the registry's files; one JSON line of the phase, then the card."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    sys.path.insert(0, str(ROOT))
    card = card_line()
    build_s = build_all()[0]
    with tempfile.TemporaryDirectory(prefix="guard_smoke_") as td:
        tmp = Path(td)
        os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(tmp / "plans")
        os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = str(tmp / "results_default")
        os.environ["GUARD_TPU_FLIGHTREC_DIR"] = str(tmp / "flightrec")
        registry_files(tmp)
        info, launches = phase_multicard(torch.device("cuda"), tmp)
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "guard_tpu" or m.startswith("guard_tpu."))
    check(not leaked, f"imported {leaked}")
    print(json.dumps({"multicard": info, "launches": launches, "build_s": build_s,
                      "card": card}))
    print(card)
    return 0


def distributed_main() -> int:
    """`--phase distributed`: the build and phase `distributed` alone,
    on the registry's files; one JSON line of the phase, then the card."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    sys.path.insert(0, str(ROOT))
    card = card_line()
    build_s = build_all()[0]
    with tempfile.TemporaryDirectory(prefix="guard_smoke_") as td:
        tmp = Path(td)
        os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(tmp / "plans")
        os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = str(tmp / "results_default")
        os.environ["GUARD_TPU_FLIGHTREC_DIR"] = str(tmp / "flightrec")
        registry_files(tmp)
        info, launches = phase_distributed(torch.device("cuda"), tmp)
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "guard_tpu" or m.startswith("guard_tpu."))
    check(not leaked, f"imported {leaked}")
    print(json.dumps({"distributed": info, "build_s": build_s, "card": card}))
    print(card)
    return 0


def kernel_fuzz_main(seconds: float) -> int:
    """`--phase kernel_fuzz [--fuzz-time S]`: the build and phase
    `kernel_fuzz` alone for S seconds (default FUZZ_SECONDS); the
    phase's line, then the card."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    sys.path.insert(0, str(ROOT))
    card = card_line()
    build_s = build_all()[0]
    info, _launches = phase_kernel_fuzz(torch.device("cuda"), seconds)
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "guard_tpu" or m.startswith("guard_tpu."))
    check(not leaked, f"imported {leaked}")
    print(json.dumps({"kernel_fuzz": info, "build_s": build_s, "card": card}))
    print(card)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import guard_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the guard_tpu_torch package is missing beside this script ({e})")
        return 2

    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    from guard_tpu_torch.parallel import ingest

    build_s, oracle_build_s, encoder_build_s = build_all()

    clock = [time.perf_counter()]

    def took() -> str:
        """Seconds since the previous call (or the phases' start)."""
        now = time.perf_counter()
        secs, clock[0] = now - clock[0], now
        return f"{secs:.1f}s"

    sweep = phase_kernel_sweep(device)
    log(f"phase 2 (kernels vs plain) ok in {took()}")
    with tempfile.TemporaryDirectory(prefix="guard_smoke_") as td:
        tmp = Path(td)
        # the plan layer's artifacts, the result cache's entries and the
        # flight recorder's dumps, of this run and its subprocesses
        os.environ["GUARD_TPU_PLAN_CACHE_DIR"] = str(tmp / "plans")
        os.environ["GUARD_TPU_RESULT_CACHE_DIR"] = str(tmp / "results_default")
        os.environ["GUARD_TPU_FLIGHTREC_DIR"] = str(tmp / "flightrec")
        slice_info, evaluation, data_files = phase_slice(device, tmp)
        log(f"phase 3 (slice) ok in {took()}: "
            f"{json.dumps({k: v for k, v in slice_info.items() if k != 'shapes'})}")
        breakdown = phase_breakdown(device, evaluation)
        log(f"phase 3 (breakdown) in {took()}: {json.dumps(breakdown)}")
        ingest_info, texts = phase_ingest(device, tmp, slice_info, evaluation)
        log(f"phase 3 (ingest) ok in {took()}")
        flags_info = phase_slice_flags(device, tmp, slice_info, texts)
        del texts
        log(f"phase 3 (cache, scalar rim, mesh) ok in {took()}: "
            f"{json.dumps({k: v for k, v in flags_info.items() if k != 'launches'})}")
        # the first N_REPORT_DOCS templates and the volume template (the
        # last document, alone in its 65,536-node bucket)
        rows = list(range(N_REPORT_DOCS)) + [len(data_files) - 1]
        check(len(data_files[-1].content) == max(len(df.content) for df in data_files),
              "the slice's last document is not the volume template")
        report_info = phase_report(device, tmp, [data_files[i] for i in rows], evaluation,
                                   rows)
        del evaluation, data_files
        log(f"phase 3 (report) ok in {took()}: {json.dumps(report_info)}")
        backends_info = phase_backends(device, tmp)
        log(f"phase 3 (backends) ok in {took()}: {json.dumps(backends_info)}")
        xref_info, evaluation, xref_files = phase_xref(device, tmp)
        log(f"phase 3 (xref) ok in {took()}: "
            f"{json.dumps({k: v for k, v in xref_info.items() if k != 'shapes'})}")
        xref_ingest = phase_xref_ingest(device, tmp, xref_info, evaluation, xref_files)
        del xref_files
        log(f"phase 3 (xref ingest) ok in {took()}: {json.dumps(xref_ingest)}")
        xref_breakdown = phase_breakdown(device, evaluation)
        del evaluation
        log(f"phase 3 (xref breakdown) in {took()}: {json.dumps(xref_breakdown)}")
        fnvar_info, evaluation = phase_fnvar(device, tmp)
        log(f"phase 3 (fnvar) ok in {took()}: "
            f"{json.dumps({k: v for k, v in fnvar_info.items() if k != 'shapes'})}")
        fnvar_breakdown = phase_breakdown(device, evaluation)
        del evaluation
        log(f"phase 3 (fnvar breakdown) in {took()}: {json.dumps(fnvar_breakdown)}")
        flagship = phase_flagship(device)
        log(f"phase 3 (flagship) ok in {took()}: {flagship}")
        corpus = phase_corpus(device)
        log(f"phase 3 (corpus) ok in {took()}: {corpus}")
        test_info = phase_test_command(device)
        log(f"phase 3 (test) ok in {took()}: {json.dumps(test_info)}")
        packing, packing_info = phase_packing(device, tmp)
        log(f"phase 3 (packing) ok in {took()}: {json.dumps(packing)}")
        sweep_run, sweep_info = phase_sweep(device, tmp)
        log(f"phase 3 (sweep) ok in {took()}: {json.dumps(sweep_run)}")
        serve_run, serve_launches = phase_serve(device, tmp)
        log(f"phase 3 (serve) ok in {took()}")
        multicard, multicard_launches = phase_multicard(device, tmp)
        log(f"phase 3 (multicard) ok in {took()}")
        distributed_info, distributed_launches = phase_distributed(device, tmp)
        log(f"phase 3 (distributed) ok in {took()}")
        summary_info = phase_summary(device)
        log(f"phase 3 (summary) ok in {took()}: "
            f"{json.dumps({k: v for k, v in summary_info.items() if k != 'shapes'})}")
        entry_info = phase_entry(device)
        log(f"phase 3 (entry) ok in {took()}: {json.dumps(entry_info)}")
        fuzz_info, fuzz_launches = phase_kernel_fuzz(device)
        print(json.dumps({"kernel_fuzz": fuzz_info}), flush=True)
        log(f"phase 3 (kernel_fuzz) ok in {took()}")
        cli = phase_cli(tmp)
        log(f"phase 4 (cli) ok in {took()}: {cli}")
    infos = {"security": slice_info, "xref": xref_info, "fnvar": fnvar_info,
             "summary": summary_info, "entry": entry_info, "report": report_info,
             "ingest_ii": ingest_info["ii_auto"], "xref_ingest": xref_ingest,
             "packing": packing_info, "sweep": sweep_info, **serve_launches,
             **{path: {"launches": launches}
                for path, launches in flags_info["launches"].items()},
             "test_command": {"launches": test_info["launches"]},
             "multicard": {"launches": multicard_launches},
             "distributed": {"launches": distributed_launches},
             "kernel_fuzz": {"launches": fuzz_launches}}
    kernels = contract_kernels(device, infos, sweep, card)
    log(f"kernels line in {took()}")
    leaked = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
        or m == "guard_tpu" or m.startswith("guard_tpu.")
    )
    check(not leaked, f"imported {leaked}")
    workers = pool_worker_modules()
    check(workers == [[], []], f"an oracle pool worker imported {workers}")
    held = ingest_worker_modules()
    check(held == [[]] * 4, f"an ingest pool worker imported {held}")
    ingest.close_shared_pools()

    print(json.dumps({
        "slice": {k: v for k, v in slice_info.items() if k != "shapes"},
        "breakdown": breakdown,
        "xref": {k: v for k, v in xref_info.items() if k != "shapes"},
        "xref_breakdown": xref_breakdown,
        "fnvar": {k: v for k, v in fnvar_info.items() if k != "shapes"},
        "fnvar_breakdown": fnvar_breakdown,
        "flagship": flagship, "corpus": corpus, "packing": packing, "sweep": sweep_run,
        "serve": serve_run, "multicard": multicard, "distributed": distributed_info,
        "summary": {k: v for k, v in summary_info.items() if k != "shapes"},
        "report": report_info, "ingest": ingest_info, "xref_ingest": xref_ingest,
        "flags": {k: v for k, v in flags_info.items() if k != "launches"}, "test": test_info,
        "backends": backends_info,
        "entry": entry_info, "cli": cli,
        "build_s": build_s, "oracle_build_s": oracle_build_s,
        "encoder_build_s": encoder_build_s, "card": card,
    }))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--design-sweep"]:
            code = design_main(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT)
        elif sys.argv[1:2] == ["--compare-designs"] and len(sys.argv) == 3:
            code = compare_main(Path(sys.argv[2]))
        elif sys.argv[1:] == ["--phase", "serve"]:
            code = serve_main()
        elif sys.argv[1:] == ["--phase", "multicard"]:
            code = multicard_main()
        elif sys.argv[1:] == ["--phase", "distributed"]:
            code = distributed_main()
        elif sys.argv[1:3] == ["--phase", "kernel_fuzz"] and (
                len(sys.argv) == 3 or (len(sys.argv) == 5 and sys.argv[3] == "--fuzz-time")):
            code = kernel_fuzz_main(float(sys.argv[4]) if len(sys.argv) == 5 else FUZZ_SECONDS)
        else:
            code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.exit(code)

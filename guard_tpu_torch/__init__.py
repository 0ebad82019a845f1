"""guard_tpu_torch: the PyTorch + CUDA port of guard-tpu's batch engine.

A second package beside the JAX reference (`guard_tpu`): it keeps its
own copies of the host-side modules it needs and imports neither JAX
nor `guard_tpu`. It runs `validate` end to end on the CUDA cards:
parse, precompute function values on the host, encode, lower, the
batched torch walk with six hand-written CUDA kernels
(`csrc/guard_kernels.cu`, `csrc/guard_joins.cu`), the rim reductions,
and the reports of the documents that need one, built on the host by
the native C++ oracle (`ops/native_oracle.py`) where it is built, else
by the CPU evaluator (`core/evaluator.py`), in every output format of
the JAX package's `validate --backend tpu` (`commands/reporters/`). A
seventh kernel counts each rule's PASS, FAIL and SKIP documents for
`with_summary`; `entry.py` holds the entry points (`python -m
guard_tpu_torch.entry`). Every evaluator runs over a mesh of the
visible cards (`parallel/mesh.py`: each bucket's documents cut across
them; `parallel/mesh2d.py`: `--mesh-shape` doc shards and pack columns;
`parallel/rules.py`: `--rule-shards` groups of cards). The documents
reach the card from the port's native encoder (`ops/native_encoder.py`),
in process or over a spawn pool of ingest workers
(`parallel/ingest.py`), with the JAX package's document quarantine
(`--max-doc-failures`); `validate --backend cpu|native|auto` evaluates
on the host instead, with no card. Rule files are lowered once into a
plan (`ops/plan.py`: an in-process memo and content-addressed artifacts
on disk) and the files that can share one program are fused into packs,
one walk and one rim reduction per (pack, bucket). Unchanged documents
replay from a content-addressed result cache (`cache/results.py`), every
host stage runs in a span of the telemetry plane (`utils/telemetry.py`,
`--trace-out`, `--metrics-out`), and `test` (`commands/test.py`) runs a
rule registry's expectation suites on the card. `sweep`
(`commands/sweep.py`) evaluates a corpus in journaled chunks, and
`serve` (`commands/serve.py`, `serve/`) is the persistent session
(stdio, TCP/HTTP, the Kubernetes webhook, `lambda_handler.py`) whose
concurrent requests coalesce into packed batches on the card;
`api.py` is the library face; `lint`, `completions` and `parse-tree`
read rule files without a card.
"""

import sys as _sys

# Deep documents exceed the interpreter's default recursion limit in the
# loader and the CPU evaluator, which walk trees recursively (the walk
# on the card is iterative); the JAX package raises it likewise.
if _sys.getrecursionlimit() < 20000:
    _sys.setrecursionlimit(20000)

from .api import (
    CommandBuilder,
    ParseTreeBuilder,
    RulegenBuilder,
    TestBuilder,
    ValidateBuilder,
    run_checks,
)
from .core.qresult import Status

#: the port's own version: it keys the plan artifacts (ops/plan.py)
__version__ = "0.1.0"

__all__ = [
    "run_checks",
    "CommandBuilder",
    "ValidateBuilder",
    "TestBuilder",
    "ParseTreeBuilder",
    "RulegenBuilder",
    "Status",
    "__version__",
]

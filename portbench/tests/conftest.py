"""The benchmark's own tests: `python -m pytest portbench/tests` from the
checkout's root. Tests that need a CUDA card carry the `cuda` marker and
skip inside the test when none is present."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs the benchmark on a CUDA card; skips without one"
    )


def tiny(spec, docs=600, dirs=2, chunks=2):
    """The cell cut to a size a CPU test holds: one chunk an invocation."""
    spec.cell.update(docs_per_invocation=docs, pool_dirs=dirs, warm_docs=docs, check_chunks=chunks)
    return spec


def load_cell(cell="secpol.sweep"):
    from portbench.harness import spec as spec_mod

    return spec_mod.load(ROOT, cell)

"""Backfill the run ledger from the committed bench artifacts.

    GUARD_TPU_LEDGER_DIR=... python -m guard_tpu_torch.tools.perf_ledger [artifact...]

The command around `utils/ledger.backfill`, the port's counterpart of
the JAX package's tools/perf_ledger.py: with no arguments it ingests
every `bench_all_*.json` at the repository's root, oldest round first
(r10 after r9), one `bench` record per metric row. Prints one JSON
summary line (the ledger's path, the artifacts, the records appended);
exits 1 when no ledger destination is configured, an artifact does not
exist or a line fails to parse.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

from ..utils import ledger

REPO = Path(__file__).resolve().parent.parent.parent


def artifact_order(path: Path):
    """Sort key of bench_all_rN.json: the numeric round, then the stem."""
    m = re.search(r"(\d+)", path.stem)
    return (int(m.group(1)) if m else -1, path.stem)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv:
        paths = [Path(a) for a in argv]
    else:
        paths = sorted(REPO.glob("bench_all_*.json"), key=artifact_order)
    if not paths:
        print("no bench artifacts to ingest", file=sys.stderr)
        return 1
    missing = [p for p in paths if not p.exists()]
    if missing:
        for p in missing:
            print(f"{p}: does not exist", file=sys.stderr)
        return 1
    if not ledger.ledger_enabled():
        print("no ledger destination: set GUARD_TPU_LEDGER_DIR", file=sys.stderr)
        return 1
    try:
        n = ledger.backfill(paths)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(json.dumps({
        "ledger": ledger.ledger_path(),
        "artifacts": [p.name for p in paths],
        "records_appended": n,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""`report`: render and diff run-ledger records.

The port's copy of guard_tpu/commands/ops_report.py; its output is the
JAX package's byte for byte on the same ledger file. The human face of
the operations plane (utils/ledger.py): with no
flags it diffs the two newest ledger records (headline ratio, changed
counters, config-hash match); `--baseline FILE` diffs the newest
record against the newest record of a committed baseline ledger;
`--check METRIC` runs the min-of-N noise-band regression gate and
exits 19 on a regression (the validate FAILURE code — CI-friendly);
`--efficiency` renders the newest record's hardware-efficiency group
(padding waste, pack occupancy, transfer bytes) as derived
utilization percentages.

Exit codes: 0 ok, 19 regression (--check), 5 unusable ledger (missing,
corrupt, too few records) — mirroring validate's 0/19/5 protocol.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..utils import ledger
from ..utils.io import Reader, Writer


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:,.2f}"
    if isinstance(v, int):
        return f"{v:,}"
    return str(v)


def _describe(rec: dict) -> str:
    head = rec.get("headline") or {}
    census = rec.get("device_census") or {}
    parts = [
        f"kind={rec.get('kind')}",
        f"ts={rec.get('ts'):.0f}" if isinstance(
            rec.get("ts"), (int, float)) else "ts=?",
        f"config={rec.get('config_hash') or '-'}",
        f"devices={census.get('backend')}x{census.get('device_count')}",
    ]
    if head:
        parts.append(
            f"{head.get('metric')}={_fmt_val(head.get('value'))} "
            f"{head.get('unit')}"
        )
    if rec.get("exit_code") is not None:
        parts.append(f"exit={rec['exit_code']}")
    return " ".join(parts)


@dataclass
class OpsReport:
    ledger_file: Optional[str] = None
    baseline: Optional[str] = None
    efficiency: bool = False
    check: Optional[str] = None
    tolerance: float = 0.15
    window: int = 3

    def _load(self, writer: Writer, path=None):
        try:
            records = ledger.read_ledger(path or self.ledger_file)
        except (FileNotFoundError, ValueError) as e:
            writer.writeln_err(f"Error: {e}")
            return None
        bad = [
            (i, p) for i, r in enumerate(records, 1)
            for p in ledger.check_record(r)
        ]
        if bad:
            for i, p in bad:
                writer.writeln_err(f"Error: ledger record {i}: {p}")
            return None
        return records

    def execute(self, writer: Writer, reader: Reader) -> int:
        records = self._load(writer)
        if records is None:
            return 5
        if not records:
            writer.writeln_err("Error: ledger is empty")
            return 5

        if self.check:
            verdict = ledger.regression_check(
                records, self.check, tolerance=self.tolerance,
                window=self.window,
            )
            if verdict["status"] == "insufficient":
                writer.writeln_err(
                    f"Error: fewer than 2 ledger records carry metric "
                    f"{self.check!r}"
                )
                return 5
            writer.writeln(
                f"check {verdict['metric']}: {verdict['status']} "
                f"(current {_fmt_val(verdict['current'])} vs best-of-"
                f"{verdict['window']} baseline "
                f"{_fmt_val(verdict['baseline'])}, tolerance "
                f"{verdict['tolerance']:.0%})"
            )
            return 19 if verdict["regressed"] else 0

        if self.efficiency:
            return self._efficiency(writer, records[-1])

        if self.baseline:
            base_records = self._load(writer, self.baseline)
            if base_records is None:
                return 5
            if not base_records:
                writer.writeln_err("Error: baseline ledger is empty")
                return 5
            a, b = base_records[-1], records[-1]
            writer.writeln(f"baseline: {_describe(a)}")
            writer.writeln(f"current:  {_describe(b)}")
        else:
            if len(records) < 2:
                writer.writeln_err(
                    "Error: need at least 2 ledger records to diff "
                    "(or pass --baseline)"
                )
                return 5
            a, b = records[-2], records[-1]
            writer.writeln(f"previous: {_describe(a)}")
            writer.writeln(f"newest:   {_describe(b)}")

        diff = ledger.diff_records(a, b)
        if diff["headline_ratio"] is not None:
            writer.writeln(
                f"headline ratio: x{diff['headline_ratio']:.3f} "
                f"({'same' if diff['same_config'] else 'DIFFERENT'} "
                "config)"
            )
        for key, d in diff["counters"].items():
            writer.writeln(
                f"  {key}: {_fmt_val(d['a'])} -> {_fmt_val(d['b'])}"
            )
        if not diff["counters"]:
            writer.writeln("  (no counter deltas)")
        self._durability(writer, records)
        return 0

    @staticmethod
    def _durability(writer: Writer, records: list) -> None:
        """Durability-plane roll-up over the whole ledger: what share
        of sweep sessions resumed from a journal (vs cold-started) and
        how many sessions exited via graceful drain — the operator's
        answer to "is checkpoint/resume actually carrying the fleet, or
        are we cold-starting every retry?"."""
        sweeps = [r for r in records if r.get("kind") == "sweep"]
        if not sweeps:
            return
        resumed = [
            r for r in sweeps
            if (r.get("extra") or {}).get("resumed_from")
        ]
        drained = [
            r for r in records if (r.get("extra") or {}).get("drained")
        ]
        if not resumed and not drained:
            return
        writer.writeln(
            f"resume rate: {len(resumed) / len(sweeps):.1%} "
            f"({len(resumed)}/{len(sweeps)} sweep sessions resumed, "
            f"{sum((r.get('extra') or {}).get('chunks_replayed', 0) for r in resumed):,}"
            " chunks replayed)"
        )
        if drained:
            writer.writeln(
                f"drained sessions: {len(drained)} "
                "(graceful SIGTERM/SIGINT exits)"
            )

    def _efficiency(self, writer: Writer, rec: dict) -> int:
        metrics = rec.get("metrics") or {}
        eff = (metrics.get("counters") or {}).get("efficiency")
        if not eff:
            writer.writeln_err(
                "Error: newest ledger record carries no efficiency "
                "metrics (run with the tpu backend, schema_version >= 2)"
            )
            return 5
        writer.writeln(f"record: {_describe(rec)}")
        for k in sorted(eff):
            writer.writeln(f"  efficiency.{k}: {_fmt_val(eff[k])}")
        docs_real = eff.get("docs_real", 0)
        docs_pad = eff.get("docs_padded", 0)
        if docs_real + docs_pad:
            writer.writeln(
                f"  doc slot fill: "
                f"{docs_real / (docs_real + docs_pad):.1%}"
            )
        nodes_real = eff.get("node_slots_real", 0)
        nodes_pad = eff.get("node_slots_padded", 0)
        if nodes_real + nodes_pad:
            writer.writeln(
                f"  node slot fill: "
                f"{nodes_real / (nodes_real + nodes_pad):.1%}"
            )
        used = eff.get("pack_rule_slots_used", 0)
        cap = eff.get("pack_rule_slots_capacity", 0)
        if cap:
            writer.writeln(f"  pack slot utilization: {used / cap:.1%}")
        for name, val in sorted((metrics.get("gauges") or {}).items()):
            if name.startswith("efficiency."):
                writer.writeln(f"  {name}: {_fmt_val(val)}")
        # incremental plane: how much of the run the result cache
        # absorbed (hits / lookups) and the delta fraction the session
        # actually dispatched
        rcache = (metrics.get("counters") or {}).get("result_cache")
        if rcache:
            hits = rcache.get("hits", 0)
            lookups = hits + rcache.get("misses", 0)
            if lookups:
                writer.writeln(
                    f"  result-cache hit rate: {hits / lookups:.1%} "
                    f"({hits:,}/{lookups:,} lookups)"
                )
        extra = rec.get("extra") or {}
        if extra.get("delta_fraction") is not None:
            writer.writeln(
                f"  delta fraction: {extra['delta_fraction']:.1%} "
                f"({extra.get('delta_docs')}/{extra.get('total_docs')} "
                "docs dispatched)"
            )
        return 0

"""Metrics-snapshot schema gate of the port: validate a `--metrics-out`
document (or the `serve --stdio` metrics response body) against the
telemetry plane's published shape.

    python -m guard_tpu_torch.tools.check_metrics_schema snapshot.json [...]

The snapshot is the machine face of `guard_tpu_torch.utils.telemetry`
(dashboards and the trace smoke consume it), so its shape is a
contract: the port's `SCHEMA_VERSION`, the absorbed counter groups with
integer-or-float counter values, histograms whose bucket counts sum to
their `count`, and span roll-ups carrying count + total_seconds. The
port's copy of the JAX package's tools/check_metrics_schema.py, whose
rules it keeps; the version it holds a snapshot to is the port's own.

Importable: `check_snapshot(doc) -> [problems]` (empty = valid).
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

from ..utils.telemetry import SCHEMA_VERSION

#: the schema_version this checker understands: the port's telemetry
#: plane's (guard_tpu_torch/utils/telemetry.py), the JAX package's
#: version 7 (v7: the `resume` and `gc` counter groups joined the
#: contract)
KNOWN_SCHEMA_VERSION = SCHEMA_VERSION

#: top-level sections every snapshot must carry
SECTIONS = ("schema_version", "counters", "gauges", "histograms", "spans")

#: counter groups a full tpu-backend run registers. Groups register at
#: module import, and a session off the device (cpu validate, serve)
#: never imports parallel/device.py, so dispatch and pipeline can be
#: absent; callers that ran the device path pass these as
#: `require_groups`. plan_cache registers with ops/plan.py,
#: result_cache with cache/results.py, analysis with the analysis
#: package, and admission, resume and gc with utils/telemetry.py itself.
EXPECTED_GROUPS = (
    "dispatch", "pipeline", "rim", "fault", "plan_cache", "efficiency",
    "result_cache", "analysis", "admission", "resume", "gc",
)

#: keys every histogram snapshot must carry
HIST_KEYS = (
    "count", "total_seconds", "min_seconds", "max_seconds",
    "p50_seconds", "p99_seconds", "buckets",
)

#: bucket labels are "le_2^{E}s" (E the integer upper-bound exponent)
#: plus the "inf" overflow bucket
_BUCKET_LABEL = re.compile(r"^le_2\^(-?\d+)s$")

#: per-doc-shard mesh gauges (v3): any gauge under the
#: `efficiency.shard_` namespace must be exactly shard index + one of
#: the three published per-shard metrics — a typo'd shard gauge would
#: otherwise silently vanish from mesh-skew dashboards
_SHARD_GAUGE = re.compile(r"^efficiency\.shard_(\d+)\.(doc_fill|h2d|d2h)$")


def _check_shard_gauges(gauges: dict) -> list:
    problems = []
    for name, v in gauges.items():
        if not name.startswith("efficiency.shard_"):
            continue
        m = _SHARD_GAUGE.match(name)
        if m is None:
            problems.append(f"malformed per-shard gauge name {name!r}")
            continue
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            problems.append(f"gauge {name} has non-numeric value {v!r}")
        elif m.group(2) == "doc_fill" and not (0.0 <= v <= 1.0):
            problems.append(
                f"gauge {name} = {v!r} outside the [0, 1] fill range"
            )
    return problems


def _check_bucket_labels(name: str, buckets: dict) -> list:
    """Bucket keys must be well-formed and monotonically ordered:
    strictly increasing exponents in insertion order, with "inf" only
    allowed as the final key — a scrambled snapshot writer would
    otherwise silently corrupt the quantile story downstream."""
    problems = []
    last_exp = None
    keys = list(buckets)
    for i, k in enumerate(keys):
        if k == "inf":
            if i != len(keys) - 1:
                problems.append(
                    f"histogram {name!r}: 'inf' bucket is not last"
                )
            continue
        m = _BUCKET_LABEL.match(k)
        if m is None:
            problems.append(
                f"histogram {name!r}: malformed bucket label {k!r}"
            )
            continue
        exp = int(m.group(1))
        if last_exp is not None and exp <= last_exp:
            problems.append(
                f"histogram {name!r}: bucket labels not monotonically "
                f"ordered ({k!r} after le_2^{last_exp}s)"
            )
        last_exp = exp
    return problems


def check_snapshot(doc, require_groups: tuple = ()) -> list:
    """Validate one parsed snapshot document; returns a list of
    problem strings (empty when the snapshot is schema-valid).
    `require_groups` names counter groups that MUST be present (pass
    EXPECTED_GROUPS after a full tpu-backend run)."""
    problems = []
    if not isinstance(doc, dict):
        return ["snapshot is not a JSON object"]
    for k in SECTIONS:
        if k not in doc:
            problems.append(f"missing top-level section {k!r}")
    if problems:
        return problems
    if doc["schema_version"] != KNOWN_SCHEMA_VERSION:
        problems.append(
            f"schema_version {doc['schema_version']!r} != "
            f"{KNOWN_SCHEMA_VERSION} (checker out of date, or snapshot "
            "from a different telemetry plane)"
        )
    counters = doc["counters"]
    if not isinstance(counters, dict):
        problems.append("`counters` is not an object")
    else:
        for g in require_groups:
            if g not in counters:
                problems.append(f"missing counter group {g!r}")
        for g, vals in counters.items():
            if not isinstance(vals, dict):
                problems.append(f"counter group {g!r} is not an object")
                continue
            for k, v in vals.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    problems.append(
                        f"counter {g}.{k} has non-numeric value {v!r}"
                    )
    if not isinstance(doc["gauges"], dict):
        problems.append("`gauges` is not an object")
    else:
        problems.extend(_check_shard_gauges(doc["gauges"]))
    hists = doc["histograms"]
    if not isinstance(hists, dict):
        problems.append("`histograms` is not an object")
        hists = {}
    for name, h in hists.items():
        if not isinstance(h, dict):
            problems.append(f"histogram {name!r} is not an object")
            continue
        for k in HIST_KEYS:
            if k not in h:
                problems.append(f"histogram {name!r} missing key {k!r}")
        if not isinstance(h.get("count"), int):
            problems.append(f"histogram {name!r} count is not an int")
            continue
        buckets = h.get("buckets")
        if not isinstance(buckets, dict):
            problems.append(f"histogram {name!r} buckets is not an object")
            continue
        problems.extend(_check_bucket_labels(name, buckets))
        total = sum(buckets.values())
        if total != h["count"]:
            problems.append(
                f"histogram {name!r}: bucket counts sum to {total}, "
                f"count says {h['count']}"
            )
        if h["count"] > 0 and h.get("p50_seconds") is None:
            problems.append(
                f"histogram {name!r}: count > 0 but p50_seconds is null"
            )
    spans = doc["spans"]
    if not isinstance(spans, dict):
        problems.append("`spans` is not an object")
        spans = {}
    for name, roll in spans.items():
        if (
            not isinstance(roll, dict)
            or not isinstance(roll.get("count"), int)
            or not isinstance(roll.get("total_seconds"), (int, float))
        ):
            problems.append(
                f"span roll-up {name!r} must carry int `count` and "
                "numeric `total_seconds`"
            )
            continue
        # every span roll-up has a matching per-stage histogram whose
        # count agrees (observe_span feeds both under one call)
        h = hists.get(f"stage.{name}")
        if h is None:
            problems.append(
                f"span roll-up {name!r} has no stage.{name} histogram"
            )
        elif isinstance(h, dict) and h.get("count") != roll["count"]:
            problems.append(
                f"span {name!r}: roll-up count {roll['count']} != "
                f"stage histogram count {h.get('count')}"
            )
    return problems


def main(argv: list) -> int:
    if not argv:
        print("usage: python -m guard_tpu_torch.tools.check_metrics_schema "
              "snapshot.json [...]",
              file=sys.stderr)
        return 2
    rc = 0
    for a in argv:
        path = pathlib.Path(a)
        if not path.exists():
            print(f"{path}: does not exist", file=sys.stderr)
            rc = 1
            continue
        try:
            doc = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            print(f"{path}: unparseable JSON ({e})", file=sys.stderr)
            rc = 1
            continue
        problems = check_snapshot(doc)
        if problems:
            rc = 1
            for p in problems:
                print(f"{path}: {p}", file=sys.stderr)
        else:
            print(f"{path}: ok (schema_version "
                  f"{doc['schema_version']})")
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

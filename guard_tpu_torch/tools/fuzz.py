"""Coverage-guided fuzzer of the port's two parsers through `run_checks`.

    python -m guard_tpu_torch.tools.fuzz --target dsl|yaml --time S
        [--seed N] [--crash-dir DIR]

The port's counterpart of the JAX package's tools/fuzz.py: a greybox
loop on CPython 3.12's `sys.monitoring` (PEP 669). LINE events fire
once per not-yet-seen location of the port's package (its tools left
out) and are then disabled per location, so "this input reached new
code" costs almost nothing in steady state; an input that reached new
lines joins the corpus.

Targets:
  dsl:  mutated rule text  -> run_checks(fixed data, rules)
  yaml: mutated documents  -> run_checks(data, fixed rules)

A crash is any exception other than the engine's own error type (or
RecursionError from adversarially deep nesting). Each crash writes its
payload to `--crash-dir`, and the run exits 1. The run ends with one
line: target= executions= corpus= coverage= crashes=. Host only: no
device is involved.
"""

from __future__ import annotations

import argparse
import random
import sys
import time
from pathlib import Path

from ..api import run_checks
from ..core.errors import GuardError

REPO = Path(__file__).resolve().parent.parent.parent
_PKG = str(Path(__file__).resolve().parent.parent)
_TOOLS = str(Path(__file__).resolve().parent)

TOOL_ID = 3  # sys.monitoring tool slot (0-5 free for apps)


class CoverageFeedback:
    """Global new-line-coverage detector over the port's package."""

    def __init__(self) -> None:
        self.seen: set = set()
        self.hit_new = False
        self._mon = sys.monitoring
        self._mon.use_tool_id(TOOL_ID, "guard-tpu-torch-fuzz")
        self._mon.register_callback(TOOL_ID, self._mon.events.LINE, self._on_line)
        self._mon.set_events(TOOL_ID, self._mon.events.LINE)

    def _on_line(self, code, line):
        name = code.co_filename
        if name.startswith(_PKG) and not name.startswith(_TOOLS):
            self.seen.add((name, line))
            self.hit_new = True
        # stop firing for this exact location either way
        return self._mon.DISABLE

    def close(self) -> None:
        self._mon.set_events(TOOL_ID, 0)
        self._mon.free_tool_id(TOOL_ID)


def seed_corpus(target: str) -> list:
    """Seeds from the repository: the corpus's rules and the examples."""
    seeds: list = []
    roots = [REPO / "corpus" / "rules", REPO / "examples"]
    if target == "dsl":
        for root in roots:
            for g in sorted(root.rglob("*.guard"))[:200]:
                try:
                    seeds.append(g.read_text()[:4000])
                except OSError:
                    pass
    else:
        for root in roots:
            for pat in ("*.json", "*.yaml"):
                for f in sorted(root.rglob(pat))[:120]:
                    try:
                        seeds.append(f.read_text()[:4000])
                    except OSError:
                        pass
    seeds.append("")
    return seeds


TOKENS = [
    "rule ", "when ", "let ", "exists", "!empty", "IN ", "or ", "some ",
    "keys ", "this", "== ", "!= ", ">= ", "r[", "r(", "/x/", "%v", "[*]",
    ".*", "<<", ">>", "{", "}", "[", "]", '"', "'", ":", "-", "\n", "  ",
    "count(", "join(", "to_upper(", "json_parse(", "parse_int(",
    "regex_replace(", "substring(", "parse_epoch(", "now()", "not ",
    "is_struct", "%v[0]", ".%v",
    "Resources", "Properties", "!Ref ", "Fn::", "&a", "*a", "null",
    "true", "1e+308", "9223372036854775807", "\\u0041", "\x00", "\xf0\x9f",
]


def mutate(rng: random.Random, corpus: list) -> str:
    s = rng.choice(corpus)
    out = list(s)
    for _ in range(rng.randint(1, 8)):
        op = rng.randrange(6)
        pos = rng.randrange(len(out) + 1)
        if op == 0 and out:  # delete span
            del out[pos - 1 : pos - 1 + rng.randint(1, 20)]
        elif op == 1:  # insert token
            out[pos:pos] = list(rng.choice(TOKENS))
        elif op == 2 and out:  # flip char
            i = rng.randrange(len(out))
            out[i] = chr(rng.randrange(32, 127))
        elif op == 3:  # splice another corpus entry
            other = rng.choice(corpus)
            if other:
                a = rng.randrange(len(other) + 1)
                out[pos:pos] = list(other[a : a + rng.randint(1, 60)])
        elif op == 4 and out:  # duplicate span
            a = rng.randrange(len(out))
            out[pos:pos] = out[a : a + rng.randint(1, 30)]
        else:  # insert raw byte
            out[pos:pos] = [chr(rng.randrange(1, 256))]
    return "".join(out[:8000])


FIXED_DATA = '{"Resources": {"a": {"Type": "T", "P": [1, "x", {"k": true}]}}}'
FIXED_RULES = "Resources !empty"


def execute(target: str, payload: str) -> str:
    if target == "dsl":
        return run_checks(FIXED_DATA, payload, verbose=False,
                          data_file_name="f.json", rules_file_name="f.guard")
    return run_checks(payload, FIXED_RULES, verbose=False,
                      data_file_name="f.yaml", rules_file_name="f.guard")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m guard_tpu_torch.tools.fuzz", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--target", choices=["dsl", "yaml"], required=True)
    ap.add_argument("--time", type=float, default=420.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-dir", default=str(REPO / "fuzz_crashes"))
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    corpus = seed_corpus(args.target)
    cov = CoverageFeedback()
    crashes = 0
    executions = 0
    deadline = time.monotonic() + args.time

    # replay seeds first so mutation feedback starts from full coverage
    for s in corpus:
        try:
            execute(args.target, s)
        except (GuardError, RecursionError):
            pass

    while time.monotonic() < deadline:
        payload = mutate(rng, corpus)
        cov.hit_new = False
        executions += 1
        try:
            execute(args.target, payload)
        except (GuardError, RecursionError):
            pass  # engine-typed rejection (incl. depth guard) is fine
        except Exception as e:  # crash: anything else (Ctrl-C propagates)
            crashes += 1
            cd = Path(args.crash_dir)
            cd.mkdir(parents=True, exist_ok=True)
            name = f"{args.target}-{executions}-{type(e).__name__}.txt"
            (cd / name).write_text(payload, errors="replace")
            print(f"CRASH {type(e).__name__}: {e!r} -> {cd / name}",
                  file=sys.stderr, flush=True)
        if cov.hit_new:
            corpus.append(payload)

    cov.close()
    print(
        f"target={args.target} executions={executions} "
        f"corpus={len(corpus)} coverage={len(cov.seen)} crashes={crashes}",
        flush=True,
    )
    return 1 if crashes else 0


if __name__ == "__main__":
    sys.exit(main())

"""Generate guard_tpu_torch/ts_lib/dist/{index.js,index.d.ts} from
guard_tpu_torch/ts_lib/index.ts.

    python -m guard_tpu_torch.tools.ts_build [--check]

The port's npm package drives the `guard-tpu-torch` CLI, so its npm
surface is plain JavaScript generated from the TypeScript source, as
the JAX package's is (tools/ts_build.py there). Neither node nor tsc is
needed: this is a small, deterministic TS->CommonJS transpiler scoped
to the constructs index.ts uses (annotations only on function
params/returns and const/let declarations, no classes, no annotated
arrows). Where node is present, `node guard_tpu_torch/ts_lib/smoke.js`
runs the build end to end.

  --check: exit 1 if the committed dist differs from the generated
  output (tests/test_torch_ts_lib.py enforces it).
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

TS_PATH = Path(__file__).resolve().parent.parent / "ts_lib" / "index.ts"
DIST = TS_PATH.parent / "dist"

OPEN = {"(": ")", "[": "]", "{": "}", "<": ">"}
CLOSE = {v: k for k, v in OPEN.items()}


def _scan_string(src: str, i: int) -> int:
    """Return index just past the string/template starting at src[i]."""
    q = src[i]
    i += 1
    while i < len(src):
        c = src[i]
        if c == "\\":
            i += 2
            continue
        if q == "`" and c == "$" and src[i : i + 2] == "${":
            # template interpolation: skip balanced braces
            depth = 0
            i += 2
            while i < len(src):
                if src[i] == "{":
                    depth += 1
                elif src[i] == "}":
                    if depth == 0:
                        break
                    depth -= 1
                elif src[i] in "'\"`":
                    i = _scan_string(src, i) - 1
                i += 1
            i += 1
            continue
        if c == q:
            return i + 1
        i += 1
    return i


def _scan_comment(src: str, i: int) -> int:
    if src[i : i + 2] == "//":
        j = src.find("\n", i)
        return len(src) if j < 0 else j
    if src[i : i + 2] == "/*":
        j = src.find("*/", i + 2)
        return len(src) if j < 0 else j + 2
    return i


def _skip_code(src: str, i: int) -> int:
    """Advance past a string or comment if one starts at i."""
    if i < len(src) and src[i] in "'\"`":
        return _scan_string(src, i)
    if src[i : i + 2] in ("//", "/*"):
        return _scan_comment(src, i)
    return i


def _match_balanced(src: str, i: int) -> int:
    """src[i] is an opener; return index just past its match."""
    opener = src[i]
    closer = OPEN[opener]
    depth = 0
    while i < len(src):
        j = _skip_code(src, i)
        if j != i:
            i = j
            continue
        c = src[i]
        if c == opener:
            depth += 1
        elif c == closer:
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return i


def _type_end(src: str, i: int, stop: str) -> int:
    """End index of a type expression starting at i: consumes balanced
    brackets/generics, stops at any char in `stop` at depth 0."""
    while i < len(src):
        j = _skip_code(src, i)
        if j != i:
            i = j
            continue
        c = src[i]
        if c in stop:
            return i
        if c in "([{<":
            i = _match_balanced(src, i)
            continue
        i += 1
    return i


def strip_interfaces(src: str) -> str:
    out = []
    i = 0
    while i < len(src):
        j = _skip_code(src, i)
        if j != i:
            out.append(src[i:j])
            i = j
            continue
        m = re.match(r"(export\s+)?interface\s+\w+\s*", src[i:])
        if m and (i == 0 or not (src[i - 1].isalnum() or src[i - 1] == "_")):
            k = i + m.end()
            if k < len(src) and src[k] == "{":
                end = _match_balanced(src, k)
                while end < len(src) and src[end] in " \t":
                    end += 1
                if end < len(src) and src[end] == "\n":
                    end += 1
                i = end
                continue
        m = re.match(r"(export\s+)?type\s+\w+\s*=", src[i:])
        if m and (i == 0 or not (src[i - 1].isalnum() or src[i - 1] == "_")):
            end = _type_end(src, i + m.end(), ";")
            i = end + 1
            if i < len(src) and src[i] == "\n":
                i += 1
            continue
        out.append(src[i])
        i += 1
    return "".join(out)


def strip_annotations(src: str) -> str:
    """Strip param/return/declaration annotations and `as` casts."""
    out = []
    i = 0
    n = len(src)

    def strip_params(k: int) -> int:
        """src[k] == '('; emit params without annotations, return index
        past the matching ')'. Recurses for nested parens (none in
        practice: arrows inside are unannotated, so copied verbatim)."""
        end = _match_balanced(src, k)
        seg = src[k:end]
        out.append(_strip_param_annotations(seg))
        return end

    while i < n:
        j = _skip_code(src, i)
        if j != i:
            out.append(src[i:j])
            i = j
            continue
        m = re.match(r"function\s+\w*\s*", src[i:])
        if m and (i == 0 or not (src[i - 1].isalnum() or src[i - 1] == "_")):
            out.append(src[i : i + m.end()])
            k = i + m.end()
            if k < n and src[k] == "(":
                k = strip_params(k)
                # return annotation: ': Type' until '{'
                m2 = re.match(r"\s*:", src[k:])
                if m2:
                    out.append(" ")
                    k = _type_end(src, k + m2.end(), "{")
            i = k
            continue
        m = re.match(r"(const|let|var)\s+\w+\s*(\?)?\s*:", src[i:])
        if m and (i == 0 or not (src[i - 1].isalnum() or src[i - 1] == "_")):
            decl = re.match(r"(const|let|var)\s+\w+", src[i:])
            out.append(src[i : i + decl.end()])
            k = _type_end(src, i + m.end(), "=;")
            out.append(" ")
            i = k
            continue
        m = re.match(r"as\s+", src[i:])
        if (
            m
            and (i == 0 or not (src[i - 1].isalnum() or src[i - 1] == "_"))
            and re.search(r"[\w)\]}\"'`]\s*$", "".join(out[-3:]) if out else "")
        ):
            k = _type_end(src, i + m.end(), ",)];\n")
            # drop trailing space the cast left behind
            while out and out[-1].endswith(" "):
                out[-1] = out[-1][:-1]
            i = k
            continue
        out.append(src[i])
        i += 1
    return "".join(out)


def _strip_param_annotations(seg: str) -> str:
    """Strip `?: Type` / `: Type` from a parameter list segment
    (including the surrounding parens)."""
    inner = seg[1:-1]
    return "(" + _strip_param_annotations_inner(inner) + ")"


def _strip_param_annotations_inner(seg: str) -> str:
    out = []
    i = 0
    n = len(seg)
    while i < n:
        j = _skip_code(seg, i)
        if j != i:
            out.append(seg[i:j])
            i = j
            continue
        c = seg[i]
        if c == "?" and re.match(r"\s*:", seg[i + 1 :]):
            m = re.match(r"\?\s*:", seg[i:])
            i = _type_end(seg, i + m.end(), ",)")
            continue
        if c == ":":
            i = _type_end(seg, i + 1, ",)")
            continue
        if c in "([{":
            end = _match_balanced(seg, i)
            out.append(seg[i:end])
            i = end
            continue
        out.append(c)
        i += 1
    return "".join(out)


def convert_modules(src: str):
    """ES imports/exports -> CommonJS. Returns (src, exported names)."""
    exported = []

    def import_repl(m):
        spec, mod = m.group(1), m.group(2)
        spec = spec.strip()
        if spec.startswith("* as "):
            return f'const {spec[5:]} = require("{mod}");'
        inner = spec.strip("{} ")
        parts = []
        for p in inner.split(","):
            p = p.strip()
            if not p:
                continue
            parts.append(p.replace(" as ", ": "))
        return f'const {{ {", ".join(parts)} }} = require("{mod}");'

    src = re.sub(
        r'import\s+(.+?)\s+from\s+"([^"]+)";', import_repl, src
    )

    def export_repl(m):
        exported.append(m.group(2))
        return f"{m.group(1)} {m.group(2)}"

    src = re.sub(
        r"export\s+(async\s+function|function|const|let|class)\s+(\w+)",
        export_repl,
        src,
    )
    return src, exported


def build_js(ts_src: str) -> str:
    src = strip_interfaces(ts_src)
    # module conversion FIRST: `import { promises as fs }` would
    # otherwise be eaten by the `as`-cast stripper
    src, exported = convert_modules(src)
    src = strip_annotations(src)
    header = (
        '"use strict";\n'
        "// GENERATED by guard_tpu_torch/tools/ts_build.py from guard_tpu_torch/ts_lib/index.ts"
        " — do not edit.\n"
        'Object.defineProperty(exports, "__esModule", { value: true });\n'
    )
    footer = "\n" + "\n".join(
        f"exports.{name} = {name};" for name in exported
    ) + "\n"
    # collapse whitespace-only lines the stripping left behind
    body = re.sub(r"[ \t]+$", "", src, flags=re.M)
    body = re.sub(r"\n{3,}", "\n\n", body)
    return header + body.strip() + footer


def build_dts(ts_src: str) -> str:
    """Type declarations: interfaces verbatim + exported signatures."""
    out = [
        "// GENERATED by guard_tpu_torch/tools/ts_build.py from guard_tpu_torch/ts_lib/index.ts"
        " — do not edit.\n"
    ]
    i = 0
    src = ts_src
    while i < len(src):
        j = _skip_code(src, i)
        if j != i:
            i = j
            continue
        m = re.match(r"export\s+interface\s+\w+\s*", src[i:])
        if m:
            k = i + m.end()
            end = _match_balanced(src, k)
            out.append(src[i:end] + "\n")
            i = end
            continue
        m = re.match(r"export\s+(async\s+)?function\s+(\w+)\s*", src[i:])
        if m:
            k = i + m.end()
            pend = _match_balanced(src, k)
            sig = src[i + len("export "): pend]
            ret = ""
            m2 = re.match(r"\s*:", src[pend:])
            if m2:
                rend = _type_end(src, pend + m2.end(), "{")
                ret = ":" + src[pend + m2.end(): rend].rstrip()
            sig = re.sub(r"^async\s+", "", sig)
            out.append(f"export declare {sig.strip()}{ret};\n")
            i = pend
            continue
        m = re.match(r"export\s+const\s+(\w+)\s*=\s*", src[i:])
        if m:
            k = i + m.end()
            if src[k] == "{":
                end = _match_balanced(src, k)
                lit = src[k:end]
                fields = re.findall(r"(\w+)\s*:\s*(\d+)", lit)
                body = "; ".join(f"readonly {f}: {v}" for f, v in fields)
                out.append(
                    f"export declare const {m.group(1)}: {{ {body} }};\n"
                )
                i = end
                continue
        i += 1
    return "".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ts_src = TS_PATH.read_text()
    js = build_js(ts_src)
    dts = build_dts(ts_src)
    check = "--check" in argv
    ok = True
    for path, content in ((DIST / "index.js", js), (DIST / "index.d.ts", dts)):
        if check:
            if not path.exists() or path.read_text() != content:
                print(f"DRIFT: {path} differs from generated output")
                ok = False
        else:
            DIST.mkdir(exist_ok=True)
            path.write_text(content)
            print(f"wrote {path}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

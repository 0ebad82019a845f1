"""Key-case converters for map-key retries.

The case converters and `CONVERTERS` table of the JAX package's
core/scopes.py, which is all that lowering (ops/ir.py) needs from it.
"""

from __future__ import annotations

import re
from typing import Callable, List

# ---------------------------------------------------------------------------
# Key-case converters (eval_context.rs:315-326, via the cruet crate):
# when a map key is missing, the walk retries the key converted to
# camel / Class / kebab-case / PascalCase / snake_case / Title Case /
# Train-Case before reporting UnResolved.
# ---------------------------------------------------------------------------
_WORD_RE = re.compile(r"[A-Za-z0-9]+")


def _words(s: str) -> List[str]:
    out: List[str] = []
    for token in _WORD_RE.findall(s):
        # split camel humps: XMLHttpRequest -> XML, Http, Request
        for m in re.finditer(r"[A-Z]+(?![a-z])|[A-Z][a-z0-9]*|[a-z0-9]+", token):
            out.append(m.group(0))
    return out


def to_camel_case(s: str) -> str:
    w = [x.lower() for x in _words(s)]
    return w[0] + "".join(x.capitalize() for x in w[1:]) if w else s


def to_pascal_case(s: str) -> str:
    return "".join(x.capitalize() for x in _words(s))


def to_kebab_case(s: str) -> str:
    return "-".join(x.lower() for x in _words(s))


def to_snake_case(s: str) -> str:
    return "_".join(x.lower() for x in _words(s))


def to_title_case(s: str) -> str:
    return " ".join(x.capitalize() for x in _words(s))


def to_train_case(s: str) -> str:
    return "-".join(x.capitalize() for x in _words(s))


# order matches CONVERTERS (eval_context.rs:317-325): camel, class,
# kebab, pascal, snake, title, train
CONVERTERS: List[Callable[[str], str]] = [
    to_camel_case,
    to_pascal_case,  # cruet class-case == PascalCase for keys
    to_kebab_case,
    to_pascal_case,
    to_snake_case,
    to_title_case,
    to_train_case,
]

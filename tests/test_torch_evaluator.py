"""The port's CPU evaluator against the JAX package's.

For every `corpus/rules/*.guard` file over the inputs of its
`tests/*_tests.yaml`, and every `examples/rules/**/*.guard` over its
`tests/`, both packages parse the rules, build a `RootScope` per input
and run `eval_rules_file`. The doc status, the merged per-rule statuses
(`rule_statuses_from_root`) and the full report of the evaluation
(`simplified_report_from_root`) must be equal; where the JAX evaluator
raises a GuardError, the port must raise one with the same text.
"""

import pathlib

import pytest
import yaml

from guard_tpu.commands import report as j_report
from guard_tpu.core.errors import GuardError as JGuardError
from guard_tpu.core.evaluator import eval_rules_file as j_eval
from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.core.scopes import RootScope as JRootScope
from guard_tpu.core.values import from_plain as j_from_plain
from guard_tpu_torch.commands import report as t_report
from guard_tpu_torch.core.errors import GuardError as TGuardError
from guard_tpu_torch.core.evaluator import eval_rules_file as t_eval
from guard_tpu_torch.core.parser import parse_rules_file as t_parse
from guard_tpu_torch.core.scopes import RootScope as TRootScope
from guard_tpu_torch.core.values import from_plain as t_from_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = sorted((ROOT / "corpus" / "rules").glob("*.guard"))
EXAMPLES = sorted((ROOT / "examples" / "rules").rglob("*.guard"))


def inputs_of(rules_path: pathlib.Path) -> list:
    spec = rules_path.parent / "tests" / f"{rules_path.stem}_tests.yaml"
    if not spec.exists():
        return []
    return [
        c["input"] for c in (yaml.safe_load(spec.read_text()) or [])
        if isinstance(c, dict) and "input" in c
    ]


def run(parse, from_plain, root_scope, eval_rules_file, report, err_cls, text, name, doc):
    try:
        rf = parse(text, name)
        if rf is None:
            return ("empty",)
        scope = root_scope(rf, from_plain(doc))
        status = eval_rules_file(rf, scope, "doc.json")
    except err_cls as e:
        return ("error", type(e).__name__, str(e))
    root = scope.reset_recorder().extract()
    return (
        status.value,
        {n: s.value for n, s in report.rule_statuses_from_root(root).items()},
        report.simplified_report_from_root(root, "doc.json"),
    )


def _id(p: pathlib.Path) -> str:
    return str(p.relative_to(ROOT))


@pytest.mark.parametrize("path", CORPUS + EXAMPLES, ids=_id)
def test_eval_rules_file_matches_jax(path):
    text = path.read_text()
    docs = inputs_of(path)
    assert docs, f"{path} has no test inputs"
    for i, doc in enumerate(docs):
        want = run(j_parse, j_from_plain, JRootScope, j_eval, j_report, JGuardError,
                   text, path.name, doc)
        got = run(t_parse, t_from_plain, TRootScope, t_eval, t_report, TGuardError,
                  text, path.name, doc)
        assert got == want, f"input {i}: {doc}"


def test_the_inputs_cover_the_corpus_and_the_examples():
    assert len(CORPUS) == 249 and len(EXAMPLES) >= 9
    assert sum(len(inputs_of(p)) for p in CORPUS) == 725

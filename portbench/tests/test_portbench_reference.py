"""The frozen reference reproduces the expected outcome of every case of
the rule corpus's suites (corpus/rules/tests), rules file by rules
file, and sweep's fold over files; the control departs from it."""

import json
from pathlib import Path

import pytest
import yaml

from portbench.reference import sweep as ref
from portbench.reference.guard.evaluator import eval_rules_file
from portbench.reference.guard.loader import load_document
from portbench.reference.guard.scopes import RootScope
from portbench.tests.conftest import ROOT

CORPUS = ROOT / "corpus" / "rules"
RULES = ref.load_rules(CORPUS)


def suite(stem):
    spec = CORPUS / "tests" / f"{stem}_tests.yaml"
    return yaml.safe_load(spec.read_text()) or []


@pytest.mark.parametrize("chunk", range(8))
def test_every_corpus_case_gives_its_expected_statuses(chunk):
    checked = 0
    for name, rules in RULES[chunk::8]:
        for case in suite(Path(name).stem):
            pv = load_document(json.dumps(case["input"]), "case")
            scope = RootScope(rules, pv)
            eval_rules_file(rules, scope, "case")
            got = {k.rsplit("/", 1)[-1]: v.value for k, v in ref.rule_statuses(scope.reset_recorder().extract()).items()}
            for rule, want in case["expectations"]["rules"].items():
                assert got.get(rule) == want, (name, case["name"], rule)
            checked += 1
    assert checked >= 80


def test_the_fold_over_files_takes_the_later_file_and_the_worst_status(tmp_path):
    (tmp_path / "a.guard").write_text("rule r { a == 1 }\nrule s { b exists }\n")
    (tmp_path / "b.guard").write_text("rule r { a == 2 }\n")
    rules = ref.load_rules(tmp_path)
    assert [n for n, _ in rules] == ["a.guard", "b.guard"]
    assert ref.outcome(rules, "d", '{"a": 2, "b": 0}') == {"status": "pass", "fails": [], "raised": []}
    assert ref.outcome(rules, "d", '{"a": 1}') == {"status": "fail", "fails": ["r", "s"], "raised": []}


def test_the_control_cuts_documents_to_their_first_resources():
    doc = {"Resources": {f"R{j}": {"Type": "AWS::EC2::Volume", "Properties": {"Encrypted": j < 9, "Size": 8}}
                         for j in range(12)}}
    cut = json.loads(ref.truncated(json.dumps(doc), ref.CONTROL_CAP))
    assert list(cut["Resources"]) == [f"R{j}" for j in range(ref.CONTROL_CAP)]
    secpol = ref.load_rules(ROOT / "portbench" / "configs" / "secpol" / "rules")
    ref.init_worker(str(ROOT / "portbench" / "configs" / "secpol" / "rules"))
    whole = ref.outcome_of(("d", json.dumps(doc)))
    assert whole == ref.outcome(secpol, "d", json.dumps(doc))
    assert "volume_encrypted" in whole["fails"]
    assert "volume_encrypted" not in ref.control_outcome_of(("d", json.dumps(doc)))["fails"]

"""The port's library faces against the JAX package's, on the CPU:
`api.run_checks`, the four builders (`ValidateBuilder`, `TestBuilder`,
`ParseTreeBuilder`, `RulegenBuilder`), `lambda_handler` in both event
shapes, and the `parse-tree` and `rulegen` commands, byte for byte
(JSON and YAML parse trees over a sample of corpus/rules and every
examples/ rules file; rulegen over seeded CloudFormation templates in
JSON and YAML).

The port's `ValidateBuilder` defaults to the `tpu` backend (the JAX
package's to `cpu`) and takes `.device(d)`; its answers on
`device("cpu")` must equal the JAX package's `tpu` backend's."""

import json
from pathlib import Path

import numpy as np
import pytest
import yaml

import bench
from guard_tpu import api as jax_api
from guard_tpu.cli import run as jax_run
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch import api
from guard_tpu_torch.cli import run as port_run
from guard_tpu_torch.core.errors import GuardError
from guard_tpu_torch.utils.io import Reader, Writer
from test_torch_ingest import set_encoders

ROOT = Path(__file__).resolve().parent.parent
CORPUS = sorted((ROOT / "corpus" / "rules").glob("*.guard"))
EXAMPLES = sorted((ROOT / "examples" / "rules").glob("*/*.guard"))
RULE_SAMPLE = CORPUS[::25] + EXAMPLES


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE_DIR", str(tmp_path / "results"))
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_COALESCE", "GUARD_TPU_TENANT_RATE",
                 "GUARD_TPU_LEDGER_DIR"):
        monkeypatch.delenv(name, raising=False)
    set_encoders(monkeypatch, None, tmp_path)


def cli_both(argv, stdin=""):
    w = Writer.buffered()
    rc = port_run(argv, writer=w, reader=Reader.from_string(stdin))
    jw = JaxWriter.buffered()
    jrc = jax_run(argv, writer=jw, reader=JaxReader.from_string(stdin))
    got = (rc, w.out.getvalue(), w.err.getvalue())
    assert got == (jrc, jw.out.getvalue(), jw.err.getvalue())
    return got


# -- parse-tree and rulegen ------------------------------------------------

@pytest.mark.parametrize("path", RULE_SAMPLE, ids=lambda p: p.name)
@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_parse_tree_matches_jax(path, fmt):
    rc, out, _err = cli_both(["parse-tree", "-r", str(path), "-p" if fmt == "json" else "-y"])
    assert rc == 0 and out
    if fmt == "json":
        assert isinstance(json.loads(out), dict)


def test_parse_tree_stdin_error_and_output_file(tmp_path):
    rc, _out, err = cli_both(["parse-tree"], stdin="rule broken {{{")
    assert rc == 5 and err
    rc, out, _err = cli_both(["parse-tree", "-p"], stdin="rule ok { a exists }")
    assert rc == 0 and json.loads(out)
    rc, _out, err = cli_both(["parse-tree", "-r", str(tmp_path / "missing.guard")])
    assert rc == 5 and "missing.guard" in err


def cfn_template(seed: int) -> dict:
    return bench.make_template(np.random.default_rng(seed), seed)


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
@pytest.mark.parametrize("ext", ["json", "yaml"])
def test_rulegen_matches_jax(tmp_path, seed, ext):
    doc = cfn_template(seed)
    path = tmp_path / f"template.{ext}"
    path.write_text(json.dumps(doc) if ext == "json" else yaml.safe_dump(doc))
    rc, out, _err = cli_both(["rulegen", "-t", str(path)])
    assert rc == 0 and "rule " in out


def test_rulegen_output_flag_and_missing_template(tmp_path):
    """`-o` is accepted and, as in the JAX package, the rules still go to
    stdout; a missing template exits 5."""
    src = tmp_path / "t.json"
    src.write_text(json.dumps(cfn_template(3)))
    rc, out, _err = cli_both(["rulegen", "-t", str(src), "-o", str(tmp_path / "out.guard")])
    assert rc == 0 and "rule " in out
    rc, _out, _err = cli_both(["rulegen", "-t", str(tmp_path / "absent.yaml")])
    assert rc == 5


# -- run_checks ---------------------------------------------------------------

@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("path", EXAMPLES[:4], ids=lambda p: p.name)
def test_run_checks_matches_jax(path, verbose):
    rules = path.read_text()
    spec = path.parent / "tests"
    inputs = []
    for f in sorted(spec.glob("*")):
        cases = yaml.safe_load(f.read_text()) or []
        inputs += [c["input"] for c in cases if isinstance(c, dict) and "input" in c]
    assert inputs
    for doc in inputs[:3]:
        data = json.dumps(doc)
        got = api.run_checks(data, rules, verbose, "data.json", path.name)
        assert got == jax_api.run_checks(data, rules, verbose, "data.json", path.name)
        assert json.loads(got)


def test_run_checks_errors_match_jax():
    from guard_tpu.core.errors import ParseError as JaxParseError
    from guard_tpu_torch.core.errors import ParseError

    with pytest.raises(ParseError) as port_e:
        api.run_checks('{"a": ', "rule ok { a exists }", False, "bad.json")
    with pytest.raises(JaxParseError) as jax_e:
        jax_api.run_checks('{"a": ', "rule ok { a exists }", False, "bad.json")
    assert str(port_e.value) == str(jax_e.value)
    assert api.run_checks('{"a": 1}', "") == jax_api.run_checks('{"a": 1}', "")


# -- the builders -------------------------------------------------------------

def test_validate_builder_defaults_to_the_device_path(tmp_path):
    rules = tmp_path / "r.guard"
    rules.write_text("rule ok { a exists }\nrule small { a < 3 }")
    data = tmp_path / "d"
    data.mkdir()
    (data / "one.json").write_text('{"a": 1}')
    (data / "two.json").write_text('{"a": 9}')
    b = api.ValidateBuilder().rules([str(rules)]).data([str(data)]).device("cpu")
    assert b.try_build().backend == "tpu" and b.try_build().device == "cpu"
    got = b.try_build_and_execute()
    want = (jax_api.ValidateBuilder().rules([str(rules)]).data([str(data)])
            .backend("tpu").try_build_and_execute())
    assert got == want and got[0] == 19
    for fmt in ("json", "sarif"):
        got = (api.ValidateBuilder().rules([str(rules)]).data([str(data)]).structured()
               .output_format(fmt).show_summary(["none"]).device("cpu")
               .try_build_and_execute())
        want = (jax_api.ValidateBuilder().rules([str(rules)]).data([str(data)]).structured()
                .output_format(fmt).show_summary(["none"]).backend("tpu")
                .try_build_and_execute())
        assert got == want


def test_validate_builder_payload_and_conflicts():
    payload = json.dumps({"rules": ["rule ok { a exists }"], "data": ['{"b": 1}']})
    got = (api.ValidateBuilder().payload().structured().output_format("json")
           .show_summary(["none"]).device("cpu").try_build_and_execute(payload))
    want = (jax_api.ValidateBuilder().payload().structured().output_format("json")
            .show_summary(["none"]).backend("tpu").try_build_and_execute(payload))
    assert got == want and got[0] == 19
    with pytest.raises(GuardError):
        api.ValidateBuilder().alphabetical().last_modified()
    with pytest.raises(GuardError):
        api.ValidateBuilder().rules(["x"]).payload()


def test_validate_builder_without_a_card_does_not_fall_back(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rules = tmp_path / "r.guard"
    rules.write_text("rule ok { a exists }")
    doc = tmp_path / "d.json"
    doc.write_text('{"a": 1}')
    with pytest.raises(RuntimeError, match="CUDA"):
        api.ValidateBuilder().rules([str(rules)]).data([str(doc)]).try_build_and_execute()


def test_test_builder_matches_jax():
    d = str(ROOT / "examples" / "rules" / "tagging")
    got = api.TestBuilder().directory(d).device("cpu").try_build_and_execute()
    want = jax_api.TestBuilder().directory(d).try_build_and_execute()
    assert got == want
    built = api.TestBuilder().directory(d).device("cpu").try_build()
    assert built.device == "cpu" and built.backend == "tpu"
    with pytest.raises(GuardError):
        api.TestBuilder().directory(d).rules_file("x.guard").try_build()


def test_parse_tree_and_rulegen_builders_match_jax(tmp_path):
    path = str(EXAMPLES[0])
    got = api.ParseTreeBuilder().rules(path).print_json().try_build_and_execute()
    assert got == jax_api.ParseTreeBuilder().rules(path).print_json().try_build_and_execute()
    got = api.ParseTreeBuilder().rules(path).print_yaml().try_build_and_execute()
    assert got == jax_api.ParseTreeBuilder().rules(path).print_yaml().try_build_and_execute()
    src = tmp_path / "t.json"
    src.write_text(json.dumps(cfn_template(5)))
    got = api.RulegenBuilder().template(str(src)).try_build_and_execute()
    assert got == jax_api.RulegenBuilder().template(str(src)).try_build_and_execute()
    assert got[0] == 0
    with pytest.raises(GuardError):
        api.RulegenBuilder().try_build()


# -- lambda_handler -------------------------------------------------------------

RULES = "rule has_a { a exists }"


def test_lambda_legacy_shape_matches_jax(monkeypatch):
    from guard_tpu import lambda_handler as jax_lambda
    from guard_tpu_torch import lambda_handler

    for ev in ({"data": '{"a": 1}', "rules": [RULES, "rule b { b exists }"]},
               {"data": '{"b": 1}', "rules": [RULES], "verbose": True}):
        assert lambda_handler.handler(ev) == jax_lambda.handler(ev)
    with pytest.raises(ValueError):
        lambda_handler.handler({"data": '{"a": 1}', "rules": ["rule broken {{{"]})


@pytest.mark.parametrize("fmt", ["sarif", "json"])
def test_lambda_documents_shape_on_the_device_path(monkeypatch, fmt):
    """The "documents" shape routes through the module's one Serve
    session (here on device cpu) with the tpu default, and answers what
    the JAX package's tpu backend answers."""
    from guard_tpu import lambda_handler as jax_lambda
    from guard_tpu_torch import lambda_handler
    from guard_tpu_torch.commands.serve import Serve

    monkeypatch.setattr(lambda_handler, "_SESSION", Serve(stdio=False, device="cpu"))
    monkeypatch.setattr(jax_lambda, "_SESSION", None)
    ev = {"documents": [{"a": 1}, '{"b": 2}', "a: 3\n"], "rules": [RULES],
          "output_format": fmt}
    got = lambda_handler.handler(ev)
    assert got["code"] == 19
    assert got == jax_lambda.handler({**ev, "backend": "tpu"})
    assert lambda_handler._session() is lambda_handler._SESSION
    monkeypatch.setattr(jax_lambda, "_SESSION", None)


def test_lambda_documents_shape_without_a_card(monkeypatch):
    import torch

    from guard_tpu_torch import lambda_handler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(lambda_handler, "_SESSION", None)
    got = lambda_handler.handler({"documents": [{"a": 1}], "rules": [RULES]})
    assert got["code"] == 5 and "CUDA" in got["error"]
    cpu = lambda_handler.handler({"documents": [{"a": 1}], "rules": [RULES],
                                  "backend": "cpu"})
    assert cpu["code"] == 0
    monkeypatch.setattr(lambda_handler, "_SESSION", None)

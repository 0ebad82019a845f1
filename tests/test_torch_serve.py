"""`serve --stdio` of the port (guard_tpu_torch/commands/serve.py)
against the JAX package's, on the CPU.

Both CLIs answer the same newline-delimited JSON request lines in this
process: the port with `--device cpu` (the plain versions of the
kernels), the JAX package on its CPU devices, each request naming its
backend. The session's stdout (one JSON envelope per request: code,
output, error), its stderr and its exit code must be equal. Beyond
parity: the prepared-rules cache, the port's request default (`tpu`,
where the JAX package's is `auto`), and the no-card envelope: with no
card and no `--device` a `tpu` request answers code 5 and the session
keeps serving; nothing falls back to the CPU.
"""

import json

import pytest

from guard_tpu.cli import run as jax_run
from guard_tpu.utils.io import Reader as JaxReader
from guard_tpu.utils.io import Writer as JaxWriter
from guard_tpu_torch.cli import run as port_run
from guard_tpu_torch.utils.io import Reader, Writer
from test_torch_ingest import set_encoders

NO_CARD = "guard_tpu_torch runs on a CUDA device and none is available"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Both packages with their native oracles and encoders off, their
    own plan directories, no result cache, no ingest pool and no serve
    knob from the environment."""
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_COALESCE", "GUARD_TPU_COALESCE_WAIT_MS",
                 "GUARD_TPU_COALESCE_MAX_BATCH", "GUARD_TPU_SERVE_TIMEOUT",
                 "GUARD_TPU_SERVE_SLO_MS", "GUARD_TPU_SERVE_SHED", "GUARD_TPU_SERVE_MAX_BODY",
                 "GUARD_TPU_TENANT_RATE", "GUARD_TPU_TENANT_BURST",
                 "GUARD_TPU_TENANT_MAX_INFLIGHT", "GUARD_TPU_TENANT_DEFAULT",
                 "GUARD_TPU_LEDGER_DIR", "GUARD_TPU_PACK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    set_encoders(monkeypatch, None, tmp_path)


def req(rules, data, backend="tpu", **extra) -> str:
    body = {"rules": rules, "data": data, **extra}
    if backend is not None:
        body["backend"] = backend
    return json.dumps(body)


def port_serve(lines, *flags, device="cpu", stdin=None):
    """The port's `serve --stdio` over `lines`: (rc, stdout, stderr)."""
    w = Writer.buffered()
    argv = ["serve", "--stdio", *flags] + (["--device", device] if device else [])
    text = stdin if stdin is not None else "\n".join(lines) + "\n"
    rc = port_run(argv, writer=w, reader=Reader.from_string(text))
    return rc, w.out.getvalue(), w.err.getvalue()


def jax_serve(lines, *flags, stdin=None):
    w = JaxWriter.buffered()
    text = stdin if stdin is not None else "\n".join(lines) + "\n"
    rc = jax_run(["serve", "--stdio", *flags], writer=w, reader=JaxReader.from_string(text))
    return rc, w.out.getvalue(), w.err.getvalue()


def both(lines, *flags, stdin=None):
    """Both sessions over the same lines; returns the port's parsed
    envelopes after checking stdout, stderr and rc are equal."""
    got = port_serve(lines, *flags, stdin=stdin)
    want = jax_serve(lines, *flags, stdin=stdin)
    assert got == want
    return got[0], [json.loads(line) for line in got[1].splitlines() if line.strip()]


@pytest.mark.parametrize("backend", ["tpu", "cpu", "auto"])
def test_serve_pass_fail_and_error_codes(backend):
    rc, resps = both([
        req(["rule ok { a exists }"], ['{"a": 1}'], backend),
        req(["rule ok { a exists }"], ['{"b": 1}'], backend),
        req(["rule broken {{{"], ['{"a": 1}'], backend),
    ])
    assert rc == 0
    # on the device path a payload whose only rules file does not parse
    # has no rules file left and returns 0 before any report, in both
    # packages; the host backends count the parse error
    assert [r["code"] for r in resps] == [0, 19, 0 if backend == "tpu" else 5]
    assert json.loads(resps[0]["output"])["version"] == "2.1.0"
    fail = json.loads(resps[1]["output"])
    assert any("ok" in (res.get("ruleId") or "").lower()
               for run_ in fail["runs"] for res in run_["results"])
    assert "Parse Error on ruleset file RULES_STDIN[1]" in resps[2]["error"]


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_serve_malformed_request_keeps_session_alive(backend):
    rc, resps = both([
        "this is not json",
        "[1, 2]",
        req(["rule ok { a exists }"], ['{"a": 1}'], backend),
        req(["rule ok { a exists }"], ['{"a": '], backend),  # a document that does not parse
        req(["rule ok { a exists }"], ['{"a": 1}'], "gpu"),  # no such backend
        req(["rule ok { a exists }"], ['{"a": 2}'], backend),
    ])
    assert rc == 0
    assert [r["code"] for r in resps] == [5, 5, 0, 5, 5, 0]
    assert resps[0]["error"] and resps[1]["error_class"] == "ValueError"
    assert resps[3]["error_class"] == "ParseError"
    assert resps[4]["error_class"] == "GuardError"


@pytest.mark.parametrize("fmt", ["sarif", "json", "yaml", "junit"])
def test_serve_output_formats(fmt):
    rules = ["rule ok { a exists }\nrule small { a < 3 }", "rule other { b !exists }"]
    data = ['{"a": 1}', '{"a": 5}', "a: 2\nb: 1\n"]
    rc, resps = both([req(rules, data, "tpu", output_format=fmt),
                      req(rules, data, "cpu", output_format=fmt)])
    assert rc == 0
    assert [r["code"] for r in resps] == [19, 19]
    assert resps[0]["output"] == resps[1]["output"]
    if fmt == "json":
        reports = json.loads(resps[0]["output"])
        assert {r["status"] for r in reports} == {"PASS", "FAIL"}


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_serve_verbose_and_empty_requests(backend):
    rc, resps = both([
        req(["rule ok { a exists }"], ['{"b": 1}'], backend, verbose=True),
        req(["rule ok { a exists }"], [], backend),  # no document: no report pass
        req([], ['{"a": 1}'], backend),  # no rules file
        req(["rule ok { a exists }", "let x = 1"], ['{"a": 1}'], backend, output_format="json"),
    ])
    assert rc == 0
    assert [r["code"] for r in resps] == [19, 0, 0, 0]


def test_serve_empty_line_ends_session():
    rc, resps = both([], stdin="\n" + req(["rule ok { a exists }"], ['{"a": 1}']) + "\n")
    assert rc == 0 and resps == []


def test_serve_requires_a_transport():
    w = Writer.buffered()
    rc = port_run(["serve", "--device", "cpu"], writer=w, reader=Reader.from_string(""))
    jw = JaxWriter.buffered()
    jrc = jax_run(["serve"], writer=jw, reader=JaxReader.from_string(""))
    assert (rc, w.out.getvalue(), w.err.getvalue()) == (jrc, jw.out.getvalue(),
                                                        jw.err.getvalue())
    assert rc == 5 and "requires a transport" in w.err.getvalue()


def test_serve_reuses_prepared_rules_across_requests(monkeypatch):
    """The second request with the same rules is served from the parsed
    RuleFile cache (no re-parse), with the same bytes; a rules payload
    that fails to parse always takes the uncached path."""
    import guard_tpu_torch.commands.serve as serve_mod
    from guard_tpu_torch.commands.serve import Serve

    calls = [0]
    real_parse = serve_mod.parse_rules_file

    def counting_parse(content, name):
        calls[0] += 1
        return real_parse(content, name)

    monkeypatch.setattr(serve_mod, "parse_rules_file", counting_parse)
    rules = ["rule ok { a exists }", "rule sized { a <= 3 }"]
    lines = [req(rules, ['{"a": 1}']), req(rules, ['{"a": 9}']), req(rules, ['{"a": 1}']),
             req(["rule broken {{{"], ['{"a": 1}'], "cpu"),
             req(["rule broken {{{"], ['{"a": 1}'], "cpu")]
    srv = Serve(stdio=True, device="cpu")
    w = Writer.buffered()
    assert srv.execute(w, Reader.from_string("\n".join(lines) + "\n")) == 0
    resps = [json.loads(line) for line in w.out.getvalue().splitlines() if line.strip()]
    assert [r["code"] for r in resps] == [0, 19, 0, 5, 5]
    assert srv.cache_hits == 2
    assert calls[0] == 4  # 2 (first request) + 1 + 1 (broken, uncached)
    assert resps[0]["output"] == resps[2]["output"]
    assert resps[3] == resps[4]
    assert w.out.getvalue() == jax_serve(lines)[1]


def test_serve_request_default_backend_is_tpu(monkeypatch):
    """A request without "backend" runs on the device path: on a CPU
    session it answers what an explicit tpu request answers, and with no
    card it answers the no-card envelope (an `auto` default would have
    answered from the host)."""
    import torch

    from guard_tpu_torch.commands.serve import Serve

    bare = req(["rule ok { a exists }"], ['{"b": 1}'], backend=None)
    explicit = req(["rule ok { a exists }"], ['{"b": 1}'], "tpu")
    srv = Serve(stdio=False, device="cpu")
    assert srv.handle_line(bare) == srv.handle_line(explicit)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    resp = Serve(stdio=False).handle_line(bare)
    assert resp["code"] == 5 and resp["error"].startswith(NO_CARD)


@pytest.mark.parametrize("coalesce", [True, False])
def test_serve_without_a_card_answers_code_5_and_keeps_serving(monkeypatch, coalesce):
    """No card and no --device: every tpu request, alone or coalesced,
    answers the structured code-5 envelope with the no-card message,
    and host-backend requests of the same session still answer as the
    JAX package's."""
    import torch

    from guard_tpu_torch.commands.serve import Serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GUARD_TPU_COALESCE_WAIT_MS", "150")
    tpu_lines = [req(["rule ok { a exists }"], [f'{{"a": {i}}}'], "tpu", id=i)
                 for i in range(4)]
    cpu_line = req(["rule ok { a exists }"], ['{"b": 1}'], "cpu")
    srv = Serve(stdio=True, coalesce=coalesce)
    w = Writer.buffered()
    text = "\n".join([tpu_lines[0].replace(', "id": 0', ""), *tpu_lines, cpu_line]) + "\n"
    assert srv.execute(w, Reader.from_string(text)) == 0
    resps = [json.loads(line) for line in w.out.getvalue().splitlines()]
    assert len(resps) == 6
    no_card = [r for r in resps if r["code"] == 5]
    assert len(no_card) == 5
    for r in no_card:
        assert r["error"].startswith(NO_CARD) and r["error_class"] == "RuntimeError"
        assert r["output"] == ""
    assert sorted(r["id"] for r in resps if "id" in r) == [0, 1, 2, 3]
    host = [r for r in resps if r["code"] != 5]
    assert json.dumps(host[0]) == jax_serve([cpu_line])[1].strip()
    # the CLI without --device says the same and exits 0
    rc, out, _err = port_serve([tpu_lines[1]], device=None)
    assert rc == 0 and json.loads(out)["error"].startswith(NO_CARD)

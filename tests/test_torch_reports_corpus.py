"""Full validate reports of the port against the JAX package's over
every rules file of corpus/rules, each over the inputs of its own
tests file: the single-line report with `-S all` and the structured
JSON report, same rc, stdout and stderr, with the native oracle not
built and built on both sides (test_torch_reports.py sets the state).
"""

import json
import pathlib

import pytest
import yaml

from test_torch_reports import (  # noqa: F401  (fixtures)
    _computed_not_replayed,
    assert_same,
    native_lib_dir,
    native_state,
    set_native,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus" / "rules"
STEMS = sorted(p.stem for p in CORPUS.glob("*.guard"))
MODES = (["-S", "all"], ["-z", "-o", "json", "-S", "none"])
# a fixed sample, every tenth stem, for the count of the native
# oracle's reports
NATIVE_SAMPLE = STEMS[::10]


def corpus_data(stem: str, root: pathlib.Path) -> pathlib.Path:
    spec = CORPUS / "tests" / f"{stem}_tests.yaml"
    docs = [c["input"] for c in yaml.safe_load(spec.read_text()) or []
            if isinstance(c, dict) and "input" in c]
    data = root / "data"
    data.mkdir()
    for i, doc in enumerate(docs):
        (data / f"case{i:02d}.json").write_text(json.dumps(doc))
    return data


def test_every_stem_is_here():
    assert len(STEMS) == 249 and len(NATIVE_SAMPLE) == 25


@pytest.mark.parametrize("stem", STEMS)
def test_corpus_reports_match_jax(native_state, tmp_path, stem):
    data = corpus_data(stem, tmp_path)
    for mode in MODES:
        (rc, _out, err), _ev = assert_same(
            ["-r", str(CORPUS / f"{stem}.guard"), "-d", str(data), *mode]
        )
        assert rc in (0, 19, 5)
        assert (rc == 5) == bool(err)


def test_native_oracle_builds_reports_on_the_corpus(monkeypatch, native_lib_dir, tmp_path):
    """Over the fixed sample, with the library built, the port's native
    oracle builds failing documents' reports."""
    set_native(monkeypatch, native_lib_dir)
    native_reports = fails = 0
    for stem in NATIVE_SAMPLE:
        root = tmp_path / stem
        root.mkdir()
        data = corpus_data(stem, root)
        (rc, _out, _err), ev = assert_same(
            ["-r", str(CORPUS / f"{stem}.guard"), "-d", str(data), "-S", "all"]
        )
        if ev is not None:
            native_reports += ev.reruns["native_reports"]
            fails += sum(int(fr.rim[3][:, 0].sum()) for fr in ev.files)
    assert fails > 0 and native_reports > 0

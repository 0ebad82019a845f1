"""The document generators repeat exactly for a seed, differ across
seeds, and give every seed the same sizes."""

import json
from collections import Counter

import numpy as np
import pytest

from portbench.harness import spec as spec_mod
from portbench.tests.conftest import ROOT

PKG = ROOT / "portbench"
CONFIGS = {p.stem: json.loads(p.read_text()) for p in sorted((PKG / "configs").glob("*.json"))}


def docs(name, seed, k=0, n=2048):
    config = CONFIGS[name]
    gen = spec_mod.module(PKG, "traffic", config["generator"])
    return gen.documents(config, np.random.default_rng([seed, k]), k * n, n)


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_a_seed_repeats_exactly_and_another_differs(cell):
    a = docs(cell, 2**31 + 5)
    assert a == docs(cell, 2**31 + 5)
    b = docs(cell, 2**31 + 6)
    assert len(a) == len(b) == 2048
    assert sum(x != y for x, y in zip(a, b)) > 1900


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_documents_of_a_pool_are_distinct_json(cell):
    texts = docs(cell, 7, 0) + docs(cell, 7, 1)
    assert len(set(texts)) == len(texts)
    assert all(isinstance(json.loads(t)["Resources"], dict) for t in texts)


def resource_counts(texts):
    return Counter(len(json.loads(t)["Resources"]) for t in texts)


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_every_seed_sweeps_the_same_sizes_in_another_order(cell):
    a, b = docs(cell, 1, n=4096), docs(cell, 2, n=4096)
    big = lambda texts: sorted(n for n, c in resource_counts(texts).items() for _ in range(c) if n >= 100)
    assert big(a) == big(b) == [100, 233, 366, 500]
    assert [len(json.loads(t)["Resources"]) for t in a] != [len(json.loads(t)["Resources"]) for t in b]


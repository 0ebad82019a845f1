"""The control, the reference in the program's place with each document
cut to its first resources, comes out not correct on three seeds at the
cell's own size (portbench/prove.py gives the same readings on the
card's machine)."""

import numpy as np
import pytest

from portbench.harness import check
from portbench.tests.conftest import load_cell


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_the_control_fails_the_check(seed):
    spec = load_cell()
    n = int(spec.cell["docs_per_invocation"])
    texts = spec.generator().documents(spec.config, np.random.default_rng([seed, 0]), 0, n)
    items = [(f"doc{j:06d}.json", t) for j, t in enumerate(texts)]
    docs = [name for name, _ in items]
    want = check.unit_answers(docs, check.reference_outcomes(spec.rules_dir(), items))
    got = check.unit_answers(docs, check.reference_outcomes(spec.rules_dir(), items,
                                                            control=True))
    numbers = check.compare([got], [want])
    assert numbers["doc_mismatches"] > 0
    assert check.compare([want], [want]) == {"doc_mismatches": 0, "count_mismatches": 0,
                                             "error_mismatches": 0}

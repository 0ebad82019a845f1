"""`core/traversal.py` in the port against the JAX package's, on the
CPU: over every input of the corpus's rule tests (corpus/rules/tests),
the port's Traversal indexes the same paths with the same parents and
node values, and resolves the same absolute and relative (`N#`,
`N/suffix`) paths to the same nodes."""

import pathlib

import pytest
import yaml

from guard_tpu.core.traversal import Traversal as JaxTraversal
from guard_tpu.core.values import from_plain as jax_from_plain
from guard_tpu_torch.core.traversal import Traversal
from guard_tpu_torch.core.values import from_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPECS = sorted((ROOT / "corpus" / "rules" / "tests").glob("*_tests.yaml"))


def inputs(spec):
    return [c["input"] for c in yaml.safe_load(spec.read_text()) or []
            if isinstance(c, dict) and "input" in c]


def view(traversal):
    return {
        path: (node.parent, node.value.self_path().s, node.value.kind)
        for path, node in traversal.nodes.items()
    }


def queries(traversal):
    """Absolute paths, the root, and relative climbs of one to three
    levels from every node, with a '#' and a '/'-suffix form each."""
    out = [("", None), ("/nowhere", None)]
    for path in traversal.nodes:
        out.append((path, None))
        for levels in (1, 2, 3):
            out.append((f"{levels}#", path))
            out.append((f"{levels}", path))
            out.append((f"{levels}/Type", path))
            out.append((f"{levels}/0", path))
            out.append((f"{levels}x", path))
    return out


def resolve(traversal, query, at):
    node = traversal.at(query, traversal.nodes[at] if at is not None else None)
    return None if node is None else node.value.self_path().s


def test_every_spec_is_here():
    assert len(SPECS) == 249


@pytest.mark.parametrize("spec", SPECS[::6], ids=lambda p: p.stem)
def test_same_index_and_lookups_as_jax(spec):
    docs = inputs(spec)
    assert docs
    for doc in docs:
        want = JaxTraversal(jax_from_plain(doc))
        got = Traversal(from_plain(doc))
        assert view(got) == view(want)
        root = got.root()
        assert root is not None and root.parent is None
        assert root.value.self_path().s == want.root().value.self_path().s
        for query, at in queries(want):
            assert resolve(got, query, at) == resolve(want, query, at), (query, at)


def test_all_specs_index_alike():
    n = 0
    for spec in SPECS:
        for doc in inputs(spec):
            assert view(Traversal(from_plain(doc))) == view(JaxTraversal(jax_from_plain(doc)))
            n += 1
    assert n == 725

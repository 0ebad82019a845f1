"""A second witness for the plain reference on the secpol cell.

The reference (portbench/reference) is a frozen copy of the port's
tree-walking evaluator and parser, so a fault that the copy shared with
the port would pass `correct`. Here the cell's four rules are written
out by hand in plain Python, with no parser and no evaluator, and held
against the reference on every document of a directory of the cell's
own size, on two seeds."""

import json
import re

import numpy as np
import pytest

from portbench.harness import check
from portbench.tests.conftest import load_cell

NAME = re.compile(r"^[a-z0-9.-]{3,63}$")


def by_hand(doc: dict) -> dict:
    """What sweep must answer for one document of the secpol cell: each
    rule's clauses hold for every value their query selects, `or` takes
    either clause whole, a rule whose `when` selects nothing skips."""
    resources = list(doc.get("Resources", {}).values())
    buckets = [r.get("Properties", {}) for r in resources if r.get("Type") == "AWS::S3::Bucket"]
    volumes = [r.get("Properties", {}) for r in resources if r.get("Type") == "AWS::EC2::Volume"]
    status = {}
    if buckets:
        algos = [c["ServerSideEncryptionByDefault"]["SSEAlgorithm"]
                 for b in buckets for c in b["BucketEncryption"]["ServerSideEncryptionConfiguration"]]
        status["s3_bucket_sse"] = all(a in ("aws:kms", "AES256") for a in algos)
        names = [b.get("BucketName") for b in buckets]
        status["s3_bucket_name"] = (all(isinstance(n, str) and NAME.match(n) for n in names)
                                    or all(n is None for n in names))
        status["no_public_buckets"] = (
            all(b["PublicAccessBlockConfiguration"]["BlockPublicAcls"] is True for b in buckets)
            or all(b["AccessControl"] != "PublicRead" for b in buckets))
    if volumes:
        status["volume_encrypted"] = all(
            v["Encrypted"] is True and 1 <= v["Size"] <= 16384 for v in volumes)
    fails = sorted(r for r, ok in status.items() if not ok)
    verdict = "fail" if fails else ("pass" if status else "skip")
    return {"status": verdict, "fails": fails, "raised": []}


@pytest.mark.parametrize("seed", [2**31 + 11, 2**32 + 17])
def test_the_reference_agrees_with_the_rules_written_by_hand(seed):
    spec = load_cell()
    n = int(spec.cell["docs_per_invocation"])
    texts = spec.generator().documents(spec.config, np.random.default_rng([seed, 0]), 0, n)
    items = [(f"doc{j:06d}.json", t) for j, t in enumerate(texts)]
    got = check.reference_outcomes(spec.rules_dir(), items)
    want = [by_hand(json.loads(t)) for t in texts]
    assert [i for i, (g, w) in enumerate(zip(got, want)) if g != w] == []
    # every rule passes and fails somewhere, and the large templates are in
    assert {s["status"] for s in want} == {"pass", "fail"}
    assert {r for s in want for r in s["fails"]} == {"s3_bucket_sse", "volume_encrypted",
                                                     "no_public_buckets"}
    assert max(len(json.loads(t)["Resources"]) for t in texts) == 500

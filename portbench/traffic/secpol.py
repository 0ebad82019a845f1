"""Documents of the `secpol` configuration.

`make_template` is a frozen copy of bench.py's seeded CloudFormation
template generator (1-3 S3 buckets, 0-2 EC2 volumes). In each block of
`large_every` documents (a sweep's chunk) one document is a large
template instead, of 100 to 500 resources at even steps (two buckets to
one volume, drawn as make_template draws them): the heavy tail up to
CloudFormation's 500-resource limit, which fills a larger node bucket.
Every seed draws the same sizes, one to a block; the seed picks which
block gets which size and where in its block it lies, so that every
seed asks the same work of a sweep, in another order.
"""

from __future__ import annotations

import json


def _bucket(rng, name: str) -> dict:
    return {
        "Type": "AWS::S3::Bucket",
        "Properties": {
            "BucketName": name,
            "AccessControl": str(rng.choice(["Private", "PublicRead"])),
            "PublicAccessBlockConfiguration": {
                "BlockPublicAcls": bool(rng.random() < 0.8)
            },
            "BucketEncryption": {
                "ServerSideEncryptionConfiguration": [
                    {
                        "ServerSideEncryptionByDefault": {
                            "SSEAlgorithm": str(
                                rng.choice(["aws:kms", "AES256", "none"])
                            )
                        }
                    }
                ]
            },
        },
    }


def _volume(rng) -> dict:
    return {
        "Type": "AWS::EC2::Volume",
        "Properties": {
            "Encrypted": bool(rng.random() < 0.7),
            "Size": int(rng.integers(1, 20000)),
        },
    }


def make_template(rng, i: int) -> dict:
    resources = {}
    for b in range(int(rng.integers(1, 4))):
        resources[f"bucket{b}"] = _bucket(rng, f"prod-logs-{i}-{b}")
    for v in range(int(rng.integers(0, 3))):
        resources[f"vol{v}"] = _volume(rng)
    return {"Resources": resources}


def large_template(rng, i: int, n_resources: int) -> dict:
    resources = {}
    for r in range(n_resources):
        if r % 3 == 2:
            resources[f"vol{r}"] = _volume(rng)
        else:
            resources[f"bucket{r}"] = _bucket(rng, f"prod-logs-{i}-{r}")
    return {"Resources": resources}


def documents(config: dict, rng, first: int, n: int) -> list:
    """n JSON texts, numbered from `first` within the pool."""
    every = config["large_every"]
    n_large = n // every
    lo, hi = config["large_resources"]
    sizes = [lo + (hi - lo) * k // max(1, n_large - 1) for k in range(n_large)]
    order = rng.permutation(n_large)
    at = rng.integers(0, every, size=n_large)
    large = {b * every + int(at[b]): sizes[int(order[b])] for b in range(n_large)}
    out = []
    for k in range(n):
        i = first + k
        doc = large_template(rng, i, large[k]) if k in large else make_template(rng, i)
        out.append(json.dumps(doc))
    return out

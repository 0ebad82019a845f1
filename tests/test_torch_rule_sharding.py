"""Rule-axis parallelism in the port (guard_tpu_torch/parallel/rules.py)
against the JAX package's (guard_tpu/parallel/rules.py), on the CPU.

The same rules give the same dependency-closed groups
(`partition_rules`, union-find over named-rule references) and the same
file groups (`partition_packs`); `RuleShardedEvaluator` and
`PackShardedEvaluator` over `[cpu] * k` give the statuses, unsure bits
and rim blocks of one device in the original rule order, and the
statuses of the JAX package's evaluators on its 8-device CPU mesh. The
group count is clamped to min(rule_shards, rules or files, devices).
No tolerance anywhere.
"""

import pathlib

import numpy as np
import pytest
import torch

from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.core.values import from_plain as j_from_plain
from guard_tpu.ops.encoder import encode_batch as j_encode
from guard_tpu.ops.ir import compile_rules_file as j_compile
from guard_tpu.ops.kernels import BatchEvaluator as JaxBatchEvaluator
from guard_tpu.parallel import rules as jax_rules
from guard_tpu_torch.core.parser import parse_rules_file
from guard_tpu_torch.core.values import from_plain
from guard_tpu_torch.ops.encoder import (
    NODE_BUCKETS_EXTENDED,
    encode_batch,
    split_batch_by_size,
)
from guard_tpu_torch.ops.ir import build_rim_spec, compile_rules_file, pack_compatible
from guard_tpu_torch.parallel import mesh
from guard_tpu_torch.parallel import rules as port_rules
from guard_tpu_torch.parallel.device import DeviceBatchEvaluator, evaluate_groups
from test_rule_sharding import RULES
from test_rule_sharding import _docs as jax_docs

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CORPUS = sorted((ROOT / "corpus" / "rules").glob("*.guard"))[:24]


def plain_docs(n=12):
    return [
        {"Resources": {"b": {"Type": "AWS::S3::Bucket", "Properties": {
            "Enc": i % 2 == 0, "Name": "logs" if i % 3 else "BAD!",
            "Size": (i * 17) % 150, **({"Tag": "x"} if i % 4 else {})}}}}
        for i in range(n)
    ]


def port_compiled(n=12):
    batch, interner = encode_batch([from_plain(d) for d in plain_docs(n)])
    return compile_rules_file(parse_rules_file(RULES, "t.guard"), interner), batch


def jax_compiled(n=12):
    batch, interner = j_encode(jax_docs(n))
    return j_compile(j_parse(RULES, "t.guard"), interner), batch


def registry(n_docs=40):
    """The first 24 corpus files lowered against one encode of their
    test inputs, both packages: (port files, port batch, JAX files, JAX
    batch), packable files only."""
    import yaml

    docs = []
    for p in CORPUS:
        spec = p.parent / "tests" / f"{p.stem}_tests.yaml"
        docs += [c["input"] for c in yaml.safe_load(spec.read_text()) or []
                 if isinstance(c, dict) and "input" in c]
    docs = (docs * (n_docs // max(1, len(docs)) + 1))[:n_docs]
    batch, interner = encode_batch([from_plain(d) for d in docs])
    jbatch, jinterner = j_encode([j_from_plain(d) for d in docs])
    port_files, jax_files = [], []
    for p in CORPUS:
        c = compile_rules_file(parse_rules_file(p.read_text(), p.name), interner)
        if c.rules and pack_compatible(c) is None:
            port_files.append(c)
            jax_files.append(j_compile(j_parse(p.read_text(), p.name), jinterner))
    return port_files, batch, jax_files, jbatch


@pytest.mark.parametrize("n_groups", [1, 2, 3, 4, 6, 8])
def test_partition_rules_like_jax(n_groups):
    got = port_rules.partition_rules(port_compiled()[0], n_groups)
    assert got == jax_rules.partition_rules(jax_compiled()[0], n_groups)
    assert sorted(i for g in got for i in g) == list(range(6))


def test_dependencies_like_jax():
    assert port_rules._rule_dependencies(port_compiled()[0]) == \
        jax_rules._rule_dependencies(jax_compiled()[0])


@pytest.mark.parametrize("n_groups", [1, 2, 3, 5, 8, 30])
def test_partition_packs_like_jax(n_groups):
    port_files, _b, jax_files, _jb = registry()
    assert len(port_files) == len(jax_files) >= 20
    got = port_rules.partition_packs(port_files, n_groups)
    assert got == jax_rules.partition_packs(jax_files, n_groups)
    assert sorted(i for g in got for i in g) == list(range(len(port_files)))


def test_slice_compiled_remaps_named_references():
    compiled, batch = port_compiled()
    groups = port_rules.partition_rules(compiled, 3)
    full = DeviceBatchEvaluator(compiled, "cpu")(batch)
    for g in groups:
        sub = port_rules._slice_compiled(compiled, g)
        np.testing.assert_array_equal(DeviceBatchEvaluator(sub, "cpu")(batch), full[:, g])


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_rule_sharded_matches_one_device_and_jax(shards, k):
    compiled, batch = port_compiled(37)
    ev = port_rules.RuleShardedEvaluator(compiled, rule_shards=shards, devices=[CPU] * k)
    assert len(ev.shards) == min(shards, 6, k)
    assert sorted(i for _e, g in ev.shards for i in g) == list(range(6))
    got = ev(batch)
    np.testing.assert_array_equal(got, DeviceBatchEvaluator(compiled, "cpu")(batch))
    jcompiled, jbatch = jax_compiled(37)
    np.testing.assert_array_equal(got, JaxBatchEvaluator(jcompiled)(jbatch))
    np.testing.assert_array_equal(
        got, jax_rules.RuleShardedEvaluator(jcompiled, rule_shards=shards)(jbatch))


def test_rule_sharded_clamps_to_the_visible_devices(monkeypatch):
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [CPU] * 2)
    compiled, _batch = port_compiled()
    assert len(port_rules.RuleShardedEvaluator(compiled, rule_shards=4).shards) == 2
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [CPU])
    assert len(port_rules.RuleShardedEvaluator(compiled, rule_shards=4).shards) == 1


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_pack_sharded_matches_per_file_and_jax(shards, k):
    port_files, batch, jax_files, jbatch = registry()
    ev = port_rules.PackShardedEvaluator(port_files, rule_shards=shards, devices=[CPU] * k,
                                         with_rim=True)
    assert len(ev.shards) == min(shards, len(port_files), k)
    groups, oversize = split_batch_by_size(batch, NODE_BUCKETS_EXTENDED)
    d = batch.n_docs
    statuses = np.zeros((d, ev.n_rules), np.int8)
    rims = None
    for sub, idx in groups:
        st, _un, rim = ev.collect(ev.dispatch(sub))
        statuses[idx] = st
        if rims is None:
            rims = [np.zeros((d,) + b.shape[1:], b.dtype) for b in rim]
        for b, block in enumerate(rim):
            rims[b][idx] = block
    keep = np.ones(d, bool)
    keep[list(oversize)] = False
    base = 0
    for k_file, c in enumerate(port_files):
        single = DeviceBatchEvaluator(c, "cpu", rim_spec=build_rim_spec([c.rules]))
        st, _un, host, rim = evaluate_groups(single, len(c.rules), groups, oversize, d)
        r = len(c.rules)
        np.testing.assert_array_equal(statuses[keep, base:base + r], st[keep])
        gsl = ev.rim_spec.file_slice(k_file)
        for b in (0, 1, 5):
            np.testing.assert_array_equal(rims[b][keep][:, gsl], rim[b][keep])
        for b in (2, 3, 4):
            np.testing.assert_array_equal(rims[b][keep][:, k_file], rim[b][keep][:, 0])
        base += r
    # the JAX package clamps to its 8 devices
    jev = jax_rules.PackShardedEvaluator(jax_files, rule_shards=shards)
    assert jev.groups == port_rules.partition_packs(port_files, min(shards, 8))
    np.testing.assert_array_equal(statuses[keep], jev(jbatch)[keep])

"""The port's document-axis mesh (guard_tpu_torch/parallel/mesh.py)
against its one-device evaluator and the JAX package's
ShardedBatchEvaluator on its 8-device CPU mesh, on the CPU.

A mesh here is a list of torch devices; `[cpu] * k` stands in for k
cards, as `--xla_force_host_platform_device_count=8` does for the JAX
tests. For k in {1, 2, 3, 8} and batches whose document count k does
not divide:

  * `evaluate_bucketed` over the mesh gives the one-device evaluator's
    statuses, unsure bits, host documents and six rim blocks, exactly;
  * `with_summary` gives the JAX package's statuses and (3, R) counts
    (its psum across 8 devices; the port sums per-device K7 counts);
  * the raw unsure bits equal those of a JAX reference started in a
    subprocess with GUARD_TPU_GATHER_CPU_MIN_NODES=0 (ROADMAP, traps).

No tolerance anywhere.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from guard_tpu_torch import entry as port_entry
from guard_tpu_torch.ops.encoder import (
    NODE_BUCKETS_EXTENDED,
    split_batch_by_size,
)
from guard_tpu_torch.ops.ir import build_rim_spec
from guard_tpu_torch.parallel import mesh
from guard_tpu_torch.parallel.device import DISPATCH_COUNTERS, DeviceBatchEvaluator
from test_torch_query_rhs import SHARED_RULES, docs_for
from test_torch_summary import WORKLOADS, jax_summary, numpy_counts, port_evaluator

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MESH_SIZES = [1, 2, 3, 8]


def cpus(k):
    return [CPU] * k


def rim_evaluators(text, docs, k):
    """(one-device evaluator, k-device mesh, batch), both with the
    file's rim spec."""
    ev, batch = port_evaluator(text, docs)
    spec = build_rim_spec([ev.compiled.rules])
    single = DeviceBatchEvaluator(ev.compiled, "cpu", rim_spec=spec)
    sharded = mesh.ShardedBatchEvaluator(ev.compiled, cpus(k), rim_spec=spec)
    return single, sharded, batch


def assert_same_evaluation(a, b):
    st_a, un_a, host_a, rim_a = a
    st_b, un_b, host_b, rim_b = b
    np.testing.assert_array_equal(st_a, st_b)
    np.testing.assert_array_equal(un_a, un_b)
    assert host_a == host_b
    assert len(rim_a) == len(rim_b) == 6
    for x, y in zip(rim_a, rim_b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# -- the device list --------------------------------------------------------
def test_visible_devices_of_the_cpu():
    assert mesh.visible_devices("cpu") == [CPU]
    assert mesh.default_mesh("cpu") == [CPU]


def test_visible_devices_of_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.visible_devices(None) == [torch.device("cuda", i) for i in range(4)]
    assert mesh.visible_devices("cuda") == [torch.device("cuda", i) for i in range(4)]
    assert mesh.visible_devices("cuda:2") == [torch.device("cuda", 2)]


def test_no_card_and_no_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.visible_devices(None)


def test_hierarchical_mesh_is_slice_major():
    devs = [torch.device("cuda", i) for i in range(8)]
    assert mesh.hierarchical_mesh(devs, n_slices=2) == devs
    assert mesh.hierarchical_mesh(devs, n_slices=4) == devs
    with pytest.raises(ValueError, match="do not split"):
        mesh.hierarchical_mesh(devs[:6], n_slices=4)


@pytest.mark.parametrize("n,k", [(0, 3), (1, 8), (7, 3), (37, 8), (64, 2), (65, 8)])
def test_slice_bounds_partition_the_documents(n, k):
    bounds = mesh.slice_bounds(n, k)
    assert len(bounds) == k
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1


def test_take_docs_slices_every_per_document_column():
    _ev, batch = port_evaluator(WORKLOADS[3][1], WORKLOADS[3][2][:20])
    assert mesh.take_docs(batch, 0, batch.n_docs) is batch
    sub = mesh.take_docs(batch, 5, 12)
    assert sub.n_docs == 7 and sub.n_nodes == batch.n_nodes
    for name, col in sub.arrays().items():
        np.testing.assert_array_equal(col, batch.arrays()[name][5:12], err_msg=name)
    np.testing.assert_array_equal(sub.num_exotic, batch.num_exotic[5:12])


# -- the mesh against one device --------------------------------------------
@pytest.mark.parametrize("k", MESH_SIZES)
@pytest.mark.parametrize("name,text,docs", WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_bucketed_mesh_equals_one_device(name, text, docs, k):
    single, sharded, batch = rim_evaluators(text, docs, k)
    assert len(sharded.shards) == k
    assert_same_evaluation(sharded.evaluate_bucketed(batch), single.evaluate_bucketed(batch))


@pytest.mark.parametrize("k", MESH_SIZES)
def test_each_slice_is_one_dispatch(k):
    _n, text, docs = WORKLOADS[0]  # 37 documents, one bucket
    _single, sharded, batch = rim_evaluators(text, docs, k)
    groups, _over = split_batch_by_size(batch, NODE_BUCKETS_EXTENDED)
    assert len(groups) == 1
    before = DISPATCH_COUNTERS["dispatches"]
    handle = sharded.dispatch(groups[0][0])
    assert DISPATCH_COUNTERS["dispatches"] - before == min(k, groups[0][0].n_docs)
    assert [sub_ev.device for sub_ev, _h in handle[0]] == [CPU] * min(k, 37)
    st, un, rim = sharded.collect(handle)
    assert un is None and not sharded.compiled.needs_unsure
    assert st.shape[0] == 37 and all(b.shape[0] == 37 for b in rim)


@pytest.mark.parametrize("blocks", [(0, 1, 2, 3, 4), (4, 5)])
def test_rim_only_collect_ships_the_named_blocks(blocks):
    _n, text, docs = WORKLOADS[2]
    single, _sharded, batch = rim_evaluators(text, docs, 1)
    full = single.evaluate_bucketed(batch)
    ev = mesh.ShardedBatchEvaluator(single.compiled, cpus(3), rim_spec=single.rim_spec,
                                    rim_blocks=blocks, ship_statuses=False)
    groups, _over = split_batch_by_size(batch, NODE_BUCKETS_EXTENDED)
    for sub, idx in groups:
        st, un, rim = ev.collect(ev.dispatch(sub))
        assert st is None and un is None
        for b, block in enumerate(rim):
            if b in blocks:
                np.testing.assert_array_equal(block, full[3][b][idx])
            else:
                assert block is None


def test_without_a_rim_statuses_always_ship():
    _n, text, docs = WORKLOADS[0]
    ev, batch = port_evaluator(text, docs)
    sharded = mesh.ShardedBatchEvaluator(ev.compiled, cpus(2), ship_statuses=False)
    assert sharded.ship_statuses
    np.testing.assert_array_equal(sharded(batch), ev(batch))


# -- with_summary against the JAX package -----------------------------------
@pytest.mark.parametrize("k", MESH_SIZES)
@pytest.mark.parametrize("name,text,docs", WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_with_summary_matches_jax_mesh(name, text, docs, k):
    want = jax_summary(text, docs)
    ev, batch = port_evaluator(text, docs)
    statuses, counts = mesh.ShardedBatchEvaluator(ev.compiled, cpus(k)).with_summary(batch)
    assert statuses.dtype == np.int8 and counts.dtype == np.int32
    np.testing.assert_array_equal(statuses, want[0])
    np.testing.assert_array_equal(counts, want[1])
    np.testing.assert_array_equal(counts, numpy_counts(statuses, len(docs)))


# -- raw unsure bits against a gather-forced JAX reference ------------------
_GATHER_SCRIPT = r"""
import json, sys
import numpy as np
from guard_tpu.core.parser import parse_rules_file
from guard_tpu.core.values import from_plain
from guard_tpu.ops.encoder import encode_batch
from guard_tpu.ops.ir import compile_rules_file
from guard_tpu.parallel.mesh import ShardedBatchEvaluator, default_mesh, evaluate_bucketed
import jax
text, docs = json.load(sys.stdin)
batch, interner = encode_batch([from_plain(d) for d in docs])
compiled = compile_rules_file(parse_rules_file(text, "r.guard"), interner)
ev = ShardedBatchEvaluator(compiled, default_mesh())
st, un, host = evaluate_bucketed(ev, len(compiled.rules), batch)
print(json.dumps([len(jax.devices()), st.tolist(), un.tolist(), sorted(host)]))
"""


def test_unsure_bits_match_a_gather_forced_jax_mesh():
    docs = docs_for(23, 101)
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "GUARD_TPU_GATHER_ON_CPU": "1",
                "GUARD_TPU_GATHER_CPU_MIN_NODES": "0", "PYTHONPATH": str(ROOT),
                "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    proc = subprocess.run([sys.executable, "-c", _GATHER_SCRIPT],
                          input=json.dumps([SHARED_RULES, docs]), capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_dev, jst, jun, jhost = json.loads(proc.stdout)
    assert n_dev == 8
    ev, batch = port_evaluator(SHARED_RULES, docs)
    assert ev.compiled.needs_unsure
    for k in (2, 3, 8):
        st, un, host, _rim = mesh.ShardedBatchEvaluator(ev.compiled, cpus(k)).evaluate_bucketed(batch)
        np.testing.assert_array_equal(st, np.array(jst, np.int8))
        np.testing.assert_array_equal(un, np.array(jun, bool))
        assert sorted(host) == jhost
    assert np.array(jun, bool).any()


# -- the multichip dry run --------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_dryrun_multichip_on_a_cpu_mesh(capsys, k):
    statuses, counts = port_entry.dryrun_multichip(k, cpus(k))
    out = capsys.readouterr().out
    assert out.startswith(f"dryrun_multichip OK: {k} cpu devices")
    axes = "('dcn', 'ici')" if k % 2 == 0 and k >= 4 else "('docs',)"
    assert f"mesh axes {axes}, batch {2 * k} over 2 buckets" in out
    assert statuses.shape[0] == 2 * k
    assert int(counts.sum()) == statuses.size


def test_dryrun_multichip_counts_match_the_jax_dryrun(capsys):
    """The JAX package's dry run on its 8 CPU devices prints the same
    counts line as the port's on eight CPU entries."""
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)
    want = capsys.readouterr().out
    port_entry.dryrun_multichip(8, cpus(8))
    got = capsys.readouterr().out
    assert got.split("counts P/F/S = ")[1] == want.split("counts P/F/S = ")[1]
    assert got.split(", mesh axes")[0].replace("cpu", "") == \
        want.split(", mesh axes")[0].replace("cpu", "")


def test_dryrun_multichip_needs_the_cards(monkeypatch):
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: cpus(2))
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        port_entry.dryrun_multichip(4)
    port_entry.dryrun_multichip(2)


def test_mesh_process_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from guard_tpu_torch.entry import dryrun_multichip\n"
        "dryrun_multichip(4, [torch.device('cpu')] * 4)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip OK: 4 cpu devices" in proc.stdout

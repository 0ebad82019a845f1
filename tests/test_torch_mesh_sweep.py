"""The 2-D (docs x packs) mesh in the port (guard_tpu_torch/parallel/
mesh2d.py, ingest.ShardPrefetcher, the shard loop of ops/backend.
dispatch_packs, sweep's --rule-shards) against the JAX package's
(tests/test_mesh_sweep.py), on the CPU.

`mesh.visible_devices` is patched to four CPU devices: the port then
resolves and shards every shape as the JAX package does on its forced
8-device CPU mesh. `sweep` and `validate` under --mesh-shape in {auto,
2x1, 4x1, 1x2, 2x2} and --rule-shards in {1, 2, 4} give the JAX CLI's
stdout, stderr, manifest and rc; the helpers (shard bounds, take_docs,
columns, the prefetcher and its error path) match the JAX ones; the
fault legs reproduce the clean run and keep a fault to its shard; the
per-shard gauges pass the metrics schema. With one visible device
every shape runs unsharded. No tolerance anywhere.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from guard_tpu.parallel import ingest as jax_ingest
from guard_tpu.parallel import mesh2d as jax_mesh2d
from guard_tpu_torch import kernels as K
from guard_tpu_torch.ops import plan as port_plan
from guard_tpu_torch.parallel import ingest as port_ingest
from guard_tpu_torch.parallel import mesh, mesh2d
from guard_tpu_torch.utils import faults as port_faults
from guard_tpu_torch.utils import telemetry
from guard_tpu_torch.utils.telemetry import PIPELINE_COUNTERS
from test_mesh_sweep import RULES_A, RULES_B, _doc
from test_torch_ingest import set_encoders
from test_torch_sweep import Pair

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SHAPES = ["auto", "2x1", "4x1", "1x2", "2x2"]


@pytest.fixture(autouse=True)
def _four_devices(monkeypatch, tmp_path):
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [CPU] * 4)
    monkeypatch.setenv("GUARD_TPU_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("GUARD_TPU_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("GUARD_TPU_RETRY_BACKOFF", "0")
    monkeypatch.setenv("GUARD_TPU_INGEST_WORKERS", "0")
    for name in ("GUARD_TPU_FAULT", "GUARD_TPU_LEDGER_DIR", "GUARD_TPU_MESH",
                 "GUARD_TPU_MESH_MIN_DOCS", "GUARD_TPU_PACK"):
        monkeypatch.delenv(name, raising=False)
    set_encoders(monkeypatch, None, tmp_path)
    port_faults.reset_faults()
    port_plan.clear_plan_memo()
    jax_ingest.close_shared_pools()
    yield
    jax_ingest.close_shared_pools()
    port_faults.reset_faults()
    port_plan.clear_plan_memo()


def mk_corpus(tmp_path, n=80, fail=(3, 71)):
    """tests/test_mesh_sweep.py's corpus: n documents over two packable
    rule files, the a-documents first (shard 0 of two), then the
    b-documents."""
    ra = tmp_path / "a.guard"
    ra.write_text(RULES_A)
    rb = tmp_path / "b.guard"
    rb.write_text(RULES_B)
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    for i in range(n):
        prefix = "a" if i < n // 2 else "b"
        (data / f"{prefix}{i:03d}.json").write_text(json.dumps(_doc(i, n, fail)))
    return Pair(tmp_path, None, [ra, rb], [data])


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    p = mk_corpus(tmp_path)
    p.mp = monkeypatch
    return p


def sweep_flags(*extra, chunk=80, workers=0):
    return ["-c", str(chunk), "--ingest-workers", str(workers), *extra]


def summary(result):
    doc = json.loads(result[1].splitlines()[-1])
    doc.pop("manifest")
    return result[0], doc


# -- the helpers -------------------------------------------------------------
@pytest.mark.parametrize("min_docs", [None, "1", "4", "40"])
def test_doc_shard_bounds_like_jax(monkeypatch, min_docs):
    if min_docs is not None:
        monkeypatch.setenv("GUARD_TPU_MESH_MIN_DOCS", min_docs)
    for n in (0, 1, 5, 7, 48, 64, 65, 100, 257):
        for r in (1, 2, 3, 4, 8):
            assert mesh2d.doc_shard_bounds(n, r) == jax_mesh2d.doc_shard_bounds(n, r)


def test_min_shard_docs_like_jax(monkeypatch):
    for raw in (None, "", "5", "junk"):
        if raw is None:
            monkeypatch.delenv("GUARD_TPU_MESH_MIN_DOCS", raising=False)
        else:
            monkeypatch.setenv("GUARD_TPU_MESH_MIN_DOCS", raw)
        assert mesh2d.min_shard_docs() == jax_mesh2d.min_shard_docs()


@pytest.mark.parametrize("loads,c", [([5, 3, 2, 2], 2), ([7], 1), ([], 4), ([1, 9, 4, 4, 2], 3),
                                     ([253, 2, 2], 2)])
def test_assign_columns_like_jax(loads, c):
    assert mesh2d.assign_columns(loads, c) == jax_mesh2d.assign_columns(loads, c)


def test_column_mesh_like_jax():
    import jax

    jdevs = jax.devices()
    devs = [torch.device("cuda", i) for i in range(len(jdevs))]
    for shape in ((2, 1), (2, 2), (1, 4), (3, 8), (2, 3)):
        for col in range(shape[1]):
            want = [d.id for d in jax_mesh2d.column_mesh(shape, col, jdevs).devices.flat]
            got = [d.index for d in mesh2d.column_mesh(shape, col, devs)]
            assert got == want, (shape, col)


def test_take_docs_and_shard_groups_like_jax():
    from guard_tpu.core.values import from_plain as j_from_plain
    from guard_tpu.ops.encoder import NODE_BUCKETS_EXTENDED as J_BUCKETS
    from guard_tpu.ops.encoder import encode_batch as j_encode
    from guard_tpu.ops.encoder import split_batch_by_size as j_split
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_bucketed

    plain = [_doc(i, fail=(1, 4)) for i in range(9)]
    plain[5]["Resources"].update({f"x{k}": {"Size": k} for k in range(40)})  # a wider bucket
    jbatch, _ = j_encode([j_from_plain(d) for d in plain])
    groups, oversize, _ = encode_bucketed([from_plain(d) for d in plain])
    for lo, hi in ((0, 9), (0, 4), (4, 9), (2, 7)):
        want, want_over = j_split(jax_mesh2d.take_docs(jbatch, lo, hi), J_BUCKETS)
        got, over = mesh2d.shard_groups(groups, oversize, lo, hi)
        np.testing.assert_array_equal(over, np.asarray(want_over) + lo)
        assert len(got) == len(want)
        for (sub, idx), (wsub, widx) in zip(got, want):
            np.testing.assert_array_equal(idx, np.asarray(widx) + lo)
            n = wsub.n_nodes
            np.testing.assert_array_equal(sub.node_kind[:, :n], wsub.node_kind)
            assert (sub.node_kind[:, n:] == -1).all()
            np.testing.assert_array_equal(sub.scalar_id[:, :n] >= 0, wsub.scalar_id >= 0)


def test_shard_prefetcher_matches_inline_shards():
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_bucketed

    groups, oversize, _ = encode_bucketed([from_plain(_doc(i)) for i in range(8)])
    bounds = [(0, 4), (4, 8)]
    before = PIPELINE_COUNTERS["shards_prefetched"]
    got = list(port_ingest.ShardPrefetcher(groups, oversize, bounds))
    assert PIPELINE_COUNTERS["shards_prefetched"] - before == 2
    assert [(s, lo) for s, lo, _g, _o in got] == [(0, 0), (1, 4)]
    for s, (lo, hi) in enumerate(bounds):
        want, want_over = mesh2d.shard_groups(groups, oversize, lo, hi)
        _s, _lo, sub_groups, over = got[s]
        np.testing.assert_array_equal(over, want_over)
        assert len(sub_groups) == len(want)
        for (sub, idx), (wsub, widx) in zip(sub_groups, want):
            np.testing.assert_array_equal(idx, widx)
            np.testing.assert_array_equal(sub.node_kind, wsub.node_kind)


def test_shard_prefetcher_propagates_producer_errors():
    class Boom:
        def __iter__(self):
            raise RuntimeError("poisoned batch")

    with pytest.raises(RuntimeError, match="poisoned batch"):
        list(port_ingest.ShardPrefetcher(Boom(), (), [(0, 2), (2, 4)]))


def test_prefetch_depth_bounds_the_queue():
    from guard_tpu_torch.core.values import from_plain
    from guard_tpu_torch.ops.encoder import encode_bucketed

    groups, oversize, _ = encode_bucketed([from_plain(_doc(i)) for i in range(6)])
    pf = port_ingest.ShardPrefetcher(groups, oversize, [(i, i + 1) for i in range(6)], depth=1)
    assert pf._q.maxsize == 1
    assert [s for s, *_ in pf] == list(range(6))


# -- sweep and validate against the JAX mesh --------------------------------
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_sweep_same_bytes_as_jax(corpus, shape, workers):
    before = PIPELINE_COUNTERS["shards_prefetched"]
    got = corpus.both(sweep_flags("--mesh-shape", shape, workers=workers))
    assert got[0] == 19
    if shape in ("auto", "2x1", "4x1", "2x2"):
        # 80 documents over the default floor of 32: two doc shards
        assert PIPELINE_COUNTERS["shards_prefetched"] - before >= 2


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_sweep_equals_the_unsharded_run(corpus, shape):
    base = summary(corpus.port(sweep_flags("--mesh-shape", "off")))
    assert base[0] == 19
    assert summary(corpus.port(sweep_flags("--mesh-shape", shape))) == base


@pytest.mark.parametrize("rule_shards", [1, 2, 4])
@pytest.mark.parametrize("chunk", [7, 80])
def test_rule_shards_same_bytes_as_jax(corpus, rule_shards, chunk):
    got = corpus.both(sweep_flags("--rule-shards", str(rule_shards), chunk=chunk))
    assert got[0] == 19


@pytest.mark.parametrize("rule_shards", [2, 4])
def test_rule_shards_per_file_same_bytes_as_jax(tmp_path, monkeypatch, rule_shards):
    """Without packing every file's rules split into dependency-closed
    groups (RuleShardedEvaluator)."""
    from test_rule_sharding import RULES

    p = mk_corpus(tmp_path)
    p.mp = monkeypatch
    (tmp_path / "c.guard").write_text(RULES)
    p.rules.append(str(tmp_path / "c.guard"))
    monkeypatch.setenv("GUARD_TPU_PACK", "0")
    want = p.jax(sweep_flags("--rule-shards", str(rule_shards)))
    got = p.port(sweep_flags("--rule-shards", str(rule_shards), "--no-pack"))
    assert got == want


@pytest.mark.parametrize(
    "mode",
    [[], ["-o", "yaml"], ["--structured", "-o", "json", "--show-summary", "none"],
     ["--structured", "-o", "junit", "--show-summary", "none"], ["--statuses-only"]],
    ids=["console", "yaml", "json", "junit", "statuses_only"],
)
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_validate_same_bytes_as_jax(tmp_path, monkeypatch, shape, mode):
    from test_torch_mesh_shape import run_jax, run_port

    p = mk_corpus(tmp_path)
    monkeypatch.setenv("GUARD_TPU_RESULT_CACHE", "0")
    args = ["-r", *p.rules, "-d", *p.data, "--mesh-shape", shape, *mode]
    try:
        want = run_jax(args)
    finally:
        monkeypatch.delenv("GUARD_TPU_MESH", raising=False)
    got, ev, _calls = run_port(args)
    assert got == want
    assert got[0] == 19
    packed = [ev.files[fi] for fi in ev.packs[0]]
    # the report path's profile: statuses stay on the cards, blocks 0-4 return
    assert all(fr.statuses is None and fr.rim[5] is None and fr.rim[0] is not None
               for fr in packed)


def test_mesh_shape_off_is_the_unsharded_path(corpus):
    telemetry.REGISTRY.reset()
    corpus.port(sweep_flags("--mesh-shape", "off"))
    assert PIPELINE_COUNTERS["shards_prefetched"] == 0
    assert not [k for k in telemetry.REGISTRY.snapshot()["gauges"]
                if k.startswith("efficiency.shard_")]


# -- the fault legs ----------------------------------------------------------
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("pack", [[], ["--no-pack"]], ids=["packed", "perfile"])
def test_dispatch_fault_under_mesh_keeps_parity(corpus, pack, workers):
    base = corpus.port(sweep_flags("--mesh-shape", "off", *pack, workers=workers))
    corpus.mp.setenv("GUARD_TPU_FAULT", "dispatch:nth=1")
    port_faults.reset_faults()
    got = corpus.port(sweep_flags("--mesh-shape", "2x2", *pack, workers=workers))
    assert summary(got) == summary(base)
    assert port_faults.fault_stats()["dispatch_fallbacks"] >= 1


@pytest.mark.parametrize("stage", ["dispatch", "collect"])
def test_packed_fault_under_mesh_same_bytes_as_jax(corpus, stage):
    corpus.mp.setenv("GUARD_TPU_FAULT", f"{stage}:nth=2")
    got = corpus.both(sweep_flags("--mesh-shape", "2x2"))
    assert got[0] == 19


@pytest.mark.parametrize("stage", ["dispatch", "collect"])
def test_rule_shards_fault_same_bytes_as_jax(corpus, stage):
    corpus.mp.setenv("GUARD_TPU_FAULT", f"{stage}:nth=1")
    got = corpus.both(sweep_flags("--rule-shards", "2"))
    assert got[0] == 19


def test_shard_fault_never_sends_other_shards_to_oracle(corpus):
    """The shard boundary is the degradation boundary: the first dispatch
    fault lands on shard 0 (the a-documents) and reruns that bucket per
    file; an armed oracle fault on every b-document (shard 1) shows no
    document of the other shard reached the oracle, and the output is
    the clean run's."""
    base = corpus.port(sweep_flags("--mesh-shape", "off"))
    corpus.mp.setenv("GUARD_TPU_FAULT", "oracle:glob=b*")
    port_faults.reset_faults()
    assert summary(corpus.port(sweep_flags("--mesh-shape", "2x2"))) == summary(base)
    corpus.mp.setenv("GUARD_TPU_FAULT", "dispatch:nth=1,oracle:glob=b*")
    port_faults.reset_faults()
    got = corpus.port(sweep_flags("--mesh-shape", "2x2"))
    assert summary(got) == summary(base)
    stats = port_faults.fault_stats()
    assert stats["dispatch_fallbacks"] == 1
    assert stats["oracle_fallbacks"] == 0
    assert stats.get("injected_oracle", 0) == 0


# -- efficiency and the schema ---------------------------------------------
def test_mesh_shard_gauges_and_rim_only_d2h(corpus):
    sys.path.insert(0, str(ROOT / "tools"))
    from check_metrics_schema import check_snapshot

    from guard_tpu_torch.parallel.device import EFFICIENCY_COUNTERS
    from guard_tpu_torch.tools.check_metrics_schema import check_snapshot as port_check_snapshot

    telemetry.REGISTRY.reset()
    corpus.port(sweep_flags("--mesh-shape", "off"))
    off_d2h = EFFICIENCY_COUNTERS["device_to_host_bytes"]
    telemetry.REGISTRY.reset()
    rc, _ = summary(corpus.port(sweep_flags("--mesh-shape", "2x1")))
    assert rc == 19
    snap = telemetry.REGISTRY.snapshot()
    gauges = snap["gauges"]
    for s in (0, 1):
        for g in ("doc_fill", "h2d", "d2h"):
            assert f"efficiency.shard_{s}.{g}" in gauges
        assert gauges[f"efficiency.shard_{s}.doc_fill"] == 1.0  # the port pads nothing
        assert gauges[f"efficiency.shard_{s}.d2h"] > 0
    assert check_snapshot(snap) == []
    assert port_check_snapshot(snap) == []
    # the sweep profile ships any-unsure and last-rule-wins only
    mesh_d2h = EFFICIENCY_COUNTERS["device_to_host_bytes"]
    assert 0 < mesh_d2h * 2 <= off_d2h
    # a reset clears the per-shard totals with the efficiency group
    d2h_0 = gauges["efficiency.shard_0.d2h"]
    telemetry.REGISTRY.reset()
    corpus.port(sweep_flags("--mesh-shape", "2x1"))
    assert telemetry.REGISTRY.snapshot()["gauges"]["efficiency.shard_0.d2h"] == d2h_0


def test_plan_cache_hits_under_mesh(corpus):
    corpus.port(sweep_flags("--mesh-shape", "2x1"))
    port_plan.reset_plan_stats()
    corpus.port(sweep_flags("--mesh-shape", "2x1"))
    stats = port_plan.plan_stats()
    assert stats["hits"] >= 1 and stats["misses"] == 0


# -- the one-card rule -------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_one_visible_device_runs_every_shape_unsharded(corpus, shape):
    corpus.mp.setattr(mesh, "visible_devices", lambda device=None: [CPU])
    calls = []
    real = K.rim_reduce

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    corpus.mp.setattr(K, "rim_reduce", counting)
    base = summary(corpus.port(sweep_flags("--mesh-shape", "off")))
    n_base = len(calls)
    calls.clear()
    before = PIPELINE_COUNTERS["shards_prefetched"]
    assert summary(corpus.port(sweep_flags("--mesh-shape", shape))) == base
    assert len(calls) == n_base == 1  # one bucket of 80 documents, one K3
    assert PIPELINE_COUNTERS["shards_prefetched"] == before


@pytest.mark.parametrize("rule_shards", ["2", "4"])
def test_one_visible_device_rule_shards_take_the_packed_path(corpus, rule_shards):
    """One card clamps --rule-shards to one group: the packable files
    take the packed path (no PackShardedEvaluator is built), with the
    K3 launches and the output of --rule-shards 1."""
    from guard_tpu_torch.parallel import rules as port_rules

    corpus.mp.setattr(mesh, "visible_devices", lambda device=None: [CPU])
    calls = []
    real = K.rim_reduce

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    def refused(*a, **k):
        raise AssertionError("one card built a PackShardedEvaluator")

    corpus.mp.setattr(K, "rim_reduce", counting)
    base = summary(corpus.port(sweep_flags("--rule-shards", "1")))
    n_base = len(calls)
    calls.clear()
    corpus.mp.setattr(port_rules, "PackShardedEvaluator", refused)
    assert summary(corpus.port(sweep_flags("--rule-shards", rule_shards))) == base
    assert len(calls) == n_base == 1


def test_mesh_sweep_process_imports_no_jax(tmp_path):
    p = mk_corpus(tmp_path)
    code = (
        "import sys, torch\n"
        "from guard_tpu_torch.parallel import mesh\n"
        "mesh.visible_devices = lambda device=None: [torch.device('cpu')] * 4\n"
        "from guard_tpu_torch.cli import run\n"
        f"rc = run(['sweep', '-r', *{p.rules!r}, '-d', *{p.data!r}, '--device', 'cpu',\n"
        f"          '-M', {str(tmp_path / 'm.jsonl')!r}, '--no-result-cache',\n"
        "          '--no-journal', '--ingest-workers', '0', '--rule-shards', '2',\n"
        "          '--mesh-shape', '2x2'])\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "sys.exit(rc)\n"
    )
    env = {**__import__("os").environ, "GUARD_TPU_PLAN_CACHE_DIR": str(tmp_path / "pl")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 19, proc.stderr[-3000:]

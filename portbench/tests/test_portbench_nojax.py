"""The check for JAX and the JAX package, and run.py's refusals: no
result without a card, without the port, or with JAX loaded."""

import os
import shutil
import subprocess
import sys

from portbench.harness import nojax, pools
from portbench.tests.conftest import ROOT


def test_top_level_names_are_compared_whole():
    assert nojax.forbidden(["guard_tpu_torch", "guard_tpu_torch.ops.kernels", "jaxtyping",
                            "flaxen", "numpy"]) == []
    assert nojax.forbidden(["jax.numpy", "jaxlib.xla_client", "flax", "guard_tpu.ops",
                            "guard_tpu_torch"]) == ["flax", "guard_tpu", "jax", "jaxlib"]


def test_the_port_and_the_harness_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import guard_tpu_torch, "
            "guard_tpu_torch.commands.sweep, guard_tpu_torch.ops.backend; "
            "from portbench.harness import bench, check, record; "
            "from portbench.reference import sweep; "
            "from portbench.harness.nojax import loaded_here; print(loaded_here())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


class FakePool:
    """An ingest pool of two 'workers' that answer in this process."""

    def __init__(self, names):
        self.names = names

    def submit(self, fn, args):
        names = self.names

        class Job:
            def get(self, timeout=None):
                return (len(names) % 2, nojax.forbidden(names))

        self.names = ["jax.numpy"] if names == [] else names
        return Job()


def test_every_worker_of_a_pool_is_asked():
    seen = pools.each_worker(FakePool([]), 2, nojax.loaded_in_worker, None, timeout=5)
    assert seen == {0: [], 1: ["jax"]}


def run_py(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "secpol.sweep", "--seed",
         "4294967311", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_it_prints_no_result_and_fails():
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_with_only_the_benchmarks_files_it_prints_no_result_and_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "guard_tpu_torch" in out.stderr


def test_an_unknown_cell_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nope", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""

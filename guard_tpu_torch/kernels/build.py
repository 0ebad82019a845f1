"""Build and load the CUDA kernel libraries (csrc/*.cu).

`nvcc` compiles each source into a shared library with a plain C
interface on first use, one process per source, all started together;
`ctypes` loads them. Each library lands in `build/guard_tpu_torch/<key>/`
at the repository root (or under `GUARD_TPU_TORCH_BUILD_DIR`), keyed on
a hash of its source, the nvcc version and the flags, so an edited
source or another toolkit rebuilds and unchanged ones load straight
away. Nothing here runs at import time: the CPU-only test environment
has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "guard_kernels": _PKG / "csrc" / "guard_kernels.cu",  # K1-K3, K7
    "guard_joins": _PKG / "csrc" / "guard_joins.cu",  # K4-K6
    "guard_walk": _PKG / "csrc" / "guard_walk.cu",  # the tape kernel (ops/tape.py)
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> (argument types, result type)
_SIGNATURES = {
    "guard_gather_rows": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "guard_segment_sum_rows": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "guard_segment_sum_branch": ([_I, _I, _I], _I),
    "guard_segment_sum_rows_as": ([_I, _P, _P, _P, _I, _I, _I, _P], _I),
    "guard_rim_max_slots": ([], _I),
    "guard_rim_reduce": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "guard_rim_reduce_branch": ([_I] * 4, _I),
    "guard_rim_reduce_as": ([_I] + [_P] * 11 + [_I] * 4 + [_P], _I),
    "guard_rule_summary": ([_P, _P, _I, _I, _I, _P], _I),
    "guard_rule_summary_branch": ([_I] * 3, _I),
    "guard_rule_summary_as": ([_I, _P, _P, _I, _I, _I, _P], _I),
    "guard_set_count_branch": ([_I, _I], _I),
    "guard_set_count_scratch": ([_I, _I], _L),
    "guard_set_count_rows": ([_P] * 8 + [_I] * 3 + [_P], _I),
    "guard_set_count_rows_as": ([_I] + [_P] * 8 + [_I] * 3 + [_P], _I),
    "guard_distinct_first_branch": ([_I, _I], _I),
    "guard_distinct_first_scratch": ([_I, _I], _L),
    "guard_distinct_first_rows": ([_P] * 5 + [_I] * 2 + [_P], _I),
    "guard_distinct_first_rows_as": ([_I] + [_P] * 5 + [_I] * 2 + [_P], _I),
    "guard_seg_min_max_branch": ([_I, _I, _I], _I),
    "guard_seg_min_max_scratch": ([_I, _I], _L),
    "guard_seg_min_max_rows": ([_P] * 9 + [_I] * 3 + [_P], _I),
    "guard_seg_min_max_rows_as": ([_I] + [_P] * 9 + [_I] * 3 + [_P], _I),
    "guard_walk_max_bufs": ([], _I),
    "guard_walk_segment": ([_P, _I, _P, _I, _P, _P, _I, _I, _I, _L, _P], _I),
}


def build_dir() -> Path:
    env = os.environ.get("GUARD_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _PKG.parent / "build" / "guard_tpu_torch"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of guard_tpu_torch are built "
        "on first use and need the CUDA toolkit (set CUDA_HOME)"
    )


def build() -> Dict[str, Path]:
    """Compile every library whose keyed build is missing, all at once;
    return the path of each."""
    nvcc = find_nvcc()
    version = subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, text=True
    ).stdout
    # each library is keyed on its own source, so an edit to one source
    # rebuilds that library alone
    libs = {}
    for name, src in SOURCES.items():
        h = hashlib.sha256()
        h.update(src.read_bytes())
        h.update(version.encode())
        h.update(" ".join(NVCC_FLAGS).encode())
        out_dir = build_dir() / h.hexdigest()[:16]
        out_dir.mkdir(parents=True, exist_ok=True)
        libs[name] = out_dir / f"lib{name}.so"
    procs = {}
    for name, src in SOURCES.items():
        if libs[name].exists():
            continue
        tmp = libs[name].with_name(f"lib{name}.{os.getpid()}.so")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {SOURCES[name]}:\n{out}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load():
    """The kernels' C functions as attributes of one namespace, building
    the libraries on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            fns, libs = {}, []
            for path in build().values():
                lib = ctypes.CDLL(str(path))
                libs.append(lib)
                for name, (args, res) in _SIGNATURES.items():
                    fn = getattr(lib, name, None)
                    if fn is not None:
                        fn.argtypes = args
                        fn.restype = res
                        fns[name] = fn
            missing = sorted(set(_SIGNATURES) - set(fns))
            if missing:
                raise RuntimeError(f"kernel libraries lack {missing}")
            # K3's largest 2G + 3F and the tape kernel's buffers a
            # launch, read once
            _LIB = SimpleNamespace(libraries=libs, rim_max_slots=fns["guard_rim_max_slots"](),
                                   walk_max_bufs=fns["guard_walk_max_bufs"](), **fns)
        return _LIB

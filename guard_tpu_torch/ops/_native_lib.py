"""Loading and building of the port's native shared libraries.

The port's counterpart of guard_tpu/ops/_native_lib.py. The library is
built from the repository's C++ source (native/oracle.cpp) into a
directory of the port's own, `build/guard_tpu_torch/native/` beside the
package (gitignored), or `GUARD_TPU_TORCH_NATIVE_DIR` when set, so that
nothing is written under native/. One CDLL per library is cached.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent.parent

NATIVE_DIR = Path(
    os.environ.get(
        "GUARD_TPU_TORCH_NATIVE_DIR", ROOT / "build" / "guard_tpu_torch" / "native"
    )
)

# the flags of native/build_oracle.sh
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_libs: Dict[str, ctypes.CDLL] = {}


def so_path(so_name: str) -> Path:
    return NATIVE_DIR / so_name


def load_lib(so_name: str) -> Optional[ctypes.CDLL]:
    """CDLL for `so_name`, cached; None when not built."""
    if so_name in _libs:
        return _libs[so_name]
    path = so_path(so_name)
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    _libs[so_name] = lib
    return lib


def build(so_name: str, source: Path, force: bool = False) -> Path:
    """Compile `source` into NATIVE_DIR/`so_name` with g++ (the flags of
    native/build_oracle.sh) unless it is there already; the library's
    path. A failed compile raises RuntimeError with g++'s stderr. The
    library is written under a temporary name and renamed, so builds
    racing in parallel processes leave one whole file."""
    path = so_path(so_name)
    if path.exists() and not force:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(source), "-ldl"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {so_name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build {so_name} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path

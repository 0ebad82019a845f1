"""The port's C ABI: the build of `csrc/host/guard_ffi.c`.

The counterpart of the JAX package's `native/build_ffi.sh`: gcc
compiles the shim, which embeds CPython and calls
`guard_tpu_torch.run_checks`, into a shared library
(`libguard_tpu_torch_ffi.so`, exporting `guard_tpu_torch_run_checks`
and `guard_tpu_torch_free_string`) and a test binary that calls it from
C (`guard_tpu_torch_ffi_test`), with the flags of `python3-config
--includes` and `--ldflags --embed`.

`build_ffi()` builds on first use, into a directory keyed by the
sources and the flags under the kernels' build directory
(`kernels/build.build_dir()`, gitignored), and returns the paths;
later calls find them built. A C caller needs the checkout on
PYTHONPATH to import the package:

    python -c "from guard_tpu_torch.ffi import build_ffi; print(build_ffi()['test'])"
    PYTHONPATH=. <that path>
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

_HOST = Path(__file__).resolve().parent / "csrc" / "host"
SOURCE = _HOST / "guard_ffi.c"
HEADER = _HOST / "guard_ffi.h"
LIBRARY = "libguard_tpu_torch_ffi.so"
TEST_BINARY = "guard_tpu_torch_ffi_test"


def _config(*flags: str) -> list:
    out = subprocess.run(["python3-config", *flags], check=True, capture_output=True,
                         text=True).stdout
    return out.split()


def build_ffi(out_dir: Optional[Path] = None) -> Dict[str, Path]:
    """Build the library and the test binary into `out_dir` (default: a
    keyed directory under the build directory) unless both are there;
    returns {"lib": path, "test": path, "header": path}. A failed build
    raises CalledProcessError with gcc's output."""
    cflags = ["-O2", *_config("--includes")]
    ldflags = _config("--ldflags", "--embed")
    if out_dir is None:
        from .kernels.build import build_dir

        h = hashlib.sha256()
        for src in (SOURCE, HEADER):
            h.update(src.read_bytes())
        h.update(" ".join(cflags + ldflags).encode())
        out_dir = build_dir() / "ffi" / h.hexdigest()[:16]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {"lib": out_dir / LIBRARY, "test": out_dir / TEST_BINARY, "header": HEADER}
    for key, extra in (("lib", ["-fPIC", "-shared"]), ("test", ["-DGUARD_FFI_TEST_MAIN"])):
        if paths[key].exists():
            continue
        tmp = out_dir / f"{paths[key].name}.{os.getpid()}"
        subprocess.run(["gcc", *cflags, *extra, f"-I{_HOST}", str(SOURCE), "-o", str(tmp),
                        *ldflags], check=True, capture_output=True, text=True)
        os.replace(tmp, paths[key])
    return paths

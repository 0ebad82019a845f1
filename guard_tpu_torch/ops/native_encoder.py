"""ctypes bindings for the port's native C++ JSON encoder.

The port's counterpart of guard_tpu/ops/native_encoder.py, over its own
copy of the encoder (csrc/host/encoder.cpp). The JAX package's binding
returns one batch padded to the largest document; this one returns the
per-size-bucket groups `encoder.encode_bucketed` builds from document
trees, cut by `encoder.groups_from_ragged` out of the ragged columns
the library returns, so no (documents x largest document) block is
ever built.

The library is built only by an explicit `build_native()` (into
ops/_native_lib.NATIVE_DIR, never under native/); until then
`native_available()` is False and the callers encode from trees.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ._native_lib import ROOT, build, load_lib
from .encoder import NODE_BUCKETS_EXTENDED, Interner, groups_from_ragged

_SO_NAME = "libguard_ragged_encoder.so"
SOURCE = ROOT / "guard_tpu_torch" / "csrc" / "host" / "encoder.cpp"

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)

NODE_COLUMNS = ("node_kind", "node_parent", "scalar_id", "num_hi", "num_lo", "child_count")
EDGE_COLUMNS = ("edge_parent", "edge_child", "edge_key_id", "edge_index")


class _RaggedBatch(ctypes.Structure):
    _fields_ = [
        ("n_docs", ctypes.c_int32),
        ("n_strings", ctypes.c_int32),
        ("n_nodes", ctypes.c_int64),
        ("n_edges", ctypes.c_int64),
        ("node_offset", _I64),
        ("edge_offset", _I64),
        *((name, _I32) for name in NODE_COLUMNS + EDGE_COLUMNS),
        ("doc_exotic", ctypes.POINTER(ctypes.c_uint8)),
        ("string_blob", ctypes.POINTER(ctypes.c_char)),
        ("string_blob_len", ctypes.c_int64),
        ("error_doc", ctypes.c_int32),
        ("owner", ctypes.c_void_p),
    ]


_configured = None


def _load() -> Optional[ctypes.CDLL]:
    global _configured
    if _configured is not None:
        return _configured
    lib = load_lib(_SO_NAME)
    if lib is None:
        return None
    lib.guard_encode_json_ragged.restype = ctypes.POINTER(_RaggedBatch)
    lib.guard_encode_json_ragged.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
    ]
    lib.guard_ragged_free.argtypes = [ctypes.POINTER(_RaggedBatch)]
    lib.guard_ragged_free.restype = None
    _configured = lib
    return lib


def build_native(force: bool = False):
    """Compile csrc/host/encoder.cpp into the port's library directory
    (a no-op when it is built) and return the library's path; raises
    RuntimeError with the compiler's stderr when the build fails."""
    return build(_SO_NAME, SOURCE, force)


def native_available() -> bool:
    return _load() is not None


def _copy(ptr, count: int, dtype) -> np.ndarray:
    if count == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def encode_json_ragged(docs: List[str]):
    """Encode JSON texts natively: (cols, node_offset, edge_offset,
    exotic, interner, error_doc-or-None), the columns ragged as
    encoder.groups_from_ragged takes them. An unparseable document has
    no node; `error_doc` is the first of them. Raises RuntimeError when
    the library is not built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native encoder not built; run guard_tpu_torch.ops.native_encoder."
            "build_native() or use the tree encoder"
        )
    n = len(docs)
    arr = (ctypes.c_char_p * n)(*[d.encode("utf-8") for d in docs])
    ptr = lib.guard_encode_json_ragged(arr, n)
    try:
        b = ptr.contents
        cols = {name: _copy(getattr(b, name), b.n_nodes, np.int32) for name in NODE_COLUMNS}
        cols.update({name: _copy(getattr(b, name), b.n_edges, np.int32) for name in EDGE_COLUMNS})
        node_offset = _copy(b.node_offset, n + 1, np.int64)
        edge_offset = _copy(b.edge_offset, n + 1, np.int64)
        exotic = _copy(b.doc_exotic, n, np.uint8).astype(bool)
        blob = ctypes.string_at(b.string_blob, b.string_blob_len)
        strings = blob.decode("utf-8").split("\x00")[:-1] if b.string_blob_len else []
        error_doc = b.error_doc if b.error_doc >= 0 else None
    finally:
        lib.guard_ragged_free(ptr)
    return cols, node_offset, edge_offset, exotic, Interner.from_strings(strings), error_doc


def encode_json_bucketed(docs: List[str], buckets: Tuple[int, ...] = NODE_BUCKETS_EXTENDED):
    """Encode JSON texts natively into per-size-bucket groups: (groups,
    oversize, interner, error_doc-or-None), groups and oversize as
    encoder.encode_bucketed returns them. Raises RuntimeError when the
    library is not built."""
    cols, node_offset, edge_offset, exotic, interner, err = encode_json_ragged(docs)
    groups, oversize = groups_from_ragged(cols, node_offset, edge_offset, exotic, buckets)
    return groups, oversize, interner, err


def encode_json_bucketed_resilient(contents: List[str], names: List[str]):
    """`encode_json_bucketed` with per-document isolation: an invalid
    document must not push the whole set off the native encoder, so it
    is reported, replaced by a `null` stand-in and the rest retried.
    Returns ((groups, oversize, interner), failed_indices, messages), or
    (None, failed_indices, messages) when the library is not built (the
    caller encodes from trees then, with the marks kept)."""
    failed: set = set()
    msgs: List[str] = []
    if not native_available():
        return None, failed, msgs
    work = list(contents)
    for _ in range(len(work) + 1):
        groups, oversize, interner, err = encode_json_bucketed(work)
        if err is None:
            return (groups, oversize, interner), failed, msgs
        if err not in failed:
            failed.add(err)
            msgs.append(f"skipping {names[err]}: invalid JSON")
        work[err] = "null"
    return None, failed, msgs

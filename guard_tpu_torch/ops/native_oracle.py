"""ctypes bindings for the native C++ oracle (native/oracle.cpp).

The port's copy of guard_tpu/ops/native_oracle.py. `NativeOracle`
compiles a parsed `RulesFile` once (Python serializes the AST, C++
deserializes) and then evaluates per-document rule statuses, and the
simplified report of a document, at compiled-engine speed. Two outcomes
per document:

  * a status list (0 PASS / 1 FAIL / 2 SKIP per guard rule, file order)
    or a report equal to the CPU evaluator's (core/evaluator.py plus
    commands/report.simplified_report_from_root), or
  * `NativeUnsupported` / `NativeEvalError`: the engine declined (a
    construct outside its certain-parity subset) or hit the evaluation
    error the CPU evaluator would raise; callers fall back to the CPU
    evaluator either way.

The library is built only by an explicit `build_native()` (into
ops/_native_lib.NATIVE_DIR); until then `native_available()` is False
and every `NativeOracle` raises `NativeUnsupported`, so the validate
path runs on the CPU evaluator alone.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

from ..core.ast_serde import (
    Unserializable,
    doc_to_compact,
    doc_to_json,
    records_from_wire,
    rules_file_to_json,
)
from ..core.exprs import RulesFile
from ..core.values import PV
from ._native_lib import ROOT, build, load_lib

#: stand-in lock for close() on partially-constructed instances
_NULL_LOCK = threading.Lock()

_SO_NAME = "libguard_oracle.so"
SOURCE = ROOT / "native" / "oracle.cpp"

_configured = None


class NativeUnsupported(Exception):
    """The native engine declined (fall back to the Python oracle)."""


class NativeEvalError(Exception):
    """The native engine hit the evaluation error Python would raise."""


def _load() -> Optional[ctypes.CDLL]:
    global _configured
    if _configured is not None:
        return _configured
    lib = load_lib(_SO_NAME)
    if lib is None:
        return None
    lib.guard_oracle_compile.restype = ctypes.c_void_p
    lib.guard_oracle_compile.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
    ]
    for fn_name in ("guard_oracle_eval", "guard_oracle_eval_raw"):
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char_p),
        ]
    for fn_name in (
        "guard_oracle_eval_records",
        "guard_oracle_eval_report",
        "guard_oracle_eval_report_raw",
    ):
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_void_p  # char* we free
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
        ]
    lib.guard_oracle_free.argtypes = [ctypes.c_void_p]
    lib.guard_oracle_free.restype = None
    lib.guard_oracle_free_str.argtypes = [ctypes.c_void_p]
    lib.guard_oracle_free_str.restype = None
    _configured = lib
    return lib


def build_native(force: bool = False):
    """Compile native/oracle.cpp into the port's library directory (a
    no-op when it is built) and return the library's path; raises
    RuntimeError with the compiler's stderr when the build fails."""
    return build(_SO_NAME, SOURCE, force)


def native_available() -> bool:
    return _load() is not None


def _consume_err(lib, err: ctypes.c_char_p) -> str:
    msg = err.value.decode("utf-8", "replace") if err.value else "unknown"
    lib.guard_oracle_free_str(err)
    return msg


class NativeOracle:
    """One compiled rule file; evaluates per-doc statuses natively.

    Thread-safe via a per-thread handle pool: the engine's regex cache
    and pcre2 match data are per-handle and unsynchronized, so sharing
    ONE handle across threads was a documented footgun — instead each
    thread lazily compiles its own handle from the serialized AST (the
    constructor compiles the calling thread's eagerly, preserving the
    compile-failure-raises contract). A pipelined consumer stage can
    therefore hammer one NativeOracle from several threads
    (the JAX package's tests/test_native_oracle.py pins it)."""

    def __init__(self, rules_file: RulesFile):
        import threading

        lib = _load()
        if lib is None:
            raise NativeUnsupported(
                "native oracle not built; call native_oracle.build_native()"
            )
        self._lib = lib
        self.n_rules = len(rules_file.guard_rules)
        try:
            self._ast_json = rules_file_to_json(rules_file).encode("utf-8")
        except (Unserializable, RecursionError) as e:
            raise NativeUnsupported(str(e))
        self._pool_lock = threading.Lock()
        self._handles: dict = {}  # thread ident -> engine handle
        self._closed = False
        self._handle_for_thread()  # compile now: constructor must raise

    def _compile_handle(self):
        err = ctypes.c_char_p()
        handle = self._lib.guard_oracle_compile(
            self._ast_json, ctypes.byref(err)
        )
        if not handle:
            raise NativeUnsupported(_consume_err(self._lib, err))
        return handle

    def _handle_for_thread(self):
        """The calling thread's private engine handle (compiled on
        first use). Raises NativeUnsupported after close()."""
        import threading

        if self._closed:
            raise NativeUnsupported("oracle handle closed")
        tid = threading.get_ident()
        handle = self._handles.get(tid)
        if handle is None:
            handle = self._compile_handle()
            with self._pool_lock:
                if self._closed:  # closed during our compile: lost race
                    self._lib.guard_oracle_free(handle)
                    raise NativeUnsupported("oracle handle closed")
                self._handles[tid] = handle
        return handle

    def close(self) -> None:
        with getattr(self, "_pool_lock", None) or _NULL_LOCK:
            self._closed = True
            for handle in getattr(self, "_handles", {}).values():
                self._lib.guard_oracle_free(handle)
            self._handles = {}

    def __del__(self):  # pragma: no cover - interpreter teardown order
        try:
            self.close()
        except Exception:
            pass

    def eval_doc(self, doc: PV) -> List[int]:
        """Per-rule statuses for one loaded document (0/1/2 =
        PASS/FAIL/SKIP in guard-rule file order)."""
        try:
            wire = doc_to_compact(doc).encode("utf-8")
        except (Unserializable, RecursionError) as e:
            raise NativeUnsupported(str(e))
        return self.eval_wire(wire)

    def eval_records(self, doc: PV, data_file_name: str):
        """Full evaluation record tree (EventRecord) for one document —
        the rich-report path. The returned tree is byte-equivalent to
        the Python evaluator's (differential suite pins the serde
        encoding), so simplified_report_from_root / rule_statuses_from_root
        consume it unchanged."""
        handle = self._handle_for_thread()
        try:
            wire = doc_to_json(doc).encode("utf-8")
        except (Unserializable, RecursionError) as e:
            raise NativeUnsupported(str(e))
        err = ctypes.c_char_p()
        ptr = self._lib.guard_oracle_eval_records(
            handle, wire, data_file_name.encode("utf-8"), ctypes.byref(err)
        )
        if not ptr:
            msg = _consume_err(self._lib, err)
            if msg.startswith("unsupported:"):
                raise NativeUnsupported(msg)
            raise NativeEvalError(
                msg[len("error: "):] if msg.startswith("error: ") else msg
            )
        try:
            text = ctypes.string_at(ptr).decode("utf-8")
        finally:
            self._lib.guard_oracle_free_str(ptr)
        return records_from_wire(text)

    def eval_report(self, doc: PV, data_file_name: str):
        """(report_dict, {rule: Status}, overall Status) for one
        document — the simplified report built natively from failing
        records only (the fail-rerun fast path). Byte-equal to
        simplified_report_from_root over the Python evaluator's tree
        (differential suite)."""
        self._handle_for_thread()
        try:
            wire = doc_to_compact(doc, locs=True).encode("utf-8")
        except (Unserializable, RecursionError) as e:
            raise NativeUnsupported(str(e))
        return self._report_call(
            self._lib.guard_oracle_eval_report, wire, data_file_name
        )

    def eval_report_raw(self, content: str, data_file_name: str):
        """eval_report straight from raw JSON text — no Python-side
        load or serialization; source marks match the loader's."""
        self._handle_for_thread()
        return self._report_call(
            self._lib.guard_oracle_eval_report_raw,
            content.encode("utf-8"),
            data_file_name,
        )

    def _report_call(self, entry, wire: bytes, data_file_name: str):
        import json as _json

        from ..core.qresult import Status

        err = ctypes.c_char_p()
        ptr = entry(
            self._handle_for_thread(), wire, data_file_name.encode("utf-8"),
            ctypes.byref(err),
        )
        if not ptr:
            msg = _consume_err(self._lib, err)
            if msg.startswith("unsupported:"):
                raise NativeUnsupported(msg)
            raise NativeEvalError(
                msg[len("error: "):] if msg.startswith("error: ") else msg
            )
        try:
            text = ctypes.string_at(ptr).decode("utf-8")
        finally:
            self._lib.guard_oracle_free_str(ptr)
        env = _json.loads(text)
        st_map = {0: Status.PASS, 1: Status.FAIL, 2: Status.SKIP}
        statuses = {k: st_map[v] for k, v in env["statuses"].items()}
        return env["report"], statuses, st_map[env["overall"]]

    def eval_raw_json(self, content: str) -> List[int]:
        """Per-rule statuses straight from raw JSON document text — no
        Python-side load or serialization (the sweep / fail-rerun JSON
        fast path; typing matches the location-aware loader's)."""
        return self.eval_wire(content.encode("utf-8"), raw=True)

    def eval_wire(self, wire: bytes, raw: bool = False) -> List[int]:
        handle = self._handle_for_thread()
        err = ctypes.c_char_p()
        buf = (ctypes.c_int32 * max(self.n_rules, 1))()
        entry = self._lib.guard_oracle_eval_raw if raw else self._lib.guard_oracle_eval
        n = entry(handle, wire, buf, len(buf), ctypes.byref(err))
        if n < 0:
            msg = _consume_err(self._lib, err)
            if msg.startswith("unsupported:"):
                raise NativeUnsupported(msg)
            raise NativeEvalError(msg[len("error: "):] if msg.startswith("error: ") else msg)
        return [int(buf[i]) for i in range(n)]


def overall_status(statuses: List[int]) -> int:
    """eval_rules_file aggregation (evaluator.py:1533-1564): FAIL if any
    rule failed, else PASS if any passed, else SKIP."""
    if any(s == 1 for s in statuses):
        return 1
    if any(s == 0 for s in statuses):
        return 0
    return 2

"""The compiled-plan artifact layer: lower once, relocate per run.

The port's copy of guard_tpu/ops/plan.py. It sits between rule parsing
and dispatch:

1. **Interner-canonical lowering** (`build_plan`): each rule file is
   lowered ONCE against a rule-local canonical `Interner` that starts
   EMPTY — lowering only ever *looks up* document strings (absent
   literals bind to the never-matching id through the runtime
   `lit_values` array), so every bit table starts at length 0 and the
   compiled IR is corpus-independent. The pack plan (membership,
   segment offsets, `RimSpec`) is computed here too, so a warm run
   skips `pack_compiled` as well.

2. **Relocation** (`relocate_batch`): the shared encode arrives in its
   own interner namespace as one DocBatch per node bucket; relocation
   interns its strings into the plan interner once, builds one (encode
   id -> plan id) table, remaps every bucket's id columns with it
   (`encoder.remap_interned_ids`, once per column), and extends the
   plan's bit tables over just the newly appended strings
   (`ir.extend_bit_tables`, driven by the recorded `bit_specs`
   predicates). `device_arrays` gathers bit tables on the host, so
   table growth never reaches the walk.

3. **Content-addressed disk artifacts** (`get_plan`): the canonical
   plan (still-empty interner + lowered IR + packs) is pickled under
   `GUARD_TPU_PLAN_CACHE_DIR` (default `~/.cache/guard_tpu_torch/plans`)
   keyed by a sha256 over the port's name, version and sources
   (`source_digest`), the artifact schema, the device (`cuda:<card name>` and the card count, or `cpu`),
   the bucket ladder, the pack ceiling and the rule-file bytes in order.
   A fresh process with a warm cache performs zero lowering passes.
   Corrupt or mismatched artifacts are MISSES, never errors, and an
   artifact is unpickled only into this package's, numpy's and the
   standard containers' classes: anything else (the JAX package's
   artifact among them) is refused as unreadable, never imported.

Escape hatch: `--no-plan-cache` bypasses the layer entirely (lowering per run, bit-identical output).
Function-variable rule files keep their excluded-from-packing slow
path: they encode with their function values and lower per run against
the plan interner.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import pickle
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.faults import maybe_fail
from ..utils.telemetry import REGISTRY as _TELEMETRY
from ..utils.telemetry import span as _span
from .encoder import Interner, remap_interned_ids
from .ir import (
    CompiledRules,
    PackedRules,
    RimSpec,
    compile_rules_file,
    extend_bit_tables,
    pack_compatible,
)

log = logging.getLogger("guard_tpu_torch.plan")

#: bump when the pickled artifact layout changes — old artifacts then
#: key to different digests and age out as misses.
PLAN_SCHEMA_VERSION = 1

#: plan-cache counters, the telemetry group "plan_cache" under the JAX
#: package's names: `hits` counts
#: in-process memo AND disk loads, `misses` full builds, `relocations`
#: relocate_batch passes, `artifacts_saved` / `bytes_loaded` the disk
#: traffic. The three `corrupt_*` counters split load failures by
#: cause: torn writes and refused classes (`unreadable`), stale layouts
#: (`version_mismatch`), a named invariant failed (`verify`).
PLAN_COUNTERS = _TELEMETRY.counter_group("plan_cache", {
    "hits": 0,
    "misses": 0,
    "relocations": 0,
    "artifacts_saved": 0,
    "bytes_loaded": 0,
    "corrupt_unreadable": 0,
    "corrupt_version_mismatch": 0,
    "corrupt_verify": 0,
})


def plan_stats() -> dict:
    return _TELEMETRY.group_stats("plan_cache")


def reset_plan_stats() -> None:
    _TELEMETRY.reset_group("plan_cache")


def plan_cache_dir() -> Path:
    d = os.environ.get("GUARD_TPU_PLAN_CACHE_DIR", "").strip()
    if d:
        return Path(d)
    return Path(os.path.expanduser("~")) / ".cache" / "guard_tpu_torch" / "plans"


#: the port's source files whose bytes key every plan and result:
#: Python modules and the CUDA and C++ sources its kernels and native
#: libraries are built from
_SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".cc", ".h", ".hpp")
_SOURCE_DIGEST: Optional[str] = None


def source_digest() -> str:
    """sha256 over the port's own sources (relative path and bytes of
    every file under guard_tpu_torch/ with a _SOURCE_SUFFIXES suffix,
    in path order, then the native oracle's C++ source), computed once
    per process. It keys plans and,
    through plan_digest, results: a change to any module or kernel
    source turns every stored plan and result into a miss, where the
    version string alone would replay what older code computed."""
    global _SOURCE_DIGEST
    if _SOURCE_DIGEST is None:
        root = Path(__file__).resolve().parent.parent
        h = hashlib.sha256()
        for path in sorted(root.rglob("*")):
            if path.suffix in _SOURCE_SUFFIXES and "__pycache__" not in path.parts:
                h.update(path.relative_to(root).as_posix().encode() + b"\0")
                h.update(hashlib.sha256(path.read_bytes()).digest())
        from .native_oracle import SOURCE as oracle_source

        if oracle_source.exists():
            h.update(hashlib.sha256(oracle_source.read_bytes()).digest())
        _SOURCE_DIGEST = h.hexdigest()
    return _SOURCE_DIGEST


def _device_fingerprint(device=None) -> Tuple[str, int]:
    """(device kind, device count) for the cache key: the card's name
    and the number of cards for a CUDA device, ("cpu", 1) otherwise."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return "cuda:" + torch.cuda.get_device_name(dev), torch.cuda.device_count()
    return dev.type, 1


def plan_key(
    rule_files,
    device_kind: Optional[str] = None,
    device_count: Optional[int] = None,
    schema_version: int = PLAN_SCHEMA_VERSION,
    buckets=None,
    pack_max_rules: Optional[int] = None,
    device=None,
) -> str:
    """Content address of a plan: sha256 over everything the canonical
    artifact depends on, domain-separated from the JAX package's keys.
    The pack plan is a pure function of the rule bytes in order plus
    `PACK_MAX_RULES`; bucket shape and device kind/count key what a warm
    process runs the plan on (`device`, when the kind and count are not
    given), and `source_digest` the code that lowers and runs it. File
    NAMES are excluded — the artifact stores none, so
    byte-identical registries share."""
    from .. import __version__
    from .backend import PACK_MAX_RULES
    from .encoder import NODE_BUCKETS_EXTENDED

    if device_kind is None or device_count is None:
        dk, dc = _device_fingerprint(device)
        device_kind = dk if device_kind is None else device_kind
        device_count = dc if device_count is None else device_count
    if buckets is None:
        buckets = NODE_BUCKETS_EXTENDED
    if pack_max_rules is None:
        pack_max_rules = PACK_MAX_RULES
    h = hashlib.sha256()
    h.update(b"guard_tpu_torch;")
    h.update(f"schema={schema_version};".encode())
    h.update(f"version={__version__};".encode())
    h.update(f"source={source_digest()};".encode())
    h.update(f"device={device_kind}x{device_count};".encode())
    h.update(f"buckets={tuple(buckets)};".encode())
    h.update(f"pack_max_rules={pack_max_rules};".encode())
    for rf in rule_files:
        content = rf.content.encode() if isinstance(rf.content, str) else rf.content
        h.update(hashlib.sha256(content).digest())
    return h.hexdigest()


@dataclass
class RulePlan:
    """One registry's canonical compiled program. `interner` starts
    empty and grows monotonically as runs relocate into it; the on-disk
    artifact is saved BEFORE first use so it stays corpus-independent.
    `compiled[i]` is rule file i's lowered IR, or None for
    function-variable files (lowered per run against this interner).
    `packs` holds the precomputed >= 2-member pack plan: (member file
    positions, PackedRules, RimSpec)."""

    interner: Interner
    compiled: List[Optional[CompiledRules]]
    slow: List[int] = field(default_factory=list)
    packs: List[Tuple[tuple, PackedRules, RimSpec]] = field(default_factory=list)
    digest: str = ""
    # per-file anchor signatures (analysis/signatures.PlanSignatures),
    # None when extraction failed — never a correctness dependency
    signatures: Optional[object] = None

    def all_compiled(self) -> List[CompiledRules]:
        """Every CompiledRules whose bit tables must track the plan
        interner — the per-file programs plus each pack's fused program
        (pack_compiled aliases the underlying arrays, so
        extend_bit_tables' id-memo grows each one exactly once)."""
        parts = [c for c in self.compiled if c is not None]
        parts.extend(p.compiled for _pos, p, _spec in self.packs)
        return parts

    def prepacked_items(self):
        """The pack list backend.dispatch_packs takes as `prepacked`:
        [(pack, PackedRules, RimSpec)] with pack = [(file_idx,
        CompiledRules)]."""
        return [
            ([(fi, self.compiled[fi]) for fi in pos], packed, spec)
            for pos, packed, spec in self.packs
        ]


def build_plan(rule_files) -> RulePlan:
    """Lower + pack the registry once against a fresh empty interner."""
    from .backend import plan_packs
    from .fnvars import precomputable_fn_vars
    from .ir import pack_compiled

    interner = Interner()
    compiled: List[Optional[CompiledRules]] = []
    slow: List[int] = []
    with _span("lower_compile", {"files": len(rule_files), "mode": "plan"}):
        for fi, rf in enumerate(rule_files):
            if precomputable_fn_vars(rf.rules):
                # function-variable files encode the documents with their
                # function results before lowering — per run, slow path
                compiled.append(None)
                slow.append(fi)
                continue
            compiled.append(compile_rules_file(rf.rules, interner))
    items = [
        (fi, c) for fi, c in enumerate(compiled)
        if c is not None and pack_compatible(c) is None
    ]
    packs = []
    for pack in plan_packs(items):
        if len(pack) < 2:
            continue  # a singleton pack gains nothing over per-file
        with _span("pack_compile", {"files": len(pack), "mode": "plan"}):
            packed = pack_compiled([c for _fi, c in pack])
            spec = packed.rim_spec()
        packs.append((tuple(fi for fi, _c in pack), packed, spec))
    try:
        from ..analysis.signatures import extract_plan_signatures

        signatures = extract_plan_signatures(rule_files)
    except Exception as e:  # advisory: a plan without anchors still runs
        log.warning("anchor-signature extraction failed (%s); plan "
                    "carries no signatures", e)
        signatures = None
    return RulePlan(interner=interner, compiled=compiled, slow=slow, packs=packs,
                    signatures=signatures)


def relocate_batch(plan: RulePlan, batches, chunk_interner: Interner,
                   verify: bool = True) -> None:
    """Move the DocBatches of one encode (the per-bucket batches of the
    shared encode, all in `chunk_interner`'s namespace) into the plan's
    id namespace, in place: intern every encode string into the plan
    interner once, remap each batch's id columns through the one
    resulting table (each column array exactly once, even where two
    batches hold the same array), drop any canonical struct ids computed
    from the old ids, then extend the plan's bit tables over whatever
    the interner just gained. Serialized under PLAN_LOCK.

    With `verify` the cheap relocation
    invariants run per batch after the extend; a violation is an
    in-process relocation bug, raised as a PlanVerifyError."""
    batches = list(batches)
    with PLAN_LOCK, _span("relocate", {"docs": sum(b.n_docs for b in batches)}):
        strings = chunk_interner.strings
        if strings:
            remap = np.fromiter(
                (plan.interner.intern(s) for s in strings),
                dtype=np.int32, count=len(strings),
            )
            seen = set()
            for batch in batches:
                if id(batch) in seen:
                    continue
                seen.add(id(batch))
                remap_interned_ids(batch, remap)
                batch._struct_ids = None  # keyed by the old ids
        extend_bit_tables(plan.all_compiled(), plan.interner)
        PLAN_COUNTERS["relocations"] += 1
        if verify:
            from ..analysis.verify import PlanVerifyError, verify_relocation

            for batch in batches:
                violations = verify_relocation(plan, batch)
                if violations:
                    raise PlanVerifyError(violations)


# -- in-process memo + on-disk artifacts ------------------------------------

# digest -> RulePlan. Values are the live (grown) plans that the runs
# of one process share. Small LRU: a plan holds the registry's whole
# lowered IR.
_PLAN_MEMO: "OrderedDict[str, RulePlan]" = OrderedDict()
_PLAN_MEMO_MAX = 8

#: one lock for the memo/key caches AND relocation
PLAN_LOCK = threading.RLock()

# (rule_files identity, device) -> digest, so repeated lookups skip
# re-hashing the registry bytes. Values keep the RuleFile objects alive
# so ids cannot be recycled under the cache.
_KEY_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_KEY_CACHE_MAX = 8


def clear_plan_memo() -> None:
    """Drop the in-process plan memo and key cache (tests, and a
    simulated process restart). Disk artifacts survive."""
    _PLAN_MEMO.clear()
    _KEY_CACHE.clear()


def _digest_for(rule_files, device=None) -> str:
    with PLAN_LOCK:
        ident = (tuple(id(rf) for rf in rule_files), str(device))
        hit = _KEY_CACHE.get(ident)
        if hit is not None:
            _KEY_CACHE.move_to_end(ident)
            return hit[1]
        digest = plan_key(rule_files, device=device)
        _KEY_CACHE[ident] = (list(rule_files), digest)
        while len(_KEY_CACHE) > _KEY_CACHE_MAX:
            _KEY_CACHE.popitem(last=False)
        return digest


def plan_digest(rule_files, device=None) -> str:
    """Public face of the plan-cache key (the content digest a result
    cache or a coalescing batcher keys on)."""
    return _digest_for(rule_files, device)


def _artifact_path(digest: str) -> Path:
    return plan_cache_dir() / f"{digest}.plan"


def save_plan(plan: RulePlan, digest: str) -> bool:
    """Serialize a canonical plan; atomic (tmp + rename) so concurrent
    writers and torn writes can only ever produce a whole artifact or a
    miss. Failures warn and return False — persistence is an
    optimization, never a correctness dependency."""
    with _span("save_plan"):
        try:
            # the persistence seam's fault point: an injected store_write
            # fault downgrades to a cache-off warning like a real ENOSPC
            maybe_fail("store_write", key=digest)
            payload = {
                "schema": PLAN_SCHEMA_VERSION,
                "version": _port_version(),
                "digest": digest,
                "plan": plan,
            }
            blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
            path = _artifact_path(digest)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp.{os.getpid()}")
            tmp.write_bytes(blob)
            os.replace(tmp, path)
        except Exception as e:
            log.warning("plan artifact save failed (%s); continuing "
                        "without persistence", e)
            return False
        _save_signature_sidecar(plan, digest, path)
        PLAN_COUNTERS["artifacts_saved"] += 1
        return True


def _save_signature_sidecar(plan: RulePlan, digest: str, path: Path) -> None:
    """The readable face of the artifact's anchor signatures:
    `<digest>.sigs.json` beside the pickle. Best-effort, like the
    artifact itself."""
    if getattr(plan, "signatures", None) is None:
        return
    try:
        import json

        from ..analysis.signatures import signatures_payload

        sidecar = path.with_name(f"{digest}.sigs.json")
        tmp = sidecar.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(signatures_payload(plan, digest), indent=1,
                                  sort_keys=True))
        os.replace(tmp, sidecar)
    except Exception as e:
        log.warning("signature sidecar save failed (%s)", e)


#: the only modules an artifact may name: this package's classes,
#: numpy's arrays and dtypes, and the builtin containers
_ARTIFACT_MODULES = ("guard_tpu_torch", "numpy", "builtins", "collections")


class _ArtifactUnpickler(pickle.Unpickler):
    """An Unpickler that resolves no class outside _ARTIFACT_MODULES: an
    artifact naming another module (the JAX package's RulePlan, say) is
    refused before anything is imported."""

    def find_class(self, module, name):
        if module.split(".", 1)[0] not in _ARTIFACT_MODULES:
            raise pickle.UnpicklingError(
                f"artifact names {module}.{name}, outside {', '.join(_ARTIFACT_MODULES)}"
            )
        return super().find_class(module, name)


class _LoadReject(Exception):
    """Internal: a load failure tagged with its cause label —
    `unreadable` (IO / torn pickle / a refused class),
    `version-mismatch` (stale schema/version/digest/type) or
    `verify:<invariant>` (a named invariant failed on an otherwise
    readable artifact)."""

    def __init__(self, cause: str, counter: str, detail: str):
        self.cause = cause
        self.counter = counter
        super().__init__(detail)


def load_plan(digest: str, verify: bool = True) -> Optional[RulePlan]:
    """Deserialize a plan artifact, or None on ANY problem — absent
    file, truncated pickle, a class outside the port, schema/version/
    digest mismatch, or (with `verify` on) a failed invariant check. A
    corrupt artifact logs a warning NAMING the failure cause, bumps the
    matching `corrupt_*` counter, and counts as a miss; it is rewritten
    by the save after the rebuild."""
    path = _artifact_path(digest)
    with _span("load_plan"):
        try:
            try:
                if not path.exists():
                    return None
                blob = path.read_bytes()
                payload = _ArtifactUnpickler(io.BytesIO(blob)).load()
            except Exception as e:
                raise _LoadReject("unreadable", "corrupt_unreadable", str(e)) from e
            if not isinstance(payload, dict):
                raise _LoadReject("version-mismatch", "corrupt_version_mismatch",
                                  "artifact payload is not a dict")
            if payload.get("schema") != PLAN_SCHEMA_VERSION:
                raise _LoadReject(
                    "version-mismatch", "corrupt_version_mismatch",
                    f"schema {payload.get('schema')!r} != {PLAN_SCHEMA_VERSION}",
                )
            if payload.get("version") != _port_version():
                raise _LoadReject("version-mismatch", "corrupt_version_mismatch",
                                  "guard_tpu_torch version mismatch")
            if payload.get("digest") != digest:
                raise _LoadReject("version-mismatch", "corrupt_version_mismatch",
                                  "digest mismatch")
            plan = payload.get("plan")
            if not isinstance(plan, RulePlan):
                raise _LoadReject("version-mismatch", "corrupt_version_mismatch",
                                  "artifact plan is not a RulePlan")
            if verify:
                from ..analysis.verify import verify_plan

                violations = verify_plan(plan)
                if violations:
                    raise _LoadReject(
                        f"verify:{violations[0].invariant}", "corrupt_verify",
                        "; ".join(str(v) for v in violations),
                    )
        except _LoadReject as e:
            log.warning(
                "plan artifact %s unusable (cause=%s: %s); treating as "
                "a cache miss", path.name, e.cause, e,
            )
            PLAN_COUNTERS[e.counter] += 1
            return None
        PLAN_COUNTERS["bytes_loaded"] += len(blob)
        return plan


def _port_version() -> str:
    from .. import __version__

    return __version__


def _memo_store(digest: str, plan: RulePlan) -> None:
    _PLAN_MEMO[digest] = plan
    _PLAN_MEMO.move_to_end(digest)
    while len(_PLAN_MEMO) > _PLAN_MEMO_MAX:
        _PLAN_MEMO.popitem(last=False)


def get_plan(rule_files, use_disk: bool = True, verify: bool = True,
             device=None) -> RulePlan:
    """The layer's one entry point: in-process memo, then the disk
    artifact, then a full build (saved back when `use_disk`). `device` is the
    device the plan will run on (it keys the artifact).

    `verify` runs the plan/IR verifier:
    a disk artifact failing verification is a logged miss (load_plan),
    a FRESH build failing is a miscompile in this process and raises
    PlanVerifyError."""
    with PLAN_LOCK:
        digest = _digest_for(rule_files, device)
        plan = _PLAN_MEMO.get(digest)
        if plan is not None:
            _PLAN_MEMO.move_to_end(digest)
            PLAN_COUNTERS["hits"] += 1
            return plan
        if use_disk:
            plan = load_plan(digest, verify=verify)
            if plan is not None:
                plan.digest = digest
                PLAN_COUNTERS["hits"] += 1
                _memo_store(digest, plan)
                return plan
        plan = build_plan(rule_files)
        plan.digest = digest
        if verify:
            from ..analysis.verify import PlanVerifyError, verify_plan

            violations = verify_plan(plan)
            if violations:
                raise PlanVerifyError(violations)
        PLAN_COUNTERS["misses"] += 1
        if use_disk:
            # saved BEFORE first relocation: the artifact's interner is
            # still empty, keeping it corpus-independent
            save_plan(plan, digest)
        _memo_store(digest, plan)
        return plan

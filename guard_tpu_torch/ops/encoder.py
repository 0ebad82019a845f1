"""Columnar document encoder: PV trees -> padded int32 arrays.

A copy of the JAX package's Python encoder (ops/encoder.py). Where
that package pads a batch to its largest document, the port encodes
per size bucket (`encode_bucketed`), from document trees or from the
ragged columns of its native encoder (`groups_from_ragged`,
ops/native_encoder.py); `encode_chunk_texts` picks between the two for
raw texts, and the bucket groups of several shards merge in document
order (`merge_bucket_groups`, parallel/ingest.py).

The device evaluation path never touches Python objects: a batch of parsed
documents is flattened into fixed-shape arrays (SURVEY.md §7, north-star
"documents -> padded columnar arrays"):

  * node columns: kind, parent, scalar-id, numeric value;
  * edge columns (parent -> child): parent, child, key-id (interned map
    key), list index;
  * one shared string-intern table across the batch, so string equality
    becomes integer equality and each regex in the rule set is matched
    ONCE per unique string on the host — the kernel just gathers bits.

Documents are padded to the batch maxima (buckets are handled a level
up), so the whole batch is a single `vmap`-able pytree of arrays.

Replaces the pointer-chasing recursive walk of the reference's
`PathAwareValue` traversal (`guard/src/rules/
eval_context.rs:337-924`) with data-parallel scatter/gather over these
arrays (see ops/kernels.py).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.values import (
    BOOL,
    CHAR,
    FLOAT,
    INT,
    LIST,
    MAP,
    NULL,
    RANGE_FLOAT,
    RANGE_INT,
    REGEX,
    STRING,
    PV,
    compiled_regex,
)


_BIAS32 = 1 << 31
_BIAS64 = 1 << 63


def num_key(kind: int, v) -> Optional[Tuple[int, int]]:
    """Order-preserving exact (hi, lo) int32 pair for a numeric value.

    The device compares numbers EXACTLY — the reference compares native
    i64/f64 (`guard/src/rules/path_value.rs:1071-1191`)
    and float32 columns silently collide above 2^24:

      * INT / BOOL: the i64 value biased to u64, split into two int32
        lanes (hi signed-biased, lo biased) — lexicographic (hi, lo)
        compare == exact i64 compare, for ALL i64 values;
      * FLOAT: the f64 bit pattern mapped through the standard monotone
        key (negative values bit-flipped, positives sign-set), -0.0
        collapsed to 0.0 — lexicographic compare == exact IEEE total
        order restricted to non-NaN values.

    Returns None when no exact encoding exists (NaN, ints outside i64):
    the encoder flags the whole document `num_exotic` and the backend
    routes it to the CPU oracle, never deciding it on device.
    """
    if kind == FLOAT:
        fv = float(v)
        if math.isnan(fv):
            return None
        if fv == 0.0:
            fv = 0.0  # collapse -0.0 so -0.0 == 0.0 holds
        b = struct.unpack("<Q", struct.pack("<d", fv))[0]
        u = (b ^ 0xFFFFFFFFFFFFFFFF) if (b >> 63) else (b | _BIAS64)
    else:
        iv = int(v)
        if iv < -_BIAS64 or iv >= _BIAS64:
            return None
        u = iv + _BIAS64
    return int((u >> 32) - _BIAS32), int((u & 0xFFFFFFFF) - _BIAS32)


class Interner:
    """Shared string table. Key ids and scalar-string ids share one
    namespace so `keys ==` filters work on the same table."""

    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._strings: List[str] = []

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strings)
            self._ids[s] = i
            self._strings.append(s)
        return i

    def lookup(self, s: str) -> int:
        """-1 when the string is absent from the corpus (a literal that
        can never match by equality)."""
        return self._ids.get(s, -1)

    @property
    def strings(self) -> List[str]:
        return self._strings

    def __len__(self) -> int:
        return len(self._strings)

    @classmethod
    def from_strings(cls, strings: List[str]) -> "Interner":
        """Rebuild an interner from its string table (the picklable
        wire form ingest workers ship across the process boundary)."""
        it = cls()
        it._strings = list(strings)
        it._ids = {s: i for i, s in enumerate(it._strings)}
        return it

    def regex_match_bits(self, pattern: str) -> np.ndarray:
        """(S,) bool: does `pattern` match each interned string —
        host-precomputed so the TPU kernel only gathers."""
        rx = compiled_regex(pattern)
        return np.array(
            [rx.search(s) is not None for s in self._strings], dtype=bool
        )

    def substring_bits(self, needle_id_unused: int, needle: str) -> np.ndarray:
        """(S,) bool: is each interned string a substring of `needle`?
        The IN operator's string-containment case is `lhs.val in
        rhs.val` with lhs the document value (operators.rs:218-230)."""
        return np.array([s in needle for s in self._strings], dtype=bool)


@dataclass
class EncodedDoc:
    """Flat columnar form of one document."""

    node_kind: np.ndarray  # (n,) int32, PV kind; -1 padding
    node_parent: np.ndarray  # (n,) int32, -1 for root
    scalar_id: np.ndarray  # (n,) int32 intern id for STRING/REGEX/CHAR else -1
    num_hi: np.ndarray  # (n,) int32 exact numeric key, high lane (num_key)
    num_lo: np.ndarray  # (n,) int32 exact numeric key, low lane
    child_count: np.ndarray  # (n,) int32 (len of list / size of map)
    edge_parent: np.ndarray  # (e,) int32
    edge_child: np.ndarray  # (e,) int32
    edge_key_id: np.ndarray  # (e,) int32 interned key, -1 for list elems
    edge_index: np.ndarray  # (e,) int32 list index, -1 for map entries
    n_nodes: int
    n_edges: int
    # document contains a number with no exact device encoding (NaN or
    # an int outside i64): must be evaluated by the CPU oracle
    num_exotic: bool = False
    # (slot, root node index, origin node index) of each precomputed
    # function-result ROOT (ops/fnvars.py): orphan subtrees appended
    # after the document, tagged post-batch with the reserved
    # fn_key_id(slot). origin = -1 for shared (root-basis) slots;
    # per-origin slots ('pexpr') carry the candidate node the result
    # belongs to (the fn_origin column the kernels select by)
    fn_roots: list = field(default_factory=list)
    # a per-origin result's origin path did not map back to a node —
    # cannot happen for origins enumerated from this same tree, but if
    # it ever does the document must route to the CPU oracle rather
    # than silently losing its RHS
    fn_origin_miss: bool = False


def encode_document(
    doc: PV, interner: Interner, fn_results=None
) -> EncodedDoc:
    kinds: List[int] = []
    parents: List[int] = []
    scalar_ids: List[int] = []
    num_his: List[int] = []
    num_los: List[int] = []
    child_counts: List[int] = []
    e_parent: List[int] = []
    e_child: List[int] = []
    e_key: List[int] = []
    e_index: List[int] = []
    exotic = [False]
    # origin-path -> node index, only built when a per-origin function
    # result needs mapping back to its candidate node
    # record paths during the MAIN doc visit only (result subtrees
    # carry fabricated paths that must not shadow document nodes).
    # Paths are unescaped slash-joined strings, so a map KEY containing
    # '/' can collide with a genuinely nested path — colliding docs
    # set the miss flag and route to the oracle instead of silently
    # mapping an origin to the wrong node (review finding, round 5)
    # fn_results entries are always (slot, pv, origin_path-or-None)
    want_paths = [any(fr[2] is not None for fr in fn_results or [])]
    path_idx: dict = {}
    path_dup = [False]

    def push_num(kind: int, v) -> None:
        key = num_key(kind, v)
        if key is None:
            exotic[0] = True
            key = (0, 0)
        num_his.append(key[0])
        num_los.append(key[1])

    def visit(pv: PV, parent: int) -> int:
        idx = len(kinds)
        if want_paths[0]:
            if pv.path.s in path_idx:
                path_dup[0] = True
            path_idx[pv.path.s] = idx
        kinds.append(pv.kind)
        parents.append(parent)
        k = pv.kind
        if k in (STRING, REGEX, CHAR):
            scalar_ids.append(interner.intern(pv.val))
            num_his.append(0)
            num_los.append(0)
            child_counts.append(0)
        elif k == INT or k == FLOAT:
            scalar_ids.append(-1)
            push_num(k, pv.val)
            child_counts.append(0)
        elif k == BOOL:
            scalar_ids.append(-1)
            push_num(INT, 1 if pv.val else 0)
            child_counts.append(0)
        elif k == NULL:
            scalar_ids.append(-1)
            num_his.append(0)
            num_los.append(0)
            child_counts.append(0)
        elif k == LIST:
            scalar_ids.append(-1)
            num_his.append(0)
            num_los.append(0)
            child_counts.append(len(pv.val))
            for i, item in enumerate(pv.val):
                ci = visit(item, idx)
                e_parent.append(idx)
                e_child.append(ci)
                e_key.append(-1)
                e_index.append(i)
        elif k == MAP:
            mv = pv.val
            scalar_ids.append(-1)
            num_his.append(0)
            num_los.append(0)
            child_counts.append(len(mv.values))
            for key_node in mv.keys:
                child = mv.values.get(key_node.val)
                if child is None:
                    continue
                ci = visit(child, idx)
                e_parent.append(idx)
                e_child.append(ci)
                e_key.append(interner.intern(key_node.val))
                e_index.append(-1)
        else:  # ranges never appear in documents
            scalar_ids.append(-1)
            num_his.append(0)
            num_los.append(0)
            child_counts.append(0)
        return idx

    visit(doc, -1)
    # precomputed function results: orphan subtrees (parent -1 -> no
    # traversal step ever reaches them; internal edges are real so
    # walks INTO the results work normally)
    want_paths[0] = False
    fn_roots = []
    origin_miss = path_dup[0]
    for slot, pv, opath in fn_results or []:
        if opath is None:
            origin = -1
        elif origin_miss:
            continue  # ambiguous path space: doc goes to the oracle
        else:
            origin = path_idx.get(opath, -2)
            if origin == -2:
                origin_miss = True
                continue
        fn_roots.append((slot, visit(pv, -1), origin))
    return EncodedDoc(
        fn_roots=fn_roots,
        fn_origin_miss=origin_miss,
        node_kind=np.array(kinds, dtype=np.int32),
        node_parent=np.array(parents, dtype=np.int32),
        scalar_id=np.array(scalar_ids, dtype=np.int32),
        num_hi=np.array(num_his, dtype=np.int32),
        num_lo=np.array(num_los, dtype=np.int32),
        child_count=np.array(child_counts, dtype=np.int32),
        edge_parent=np.array(e_parent, dtype=np.int32),
        edge_child=np.array(e_child, dtype=np.int32),
        edge_key_id=np.array(e_key, dtype=np.int32),
        edge_index=np.array(e_index, dtype=np.int32),
        n_nodes=len(kinds),
        n_edges=len(e_parent),
        num_exotic=exotic[0],
    )


@dataclass
class DocBatch:
    """Batch of encoded documents padded to common (N, E) shapes.

    All arrays have a leading doc axis — the axis that gets DP-sharded
    across the device (parallel/device.py).

    On construction three derived *per-node* columns are computed from
    the edge arrays. They fold each node's unique parent edge into the
    node itself, which is what lets the kernels run entirely on
    elementwise ops + one-hot parent compares — device-side gathers are
    catastrophically slow on TPU (measured ~150x a fused masked
    reduction at these shapes), so every array the kernel indexes by a
    *data-dependent* index is instead precomputed host-side:

      * ``node_key_id``     (D, N): intern id of the map key under
        which this node sits (-1 for list elements, -2 for the root
        and padding);
      * ``node_index``      (D, N): list index of this node in its
        parent (-1 for map entries, -2 for root/padding);
      * ``node_parent_kind`` (D, N): node kind of the parent (-1 for
        root/padding).
    """

    node_kind: np.ndarray  # (D, N) int32; -1 padding
    node_parent: np.ndarray  # (D, N)
    scalar_id: np.ndarray  # (D, N)
    num_hi: np.ndarray  # (D, N) int32 exact numeric key, high lane (num_key)
    num_lo: np.ndarray  # (D, N) int32 exact numeric key, low lane
    child_count: np.ndarray  # (D, N)
    edge_parent: np.ndarray  # (D, E); padding edges point at node N-? no: -1
    edge_child: np.ndarray  # (D, E)
    edge_key_id: np.ndarray  # (D, E)
    edge_index: np.ndarray  # (D, E)
    edge_valid: np.ndarray  # (D, E) bool
    n_docs: int
    n_nodes: int
    n_edges: int
    node_key_id: np.ndarray = None  # (D, N) derived, see class docstring
    node_index: np.ndarray = None  # (D, N) derived
    node_parent_kind: np.ndarray = None  # (D, N) derived
    # (D,) bool: doc has a number with no exact device encoding (NaN or
    # beyond-i64 int); such docs route to the CPU oracle like oversize
    # ones (split_batch_by_size) so the device never decides them
    num_exotic: np.ndarray = None
    # (D, N) int32, only when the batch carries per-origin function
    # results (ops/fnvars.py 'pexpr' slots): the candidate node index a
    # result root belongs to, -1 everywhere else. None when no
    # per-origin slot exists — the column ships to the device only for
    # rule files that read it (ir.CompiledRules.needs_fn_origin)
    fn_origin: np.ndarray = None

    def __post_init__(self):
        if self.num_exotic is None:
            self.num_exotic = np.zeros(self.node_kind.shape[0], dtype=bool)
        if self.node_key_id is not None:
            return
        d, n = self.node_kind.shape
        # scatter each edge's attributes onto its child node; invalid
        # padding edges all have child 0 (the root), which is fixed up
        # after the scatter — the root has no parent edge
        self.node_key_id = np.full((d, n), -2, dtype=np.int32)
        np.put_along_axis(self.node_key_id, self.edge_child, self.edge_key_id, axis=1)
        self.node_key_id[:, 0] = -2
        self.node_index = np.full((d, n), -2, dtype=np.int32)
        np.put_along_axis(self.node_index, self.edge_child, self.edge_index, axis=1)
        self.node_index[:, 0] = -2
        pk = np.take_along_axis(self.node_kind, np.maximum(self.edge_parent, 0), axis=1)
        self.node_parent_kind = np.full((d, n), -1, dtype=np.int32)
        np.put_along_axis(self.node_parent_kind, self.edge_child, pk, axis=1)
        self.node_parent_kind[:, 0] = -1

    def arrays(self, include_struct: bool = False) -> dict:
        out = {
            "node_kind": self.node_kind,
            "node_parent": self.node_parent,
            "scalar_id": self.scalar_id,
            "num_hi": self.num_hi,
            "num_lo": self.num_lo,
            "child_count": self.child_count,
            "edge_parent": self.edge_parent,
            "edge_child": self.edge_child,
            "edge_key_id": self.edge_key_id,
            "edge_index": self.edge_index,
            "edge_valid": self.edge_valid,
            "node_key_id": self.node_key_id,
            "node_index": self.node_index,
            "node_parent_kind": self.node_parent_kind,
        }
        if self.fn_origin is not None:
            out["fn_origin"] = self.fn_origin
        if include_struct:
            out["struct_id"] = self.struct_ids()
        return out

    def struct_ids(self) -> np.ndarray:
        """(D, N) int32 canonical-form ids: two nodes get the same id
        iff they are `loose_eq` (values.loose_eq — strict scalar kinds,
        ordered lists, unordered maps). Used by query-RHS comparisons
        so set membership is an id-equality test on device. Computed
        lazily (only rules with query RHS pay for it) and cached."""
        self._canonicalize()
        return self._struct_ids

    def _canonicalize(self) -> None:
        """Builds BOTH canonical id spaces in one bottom-up pass:
        `_struct_ids` (loose_eq classes, see struct_ids) and
        `_ord_ids` — ORDER-PRESERVING classes where two nodes share an
        id iff `compare_eq(node, lit)` behaves identically for every
        possible literal (map entries keep document insertion order
        because compare_eq short-circuits per entry,
        values.compare_eq:386-399; finer than loose_eq, which collapses
        map order). The ord space feeds the struct-literal tri-state
        tables (struct_literal_tri)."""
        if getattr(self, "_struct_ids", None) is not None:
            return
        d_n = self.node_kind.shape
        out = np.full(d_n, -1, dtype=np.int32)
        oout = np.full(d_n, -1, dtype=np.int32)
        table: dict = {}
        otable: dict = {}
        for di in range(d_n[0]):
            kinds = self.node_kind[di]
            sids = self.scalar_id[di]
            nhi = self.num_hi[di]
            nlo = self.num_lo[di]
            # group children per parent from the edge arrays
            children: dict = {}
            ev = self.edge_valid[di]
            ep = self.edge_parent[di]
            ec = self.edge_child[di]
            ek = self.edge_key_id[di]
            ei = self.edge_index[di]
            for e in range(self.edge_parent.shape[1]):
                if not ev[e]:
                    continue
                children.setdefault(int(ep[e]), []).append(
                    (int(ei[e]), int(ek[e]), int(ec[e]))
                )
            # children always have higher indices than their parent
            # (encoder visit order), so a reverse scan is bottom-up
            for i in range(d_n[1] - 1, -1, -1):
                k = int(kinds[i])
                if k < 0:
                    continue
                if k == LIST:
                    elems = sorted(children.get(i, []))
                    key = ("l",) + tuple(int(out[di, c]) for _, _, c in elems)
                    okey = ("L",) + tuple(int(oout[di, c]) for _, _, c in elems)
                elif k == MAP:
                    entries = children.get(i, [])
                    key = ("m", frozenset(
                        (kid, int(out[di, c])) for _, kid, c in entries
                    ))
                    # encoder visit order == document insertion order
                    # (child node index ascends in insertion order)
                    okey = ("M",) + tuple(
                        (kid, int(oout[di, c]))
                        for _, kid, c in sorted(entries, key=lambda t: t[2])
                    )
                elif k in (STRING, REGEX, CHAR):
                    key = ("s", int(sids[i]))
                    okey = key
                elif k in (INT, FLOAT, BOOL):
                    # the exact key pair: no float32 collisions
                    key = (k, int(nhi[i]), int(nlo[i]))
                    okey = key
                else:  # NULL
                    key = ("n",)
                    okey = key
                sid = table.get(key)
                if sid is None:
                    sid = len(table)
                    table[key] = sid
                out[di, i] = sid
                oid = otable.get(okey)
                if oid is None:
                    oid = len(otable)
                    otable[okey] = oid
                oout[di, i] = oid
        self._struct_ids = out
        self._struct_table = table
        self._ord_ids = oout
        self._ord_table = otable

    def struct_literal_tri(self, literals, interner) -> list:
        """Per struct literal: ((D, N) match, (D, N) comparable,
        (D, N) loose_match) bool columns.

        match/comparable carry exact `compare_eq(doc_node, literal)`
        tri-state semantics (path_value.rs:1071-1146 incl. regex
        matching inside maps, range membership, and NotComparable
        propagation with the reference's per-entry short-circuit
        order); loose_match is `loose_eq(doc_node, literal)`
        (path_value.rs:245-291 — never raises, maps compare values
        order-insensitively via MapValue PartialEq, regex members
        match). Evaluated ONCE per order-preserving canonical class
        (ord_ids) on the host, then broadcast to nodes — the kernel
        reads plain bool columns."""
        self._canonicalize()
        otable = self._ord_table
        strings = interner.strings
        # reconstruct each canonical entry's scalar value lazily from
        # the exact (hi, lo) key (num_key is bijective off NaN)
        T, F, R = 1, 0, 2  # tri-states: True / False / Raise

        def unkey(kind: int, hi: int, lo: int):
            u = ((hi + _BIAS32) << 32) | ((lo + _BIAS32) & 0xFFFFFFFF)
            if kind == FLOAT:
                b = (u ^ _BIAS64) if (u >> 63) else (u ^ 0xFFFFFFFFFFFFFFFF)
                return struct.unpack("<d", struct.pack("<Q", b))[0]
            return u - _BIAS64

        rev = {oid: okey for okey, oid in otable.items()}
        out = []
        for lit in literals:
            memo: Dict[tuple, int] = {}

            def tri(okey, pv) -> int:
                mk = (okey, id(pv))
                got = memo.get(mk)
                if got is not None:
                    return got
                memo[mk] = r = _tri(okey, pv)
                return r

            def _tri(okey, pv) -> int:
                tag = okey[0]
                k = pv.kind
                if tag == "s":  # document STRING node
                    s = strings[okey[1]]
                    if k == STRING:
                        return T if s == pv.val else F
                    if k == REGEX:
                        return T if compiled_regex(pv.val).search(s) else F
                    return R
                if tag == "n":
                    return T if k == NULL else R
                if tag == INT:
                    v = unkey(INT, okey[1], okey[2])
                    if k == INT:
                        return T if v == pv.val else F
                    if k == RANGE_INT:
                        return T if pv.val.contains(v) else F
                    return R
                if tag == FLOAT:
                    v = unkey(FLOAT, okey[1], okey[2])
                    if k == FLOAT:
                        return T if v == pv.val else F
                    if k == RANGE_FLOAT:
                        return T if pv.val.contains(v) else F
                    return R
                if tag == BOOL:
                    v = bool(unkey(INT, okey[1], okey[2]))
                    return (T if v == pv.val else F) if k == BOOL else R
                if tag == "L":
                    if k != LIST:
                        return R
                    elems = okey[1:]
                    if len(elems) != len(pv.val):
                        return F
                    # okey elements here are ord ids: resolve back to
                    # keys via the reverse table built below
                    for oid, e in zip(elems, pv.val):
                        r = tri(rev[oid], e)
                        if r != T:
                            return r
                    return T
                if tag == "M":
                    if k != MAP:
                        return R
                    entries = okey[1:]
                    if len(entries) != len(pv.val.values):
                        return F
                    for kid, oid in entries:
                        v2 = pv.val.values.get(strings[kid])
                        if v2 is None:
                            return F
                        r = tri(rev[oid], v2)
                        if r != T:
                            return r
                    return T
                raise AssertionError(f"canonical tag {tag}")

            lmemo: Dict[tuple, bool] = {}

            def loose(okey, pv) -> bool:
                mk = (okey, id(pv))
                got = lmemo.get(mk)
                if got is not None:
                    return got
                lmemo[mk] = r = _loose(okey, pv)
                return r

            def _loose(okey, pv) -> bool:
                tag = okey[0]
                k = pv.kind
                if tag == "M":
                    # MapValue PartialEq: same size, every doc entry
                    # loose_eq the literal's same-key value
                    if k != MAP:
                        return False
                    entries = okey[1:]
                    if len(entries) != len(pv.val.values):
                        return False
                    for kid, oid in entries:
                        v2 = pv.val.values.get(strings[kid])
                        if v2 is None or not loose(rev[oid], v2):
                            return False
                    return True
                if tag == "L":
                    if k != LIST:
                        return False
                    elems = okey[1:]
                    if len(elems) != len(pv.val):
                        return False
                    return all(
                        loose(rev[oid], e) for oid, e in zip(elems, pv.val)
                    )
                if tag == "s" and k == REGEX:
                    # loose_eq guards regex compile errors itself
                    try:
                        return bool(
                            compiled_regex(pv.val).search(strings[okey[1]])
                        )
                    except Exception:
                        return False
                return tri(okey, pv) == T

            tri_of = np.zeros(max(len(otable), 1), dtype=np.int8)
            loose_of = np.zeros(max(len(otable), 1), dtype=bool)
            for okey, oid in otable.items():
                tri_of[oid] = tri(okey, lit)
                loose_of[oid] = loose(okey, lit)
            ids = self._ord_ids
            safe = np.clip(ids, 0, len(tri_of) - 1)
            vals = np.where(ids >= 0, tri_of[safe], R)
            lvals = np.where(ids >= 0, loose_of[safe], False)
            out.append((vals == T, vals != R, lvals))
        return out



def _round_up(n: int, multiple: int = 8) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


# node-capacity buckets for the kernel path. Small buckets use the
# fused one-hot traversal (O(N^2) lanes per doc per step — fastest
# below kernels.GATHER_MIN_NODES where the compare fuses into the
# consuming reduction); buckets at and above that threshold trace the
# O(N) gather/segment-sum formulation instead, so the per-doc cost
# stays proportional to document size. EVERY rule file uses the
# extended buckets (documents up to 64k nodes stay on device): as of
# round 5 the pairwise constructions (query-RHS compares, variable key
# interpolation — CompiledRules.needs_pairwise) evaluate through
# O(N log N) sorted-set joins in gather mode, which needs_pairwise
# forces above 8,192 nodes, so no (N, N) matrix exists at the big
# buckets. Only documents beyond the last bucket route to the CPU
# oracle (ops/backend.py)
NODE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
NODE_BUCKETS_EXTENDED = NODE_BUCKETS + (16384, 32768, 65536)


def split_batch_by_size(
    batch: DocBatch, buckets: Tuple[int, ...] = NODE_BUCKETS
) -> Tuple[List[Tuple[DocBatch, np.ndarray]], np.ndarray]:
    """Split a batch into per-size-bucket sub-batches so small documents
    are not padded (and evaluated) at the largest document's shape.

    Returns (groups, oversize_doc_indices): each group is (sub_batch,
    doc_indices) with node/edge axes sliced down to the bucket shape —
    exact because padding is always a suffix. Documents larger than the
    biggest bucket — and documents whose numbers have no exact device
    encoding (num_exotic) — are returned in `oversize_doc_indices` for
    CPU-oracle evaluation."""
    n_real = (batch.node_kind >= 0).sum(axis=1)
    e_real = batch.edge_valid.sum(axis=1)
    host_mask = (n_real > buckets[-1]) | batch.num_exotic
    oversize = np.where(host_mask)[0]
    groups: List[Tuple[DocBatch, np.ndarray]] = []
    lo = 0
    for b in buckets:
        idx = np.where((n_real > lo) & (n_real <= b) & ~host_mask)[0]
        lo = b
        if len(idx) == 0:
            continue
        m_nodes = min(b, batch.n_nodes)
        m_edges = min(
            max(_round_up(int(e_real[idx].max())), 8), batch.n_edges
        )
        sub = DocBatch(
            node_kind=batch.node_kind[idx, :m_nodes],
            node_parent=batch.node_parent[idx, :m_nodes],
            scalar_id=batch.scalar_id[idx, :m_nodes],
            num_hi=batch.num_hi[idx, :m_nodes],
            num_lo=batch.num_lo[idx, :m_nodes],
            child_count=batch.child_count[idx, :m_nodes],
            edge_parent=batch.edge_parent[idx, :m_edges],
            edge_child=batch.edge_child[idx, :m_edges],
            edge_key_id=batch.edge_key_id[idx, :m_edges],
            edge_index=batch.edge_index[idx, :m_edges],
            edge_valid=batch.edge_valid[idx, :m_edges],
            n_docs=len(idx),
            n_nodes=m_nodes,
            n_edges=m_edges,
            node_key_id=batch.node_key_id[idx, :m_nodes],
            node_index=batch.node_index[idx, :m_nodes],
            node_parent_kind=batch.node_parent_kind[idx, :m_nodes],
            num_exotic=batch.num_exotic[idx],
            fn_origin=(
                batch.fn_origin[idx, :m_nodes]
                if batch.fn_origin is not None
                else None
            ),
        )
        groups.append((sub, idx))
    return groups, oversize


def take_doc_subset(batch: DocBatch, idx) -> DocBatch:
    """Arbitrary doc-index subset of an encoded batch (the incremental
    plane's delta extraction: a worker-encoded full chunk minus its
    result-cache hits). Node/edge widths are kept — statuses are
    invariant under batch composition (the plan layer's relocation
    contract), so the narrower batch evaluates identically and
    split_batch_by_size re-buckets it as usual. Derived per-node
    columns pass through so __post_init__ skips the edge re-scatter."""
    idx = np.asarray(idx, dtype=np.int64)
    if len(idx) == batch.n_docs:
        return batch
    return DocBatch(
        node_kind=batch.node_kind[idx],
        node_parent=batch.node_parent[idx],
        scalar_id=batch.scalar_id[idx],
        num_hi=batch.num_hi[idx],
        num_lo=batch.num_lo[idx],
        child_count=batch.child_count[idx],
        edge_parent=batch.edge_parent[idx],
        edge_child=batch.edge_child[idx],
        edge_key_id=batch.edge_key_id[idx],
        edge_index=batch.edge_index[idx],
        edge_valid=batch.edge_valid[idx],
        n_docs=len(idx),
        n_nodes=batch.n_nodes,
        n_edges=batch.n_edges,
        node_key_id=batch.node_key_id[idx],
        node_index=batch.node_index[idx],
        node_parent_kind=batch.node_parent_kind[idx],
        num_exotic=batch.num_exotic[idx],
        fn_origin=(
            batch.fn_origin[idx] if batch.fn_origin is not None else None
        ),
    )


def _pad_encoded(encoded: List[EncodedDoc], n: int, e_max: int) -> DocBatch:
    """Pad encoded documents into one (D, n) / (D, e_max) batch."""
    d = len(encoded)

    def pad_node(attr, fill):
        out = np.full((d, n), fill, dtype=getattr(encoded[0], attr).dtype if encoded else np.int32)
        for i, enc in enumerate(encoded):
            arr = getattr(enc, attr)
            out[i, : len(arr)] = arr
        return out

    def pad_edge(attr, fill):
        out = np.full((d, e_max), fill, dtype=np.int32)
        for i, enc in enumerate(encoded):
            arr = getattr(enc, attr)
            out[i, : len(arr)] = arr
        return out

    edge_valid = np.zeros((d, e_max), dtype=bool)
    for i, enc in enumerate(encoded):
        edge_valid[i, : enc.n_edges] = True

    return DocBatch(
        node_kind=pad_node("node_kind", -1),
        node_parent=pad_node("node_parent", -1),
        scalar_id=pad_node("scalar_id", -1),
        num_hi=pad_node("num_hi", 0),
        num_lo=pad_node("num_lo", 0),
        child_count=pad_node("child_count", 0),
        # padding edges self-loop on node 0 but are masked by edge_valid
        edge_parent=pad_edge("edge_parent", 0),
        edge_child=pad_edge("edge_child", 0),
        edge_key_id=pad_edge("edge_key_id", -2),
        edge_index=pad_edge("edge_index", -2),
        edge_valid=edge_valid,
        n_docs=d,
        n_nodes=n,
        n_edges=e_max,
        num_exotic=np.array(
            [enc.num_exotic for enc in encoded], dtype=bool
        ),
    )


def _encode_all(docs: List[PV], interner: Interner, fn_values=None,
                fn_var_order=None) -> Tuple[List[EncodedDoc], bool]:
    """Encode each document, with its precomputed function results
    appended as orphan subtrees when `fn_values` (per-doc {var: [PV]},
    ops/fnvars.precompute_fn_values) and `fn_var_order` (the slot
    order) are given. Also returns whether any slot is per-origin."""
    if fn_values is None or not fn_var_order:
        return [encode_document(d, interner) for d in docs], False
    any_per_origin = False
    encoded = []
    for i, d in enumerate(docs):
        per = fn_values[i]
        flat = []
        for slot, var in enumerate(fn_var_order):
            vals = per.get(var, [])
            if isinstance(vals, dict):
                # per-origin slot ('pexpr'): {origin path: [PV]}
                any_per_origin = True
                for opath, pvs in vals.items():
                    for pv in pvs:
                        flat.append((slot, pv, opath))
            else:
                for pv in vals:
                    flat.append((slot, pv, None))
        encoded.append(encode_document(d, interner, fn_results=flat))
    return encoded, any_per_origin


def _tag_fn_roots(batch: DocBatch, encoded: List[EncodedDoc],
                  any_per_origin: bool) -> None:
    """Tag function-result roots AFTER the derived-column pass: the ids
    live in a reserved negative namespace (ops/fnvars.fn_key_id) that
    no interned key or sentinel uses, and carrying them in the derived
    column (not the edge arrays) keeps the results out of struct-id
    child grouping and parent-kind derivation. A document whose
    per-origin result lost its origin goes to the CPU oracle."""
    from .fnvars import fn_key_id

    if any_per_origin:
        batch.fn_origin = np.full(batch.node_kind.shape, -1, dtype=np.int32)
    for i, enc in enumerate(encoded):
        for slot, idx, origin in enc.fn_roots:
            batch.node_key_id[i, idx] = fn_key_id(slot)
            if origin >= 0:
                batch.fn_origin[i, idx] = origin
        if enc.fn_origin_miss:
            batch.num_exotic[i] = True


def encode_batch(docs: List[PV], interner: Optional[Interner] = None,
                 pad_nodes: Optional[int] = None, pad_edges: Optional[int] = None,
                 fn_values=None, fn_var_order=None,
                 ) -> Tuple[DocBatch, Interner]:
    """Encode + pad a list of documents into one batch.

    Pads node/edge axes to bucket sizes (multiples of 8) so XLA sees a
    small number of distinct shapes across batches.

    `fn_values` (per-doc {var: [PV]}, ops/fnvars.precompute_fn_values)
    with `fn_var_order` (the slot order) appends each function result
    as an orphan subtree and tags its root with the reserved
    fn_key_id(slot) in the derived node_key_id column.
    """
    interner = interner if interner is not None else Interner()
    encoded, any_per_origin = _encode_all(docs, interner, fn_values, fn_var_order)
    n = pad_nodes or _round_up(max((e.n_nodes for e in encoded), default=1))
    e_max = pad_edges or _round_up(max((e.n_edges for e in encoded), default=1))
    batch = _pad_encoded(encoded, n, e_max)
    _tag_fn_roots(batch, encoded, any_per_origin)
    return batch, interner


def encode_bucketed(docs: List[PV], interner: Optional[Interner] = None,
                    buckets: Tuple[int, ...] = NODE_BUCKETS_EXTENDED,
                    fn_values=None, fn_var_order=None):
    """Encode documents straight into per-size-bucket batches, each padded
    to its bucket's node count: the groups `split_batch_by_size` would
    cut from `encode_batch`'s output, without first padding every
    document to the largest one (one 60k-node template in a corpus of
    small ones would otherwise make a (D, 60k) batch).

    `fn_values` and `fn_var_order` append function results as in
    `encode_batch`; a document is bucketed by its node count with its
    results, and each bucket carries its own `fn_origin` column when a
    slot is per-origin.

    Returns (groups, oversize, interner): groups as in
    split_batch_by_size, (sub_batch, doc_indices); oversize holds the
    documents beyond the last bucket, with numbers that have no exact
    device encoding, or with a per-origin function result whose origin
    did not map back to a node, which are not encoded into any group."""
    interner = interner if interner is not None else Interner()
    encoded, any_per_origin = _encode_all(docs, interner, fn_values, fn_var_order)
    sizes = np.array([e.n_nodes for e in encoded], dtype=np.int64)
    exotic = np.array([e.num_exotic or e.fn_origin_miss for e in encoded], dtype=bool)
    host = (sizes > buckets[-1]) | exotic
    groups: List[Tuple[DocBatch, np.ndarray]] = []
    lo = 0
    for b in buckets:
        idx = np.where((sizes > lo) & (sizes <= b) & ~host)[0]
        lo = b
        if len(idx) == 0:
            continue
        part = [encoded[i] for i in idx]
        e_max = _round_up(max(e.n_edges for e in part))
        batch = _pad_encoded(part, b, e_max)
        _tag_fn_roots(batch, part, any_per_origin)
        groups.append((batch, idx))
    return groups, np.where(host)[0], interner


def _row_positions(offsets: np.ndarray, idx: np.ndarray):
    """For the documents `idx` of ragged columns cut at `offsets`: each
    element's (row in the bucket, position in its document, position in
    the ragged column)."""
    counts = offsets[idx + 1] - offsets[idx]
    rows = np.repeat(np.arange(len(idx)), counts)
    within = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts)
    return rows, within, np.repeat(offsets[idx], counts) + within


def groups_from_ragged(cols: dict, node_offset: np.ndarray, edge_offset: np.ndarray,
                       exotic: np.ndarray,
                       buckets: Tuple[int, ...] = NODE_BUCKETS_EXTENDED):
    """The groups `encode_bucketed` builds, cut out of ragged columns:
    `cols` holds every document's node columns (node_kind, node_parent,
    scalar_id, num_hi, num_lo, child_count) and edge columns
    (edge_parent, edge_child, edge_key_id, edge_index) concatenated, the
    documents' nodes at node_offset[i]:node_offset[i + 1] and edges at
    edge_offset[i]:edge_offset[i + 1]. Each bucket's batch is padded to
    its node count and its edges to the rounded largest edge count, as
    encode_bucketed pads them; no wider block is ever built.

    Returns (groups, oversize): groups as in encode_bucketed; oversize
    the documents beyond the last bucket or with numbers that have no
    exact device encoding (`exotic`)."""
    sizes = np.diff(node_offset)
    e_sizes = np.diff(edge_offset)
    host = (sizes > buckets[-1]) | exotic
    groups: List[Tuple[DocBatch, np.ndarray]] = []
    lo = 0
    for b in buckets:
        idx = np.where((sizes > lo) & (sizes <= b) & ~host)[0]
        lo = b
        if len(idx) == 0:
            continue
        e_max = _round_up(int(e_sizes[idx].max()))
        n_rows, n_within, n_src = _row_positions(node_offset, idx)
        e_rows, e_within, e_src = _row_positions(edge_offset, idx)

        def cut(attr, width, fill, rows, within, src):
            out = np.full((len(idx), width), fill, dtype=np.int32)
            out[rows, within] = cols[attr][src]
            return out

        edge_valid = np.zeros((len(idx), e_max), dtype=bool)
        edge_valid[e_rows, e_within] = True
        node = {a: cut(a, b, fill, n_rows, n_within, n_src) for a, fill in (
            ("node_kind", -1), ("node_parent", -1), ("scalar_id", -1),
            ("num_hi", 0), ("num_lo", 0), ("child_count", 0))}
        edge = {a: cut(a, e_max, fill, e_rows, e_within, e_src) for a, fill in (
            ("edge_parent", 0), ("edge_child", 0), ("edge_key_id", -2),
            ("edge_index", -2))}
        groups.append((DocBatch(**node, **edge, edge_valid=edge_valid,
                                n_docs=len(idx), n_nodes=b, n_edges=e_max,
                                num_exotic=np.zeros(len(idx), dtype=bool)), idx))
    return groups, np.where(host)[0]


# -- the wire form of a batch (ingest workers -> parent) ---------------
# plain dicts of numpy arrays: cheap to pickle, and the derived columns
# travel along so the receiving process never re-runs the __post_init__
# derivation.

_PAYLOAD_ARRAYS = (
    "node_kind", "node_parent", "scalar_id", "num_hi", "num_lo",
    "child_count", "edge_parent", "edge_child", "edge_key_id",
    "edge_index", "edge_valid", "node_key_id", "node_index",
    "node_parent_kind", "num_exotic", "fn_origin",
)


def batch_payload(batch: DocBatch) -> dict:
    """Picklable wire form of a DocBatch (derived columns included)."""
    out = {k: getattr(batch, k) for k in _PAYLOAD_ARRAYS}
    out["n_docs"] = batch.n_docs
    out["n_nodes"] = batch.n_nodes
    out["n_edges"] = batch.n_edges
    return out


def batch_from_payload(payload: dict) -> DocBatch:
    return DocBatch(**payload)


def remap_interned_ids(batch: DocBatch, remap: np.ndarray) -> None:
    """Relabel a shard batch's intern ids in place through `remap`
    (shard-local id -> merged id). Only non-negative entries are ids;
    the sentinel namespaces (-1/-2, and the reserved fn ids — never
    present at encode time) pass through untouched."""
    if len(remap) == 0:
        return
    for attr in ("scalar_id", "edge_key_id", "node_key_id"):
        col = getattr(batch, attr)
        if col.size:
            safe = np.clip(col, 0, len(remap) - 1)
            col[...] = np.where(col >= 0, remap[safe], col)


_CONCAT_FILL = {
    "node_kind": -1, "node_parent": -1, "scalar_id": -1, "num_hi": 0,
    "num_lo": 0, "child_count": 0, "edge_parent": 0, "edge_child": 0,
    "edge_key_id": -2, "edge_index": -2, "edge_valid": False,
    "node_key_id": -2, "node_index": -2, "node_parent_kind": -1,
}


def concat_batches(parts: List[DocBatch]) -> DocBatch:
    """Concatenate shard batches along the doc axis, padding node/edge
    axes to the widest shard with the same suffix fills the encoder
    uses — so the result is shape- and content-equivalent to encoding
    the union serially (modulo intern-id labels, which the caller has
    already remapped into one namespace)."""
    if not parts:
        raise ValueError("concat_batches needs at least one shard")
    if any(p.fn_origin is not None for p in parts):
        raise ValueError("fn results are encoded after the shard merge, never inside it")
    n_nodes = max(p.n_nodes for p in parts)
    n_edges = max(p.n_edges for p in parts)

    def padcat(attr: str, width: int) -> np.ndarray:
        fill = _CONCAT_FILL[attr]
        cols = []
        for p in parts:
            col = getattr(p, attr)
            if col.shape[1] < width:
                pad = np.full(
                    (col.shape[0], width - col.shape[1]), fill,
                    dtype=col.dtype,
                )
                col = np.concatenate([col, pad], axis=1)
            cols.append(col)
        return np.concatenate(cols, axis=0)

    node_attrs = (
        "node_kind", "node_parent", "scalar_id", "num_hi", "num_lo",
        "child_count", "node_key_id", "node_index", "node_parent_kind",
    )
    edge_attrs = (
        "edge_parent", "edge_child", "edge_key_id", "edge_index",
        "edge_valid",
    )
    fields = {a: padcat(a, n_nodes) for a in node_attrs}
    fields.update({a: padcat(a, n_edges) for a in edge_attrs})
    return DocBatch(
        n_docs=sum(p.n_docs for p in parts),
        n_nodes=n_nodes,
        n_edges=n_edges,
        num_exotic=np.concatenate([p.num_exotic for p in parts]),
        **fields,
    )


def merge_bucket_groups(shards):
    """The bucketed counterpart of concat_batches: merge the bucket
    groups of contiguous document shards, given in document order as
    (groups, oversize, first document index) with their intern ids
    already remapped into one namespace, into the groups and oversize
    set one encode of all the documents gives: one group per bucket,
    its documents in document order, its edges padded to the widest
    shard's."""
    by_width: Dict[int, list] = {}
    for groups, _oversize, start in shards:
        for batch, idx in groups:
            by_width.setdefault(batch.n_nodes, []).append((batch, idx + start))
    merged = []
    for width in sorted(by_width):
        parts = by_width[width]
        batch = parts[0][0] if len(parts) == 1 else concat_batches([b for b, _ in parts])
        merged.append((batch, np.concatenate([i for _, i in parts])))
    oversize = np.concatenate(
        [np.asarray(o, dtype=np.int64) + start for _g, o, start in shards]
        or [np.zeros(0, np.int64)]
    )
    return merged, oversize


def encode_chunk_texts(names: List[str], contents: List[str]):
    """The quarantine-aware encode of raw texts (--max-doc-failures):
    the native JSON encoder when every text sniffs as JSON and the
    library is built (an invalid document is marked, replaced by a
    `null` stand-in and the rest retried), the tree loader otherwise (a
    parse failure marks the document and encodes a null stand-in).
    With GUARD_TPU_FAULT naming the `parse` or `encode` point, each
    document passes those points first (utils/faults.py).

    Returns (groups, oversize, interner, failed_indices, messages,
    errors, quarantined, pvs): the bucket groups and oversize set as in
    encode_bucketed, the failed documents in order, one `skipping ...`
    message and one quarantine record (utils/faults.quarantine_record)
    per failure, and the per-document trees when the tree loader ran
    (None on the native path)."""
    from ..utils.telemetry import span

    with span("encode", {"docs": len(names)}):
        return _encode_chunk_texts_inner(names, contents)


def _encode_chunk_texts_inner(names: List[str], contents: List[str]):
    from ..utils.faults import fault_active, maybe_fail, quarantine_record
    from .native_encoder import encode_json_bucketed_resilient

    pv_failed: set = set()
    messages: List[str] = []
    recs: dict = {}
    errors = 0
    enc = pvs = None
    if fault_active("parse") or fault_active("encode"):
        contents = list(contents)
        for i, name in enumerate(names):
            for stage in ("parse", "encode"):
                if i in pv_failed:
                    continue
                try:
                    maybe_fail(stage, key=name)
                except Exception as e:
                    pv_failed.add(i)
                    messages.append(f"skipping {name}: {e}")
                    recs[i] = quarantine_record(name, stage, e)
                    errors += 1
                    contents[i] = "null"  # neutral stand-in downstream
    if all(c.lstrip()[:1] in ("{", "[") for c in contents):
        enc, failed, msgs = encode_json_bucketed_resilient(contents, names)
        pv_failed |= failed
        messages += msgs
        errors += len(failed)
        for i in failed:
            recs[i] = {
                "file": names[i], "stage": "parse",
                "error": "ParseError", "message": "invalid JSON",
            }
    if enc is None:
        from ..core.errors import GuardError
        from ..core.loader import load_document
        from ..core.values import PV, Path as VPath

        pvs = []
        for i, content in enumerate(contents):
            if i in pv_failed:
                pvs.append(None)  # already marked by the native retry
                continue
            try:
                pvs.append(load_document(content, names[i]))
            except GuardError as e:
                pv_failed.add(i)
                messages.append(f"skipping {names[i]}: {e}")
                recs[i] = quarantine_record(names[i], "parse", e)
                errors += 1
                pvs.append(None)
        enc = encode_bucketed(
            [pv if pv is not None else PV.null(VPath.root()) for pv in pvs]
        )
    groups, oversize, interner = enc
    order = sorted(pv_failed)
    return (groups, oversize, interner, order, messages, errors,
            [recs[i] for i in order], pvs)

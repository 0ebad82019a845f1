"""Location-aware YAML/JSON document loader.

Event-driven loader over PyYAML's parser events (the exact analogue of the
reference driving libyaml events, `guard/src/rules/libyaml/
loader.rs:31-60` + `parser.rs:44-61`), producing path-aware `PV` trees:

  * per-node line/col from 0-based parser marks (libyaml/util.rs:56-61);
  * scalar typing from the raw scalar string, NOT the YAML 1.1 resolver:
    plain scalars try i64 -> f64 -> bool(true/yes/on/y|false/no/off/n) ->
    null(~|null, case-insensitive) -> string (loader.rs:83-99);
  * CloudFormation intrinsic short-forms (`!Ref`, `!GetAtt`, ...) are
    rewritten to their long forms `{"Fn::X": value}`
    (loader.rs:197-225, rules/mod.rs:30-86);
  * YAML aliases are rejected (loader.rs:52-56);
  * JSON is loaded through the same path (JSON is a YAML subset), so JSON
    documents get source locations too.
"""

from __future__ import annotations

import json
import re
from typing import Iterator, Optional, Tuple

import yaml

from .errors import ParseError
from .values import Location, MapValue, Path, PV, from_plain

# rules/mod.rs:30-54
SHORT_FORM_TO_LONG = {
    "Ref": "Ref",
    "GetAtt": "Fn::GetAtt",
    "Base64": "Fn::Base64",
    "Sub": "Fn::Sub",
    "GetAZs": "Fn::GetAZs",
    "ImportValue": "Fn::ImportValue",
    "Condition": "Condition",
    "RefAll": "Fn::RefAll",
    "Select": "Fn::Select",
    "Split": "Fn::Split",
    "Join": "Fn::Join",
    "FindInMap": "Fn::FindInMap",
    "And": "Fn::And",
    "Equals": "Fn::Equals",
    "Contains": "Fn::Contains",
    "EachMemberIn": "Fn::EachMemberIn",
    "EachMemberEquals": "Fn::EachMemberEquals",
    "ValueOf": "Fn::ValueOf",
    "If": "Fn::If",
    "Not": "Fn::Not",
    "Or": "Fn::Or",
}

# rules/mod.rs:55-66
SINGLE_VALUE_FUNC_REF = {
    "Ref", "Base64", "Sub", "GetAZs", "ImportValue", "GetAtt", "Condition", "RefAll",
}

# rules/mod.rs:67-85
SEQUENCE_VALUE_FUNC_REF = {
    "GetAtt", "Sub", "Select", "Split", "Join", "FindInMap", "And", "Equals",
    "Contains", "EachMemberIn", "EachMemberEquals", "ValueOf", "If", "Not", "Or",
}

_TYPE_REF_PREFIX = "tag:yaml.org,2002:"

_INT_RE = re.compile(r"^[+-]?[0-9]+$")
# Rust f64::from_str grammar (no underscores, optional exp, inf/nan)
_FLOAT_RE = re.compile(
    r"^[+-]?((inf(inity)?)|(nan)|((([0-9]+)|([0-9]+\.[0-9]*)|(\.[0-9]+))([eE][+-]?[0-9]+)?))$",
    re.IGNORECASE,
)

_TRUE_SET = {"true", "yes", "on", "y"}  # loader.rs:103-105
_FALSE_SET = {"false", "no", "off", "n"}  # loader.rs:107-109


def _typed_scalar(raw: str, path: Path) -> PV:
    """Plain-scalar typing, mirroring loader.rs:86-98."""
    if _INT_RE.match(raw):
        try:
            return PV.int_(path, int(raw))
        except ValueError:
            pass
    if _FLOAT_RE.match(raw):
        try:
            return PV.float_(path, float(raw))
        except ValueError:
            pass
    if raw in _TRUE_SET:
        return PV.boolean(path, True)
    if raw in _FALSE_SET:
        return PV.boolean(path, False)
    if raw.lower() in ("~", "null"):
        return PV.null(path)
    return PV.string(path, raw)


def _loc(event) -> Location:
    m = event.start_mark
    return Location(m.line, m.column)


class _EventLoader:
    """Recursive-descent build of a PV tree from PyYAML parser events."""

    def __init__(self, events: Iterator, file_name: str):
        self.events = events
        self.file_name = file_name

    def _next(self):
        try:
            return next(self.events)
        except StopIteration:
            raise ParseError(f"Unexpected end of YAML stream in {self.file_name}")
        except yaml.YAMLError as e:
            raise ParseError(f"Error parsing file {self.file_name}: {e}")

    def load(self) -> PV:
        doc: Optional[PV] = None
        while True:
            ev = self._next()
            if isinstance(ev, (yaml.StreamStartEvent, yaml.DocumentStartEvent)):
                continue
            if isinstance(ev, (yaml.DocumentEndEvent, yaml.StreamEndEvent)):
                if doc is None:
                    raise ParseError(f"Empty YAML document in {self.file_name}")
                return doc
            doc = self._node(ev, Path.root())

    def _node(self, ev, path: Path) -> PV:
        if isinstance(ev, yaml.AliasEvent):
            # loader.rs:52-56
            raise ParseError("Guard does not currently support aliases")

        if isinstance(ev, yaml.ScalarEvent):
            return self._scalar(ev, path)

        if isinstance(ev, yaml.SequenceStartEvent):
            loc = _loc(ev)
            tag = ev.tag
            items = []
            idx = 0
            while True:
                child = self._next()
                if isinstance(child, yaml.SequenceEndEvent):
                    break
                items.append(self._node(child, path.extend(str(idx), None)))
                idx += 1
            seq = PV.list_(Path(path.s, loc), items)
            # CFN short-form over a sequence, e.g. `!GetAtt [a, b]`
            # (loader.rs:148-163 + handle_sequence_value_func_ref)
            if tag and tag.startswith("!") and not tag.startswith("!!"):
                suffix = tag[1:]
                if suffix in SEQUENCE_VALUE_FUNC_REF:
                    return self._wrap_fn(suffix, seq, loc, path)
            return seq

        if isinstance(ev, yaml.MappingStartEvent):
            loc = _loc(ev)
            mv = MapValue()
            while True:
                key_ev = self._next()
                if isinstance(key_ev, yaml.MappingEndEvent):
                    break
                if not isinstance(key_ev, yaml.ScalarEvent):
                    raise ParseError(
                        f"Non-scalar mapping key at line {_loc(key_ev).line} in {self.file_name}"
                    )
                key = key_ev.value
                key_path = path.extend(key, _loc(key_ev))
                val_ev = self._next()
                value = self._node(val_ev, key_path)
                # last-write-wins on duplicate keys (IndexMap::insert)
                if key not in mv.values:
                    mv.keys.append(PV.string(key_path, key))
                mv.values[key] = value
            return PV.map_(Path(path.s, loc), mv)

        raise ParseError(f"Unexpected YAML event {ev!r} in {self.file_name}")

    def _scalar(self, ev, path: Path) -> PV:
        loc = _loc(ev)
        p = Path(path.s, loc)
        raw = ev.value
        tag = ev.tag
        if tag is not None:
            if tag.startswith(_TYPE_REF_PREFIX):
                return self._type_ref(raw, p, tag)
            if tag.startswith("!") and not tag.startswith("!!"):
                suffix = tag[1:]
                # loader.rs:197-210: short-form scalar like `!Ref foo`
                if suffix in SINGLE_VALUE_FUNC_REF:
                    return self._wrap_fn(suffix, PV.string(p, raw), loc, path)
                return PV.string(p, raw)
            return PV.string(p, raw)
        if ev.style is not None and ev.style != "":
            # quoted / literal / folded scalars stay strings (loader.rs:83-84)
            return PV.string(p, raw)
        return _typed_scalar(raw, p)

    def _type_ref(self, raw: str, p: Path, tag: str) -> PV:
        """Explicit `!!type` tags (loader.rs:227-244)."""
        if tag == _TYPE_REF_PREFIX + "bool":
            if raw in ("true", "false"):
                return PV.boolean(p, raw == "true")
            return PV.string(p, raw)
        if tag == _TYPE_REF_PREFIX + "int":
            if _INT_RE.match(raw):
                return PV.int_(p, int(raw))
            raise ParseError(f"Bad !!int value {raw!r}")
        if tag == _TYPE_REF_PREFIX + "float":
            if _FLOAT_RE.match(raw):
                return PV.float_(p, float(raw))
            raise ParseError(f"Bad !!float value {raw!r}")
        if tag == _TYPE_REF_PREFIX + "null":
            return PV.null(p)
        return PV.string(p, raw)

    def _wrap_fn(self, suffix: str, value: PV, loc: Location, path: Path) -> PV:
        long_name = SHORT_FORM_TO_LONG[suffix]
        key_path = path.extend(long_name, loc)
        value.path = Path(key_path.s, value.path.loc)
        mv = MapValue(
            keys=[PV.string(key_path, long_name)], values={long_name: value}
        )
        return PV.map_(Path(path.s, loc), mv)


def load_document(content: str, file_name: str = "") -> PV:
    """Parse a YAML or JSON document into a path-aware tree.

    Equivalent of `values::read_from` -> `Loader::load` ->
    `PathAwareValue::try_from(MarkedValue)`
    (values.rs:444, loader.rs:31, path_value.rs:407-414).
    """
    try:
        events = yaml.parse(content, Loader=getattr(yaml, "CSafeLoader", yaml.SafeLoader))
        return _EventLoader(iter(events), file_name).load()
    except ParseError:
        raise
    except yaml.YAMLError as yaml_err:
        # JSON documents that YAML 1.1 rejects (rare: tabs, special keys)
        try:
            data = json.loads(content)
        except (json.JSONDecodeError, ValueError):
            raise ParseError(f"Error parsing file {file_name}: {yaml_err}")
        return from_plain(data)


class _IntrinsicsSafeLoader(yaml.SafeLoader):
    """SafeLoader that rewrites CFN short-form tags to long forms when
    loading plain python data (test specs, rulegen templates) — the
    analogue of serde_yaml's Tagged handling + `handle_tagged_value`
    (values.rs:324-336)."""


def _intrinsic_multi_constructor(loader, tag_suffix, node):
    name = tag_suffix
    if isinstance(node, yaml.ScalarNode):
        value = loader.construct_scalar(node)
        if name in SINGLE_VALUE_FUNC_REF:
            return {SHORT_FORM_TO_LONG[name]: value}
        return value
    if isinstance(node, yaml.SequenceNode):
        value = loader.construct_sequence(node, deep=True)
        if name in SEQUENCE_VALUE_FUNC_REF:
            return {SHORT_FORM_TO_LONG[name]: value}
        return value
    return loader.construct_mapping(node, deep=True)


yaml.add_multi_constructor("!", _intrinsic_multi_constructor, Loader=_IntrinsicsSafeLoader)


def yaml_load_with_intrinsics(content: str):
    """yaml.safe_load that tolerates CFN short-form intrinsic tags."""
    return yaml.load(content, Loader=_IntrinsicsSafeLoader)


def load_payload(content: str) -> Tuple[list, list]:
    """Parse a stdin payload `{"rules": [...], "data": [...]}`
    (validate.rs:507-513)."""
    try:
        payload = json.loads(content)
    except json.JSONDecodeError as e:
        raise ParseError(f"Error parsing payload: {e}")
    if not isinstance(payload, dict) or "rules" not in payload or "data" not in payload:
        raise ParseError("Payload must be a JSON object with 'rules' and 'data' lists")
    return list(payload["rules"]), list(payload["data"])

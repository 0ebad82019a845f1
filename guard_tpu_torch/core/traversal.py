"""Traversal index: path-string -> node lookup for reporters.

Equivalent of `guard/src/rules/path_value/traversal.rs:
12-45`: builds an index from a document tree so reporters can map
`"/Resources/x/..."` path strings back to nodes (and their source
locations); supports relative `N#` / `N/...` paths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .values import LIST, MAP, PV


class Node:
    __slots__ = ("parent", "value")

    def __init__(self, parent: Optional[str], value: PV):
        self.parent = parent
        self.value = value


class Traversal:
    def __init__(self, root: PV):
        self.nodes: Dict[str, Node] = {}
        self._root_path = root.self_path().s
        self._build(root, None)

    def _build(self, pv: PV, parent: Optional[str]) -> None:
        path = pv.self_path().s
        self.nodes[path] = Node(parent, pv)
        if pv.kind == MAP:
            for key, value in pv.val.values.items():
                self._build(value, path)
        elif pv.kind == LIST:
            for item in pv.val:
                self._build(item, path)

    def root(self) -> Optional[Node]:
        return self.nodes.get(self._root_path)

    def at(self, path: str, node: Optional[Node] = None):
        """Resolve an absolute path, or a relative path of the form
        `N#` (climb N levels) or `N/suffix` (climb then descend)
        (traversal.rs:47-100). Returns the Node or None (abort)."""
        if path in self.nodes:
            return self.nodes[path]
        # relative: <digits>'#' or <digits>'/rest'
        i = 0
        while i < len(path) and path[i].isdigit():
            i += 1
        if i == 0 or node is None:
            return None
        levels = int(path[:i])
        current: Optional[Node] = node
        for _ in range(levels):
            if current is None or current.parent is None:
                return None
            current = self.nodes.get(current.parent)
        if current is None:
            return None
        rest = path[i:]
        if rest == "#" or rest == "":
            return current
        if rest.startswith("/"):
            target = current.value.self_path().s + rest
            return self.nodes.get(target)
        return None

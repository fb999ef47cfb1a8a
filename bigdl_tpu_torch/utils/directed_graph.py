"""DirectedGraph / Node: generic DAG with traversals and the ``->`` edge DSL.

The JAX package's ``bigdl_tpu/utils/directed_graph.py`` (reference
``utils/DirectedGraph.scala:34,135``): plain Python, no tensors.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterator, List, Optional


class Edge:
    def __init__(self, from_index: Optional[int] = None):
        self.from_index = from_index


class Node:
    """Graph node holding an element (reference ``Node``, ``:135``)."""

    def __init__(self, element: Any):
        self.element = element
        self.nexts: List[tuple] = []   # (Node, Edge)
        self.prevs: List[tuple] = []   # (Node, Edge)

    def add(self, node: "Node", edge: Optional[Edge] = None) -> "Node":
        """``self -> node`` (reference ``Node.->:155``).  Returns ``node``."""
        e = edge or Edge()
        self.nexts.append((node, e))
        node.prevs.append((self, e))
        return node

    def __rshift__(self, node: "Node") -> "Node":
        return self.add(node)

    def delete(self, node: "Node", edge: Optional[Edge] = None) -> "Node":
        if edge is not None:
            self.nexts = [(n, e) for n, e in self.nexts
                          if not (n is node and e is edge)]
            node.prevs = [(n, e) for n, e in node.prevs
                          if not (n is self and e is edge)]
        else:
            self.nexts = [(n, e) for n, e in self.nexts if n is not node]
            node.prevs = [(n, e) for n, e in node.prevs if n is not self]
        return self

    def remove_prev_edges(self) -> "Node":
        for p, e in list(self.prevs):
            p.nexts = [(n, ee) for n, ee in p.nexts if ee is not e]
        self.prevs = []
        return self

    def remove_next_edges(self) -> "Node":
        for n, e in list(self.nexts):
            n.prevs = [(p, ee) for p, ee in n.prevs if ee is not e]
        self.nexts = []
        return self

    def graph(self, reverse: bool = False) -> "DirectedGraph":
        return DirectedGraph(self, reverse)

    def __repr__(self):
        return f"Node({self.element!r})"


class DirectedGraph:
    """DAG rooted at ``source`` (reference ``DirectedGraph.scala:34``).

    ``reverse=True`` walks ``prevs`` instead of ``nexts`` — used for backward
    passes from the output node.
    """

    def __init__(self, source: Node, reverse: bool = False):
        self.source = source
        self.reverse = reverse

    def _next(self, node: Node) -> List[Node]:
        edges = node.prevs if self.reverse else node.nexts
        return [n for n, _ in edges]

    def size(self) -> int:
        return sum(1 for _ in self.bfs())

    def edges(self) -> int:
        return sum(len(self._next(n)) for n in self.bfs())

    def bfs(self) -> Iterator[Node]:
        """Breadth-first from source (reference ``BFS:108``)."""
        seen = {id(self.source)}
        queue = deque([self.source])
        while queue:
            node = queue.popleft()
            yield node
            for n in self._next(node):
                if id(n) not in seen:
                    seen.add(id(n))
                    queue.append(n)

    def dfs(self) -> Iterator[Node]:
        """Depth-first from source (reference ``DFS:85``)."""
        seen = set()
        stack = [self.source]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            yield node
            for n in self._next(node):
                if id(n) not in seen:
                    stack.append(n)

    def topology_sort(self) -> List[Node]:
        """Kahn's algorithm; raises on cycles (reference ``topologySort:52``)."""
        nodes = list(self.bfs())
        in_graph = {id(n) for n in nodes}
        indeg = {}
        for n in nodes:
            back = n.nexts if self.reverse else n.prevs
            indeg[id(n)] = sum(1 for p, _ in back if id(p) in in_graph)
        queue = deque(n for n in nodes if indeg[id(n)] == 0)
        out: List[Node] = []
        while queue:
            node = queue.popleft()
            out.append(node)
            for n in self._next(node):
                if id(n) in in_graph:
                    indeg[id(n)] -= 1
                    if indeg[id(n)] == 0:
                        queue.append(n)
        if len(out) != len(nodes):
            raise ValueError("graph contains a cycle, cannot topology-sort")
        return out

    def clone_graph(self) -> "DirectedGraph":
        mapping = {}
        for n in self.bfs():
            mapping[id(n)] = Node(n.element)
        for n in self.bfs():
            for nxt, e in n.nexts:
                if id(nxt) in mapping:
                    mapping[id(n)].add(mapping[id(nxt)], Edge(e.from_index))
        return DirectedGraph(mapping[id(self.source)], self.reverse)

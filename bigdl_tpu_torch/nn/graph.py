"""The graph container (``bigdl_tpu/nn/graph.py``: ``ModuleNode`` :18,
``Graph`` :39, ``Input`` :103; reference ``nn/Graph.scala:58``): a DAG of
modules built with the ``inputs()`` DSL and run as a topological fold.
Autograd differentiates the fold, as ``jax.vjp`` does the JAX package's;
there is no per-node backward bookkeeping."""

from __future__ import annotations

from typing import Dict, List

from torch import nn

from bigdl_tpu_torch.nn.module import Container


class ModuleNode:
    """A node wrapping a module, with its predecessor and successor edges
    (reference ``utils/Node`` and ``AbstractModule.inputs:539``)."""

    def __init__(self, element: nn.Module):
        self.element = element
        self.prev: List["ModuleNode"] = []
        self.next: List["ModuleNode"] = []

    def inputs(self, *nodes) -> "ModuleNode":
        """Feed this node from ``nodes`` (a module is wrapped in a node of
        its own), in order; returns this node."""
        for n in nodes:
            if isinstance(n, nn.Module):
                n = ModuleNode(n)
            self.prev.append(n)
            n.next.append(self)
        return self

    def __repr__(self):
        return f"Node({type(self.element).__name__})"


class Graph(Container):
    """DAG container (reference ``nn/Graph.scala:58``).

    ``Graph(inputs, outputs)``: ``inputs`` is a node or a list of nodes fed
    with the graph's input (a list of as many activations, in order, when
    there are several); ``outputs`` likewise, the output a list when there
    are several.  A source node that is not an input takes the first
    input; a node of one predecessor takes its output, a node of several
    the list of theirs.  The children (``layers``) are the nodes' modules in
    Kahn's topological order over the nodes that reach an output, the
    JAX package's order (its ``params[i]`` is node i's), so that
    ``params_from_jax`` carries a JAX ``Graph``'s parameters over.  A cycle
    raises :class:`ValueError`."""

    def __init__(self, inputs, outputs):
        super().__init__()
        self.input_nodes = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self.output_nodes = list(outputs) \
            if isinstance(outputs, (list, tuple)) else [outputs]
        self.executions = self._topo_sort()
        for node in self.executions:
            self.add(node.element)

    def _topo_sort(self) -> List[ModuleNode]:
        # every node that reaches an output, walking the edges backwards
        seen: Dict[int, ModuleNode] = {}
        stack = list(self.output_nodes)
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen[id(n)] = n
            stack.extend(n.prev)
        # Kahn's algorithm over them
        indeg = {i: sum(1 for p in n.prev if id(p) in seen)
                 for i, n in seen.items()}
        ready = [n for i, n in seen.items() if indeg[i] == 0]
        order: List[ModuleNode] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for nxt in n.next:
                if id(nxt) in seen:
                    indeg[id(nxt)] -= 1
                    if indeg[id(nxt)] == 0:
                        ready.append(nxt)
        if len(order) != len(seen):
            raise ValueError("Graph contains a cycle")
        return order

    def forward(self, input):
        multi = isinstance(input, (list, tuple)) and len(self.input_nodes) > 1
        outputs: Dict[int, object] = {}
        for node, module in zip(self.executions, self.layers):
            if not node.prev:
                k = next((i for i, n in enumerate(self.input_nodes)
                          if n is node), 0)
                x = input[k] if multi else input
            elif len(node.prev) == 1:
                x = outputs[id(node.prev[0])]
            else:
                x = [outputs[id(p)] for p in node.prev]
            outputs[id(node)] = module(x)
        outs = [outputs[id(n)] for n in self.output_nodes]
        return outs[0] if len(outs) == 1 else outs


def Input() -> ModuleNode:
    """A placeholder source node (reference ``nn/Input.scala``)."""
    from bigdl_tpu_torch.nn.structural import Identity
    return ModuleNode(Identity())

"""Probabilistic execution traces (PETs) and scaffolds — paper Defs. 1–8.

The port of ``repro.ppl.trace``. A ``Trace`` records one execution of a
generative program as a directed graph with *statistical* edges E_s (value
dependence) and *existential* edges E_e (control-flow dependence, Def. 1).
Scaffold machinery implements:

  Def 2  target set D(rho, v)      — v + deterministic-descendant closure
  Def 3  transient set T(rho, v)   — existence depends on values in D
  Def 4  absorbing set A(rho, v)   — outside nodes with a parent in D∪T
  Def 5  scaffold s = D ∪ T ∪ A
  Def 6  border node b(s, v)       — first descendant of v with >1 branch in s
  Def 7  global section            — s minus descendants(b)
  Def 8  local sections            — s ∩ ({c_i} ∪ descendants(c_i))

``Plate`` nodes hold N structurally-identical sub-traces in structure-of-array
form; they keep Def. 8's local sections vectorized. ``compile.py`` lowers a
(trace, v) pair with a plate-shaped scaffold to the
``core.PartitionedTarget`` tensor interface.

The graph code is the reference's, line for line. A trace lives on one
device (``Trace(device=None)`` means the card, and raises without one unless
``device="cpu"``): constants, sampled and observed values and a plate's
index node are put there, and a deterministic node's value is computed
there when it is added.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import resolve_device
from .dists import Distribution


def _on(value, device: torch.device):
    """A node value as a tensor on ``device``: floating values become
    float32, integer and boolean values keep their dtype."""
    if value is None:
        return None
    t = torch.as_tensor(value)
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


@dataclasses.dataclass
class Node:
    nid: int
    name: str
    kind: str  # "stochastic" | "deterministic" | "constant"
    dist: Distribution | None = None
    fn: Callable | None = None
    parents: tuple = ()  # E_s in-edges (Node refs)
    exist_parent: "Node | None" = None  # E_e in-edge
    value: Any = None
    observed: bool = False
    # plate support
    plate: "Plate | None" = None  # owning plate (None = global graph)

    def __hash__(self):
        return self.nid

    def __eq__(self, other):
        return isinstance(other, Node) and other.nid == self.nid

    def __repr__(self):  # pragma: no cover
        flags = ("obs" if self.observed else self.kind[:3]) + (
            f"@{self.plate.name}" if self.plate else ""
        )
        return f"<{self.name}#{self.nid}:{flags}>"


@dataclasses.dataclass(eq=False)
class Plate:
    """N structurally-identical local sub-traces, stored SoA.

    ``index_node`` is the symbolic section index available to member nodes;
    member node values carry a leading axis of size ``size``.
    """

    name: str
    size: int
    index_node: "Node" = None
    members: list = dataclasses.field(default_factory=list)


class Trace:
    """One probabilistic execution trace. Build eagerly with concrete values."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.nodes: list[Node] = []
        self.plates: list[Plate] = []
        self._plate_stack: list[Plate] = []

    # -- construction -------------------------------------------------------
    def _add(self, node: Node) -> Node:
        self.nodes.append(node)
        if self._plate_stack:
            node.plate = self._plate_stack[-1]
            node.plate.members.append(node)
        return node

    def constant(self, name: str, value) -> Node:
        return self._add(Node(len(self.nodes), name, "constant", value=_on(value, self.device)))

    def sample(self, name: str, dist: Distribution, *parents: Node, value=None,
               exist_parent: Node | None = None) -> Node:
        """`assume` with a stochastic right-hand side."""
        n = Node(len(self.nodes), name, "stochastic", dist=dist,
                 parents=tuple(parents), exist_parent=exist_parent,
                 value=_on(value, self.device))
        return self._add(n)

    def det(self, name: str, fn: Callable, *parents: Node,
            exist_parent: Node | None = None) -> Node:
        """`assume` with a deterministic right-hand side; value computed now."""
        vals = [p.value for p in parents]
        n = Node(len(self.nodes), name, "deterministic", fn=fn,
                 parents=tuple(parents), exist_parent=exist_parent,
                 value=fn(*vals))
        return self._add(n)

    def observe(self, node: Node, value) -> Node:
        assert node.kind == "stochastic", "only stochastic nodes can be observed"
        node.observed = True
        node.value = _on(value, self.device)
        return node

    def plate(self, name: str, size: int):
        """Context manager: nodes created inside belong to one plate (the N
        local sections of Def. 8, stored stacked)."""
        plate = Plate(name, size)
        plate.index_node = Node(len(self.nodes), f"{name}.idx", "constant",
                                value=torch.arange(size, dtype=torch.int32,
                                                   device=self.device))
        self.nodes.append(plate.index_node)
        plate.index_node.plate = plate
        plate.members.append(plate.index_node)
        self.plates.append(plate)
        trace = self

        class _Ctx:
            def __enter__(self):
                trace._plate_stack.append(plate)
                return plate

            def __exit__(self, *exc):
                trace._plate_stack.pop()
                return False

        return _Ctx()

    # -- graph queries ------------------------------------------------------
    def children(self, node: Node) -> list[Node]:
        return [n for n in self.nodes if node in n.parents]

    def exist_children(self, node: Node) -> list[Node]:
        return [n for n in self.nodes if n.exist_parent is node]

    def descendants(self, node: Node) -> set[Node]:
        out, frontier = set(), [node]
        while frontier:
            n = frontier.pop()
            for c in self.children(n) + self.exist_children(n):
                if c not in out:
                    out.add(c)
                    frontier.append(c)
        return out


# ---------------------------------------------------------------------------
# Scaffold construction (Defs. 2–8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scaffold:
    v: Node
    D: set  # target set
    T: set  # transient set
    A: set  # absorbing set

    @property
    def nodes(self) -> set:
        return self.D | self.T | self.A


def target_set(trace: Trace, v: Node) -> set:
    """Def. 2: v plus descendants reached through deterministic nodes."""
    D = {v}
    frontier = [v]
    while frontier:
        n = frontier.pop()
        for c in trace.children(n):
            if c.kind == "deterministic" and c not in D:
                D.add(c)
                frontier.append(c)
    return D


def transient_set(trace: Trace, D: set) -> set:
    """Def. 3 (+ descendants closure: removed nodes take their subtrees)."""
    T = set()
    frontier = []
    for d in D:
        for c in trace.exist_children(d):
            if c not in D and c not in T:
                T.add(c)
                frontier.append(c)
    while frontier:
        n = frontier.pop()
        for c in trace.children(n) + trace.exist_children(n):
            if c not in T and c not in D:
                T.add(c)
                frontier.append(c)
    return T


def absorbing_set(trace: Trace, D: set, T: set) -> set:
    """Def. 4: outside nodes with a parent in D ∪ T (they re-score, not resample)."""
    DT = D | T
    A = set()
    for n in trace.nodes:
        if n in DT:
            continue
        if any(p in DT for p in n.parents):
            assert n.kind == "stochastic", (
                f"deterministic node {n} with a parent in D∪T must itself be in D∪T"
            )
            A.add(n)
    return A


def scaffold(trace: Trace, v: Node) -> Scaffold:
    D = target_set(trace, v)
    T = transient_set(trace, D)
    A = absorbing_set(trace, D, T)
    return Scaffold(v=v, D=D, T=T, A=A)


def border_node(trace: Trace, sc: Scaffold) -> Node:
    """Def. 6: first descendant of v (walking inside the scaffold through D)
    with multiple scaffold branches. A plate child counts as N branches."""
    n = sc.v
    seen = {n}
    while True:
        in_scaffold = [c for c in trace.children(n) if c in sc.nodes and c not in seen]
        plate_children = [c for c in in_scaffold if c.plate is not None]
        if plate_children:
            return n  # children live in a plate → N branches meet here
        if len(in_scaffold) != 1:
            return n
        n = in_scaffold[0]
        seen.add(n)


def partition(trace: Trace, sc: Scaffold) -> tuple[set, Plate | None]:
    """Defs. 7–8: (global section nodes, plate holding the local sections).

    Requires T = ∅ (paper Sec. 3.1: approximate transitions must not change
    trace structure) and all N local branches mediated by one border node.
    """
    if sc.T:
        raise ValueError(
            "subsampled MH requires T(rho, v) = ∅ — proposals must not change "
            "the trace structure (paper Sec. 3.1)"
        )
    b = border_node(trace, sc)
    local_nodes = {n for n in sc.nodes if n.plate is not None}
    global_nodes = sc.nodes - local_nodes
    plates = {n.plate for n in local_nodes}
    if len(plates) > 1:
        raise ValueError("scaffold spans multiple plates; sample one variable at a time")
    plate = plates.pop() if plates else None
    if plate is not None:
        # all local sections must hang off the border node with a single link
        for c in trace.children(b):
            if c in sc.nodes and c.plate is None and c is not b:
                pass  # global-side children are fine
    return global_nodes, plate

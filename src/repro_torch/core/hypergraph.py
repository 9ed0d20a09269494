"""Query hypergraphs (paper Section 2.1).

"There is a direct correspondence between a query and its hypergraph: a
vertex for each attribute and a hyperedge for each relation."
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.datalog import Atom, Rule, Var


@dataclasses.dataclass(frozen=True)
class HyperEdge:
    idx: int                 # position of the atom in the rule body
    rel: str                 # relation name
    vars: FrozenSet[str]

    def __repr__(self):
        return f"{self.rel}[{self.idx}]({','.join(sorted(self.vars))})"


@dataclasses.dataclass
class Hypergraph:
    vertices: Tuple[str, ...]
    edges: Tuple[HyperEdge, ...]

    @staticmethod
    def from_rule(rule: Rule) -> "Hypergraph":
        verts: List[str] = []
        edges: List[HyperEdge] = []
        for i, atom in enumerate(rule.body):
            vs = frozenset(atom.vars)
            for v in atom.vars:
                if v not in verts:
                    verts.append(v)
            edges.append(HyperEdge(i, atom.rel, vs))
        return Hypergraph(tuple(verts), tuple(edges))

    def edge_vars(self, edge_idxs: Sequence[int]) -> FrozenSet[str]:
        out: set = set()
        for i in edge_idxs:
            out |= self.edges[i].vars
        return frozenset(out)

    def connected_components(self, edge_idxs: FrozenSet[int],
                             separator: FrozenSet[str]) -> List[FrozenSet[int]]:
        """Components of the sub-hypergraph on ``edge_idxs`` where two edges
        are adjacent iff they share a variable NOT in ``separator``."""
        remaining = set(edge_idxs)
        comps: List[FrozenSet[int]] = []
        while remaining:
            seed = remaining.pop()
            comp = {seed}
            frontier_vars = set(self.edges[seed].vars) - set(separator)
            changed = True
            while changed:
                changed = False
                for e in list(remaining):
                    if set(self.edges[e].vars) & frontier_vars:
                        comp.add(e)
                        remaining.discard(e)
                        frontier_vars |= set(self.edges[e].vars) - set(separator)
                        changed = True
            comps.append(frozenset(comp))
        return comps

    def is_connected(self) -> bool:
        if not self.edges:
            return True
        comps = self.connected_components(
            frozenset(range(len(self.edges))), frozenset())
        return len(comps) == 1

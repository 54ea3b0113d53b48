"""Degree-aware selector placement tree.

A copy of the JAX package's cs/selector_tree.py (itself era-boojum's
TreeNode optimizer, setup.rs compute_selectors_and_constants_placement and
try_find_placement_for_degree), so that both packages place selectors
identically: gates are
packed into a variable-depth binary selector tree so that high-degree /
constant-hungry gates sit near the root (short selector paths) and cheap
gates absorb depth. Selector path bits occupy the leading constant columns
along each row's path; the gate's own constants start at column
`len(path)`. The lookup marker's degree at depth d is max(d, 2): its A
relations are of degree 2, its selector of degree d.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GateDescription:
    gate_idx: int
    num_constants: int
    degree: int
    is_lookup: bool = False

    def degree_at_depth(self, depth: int) -> int:
        if self.is_lookup:
            return max(depth, 2)
        return depth + self.degree


class TreeNode:
    """kind is one of 'Empty' | 'GateOnly' | 'Fork'."""

    def __init__(self, kind, gate=None, left=None, right=None):
        self.kind = kind
        self.gate = gate
        self.left = left
        self.right = right

    # -- queries ------------------------------------------------------------

    def output_placement(self, gate_idx: int):
        """Root-to-leaf bool path for the gate, True = left (setup.rs:1439)."""
        if self.kind == "Empty":
            return None
        if self.kind == "GateOnly":
            return [] if self.gate.gate_idx == gate_idx else None
        left = self.left.output_placement(gate_idx)
        if left is not None:
            return [True] + left
        right = self.right.output_placement(gate_idx)
        if right is not None:
            return [False] + right
        return None

    def compute_stats(self, depth: int = 0):
        """(max constraint degree incl. selector path, max constants used)
        — reference compute_stats_at_depth (setup.rs:1412)."""
        if self.kind == "Empty":
            assert depth == 0
            return (0, 0)
        if self.kind == "GateOnly":
            return (
                self.gate.degree_at_depth(depth),
                self.gate.num_constants + depth,
            )
        ls = self.left.compute_stats(depth + 1)
        rs = self.right.compute_stats(depth + 1)
        return (max(ls[0], rs[0]), max(ls[1], rs[1]))

    # -- construction (setup.rs:1466 try_add_gate) --------------------------

    def try_add_gate(
        self,
        gate: GateDescription,
        max_degree: int,
        max_constants: int,
        depth: int = 0,
    ):
        if self.kind == "Empty":
            if (
                gate.degree_at_depth(depth) > max_degree
                or gate.num_constants > max_constants
            ):
                return None
            return TreeNode("GateOnly", gate=gate)
        if self.kind == "GateOnly":
            for left, right in (
                (self.gate, gate),
                (gate, self.gate),
            ):
                candidate = TreeNode(
                    "Fork",
                    left=TreeNode("GateOnly", gate=left),
                    right=TreeNode("GateOnly", gate=right),
                )
                deg, consts = candidate.compute_stats(depth)
                if deg <= max_degree and consts <= max_constants:
                    return candidate
            return None
        new_left = self.left.try_add_gate(
            gate, max_degree, max_constants, depth + 1
        )
        if new_left is not None:
            return TreeNode("Fork", left=new_left, right=self.right)
        new_right = self.right.try_add_gate(
            gate, max_degree, max_constants, depth + 1
        )
        if new_right is not None:
            return TreeNode("Fork", left=self.left, right=new_right)
        return None


def try_find_placement_for_degree(
    gates, degree_bound: int, starting_num_constants: int
):
    """setup.rs:1328 — relax the constant budget a few times at fixed
    degree."""
    k = len(gates)
    upper = (max(k - 1, 1)).bit_length()
    for i in range(upper + 2):
        tree = TreeNode("Empty")
        ok = True
        for gate in gates:
            new = tree.try_add_gate(
                gate, degree_bound, starting_num_constants + i
            )
            if new is None:
                ok = False
                break
            tree = new
        if ok:
            return tree
    return None


def compute_selector_placement(descriptions) -> TreeNode:
    """Reference compute_selectors_and_constants_placement (setup.rs:486):
    stable-sort by (degree desc, constants desc), pick a power-of-two target
    degree from the max bare gate degree, insert greedily, doubling the
    target up to 4 times."""
    assert descriptions, "no gates to place"
    if len(descriptions) == 1:
        return TreeNode("GateOnly", gate=descriptions[0])
    gates = sorted(
        descriptions, key=lambda g: (-g.degree, -g.num_constants)
    )
    max_degree = max(g.degree_at_depth(0) for g in gates) - 1
    max_num_constants = max(g.num_constants for g in gates)
    target = max(1, max_degree)
    if target & (target - 1):
        target = 1 << target.bit_length()
    for _ in range(4):
        tree = try_find_placement_for_degree(
            gates, target, max_num_constants
        )
        if tree is not None:
            return tree
        target *= 2
    raise RuntimeError(
        f"cannot find a selector placement for target degree {target}"
    )

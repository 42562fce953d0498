"""YOLO9000 hierarchical softmax tree, darknet ``.tree`` and ``.map``
files (port of yolo_tpu/configs/tree.py, the same reader, invariants and
error messages).

The YOLO9000 paper (arXiv:1612.08242, section 4 "Hierarchical
classification") trains the v2 [region] head over a WordTree: class
logits are soft-maxed per sibling group (the children of one parent),
giving conditional probabilities Pr(node | parent); a node's absolute
probability is the product of the conditionals on its path to the root,
and prediction descends the tree taking the most confident child at
every split while that product stays above a threshold.

File format (darknet ``data/9k.tree``): one node per line, ``<name>
<parent-index>``, parent ``-1`` for roots, parents before their
children. Sibling groups are maximal runs of consecutive lines sharing
one parent value, as darknet's reader makes them.

Map files (darknet ``data/coco9k.map``): one tree-node index per line,
projecting a detection dataset's class list (COCO's 80) onto tree nodes.
The tree math on tensors is ops/decode.py's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SoftmaxTree:
    """Parsed WordTree. All derived structure is precomputed so the
    device code only gathers:

      parents[i]      parent node index, -1 for roots
      names[i]        node name (the class vocabulary)
      node_group[i]   sibling-group id of node i
      group_offset[g] first node of group g (groups are contiguous runs)
      group_size[g]   node count of group g
      child_group[i]  group id holding node i's children, -1 for leaves
    """

    parents: Tuple[int, ...]
    names: Tuple[str, ...]
    node_group: Tuple[int, ...]
    group_offset: Tuple[int, ...]
    group_size: Tuple[int, ...]
    child_group: Tuple[int, ...]

    @property
    def n_nodes(self) -> int:
        return len(self.parents)

    @property
    def n_groups(self) -> int:
        return len(self.group_offset)

    @property
    def max_group_size(self) -> int:
        return max(self.group_size)

    @functools.cached_property
    def max_depth(self) -> int:
        """Longest root->node path length (nodes on path, >= 1)."""
        return max(len(self.path(i)) for i in range(self.n_nodes))

    def __hash__(self) -> int:
        # computed once: the tree's constant tables are cached by it
        # (ops/decode.py::_tree_np_consts) and looked up on every forward
        return self._hash

    @functools.cached_property
    def _hash(self) -> int:
        # ints only, so a pickled tree keeps a valid hash in another
        # process; equal trees have equal parents and child groups
        return hash((self.parents, self.child_group))

    def path(self, node: int) -> Tuple[int, ...]:
        """Ancestor chain root-first, ending at ``node`` (inclusive)."""
        chain = []
        while node >= 0:
            chain.append(node)
            node = self.parents[node]
        return tuple(reversed(chain))

    def leaf(self, node: int) -> bool:
        return self.child_group[node] < 0

    def group_members(self, g: int) -> Tuple[int, ...]:
        off = self.group_offset[g]
        return tuple(range(off, off + self.group_size[g]))


def parse_tree(path: str) -> SoftmaxTree:
    """Read a darknet ``.tree`` file.

    Validates the invariants the YOLO9000 math relies on (all hold for
    the official ``9k.tree``) and fails loudly otherwise:
      * parents precede children (enables one-pass path products);
      * every root (parent -1) is in the FIRST group (prediction
        traversal starts there);
      * each parent's children form exactly one contiguous run (so
        "the children of node p" is a single softmax group).
    """
    parents, names = [], []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(
                    f"{path}:{lineno}: expected '<name> <parent>', "
                    f"got {line!r}")
            try:
                parent = int(parts[1])
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: parent must be an int, "
                    f"got {parts[1]!r}") from None
            idx = len(parents)
            if parent >= idx:
                raise ValueError(
                    f"{path}:{lineno}: parent {parent} does not precede "
                    f"node {idx} — darknet tree files list parents "
                    f"before children")
            if parent < -1:
                raise ValueError(
                    f"{path}:{lineno}: parent {parent} < -1")
            names.append(parts[0])
            parents.append(parent)
    if not parents:
        raise ValueError(f"{path}: empty tree file")

    # sibling groups = maximal runs of one parent value (darknet reader)
    node_group, group_offset, group_size = [], [], []
    group_parent = []
    for i, p in enumerate(parents):
        if not group_offset or p != group_parent[-1]:
            group_offset.append(i)
            group_size.append(0)
            group_parent.append(p)
        node_group.append(len(group_offset) - 1)
        group_size[-1] += 1

    seen_parent = {}
    for g, p in enumerate(group_parent):
        if p in seen_parent:
            raise ValueError(
                f"{path}: children of node {p} appear in two separate "
                f"runs (groups {seen_parent[p]} and {g}) — sibling "
                f"groups must be contiguous")
        seen_parent[p] = g
    if group_parent[0] != -1:
        raise ValueError(
            f"{path}: the first group must hold the roots (parent -1), "
            f"found parent {group_parent[0]}")

    child_group = [-1] * len(parents)
    for g, p in enumerate(group_parent):
        if p >= 0:
            child_group[p] = g

    return SoftmaxTree(
        parents=tuple(parents), names=tuple(names),
        node_group=tuple(node_group), group_offset=tuple(group_offset),
        group_size=tuple(group_size), child_group=tuple(child_group))


def parse_map(path: str, tree: Optional[SoftmaxTree] = None
              ) -> Tuple[int, ...]:
    """Read a darknet ``.map`` file: one tree-node index per line."""
    out = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line:
                continue
            try:
                idx = int(line)
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: map entries are tree-node "
                    f"indices, got {line!r}") from None
            if idx < 0 or (tree is not None and idx >= tree.n_nodes):
                bound = tree.n_nodes if tree is not None else "?"
                raise ValueError(
                    f"{path}:{lineno}: node index {idx} outside the "
                    f"tree (n_nodes={bound})")
            out.append(idx)
    if not out:
        raise ValueError(f"{path}: empty map file")
    return tuple(out)


def tree_paths_padded(tree: SoftmaxTree):
    """(n_nodes, max_depth) int32 ancestor matrix, row i = path(i)
    root-first, padded with -1 — the gather table for the path-product
    and the training path-loss (train/loss.py)."""
    import numpy as np

    depth = tree.max_depth
    out = np.full((tree.n_nodes, depth), -1, dtype=np.int32)
    for i in range(tree.n_nodes):
        p = tree.path(i)
        out[i, :len(p)] = p
    return out


def group_members_padded(tree: SoftmaxTree):
    """(n_groups, max_group_size) int32 member matrix padded with -1 —
    the traversal's per-group candidate table (ops/decode.py)."""
    import numpy as np

    out = np.full((tree.n_groups, tree.max_group_size), -1,
                  dtype=np.int32)
    for g in range(tree.n_groups):
        m = tree.group_members(g)
        out[g, :len(m)] = m
    return out

"""BVH topology validation: host-side numpy property checks of a binary
BVH (the reference's structural self-checks of every build, its
TestHierarchyLogic and max-depth probe). Counterpart of
`tpt/bvh/validate.py`: the same checks and the same report."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..scene.structs import LBVHData


@dataclass
class BVHReport:
    ok: bool
    num_leaves: int
    num_internal: int
    max_depth: int
    errors: List[str]


def validate_lbvh(bvh: LBVHData) -> BVHReport:
    h = bvh.numpy()
    left, right, parent = h["left"], h["right"], h["parent"]
    escape, prim = h["escape"], h["prim_index"]
    amin, amax = h["aabb_min"], h["aabb_max"]

    total = left.shape[0]
    n = (total + 1) // 2
    num_internal = n - 1
    errors: List[str] = []

    # root
    if parent[0] != -1:
        errors.append(f"root parent != -1 (got {parent[0]})")

    # parent/child mutual consistency
    for i in range(num_internal):
        for c in (left[i], right[i]):
            if not (0 <= c < total):
                errors.append(f"node {i} child {c} out of range")
            elif parent[c] != i:
                errors.append(f"child {c} of {i} has parent {parent[c]}")
        if len(errors) > 20:
            break

    # leaves carry prim ids; internals don't
    if not np.all(prim[num_internal:] >= 0):
        errors.append("leaf without prim index")
    if not np.all(prim[:num_internal] == -1):
        errors.append("internal node with prim index")
    # every original primitive appears exactly once
    counts = np.bincount(prim[num_internal:], minlength=n)
    if bvh.num_triangles >= 2 and not np.all(counts == 1):
        errors.append("primitive permutation not a bijection")

    # iterative DFS: reachability, cycle check, depth
    visited = np.zeros(total, bool)
    max_depth = 0
    stack = [(0, 1)]
    steps = 0
    while stack:
        steps += 1
        if steps > 4 * total:
            errors.append("cycle suspected (DFS overran)")
            break
        node, depth = stack.pop()
        if visited[node]:
            errors.append(f"node {node} visited twice (cycle/DAG)")
            break
        visited[node] = True
        max_depth = max(max_depth, depth)
        if node < num_internal:
            stack.append((int(left[node]), depth + 1))
            stack.append((int(right[node]), depth + 1))
    if not visited.all():
        errors.append(f"{(~visited).sum()} unreachable nodes")

    # AABB containment: parent contains children
    ip = np.arange(num_internal)
    lc = left[:num_internal]
    rc = right[:num_internal]
    eps = 1e-4
    for cs in (lc, rc):
        bad = np.any(amin[ip] > amin[cs] + eps) or np.any(amax[ip] < amax[cs] - eps)
        if bad:
            errors.append("parent AABB does not contain child AABB (refit not converged?)")
            break

    # escape links point forward in preorder or -1
    if escape[0] != -1:
        errors.append("root escape must be -1")

    return BVHReport(
        ok=not errors,
        num_leaves=n,
        num_internal=num_internal,
        max_depth=max_depth,
        errors=errors,
    )

"""Escape-linked BVH4 layout for the fused megakernel's in-loop walk.

The reference walks a binary BVH per pixel with a 28-deep stack of
(nodeID, boxT) pairs (GLTFModelPathTracing_FragmentShader.js:95,206-298).
The fused kernel instead walks ONE node per step for a whole block of rays
sharing a scalar cursor, reading node and triangle values by scalar loads;
subtree skipping then needs no stack at all: because the layout is preorder,
"skip this subtree" is just "jump to the record after it" — the classic
escape-link / threaded BVH.  Leaves are widened to `leaf_size` triangles so
the per-step overhead amortizes over a burst of triangle tests.

This module is the host-side (numpy) packing pass: collapse the binary tree
into clustered leaves, collapse that into a 4-ary tree with inlined leaf
children, reorder triangles into contiguous leaf ranges, and pack node and
triangle records into the row layouts the kernel reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from bpt_tpu.accel.builder import BuiltBVH


class Bvh4BVH(NamedTuple):
    """4-ary escape-linked BVH with inlined leaf children.

    A binary escape walk spends one step per node visited: one record
    load, ONE slab test, one block-wide any-reduce.  Collapsing to BVH4 packs
    FOUR child AABBs into one 32-float record, so each step makes a 4-way
    decision (4 slab tests amortize the same row load / step overhead), and
    leaf children are inlined in the parent record (meta < 0 encodes
    row_start*32 + row_count), so a leaf costs NO node visit at all — its
    triangle rows are processed at the parent's step.  Node count drops to
    the INNER nodes of the 4-ary tree (~1/6 of the padded binary table).

    Record layout, (N4, 32) f32, preorder:
      [ 0..23]  4x child AABB (min.xyz, max.xyz); absent children get the
                never-hit box (min=+1e30, max=-1e30)
      [24..27]  child meta: >= 0 -> inner child's record id;
                < 0 -> inlined leaf, -(row_start * 32 + row_count) in
                triangle rows (leaves are 4-slot aligned, one row each)
      [28]      escape (next record after this subtree)
      [29..31]  pad (0)
    All links are float-encoded (exact < 2^24, checked)."""

    nodes_f: np.ndarray  # (N4, 32) preorder records
    tris: np.ndarray  # (R, 128) triangle rows, 4 records each
    tri_order: np.ndarray  # (R*4,) packed slot -> original tri id
    n_nodes: int  # N4
    n_rows: int


def _collapse_binary(bvh: BuiltBVH, leaf_size: int):
    """Collapse the flat 1-tri-leaf binary BVH into the clustered binary
    tree + triangle slot order (leaf cid order == preorder), each leaf's
    slot run padded to whole 4-record rows."""
    node_tri = np.asarray(bvh.node_tri)
    node_right = np.asarray(bvh.node_right)
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    n = len(node_tri)
    count = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if node_tri[i] >= 0:
            count[i] = 1
        else:
            count[i] = count[i + 1] + count[node_right[i]]

    def leaves_of(i: int) -> list:
        ids, st = [], [i]
        while st:
            j = st.pop()
            if node_tri[j] >= 0:
                ids.append(int(node_tri[j]))
            else:
                st.append(int(node_right[j]))
                st.append(j + 1)
        return ids

    cmin, cmax, cleft, cright, ctri = [], [], [], [], []
    tri_order_raw: list = []
    stack = [(0, -1, 0)]
    while stack:
        x, parent, slot = stack.pop()
        cid = len(cmin)
        cmin.append(node_min[x])
        cmax.append(node_max[x])
        cleft.append(-1)
        cright.append(-1)
        ctri.append((0, 0))
        if parent >= 0:
            if slot == 0:
                cleft[parent] = cid
            else:
                cright[parent] = cid
        if node_tri[x] >= 0 or count[x] <= leaf_size:
            ids = leaves_of(x)
            ctri[cid] = (len(tri_order_raw), len(ids))
            tri_order_raw.extend(ids)
        else:
            stack.append((int(node_right[x]), cid, 1))
            stack.append((x + 1, cid, 0))
    n_nodes = len(cmin)

    slots: list = []
    row_of = {}
    for cid in range(n_nodes):
        s, c = ctri[cid]
        if cleft[cid] < 0:
            row_of[cid] = (len(slots) // 4, (c + 3) // 4)
            slots.extend(int(t) for t in tri_order_raw[s:s + c])
            slots.extend([-1] * (-c % 4))
    n_rows = len(slots) // 4
    return cmin, cmax, cleft, cright, row_of, slots, n_rows


def _pack_rows(slots, n_rows, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, tri_attr):
    """(R, 128) triangle row table from packed slot ids: four 32-float
    records per row, [p0 p1 p2 n0 n1 n2 uv0 uv1 uv2 attr8]; pad slots are
    all-zero records, which the triangle test rejects (t <= 0)."""
    order = np.asarray(slots, np.int32)
    rec32 = np.zeros((len(order), 32), np.float32)
    real = order >= 0
    o = order[real]
    rec32[real, 0:3] = p0[o]
    rec32[real, 3:6] = p1[o]
    rec32[real, 6:9] = p2[o]
    rec32[real, 9:12] = n0[o]
    rec32[real, 12:15] = n1[o]
    rec32[real, 15:18] = n2[o]
    rec32[real, 18:20] = uv0[o]
    rec32[real, 20:22] = uv1[o]
    rec32[real, 22:24] = uv2[o]
    if tri_attr is not None:
        na = tri_attr.shape[1]
        assert na <= 8, "only 8 free floats per 32-float record"
        rec32[real, 24:24 + na] = tri_attr[o]
    return rec32.reshape(n_rows, 128), order


def pack_bvh4(
    bvh: BuiltBVH,
    p0: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    n0: np.ndarray,
    n1: np.ndarray,
    n2: np.ndarray,
    uv0: np.ndarray,
    uv1: np.ndarray,
    uv2: np.ndarray,
    leaf_size: int = 16,
    tri_attr: np.ndarray | None = None,
) -> Bvh4BVH:
    """Collapse + pack into the BVH4 inlined-leaf layout (see Bvh4BVH)."""
    if leaf_size > 31 * 4:
        raise ValueError("leaf_size > 124 overflows the 5-bit leaf row count")
    cmin, cmax, cleft, cright, row_of, slots, n_rows = _collapse_binary(bvh, leaf_size)
    rows, order = _pack_rows(slots, n_rows, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, tri_attr)

    def leaf_meta(cid):
        rs, rc = row_of[cid]
        return -float(rs * 32 + rc)

    def kids4(x):
        """2-4 children of 4-ary node x (binary cids): an inner binary
        child is expanded into its two children (one collapsed level)."""
        out = []
        for c in (cleft[x], cright[x]):
            if cleft[c] >= 0:
                out.extend([cleft[c], cright[c]])
            else:
                out.append(c)
        return out

    NEVER = np.array([1e30, 1e30, 1e30, -1e30, -1e30, -1e30], np.float32)

    def emit():
        """Preorder records for the INNER 4-ary nodes only."""
        rec = []  # each: np.float32[32]
        # stack ops: ("v", binary_cid, parent_rec, slot) / ("c", rec_idx)
        if cleft[0] < 0:
            # whole mesh fits one clustered leaf: single record with one
            # inlined leaf child
            r = np.zeros(32, np.float32)
            r[0:3] = cmin[0]
            r[3:6] = cmax[0]
            r[6:24] = NEVER[0:6].tolist() * 3
            r[24] = leaf_meta(0)
            r[25] = r[26] = r[27] = 0.0
            for k in range(1, 4):
                r[6 * k:6 * k + 6] = NEVER
            r[28] = 1.0
            rec.append(r)
        else:
            st = [("v", 0, -1, 0)]
            while st:
                op = st.pop()
                if op[0] == "c":
                    rec[op[1]][28] = float(len(rec))
                    continue
                _, x, prec, slot = op
                my = len(rec)
                if prec >= 0:
                    rec[prec][24 + slot] = float(my)
                kids = kids4(x)
                r = np.zeros(32, np.float32)
                for k in range(4):
                    if k < len(kids):
                        r[6 * k:6 * k + 3] = cmin[kids[k]]
                        r[6 * k + 3:6 * k + 6] = cmax[kids[k]]
                    else:
                        r[6 * k:6 * k + 6] = NEVER
                rec.append(r)
                st.append(("c", my))
                # leaf children inline; inner children emit in slot order
                # (push reversed so the first inner child pops first)
                inner = []
                for k, c in enumerate(kids):
                    if cleft[c] < 0:
                        r[24 + k] = leaf_meta(c)
                    else:
                        inner.append((c, my, k))
                for c, pr, k in reversed(inner):
                    st.append(("v", c, pr, k))
        return np.stack(rec)

    nodes = emit()
    n4 = nodes.shape[0]
    if max(n4, n_rows * 32) >= 1 << 24:
        raise ValueError("mesh too large for the float-linked BVH4 pack")
    return Bvh4BVH(nodes, rows, order, n4, n_rows)

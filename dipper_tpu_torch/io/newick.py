"""Host-side Newick tree: parse + serialize.

Replicates the observable semantics of the reference host tree
(src/tree.cpp:216-361, src/tree.hpp:11-51):

- leaf `idx` assigned in Newick encounter order (tree.cpp:341,
  m_numLeafID++),
- internal `idx` assigned in preorder of '(' starting at
  `totalLeaves` (tree.cpp:308-317: m_currInternalNode = totalLeaves-1,
  first internal gets m_currInternalNode+1),
- internal names "node_<idx>" (tree.hpp:41),
- quoted leaf names supported ('...'),
- root branch length forced to 0 (tree.cpp:358).

The serializer mirrors the builders' printTree recursion
(src/placement_close_k.cu:568-643, src/neighborJoining.cu:252-270):
children in adjacency order, "%.6g"-style lengths (C++ default ostream
precision).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class Node:
    __slots__ = ("name", "idx", "bl", "parent", "children")

    def __init__(self, name: str, bl: float = 0.0, parent: "Optional[Node]" = None):
        self.name = name
        self.bl = bl
        self.parent = parent
        self.children: List[Node] = []
        self.idx = -1
        if parent is not None:
            parent.children.append(self)

    def is_leaf(self) -> bool:
        return not self.children


class Tree:
    def __init__(self, root: Node, all_nodes: Dict[str, Node], num_leaves: int):
        self.root = root
        self.all_nodes = all_nodes
        self.num_leaves = num_leaves

    def leaf_names_in_idx_order(self) -> List[str]:
        names = [""] * self.num_leaves
        for n in self.all_nodes.values():
            if n.is_leaf():
                names[n.idx] = n.name
        return names


def parse_newick(newick: str, total_leaves: int) -> Tree:
    """Parse a Newick string.

    `total_leaves` plays the role of the reference's `totalLeaves` ctor
    argument: internal node ids start at `total_leaves` (so that, in
    --add mode, query middle nodes N+i-1 never collide)."""
    s = newick.strip()
    if s.endswith(";"):
        s = s[:-1]
    pos = 0
    n = len(s)
    leaf_counter = 0
    internal_counter = total_leaves - 1
    all_nodes: Dict[str, Node] = {}

    def parse_name_and_bl():
        nonlocal pos
        name = []
        if pos < n and s[pos] == "'":
            pos += 1
            while pos < n and s[pos] != "'":
                name.append(s[pos])
                pos += 1
            pos += 1  # closing quote
        else:
            while pos < n and s[pos] not in ",():;":
                name.append(s[pos])
                pos += 1
        bl = 1.0
        if pos < n and s[pos] == ":":
            pos += 1
            st = pos
            while pos < n and s[pos] not in ",()":
                pos += 1
            try:
                bl = float(s[st:pos])
            except ValueError:
                bl = 1.0
        return "".join(name), bl

    def parse_subtree(parent: Optional[Node]) -> Node:
        nonlocal pos, leaf_counter, internal_counter
        if s[pos] == "(":
            internal_counter += 1
            idx = internal_counter
            node = Node(f"node_{idx}", 0.0, parent)
            node.idx = idx
            pos += 1  # consume '('
            while True:
                parse_subtree(node)
                if pos < n and s[pos] == ",":
                    pos += 1
                    continue
                break
            if pos < n and s[pos] == ")":
                pos += 1
            name, bl = parse_name_and_bl()
            # internal node label in input is discarded (reference names
            # internals "node_<k>" itself); branch length kept
            node.bl = bl
            all_nodes[node.name] = node
            return node
        name, bl = parse_name_and_bl()
        node = Node(name, bl, parent)
        node.idx = leaf_counter
        leaf_counter += 1
        all_nodes[name] = node
        return node

    root = parse_subtree(None)
    root.bl = 0.0
    return Tree(root, all_nodes, leaf_counter)


def _fmt(x: float) -> str:
    # C++ default ostream formatting: 6 significant digits
    return f"{x:.6g}"


def write_newick(tree: Tree) -> str:
    out: List[str] = []

    def rec(node: Node):
        if node.is_leaf():
            out.append(node.name)
            return
        out.append("(")
        for i, ch in enumerate(node.children):
            rec(ch)
            out.append(":")
            out.append(_fmt(ch.bl))
            out.append(")" if i + 1 == len(node.children) else ",")

    rec(tree.root)
    out.append(";")
    return "".join(out)


def edge_arrays_newick(num_leaves: int, names: List[str], belong, e,
                       length, root: int) -> str:
    """Serialize directly from flat edge arrays (belong=src, e=dst,
    length) without materializing a per-node Python adjacency list —
    the grouping is one vectorized argsort-by-source (CSR layout), so
    the only Python-rate work left is the DFS emit itself. Bitwise
    identical output to adjacency_newick over the same edges: a stable
    sort preserves edge-id order within each source node, which is the
    adjacency order the device printTree recursion uses."""
    import numpy as np

    belong = np.asarray(belong)
    e = np.asarray(e)
    length = np.asarray(length, dtype=np.float64)
    ok = (belong >= 0) & (e >= 0)
    src = belong[ok]
    dst = e[ok]
    ln = length[ok]
    order = np.argsort(src, kind="stable")
    dst = dst[order]
    ln = ln[order]
    counts = np.bincount(src[order], minlength=2 * num_leaves)
    starts = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    nat = _native_emit(starts, dst, ln, names, root)
    if nat is not None:
        return nat

    out: List[str] = []
    dst_l = dst.tolist()
    ln_l = ln.tolist()
    starts_l = starts.tolist()
    # frames: (node, parent, None | (child_edge_slots, next_child))
    stack = [(root, -1, None)]
    while stack:
        node, parent, it = stack.pop()
        if it is None:
            s, t = starts_l[node], starts_l[node + 1]
            nbrs = [i for i in range(s, t) if dst_l[i] != parent]
            if not nbrs:
                out.append(names[node])
                continue
            out.append("(")
            it = (nbrs, 0)
        nbrs, i = it
        if i > 0:
            out.append(":")
            out.append(_fmt(ln_l[nbrs[i - 1]]))
            out.append(")" if i == len(nbrs) else ",")
        if i < len(nbrs):
            stack.append((node, parent, (nbrs, i + 1)))
            stack.append((dst_l[nbrs[i]], node, None))
    out.append(";")
    return "".join(out)


_nwlib = None
_nwlib_tried = False


def _native_emit(starts, dst, ln, names, root):
    """C DFS emit (native/newick.cpp) — byte-identical to the Python
    stack walk below (asserted by tests), ~30x faster (the Python walk
    is ~10 s at N=1M). Returns None when the library is unavailable."""
    global _nwlib, _nwlib_tried
    import ctypes
    import numpy as np

    if not _nwlib_tried:
        _nwlib_tried = True
        from dipper_tpu_torch.utils.native_lib import native_library

        try:
            so = native_library("libnewick.so", "newick.cpp")
            if so is None:
                raise OSError("native/libnewick.so could not be built")
            lib = ctypes.CDLL(so)
            lib.newick_emit.restype = ctypes.c_int64
            lib.newick_emit.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ]
            lib.newick_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
            _nwlib = lib
        except Exception:
            _nwlib = None
    if _nwlib is None:
        return None

    n_nodes = len(starts) - 1
    enc = [s.encode() for s in names]
    enc += [b""] * (n_nodes - len(enc))
    name_off = np.zeros(n_nodes + 1, np.int64)
    np.cumsum([len(x) for x in enc], out=name_off[1:])
    blob = b"".join(enc)
    if len(dst) == 0:
        return None  # degenerate input: let the Python walk handle it
    starts = np.ascontiguousarray(starts, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    ln = np.ascontiguousarray(ln, np.float64)
    out_p = ctypes.POINTER(ctypes.c_char)()
    pi64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    pf64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    sz = _nwlib.newick_emit(
        pi64(starts), n_nodes, pi64(dst), pf64(ln),
        blob, pi64(name_off), root, ctypes.byref(out_p))
    try:
        return ctypes.string_at(out_p, sz).decode()
    finally:
        _nwlib.newick_free(out_p)


def adjacency_newick(num_leaves: int, names: List[str], edges, root: int) -> str:
    """Serialize from a (node -> [(child, bl), ...]) adjacency structure,
    mirroring the device printTree recursion: node ids < num_leaves are
    leaves; every other node prints '(' + children in adjacency order.

    `edges` is a dict or list mapping node id -> list of (neighbor, length);
    traversal avoids the edge back to the parent."""
    out: List[str] = []

    # iterative DFS to avoid recursion limits on 1M-taxon trees
    # frames: (node, parent, child_iter_state)
    stack = [(root, -1, None)]
    while stack:
        node, parent, it = stack.pop()
        if it is None:
            nbrs = [(v, l) for (v, l) in edges[node] if v != parent]
            if not nbrs:
                out.append(names[node])
                continue
            out.append("(")
            it = (nbrs, 0)
        nbrs, i = it
        if i > 0:
            # just returned from child i-1
            out.append(":")
            out.append(_fmt(nbrs[i - 1][1]))
            out.append(")" if i == len(nbrs) else ",")
        if i < len(nbrs):
            stack.append((node, parent, (nbrs, i + 1)))
            stack.append((nbrs[i][0], node, None))
    out.append(";")
    return "".join(out)

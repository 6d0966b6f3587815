"""The pipeline's placement entry points: k-closest, exact, --add."""

from __future__ import annotations

import sys

import numpy as np
import torch

from dipper_tpu_torch.placement import kclosest
from dipper_tpu_torch.utils.device import torch_dtype
from dipper_tpu_torch.utils.params import Param


def run_fingerprint(params: Param, names) -> dict:
    """Identifies a build for checkpoint/resume: resuming with a
    different input file, shuffle seed, or sketch config that happens
    to share N must be refused (the distance rows would not match)."""
    import hashlib

    h = hashlib.sha256()
    for nm in names:
        h.update(nm.encode())
        h.update(b"\0")
    return {
        "names_sha256": h.hexdigest()[:16],
        "shuffle_seed": params.shuffle_seed,
        "kmer_size": params.kmer_size,
        "sketch_size": params.sketch_size,
        "distance_type": params.distance_type,
        "in_format": params.in_format,
    }


def _mash_frontend(seqs, params: Param, device: torch.device, log=None):
    """The padded int32 rank bank on `device`, and (k, sketch_size)."""
    from dipper_tpu_torch.distance.mash import mash_rank_bank

    ranks = mash_rank_bank(seqs, params, device, log=log)
    return (ranks,), (params.kmer_size, params.sketch_size)


def _msa_frontend(seqs, params: Param, device: torch.device):
    """The aligned bank as [N, L] uint8 codes on `device` with the
    per-sequence non-gap counts in the run's type, and (distance_type,).
    The one-hot channels are expanded a tile at a time
    (distance/msa.py::msa_tiled_block), so the resident bank is one byte
    a base."""
    from dipper_tpu_torch.distance.msa import nongap_counts
    from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes

    codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    codes_d = torch.from_numpy(codes).to(device)
    return ((codes_d, nongap_counts(codes_d, params.dtype)),
            (params.distance_type,))


def _seq_frontend(seqs, params: Param, device: torch.device, log=None):
    """(frontend_args, frontend, frontend_static) of aligned (-i m) or
    unaligned (-i r) sequences."""
    if params.in_format == "m":
        args, static = _msa_frontend(seqs, params, device)
        return args, "msa", static
    args, static = _mash_frontend(seqs, params, device, log=log)
    return args, "mash", static


def _build(frontend_args, frontend, frontend_static, names, params: Param,
           exact: bool, log) -> str:
    n = len(names)
    kw = dict(num_sequences=n, frontend=frontend,
              frontend_static=frontend_static, dtype_name=params.dtype,
              chunk=params.state_chunk, save_state=params.save_state,
              load_state=params.load_state,
              fingerprint=run_fingerprint(params, names), log=log)
    if exact:
        from dipper_tpu_torch.placement.exact import run_exact_placement

        e, belong, length = run_exact_placement(frontend_args, **kw)
    else:
        st = kclosest.run_placement_chunked(
            frontend_args, use_caps=params.prefix_caps, **kw)
        e, belong, length = st.e, st.belong, st.length
    return kclosest.edges_to_newick(e, belong, length, names, n)


def build_placement_tree_from_matrix(D, names, params: Param, *, device,
                                     exact=False, log=None) -> str:
    """Placement tree (Newick; k-closest, or exact) of a host distance
    matrix, built on `device`."""
    Dt = torch.from_numpy(np.asarray(D, dtype=params.dtype)).to(device)
    return _build((Dt,), "matrix", (), names, params, exact, log)


def build_placement_tree_from_seqs(seqs, names, params: Param, *, device,
                                   exact=False, log=None) -> str:
    """Placement tree (Newick; k-closest, or exact) of aligned sequences
    (params.in_format "m", MSA distances) or unaligned ones (mash
    distances), built on `device`."""
    frontend_args, frontend, frontend_static = _seq_frontend(
        seqs, params, device, log=log)
    return _build(frontend_args, frontend, frontend_static, names, params,
                  exact, log)


def backbone_tree_to_arrays(tree, num_sequences: int):
    """Host Tree -> host edge arrays (e, belong, length, rev) of 4N slots
    via postorder DFS emitting child->parent then parent->child edge
    pairs (initializeDeviceArrays, src/placement_close_k.cu:159-184)."""
    E = 4 * num_sequences
    e = np.full(E, -1, np.int32)
    belong = np.full(E, -1, np.int32)
    length = np.zeros(E, np.float64)
    rev = np.full(E, -1, np.int32)
    cursor = 0

    stack = [(tree.root, False)]
    order = []
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        stack.append((node, True))
        # push reversed so children are visited in order (matches the
        # reference's recursive postorder; edge-id order is load-bearing
        # for argmin tie-breaks)
        for ch in reversed(node.children):
            stack.append((ch, False))
    for node in order:
        if node.parent is None:
            continue
        x, y = node.idx, node.parent.idx
        e[cursor] = y
        belong[cursor] = x
        length[cursor] = node.bl
        rev[cursor] = cursor + 1
        e[cursor + 1] = x
        belong[cursor + 1] = y
        length[cursor + 1] = node.bl
        rev[cursor + 1] = cursor
        cursor += 2
    return e, belong, length, rev


def add_queries_to_backbone(tree, seqs, names, params: Param,
                            backbone_size: int, *, device, log=None) -> str:
    """--add: the backbone `tree` (leaves 0..backbone_size-1 of `seqs`)
    with the remaining sequences placed onto it, as Newick, built on
    `device`."""
    n = len(seqs)
    if params.in_format not in ("m", "r"):
        print("Adding new sequences only supported with input aligned "
              "and unaligned sequences", file=sys.stderr)
        raise SystemExit(1)
    frontend_args, frontend, frontend_static = _seq_frontend(
        seqs, params, device, log=log)
    e0, belong0, length0, rev0 = backbone_tree_to_arrays(tree, n)
    # multifurcating backbones (legal Newick, handled by the reference's
    # linked-list adjacency) have out-degree > 3 and would overflow the
    # [M,3] compact-BFS table: on the card their wide nodes' out-edges
    # go to a table of their own, which kernel 6's wide instantiation
    # reads (the seeding in one closest_bfs_range launch); on the CPU
    # they take the dense BFS
    deg = np.bincount(belong0[belong0 >= 0])
    max_deg = int(deg.max(initial=0))
    if max_deg > 3 and log:
        route = (f"insert_step.cu's wide table ({int((deg > 3).sum())} "
                 "nodes of degree > 3), seeded by closest_bfs_range"
                 if torch.device(device).type == "cuda"
                 else "using dense witness BFS")
        log(f"Backbone has multifurcations (max degree {max_deg}); {route}")
    e, belong, length = kclosest.run_add_queries(
        frontend_args,
        torch.from_numpy(e0).to(device), torch.from_numpy(belong0).to(device),
        torch.from_numpy(length0).to(torch_dtype(params.dtype)).to(device),
        torch.from_numpy(rev0).to(device),
        num_sequences=n, backbone_size=backbone_size, frontend=frontend,
        frontend_static=frontend_static, dtype_name=params.dtype,
        use_adj=(max_deg <= 3), log=log,
    )
    return kclosest.edges_to_newick(e, belong, length, names, n)

"""Pipeline driver: mode dispatch mirroring src/tree_generation.cu:159-648.

Auto-mode thresholds (tree_generation.cu:247-248): NJ for N < 30_000,
placement for 30_000 <= N < 1_000_000, divide-and-conquer above. The
port runs conventional NJ and placement (k-closest, or exact where the
-m value is 0) from unaligned FASTA (-i r, mash distances), aligned
FASTA (-i m, the six MSA models) and PHYLIP matrices (-i d), writes the
distance matrix (-i r/-i m with -o d), places queries onto a backbone
tree (--add) and runs divide-and-conquer from -i r and -i m (a matrix is
refused in that mode, as by the reference). In a multi-process run every
rank reads, shuffles and sketches the input itself; NJ and D&C split
their work over `--devices` ranks (parallel/sharded.py), the other modes
run whole on every rank, and rank 0 alone writes the output.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from dipper_tpu_torch.utils.device import synchronize
from dipper_tpu_torch.utils.params import Param, PLACEMENT_THRESHOLD, DC_THRESHOLD


def _log(msg: str):
    print(msg, file=sys.stderr)


def _write_tree(nwk: str, out_path: str):
    """Writes the Newick output (rank 0 only in a multi-process run: every
    rank holds the same tree; one writer suffices)."""
    from dipper_tpu_torch.parallel.distributed import is_primary

    if not is_primary():
        return
    with open(out_path, "w") as f:
        f.write(nwk + "\n")


def _choose_mode(algo: str, n: int) -> str:
    if algo == "1":
        return "placement"
    if algo == "2":
        return "nj"
    if algo == "3":
        return "dc"
    if n >= DC_THRESHOLD:
        return "dc"
    if n >= PLACEMENT_THRESHOLD:
        return "placement"
    return "nj"


def _log_placement(placemode: str) -> bool:
    """Logs the placement mode; True for exact placement (the -m value
    0, which auto mode reaches at N >= PLACEMENT_THRESHOLD)."""
    exact = placemode == "0"
    _log("Using exact placement mode" if exact
         else "Using k-closest placement mode")
    return exact


def _log_nj(n: int) -> None:
    _log("Using conventional NJ")
    if n >= 40_000:
        _log("Warning: forcing conventional NJ on large datasets "
             "might result in unexpected behavior")


def _load_sequences(params: Param, path: str):
    """Read FASTA + apply the input-order shuffle
    (tree_generation.cu:341-344: ids are shuffled and sequence i is
    stored at slot ids[i])."""
    from dipper_tpu_torch.io.fasta import read_fasta

    names_in, seqs_in = read_fasta(path)
    n = len(seqs_in)
    if params.shuffle_seed is not None:
        rng = np.random.default_rng(params.shuffle_seed)
        ids = rng.permutation(n)
    else:
        ids = np.arange(n)
    names = [""] * n
    seqs = [b""] * n
    for i in range(n):
        names[ids[i]] = names_in[i]
        seqs[ids[i]] = seqs_in[i]
    return names, seqs


def run_pipeline(params: Param, algo: str, placemode: str, args,
                 device) -> None:
    """Runs the CLI's request on `device` (a torch.device)."""
    if args.add:
        _run_add(params, args, device)
    elif params.in_format == "d":
        _run_matrix(params, algo, placemode, args, device)
    elif params.in_format in ("r", "m"):
        _run_sequences(params, algo, placemode, args, device)
    else:
        raise SystemExit("Invalid input-output combination")


def _run_matrix(params: Param, algo: str, placemode: str, args, device):
    from dipper_tpu_torch.io.phylip import read_phylip_lower_triangular
    from dipper_tpu_torch.placement import build_placement_tree_from_matrix

    t0 = time.time()
    names, D = read_phylip_lower_triangular(args.input_file)
    n = len(names)
    _log(f"Input in: {int((time.time() - t0) * 1000)} ms")
    mode = _choose_mode(algo, n)
    if mode == "dc":
        raise SystemExit("Divide-and-conquer mode not supported with input matrix")
    if mode == "nj":
        _log_nj(n)
        _write_nj(D, names, params, device, args.output_file)
        return
    nwk = build_placement_tree_from_matrix(
        D, names, params, device=device, exact=_log_placement(placemode),
        log=_log)
    _write_tree(nwk, args.output_file)


def _run_sequences(params: Param, algo: str, placemode: str, args, device):
    from dipper_tpu_torch.placement import build_placement_tree_from_seqs

    t0 = time.time()
    names, seqs = _load_sequences(params, args.input_file)
    n = len(seqs)
    _log(f"Input in: {int((time.time() - t0) * 1000)} ms")

    if params.out_format == "d":
        # distance-matrix output: the matrix NJ would use, widened to f64
        from dipper_tpu_torch.io.phylip import write_phylip_lower_triangular

        from dipper_tpu_torch.parallel.distributed import is_primary

        D = _distance_matrix(params, seqs, device)
        if is_primary():
            write_phylip_lower_triangular(
                names, D.cpu().numpy().astype(np.float64), args.output_file)
        return

    mode = _choose_mode(algo, n)
    if mode == "nj":
        _log_nj(n)
        D = _distance_matrix(params, seqs, device)
        _write_nj(D, names, params, device, args.output_file)
    elif mode == "placement":
        nwk = build_placement_tree_from_seqs(
            seqs, names, params, device=device,
            exact=_log_placement(placemode), log=_log)
        _write_tree(nwk, args.output_file)
    else:
        _run_dc(seqs, names, params, args.output_file, device)


def _make_mesh(params: Param, device):
    """The Mesh of the first min(--devices, ranks) ranks of the
    multi-process group, or None (one rank, or --devices 1): the
    single-device build. Every rank calls it."""
    if params.devices <= 1:
        return None
    from dipper_tpu_torch.parallel.distributed import world

    nd = min(params.devices, world()[1])
    if nd <= 1:
        _log(f"--devices {params.devices}: one device here ({device}), "
             "building unsharded")
        return None
    from dipper_tpu_torch.parallel.sharded import make_mesh

    mesh = make_mesh(nd, device, log=_log)
    if mesh is not None:
        _log(f"Sharding over {nd} devices")
    return mesh


def _run_dc(seqs, names, params: Param, out_path: str, device):
    from dipper_tpu_torch.dc import build_dc_tree

    _log("Using divide-and-conquer mode")
    backbone = len(seqs) // 20
    params = dataclasses.replace(params, backbone_size=backbone,
                                 batch_size=backbone)
    mesh = _make_mesh(params, device)
    _write_tree(build_dc_tree(seqs, names, params, device=device, log=_log,
                              mesh=mesh), out_path)


def _distance_matrix(params: Param, seqs, device):
    """The [N, N] distance matrix on `device`, in params.dtype: MSA
    distances of aligned sequences (-i m), else mash distances."""
    if params.in_format == "m":
        from dipper_tpu_torch.distance.msa import msa_distance_matrix
        from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes

        t0 = time.time()
        codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
        _log(f"Encoded in: {int((time.time() - t0) * 1000)} ms")
        t0 = time.time()
        D = msa_distance_matrix(codes, params.distance_type, params.dtype,
                                device)
    else:
        # the device sketch bank and device ranks, as dipper_tpu/driver.py
        # routes the NJ matrix and -o d
        from dipper_tpu_torch.distance.mash import (mash_distance_matrix,
                                                    mash_rank_bank_device)

        ranks = mash_rank_bank_device(seqs, params, device, log=_log)
        t0 = time.time()
        D = mash_distance_matrix(ranks, params.kmer_size, params.sketch_size,
                                 params.dtype, device)
    synchronize(device)
    _log(f"Distance matrix in: {int((time.time() - t0) * 1000)} ms")
    return D


def _write_nj(D, names, params: Param, device, out_path: str):
    from dipper_tpu_torch.nj import neighbor_joining, nj_tree_newick

    mesh = _make_mesh(params, device)
    t0 = time.time()
    children, root = neighbor_joining(D, dtype_name=params.dtype,
                                      device=device, mesh=mesh, log=_log)
    _log(f"NJ in: {int((time.time() - t0) * 1000)} ms")
    _write_tree(nj_tree_newick(children, root, names), out_path)


def _run_add(params: Param, args, device):
    """--add: place query tips onto an existing backbone tree
    (tree_generation.cu:252-332)."""
    from dipper_tpu_torch.io.newick import parse_newick
    from dipper_tpu_torch.placement import add_queries_to_backbone

    names_dump, seqs = _load_sequences(
        # --add path does NOT shuffle in the reference
        dataclasses.replace(params, shuffle_seed=None), args.input_file
    )
    with open(args.input_tree) as f:
        newick = f.readline().strip()
    tree = parse_newick(newick, total_leaves=len(seqs))
    backbone_size = tree.num_leaves
    # remap: backbone leaves keep their tree ids; queries appended
    names = [""] * backbone_size
    id_map = {}
    for i, nm in enumerate(names_dump):
        node = tree.all_nodes.get(nm)
        if node is None or not node.is_leaf():
            names.append(nm)
            id_map[i] = len(names) - 1
        else:
            names[node.idx] = nm
            id_map[i] = node.idx
    seqs_re = [b""] * len(seqs)
    for i, s in enumerate(seqs):
        seqs_re[id_map[i]] = s
    nwk = add_queries_to_backbone(tree, seqs_re, names, params, backbone_size,
                                  device=device, log=_log)
    _write_tree(nwk, args.output_file)

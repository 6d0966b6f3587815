"""Pipeline driver: mode dispatch mirroring src/tree_generation.cu:159-648.

Auto-mode thresholds (tree_generation.cu:247-248): NJ for N < 30_000,
placement for 30_000 <= N < 1_000_000, divide-and-conquer above. The
port runs conventional NJ and k-closest placement from unaligned FASTA
(-i r, through mash distances) and PHYLIP matrices (-i d), and writes
the mash distance matrix (-i r -o d); every other mode stops with
NotYetPorted.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from dipper_tpu_torch.utils.device import synchronize
from dipper_tpu_torch.utils.params import Param, PLACEMENT_THRESHOLD, DC_THRESHOLD


class NotYetPorted(Exception):
    """A mode of the JAX package that this port does not run yet."""


def _not_ported(what: str) -> NotYetPorted:
    return NotYetPorted(f"{what} is not yet ported to dipper_tpu_torch "
                        "(see ROADMAP.md)")


def _log(msg: str):
    print(msg, file=sys.stderr)


def _write_tree(nwk: str, out_path: str):
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


def _check_placement(placemode: str) -> None:
    if placemode == "0":
        raise _not_ported("exact placement (-m 0 at N >= "
                          f"{PLACEMENT_THRESHOLD})")


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
        raise _not_ported("--add (placing queries onto a backbone tree)")
    if params.in_format == "d":
        _run_matrix(params, algo, placemode, args, device)
    elif params.in_format == "r":
        _run_sequences(params, algo, placemode, args, device)
    elif params.in_format == "m":
        raise _not_ported("aligned-FASTA input (-i m, MSA distances)")
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
    _check_placement(placemode)
    _log("Using k-closest placement mode")
    nwk = build_placement_tree_from_matrix(D, names, params, device=device,
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

        D = _distance_matrix(params, seqs, device)
        write_phylip_lower_triangular(
            names, D.cpu().numpy().astype(np.float64), args.output_file)
        return

    mode = _choose_mode(algo, n)
    if mode == "nj":
        _log_nj(n)
        D = _distance_matrix(params, seqs, device)
        _write_nj(D, names, params, device, args.output_file)
    elif mode == "placement":
        _check_placement(placemode)
        _log("Using k-closest placement mode")
        nwk = build_placement_tree_from_seqs(seqs, names, params,
                                             device=device, log=_log)
        _write_tree(nwk, args.output_file)
    else:
        raise _not_ported("divide-and-conquer mode")


def _distance_matrix(params: Param, seqs, device):
    """The [N, N] mash distance matrix on `device`, in params.dtype."""
    from dipper_tpu_torch.distance.mash import (mash_distance_matrix,
                                                mash_rank_bank)

    ranks = mash_rank_bank(seqs, params, device, log=_log)
    t0 = time.time()
    D = mash_distance_matrix(ranks, params.kmer_size, params.sketch_size,
                             params.dtype, device)
    synchronize(device)
    _log(f"Distance matrix in: {int((time.time() - t0) * 1000)} ms")
    return D


def _write_nj(D, names, params: Param, device, out_path: str):
    from dipper_tpu_torch.nj import neighbor_joining, nj_tree_newick

    t0 = time.time()
    children, root = neighbor_joining(D, dtype_name=params.dtype,
                                      device=device)
    _log(f"NJ in: {int((time.time() - t0) * 1000)} ms")
    _write_tree(nj_tree_newick(children, root, names), out_path)

"""Driver-facing placement entry points (k-closest)."""

from __future__ import annotations

import numpy as np
import torch

from dipper_tpu_torch.placement import kclosest
from dipper_tpu_torch.utils.params import Param

_EXACT_NOT_PORTED = "exact placement: not yet ported, see ROADMAP.md"


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


def _build(frontend_args, frontend, frontend_static, names, params: Param,
           log) -> str:
    n = len(names)
    st = kclosest.run_placement_chunked(
        frontend_args, num_sequences=n, frontend=frontend,
        frontend_static=frontend_static, dtype_name=params.dtype,
        chunk=params.state_chunk, save_state=params.save_state,
        load_state=params.load_state, use_caps=params.prefix_caps,
        fingerprint=run_fingerprint(params, names), log=log,
    )
    return kclosest.edges_to_newick(st.e, st.belong, st.length, names, n)


def build_placement_tree_from_matrix(D, names, params: Param, *, device,
                                     exact=False, log=None) -> str:
    """k-closest placement tree (Newick) of a host distance matrix, built
    on `device`."""
    if exact:
        raise NotImplementedError(_EXACT_NOT_PORTED)
    Dt = torch.from_numpy(np.asarray(D, dtype=params.dtype)).to(device)
    return _build((Dt,), "matrix", (), names, params, log)


def build_placement_tree_from_seqs(seqs, names, params: Param, *, device,
                                   exact=False, log=None) -> str:
    """k-closest placement tree (Newick) of unaligned sequences through
    mash distances, built on `device`."""
    if exact:
        raise NotImplementedError(_EXACT_NOT_PORTED)
    if params.in_format != "r":
        raise NotImplementedError(
            f"placement from -i {params.in_format} input: not yet ported, "
            "see ROADMAP.md")
    frontend_args, frontend_static = _mash_frontend(seqs, params, device,
                                                    log=log)
    return _build(frontend_args, "mash", frontend_static, names, params, log)

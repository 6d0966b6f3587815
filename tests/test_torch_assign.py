"""D&C phase 2's kernel 10 (csrc/dc_assign.cu) on the CPU: its numpy model
(dipper_tpu_torch/dc/assign_model.py) against the plain version
(kclosest.score_edges_rows_plain) and the JAX package's phase-2 chunks
(dipper_tpu/dc/pipeline.py's _phase2_chunk_matrix, _phase2_chunk_mash
and _phase2_chunk_msa), on the same states and rows, made from seeds.

Tolerance 0: a row's slot is an integer, and the model, the plain version
and the JAX package run the same float operations in the same order, so
every slot is equal. The cases: the scorer's made-up states (ties between
two valid edges, every valid score above SENT_DIS, NaN and +inf in a
row, a state of four edges, unused tails) and a built state, rows with a
stride other than their width, Q not a multiple of a block's rows and E
not a multiple of a block's threads, under every plan of the kernel; real
states and rows of the mash and aligned-sequence frontends. The card's
route of the whole phase, with the model as the kernel, is in
tests/test_torch_dc.py."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dipper_tpu.dc.pipeline as jpl
from dipper_tpu.placement.kclosest import TreeState as JaxTreeState
from dipper_tpu_torch.dc import assign_model as am
from dipper_tpu_torch.placement import kclosest as tk
from dipper_tpu_torch.placement import score_model as sm

from datagen import simulate_alignment, simulate_unaligned
from test_nj import random_additive_matrix

torch.set_num_threads(2)

CPU = torch.device("cpu")
FIELDS = ("e", "belong", "length", "rev", "cdis", "cid")

# plans beside each width's own: the kernel's instances (1, 2, 4 or 8
# staged rows a block, 8 read from device memory), and blocks of 64 and
# 32 threads (E then spans several ragged slot tiles)
PLANS = [am.Plan(1, True, 256, 0), am.Plan(2, True, 256, 0),
         am.Plan(4, True, 256, 0), am.Plan(8, False, 256, 0),
         am.Plan(8, True, 64, 0), am.Plan(8, False, 32, 0)]


def _arrays(st) -> dict:
    return {f: getattr(st, f).numpy() for f in FIELDS}


def _jax_state(d: dict) -> JaxTreeState:
    return JaxTreeState(**{f: jnp.asarray(d[f]) for f in FIELDS},
                        idx=jnp.int32(int(d["idx"])))


def _made_up_rows(row, rng, n: int = 13):
    """The case's row, permutations of it and a constant row: n rows (not
    a multiple of any plan's rows a block)."""
    return np.stack([row] + [rng.permutation(row) for _ in range(n - 2)]
                    + [np.full_like(row, row[0])])


def _cases(dtype):
    cases = [(name, d, row) for name, d, row, _ in sm.made_up_cases(dtype)]
    rng = np.random.default_rng(3)
    D = random_additive_matrix(64, rng)
    D = (D / (D.max() * 1.05)).astype(dtype)
    st = tk.init_placement_state((torch.from_numpy(D),), num_sequences=64,
                                 frontend="matrix", dtype_name=dtype)
    tk._insert_range(st, 2, 44, torch.from_numpy(D)[2:], 64)
    cases.append(("built", tk.tree_state_to_numpy(st), D[44]))
    return cases


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_model_equals_plain_and_jax_on_made_up_states(dtype):
    """Every made-up case and a built state, 13 rows each, contiguous and
    as a strided view of wider rows: the model under its own plan and
    under PLANS, the plain version and the JAX package's
    _phase2_chunk_matrix give the same slots."""
    rng = np.random.default_rng(11)
    names = set()
    for name, d, row in _cases(dtype):
        names.add(name)
        st = tk.tree_state_from_numpy(
            {k: v for k, v in d.items() if v is not None}, CPU)
        rows = _made_up_rows(row, rng)
        W = rows.shape[1]
        wide = np.concatenate([rows, rng.random((rows.shape[0], 7))
                               .astype(dtype)], axis=1)
        strided = wide[:, :W]
        assert strided.strides[0] != W * rows.itemsize
        want = tk.score_edges_rows_plain(st, torch.from_numpy(rows))
        assert want.dtype == torch.int64
        jax_ids = np.asarray(jpl._phase2_chunk_matrix(
            _jax_state(d), jnp.asarray(rows),
            jnp.arange(rows.shape[0]), backbone_size=W))
        assert jax_ids.tolist() == want.tolist(), name
        assert tk.score_edges_rows_plain(
            st, torch.from_numpy(wide)[:, :W]).tolist() == want.tolist()
        arrays = _arrays(st)
        for plan in [None] + PLANS:
            for r in (rows, strided):
                got = am.assign(arrays, r, plan)
                assert got.dtype == np.int64
                assert got.tolist() == want.tolist(), (name, plan)
    assert {"tie", "all_above_2", "nan_in_row", "inf_in_row",
            "nan_and_inf_in_row", "four_edges", "unused_candidate_wins",
            "built"} <= names


def test_model_meets_the_made_up_expectations():
    """Where a made-up case was made to give a slot (a tie's lower slot,
    slot 0 when every valid score is above 2.0, the first unused slot when
    every used slot is valid), the model's first row gives it."""
    for dtype in ("float32", "float64"):
        for name, d, row, expected in sm.made_up_cases(dtype):
            if "eid" not in expected:
                continue
            st = tk.tree_state_from_numpy(
                {k: v for k, v in d.items() if v is not None}, CPU)
            got = am.assign(_arrays(st), row[None])
            assert got.tolist() == [expected["eid"]], (dtype, name)


def test_plan_by_width():
    """kernel_plan: R rows a block within 96 KB (R = 8, 4, 2), else one
    row within 225 KB, else 8 rows read from device memory; D&C's
    backbones of 1,500, 5,000 and 50,000 taxa."""
    for width, item, want in ((1500, 4, (8, True)), (1500, 8, (8, True)),
                              (5000, 4, (4, True)), (5000, 8, (2, True)),
                              (12288, 8, (1, True)), (50000, 4, (1, True)),
                              (50000, 8, (8, False)), (28800, 8, (1, True)),
                              (28801, 8, (8, False))):
        plan = am.kernel_plan(width, item)
        assert (plan.rows, plan.staged) == want, (width, item)
        assert plan.smem == (plan.rows * width * item if plan.staged else 0)
        assert plan.smem <= am.STAGED_ONE_ROW


def test_kernel_source_matches_the_model():
    """Runs without a GPU: kernel 10 is in the build table, scores with
    edge_score.cuh (the scorers' one clamp sequence, side_vals and the
    argmin order), and its plan's constants are the model's."""
    from dipper_tpu_torch.csrc import build as kernel_build

    assert kernel_build.KERNELS["dc_assign"] == "dc_assign.cu"
    with open(os.path.join(kernel_build.CSRC_DIR, "dc_assign.cu")) as f:
        src = f.read()
    code = re.sub(r"//.*", "", src)
    assert '#include "edge_score.cuh"' in code
    for call in ("edge_score(", "side_vals(", "before(", "block_min<"):
        assert call in code, call
    consts = dict(re.findall(r"constexpr [\w ]+ (k\w+) = ([\d *]+);", code))
    assert eval(consts["kAssignThreads"]) == am.THREADS
    assert eval(consts["kStagedBytes"]) == am.STAGED_BYTES
    assert eval(consts["kStagedOneRow"]) == am.STAGED_ONE_ROW
    assert eval(consts["kGlobalRows"]) == am.GLOBAL_ROWS


def _mash_case(dtype):
    from dipper_tpu_torch.distance.mash import (mash_pairwise, pad_ranks,
                                                rank_compress_host)
    from dipper_tpu_torch.sketch.native import sketch_sequences_native

    _, seqs = simulate_unaligned(70, 900, np.random.default_rng(21))
    ranks = pad_ranks(rank_compress_host(sketch_sequences_native(seqs, 12,
                                                                 100)))
    B = 20
    R = torch.from_numpy(ranks)
    st = tk.run_placement_full((R[:B],), num_sequences=B, frontend="mash",
                               frontend_static=(12, 100), dtype_name=dtype)
    rows = mash_pairwise(R[:B], R[B:], k=12, sketch_size=100,
                         dtype_name=dtype)
    jax_ids = jpl._phase2_chunk_mash(
        _jax_state(tk.tree_state_to_numpy(st)), jnp.asarray(ranks),
        jnp.arange(B, len(seqs)), k=12, sketch_size=100, dtype_name=dtype,
        backbone_size=B)
    return st, rows, np.asarray(jax_ids)


def _msa_case(dtype):
    from dipper_tpu_torch.distance.msa import msa_tiled_block, nongap_counts
    from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes

    _, seqs = simulate_alignment(60, 500, np.random.default_rng(9),
                                 gap_frac=0.03, blen_scale=0.5)
    codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    B = 16
    C = torch.from_numpy(codes)
    ng = nongap_counts(C, dtype)
    st = tk.run_placement_full((C[:B], ng[:B]), num_sequences=B,
                               frontend="msa", frontend_static=(2,),
                               dtype_name=dtype)
    rows = msa_tiled_block(C[B:], ng[B:], C[:B], ng[:B], distance_type=2,
                           dtype_name=dtype)
    jdt = jnp.dtype(dtype)
    ngh = (codes < 4).sum(axis=1)
    jax_ids = jpl._phase2_chunk_msa(
        _jax_state(tk.tree_state_to_numpy(st)), jnp.asarray(codes[:B]),
        jnp.asarray(ngh[:B], jdt), jnp.asarray(codes[B:]),
        jnp.asarray(ngh[B:], jdt), distance_type=2, dtype_name=dtype)
    return st, rows, np.asarray(jax_ids)


@pytest.mark.parametrize("frontend", ["mash", "msa"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_model_equals_jax_phase2_chunks(frontend, dtype):
    """A backbone placed by the port from mash ranks (B = 20, 50 queries)
    or aligned codes (B = 16, 44 queries) and the port's rows to it: the
    model under its plan and PLANS, and the plain version, equal the JAX
    package's _phase2_chunk_mash / _phase2_chunk_msa on that state."""
    st, rows, want = (_mash_case if frontend == "mash" else _msa_case)(dtype)
    assert len(set(want.tolist())) > 3
    assert tk.score_edges_rows_plain(st, rows).tolist() == want.tolist()
    arrays = _arrays(st)
    for plan in [None] + PLANS:
        assert am.assign(arrays, rows.numpy(), plan).tolist() == \
            want.tolist(), plan


def test_wrapper_rejects_cpu_states():
    """Kernel 10's wrapper raises for a CPU state (its caller takes the
    plain version there), and score_edges_rows on a CPU state never
    reaches it."""
    from dipper_tpu_torch.dc import assign_cuda

    name, d, row, _ = sm.made_up_cases("float32")[0]
    st = tk.tree_state_from_numpy(
        {k: v for k, v in d.items() if v is not None}, CPU)
    rows = torch.from_numpy(np.stack([row, row]))
    with pytest.raises(ValueError, match="CUDA state"):
        assign_cuda.assign(st, rows)
    before = assign_cuda.ASSIGN_LAUNCHES
    out = torch.full((2,), -1, dtype=torch.int64)
    got = tk.score_edges_rows(st, rows, out=out)
    assert got is out and not tk.uses_assign_kernel(st)
    assert got.tolist() == tk.score_edges_rows_plain(st, rows).tolist()
    assert assign_cuda.ASSIGN_LAUNCHES == before

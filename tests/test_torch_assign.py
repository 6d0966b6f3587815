"""D&C phase 2's kernel 10 (csrc/dc_assign.cu) on the CPU: its numpy model
(dipper_tpu_torch/dc/assign_model.py) against the plain version
(kclosest.score_edges_rows_plain) and the JAX package's phase-2 chunks
(dipper_tpu/dc/pipeline.py's _phase2_chunk_matrix, _phase2_chunk_mash
and _phase2_chunk_msa), on the same states and rows, made from seeds; the
pack's plain version (kclosest.pack_slots_plain) against the model's.

Tolerance 0: a row's slot is an integer, and the model, the plain version
and the JAX package run the same float operations in the same order, so
every slot is equal; the records are bytes. The cases: the scorer's
made-up states (ties between two valid edges, every valid score above
SENT_DIS, NaN and +inf in a row, a state of four edges, unused tails) and
a built state, rows with a stride other than their width, Q not a
multiple of a block's rows and record counts not a multiple of the tile,
under the kernel's plan and every forced instance (clusters of 1 and of
CLUSTER_CTAS blocks, R = 1, 2, 4, 8 staged, rows read from device memory)
and plans of fewer warps and tiles of 32 (a warp takes many slices), in
the default slice order and a shuffled one; real states and rows of the
mash and aligned-sequence frontends. The card's route of the whole phase,
with the model as the kernels, is in tests/test_torch_dc.py."""

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

# the kernel's instances beside each width's own plan: (rows a block,
# staged, blocks a cluster, ring stages), None the plan's
INSTANCES = [(None, None, 1, None), (None, None, None, 2),
             (1, True, None, None), (2, True, None, None),
             (4, True, None, None), (8, True, None, None),
             (am.GLOBAL_ROWS, False, None, None),
             (am.GLOBAL_ROWS, False, 1, 16)]


def _plans(width: int, item: int) -> list:
    """The plan, every instance of INSTANCES, and model-only plans of one
    and three consumer warps with tiles of 32 and 64 records (a warp then
    takes many slices)."""
    own = am.kernel_plan(width, item)
    plans = [own] + [am.kernel_plan(width, item, *inst)
                     for inst in INSTANCES]
    return plans + [own._replace(threads=64, tile=32),
                    own._replace(threads=128, tile=64),
                    own._replace(threads=128, tile=32)]


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
    under every plan of _plans, the plain version and the JAX package's
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
        records, first = am.pack(arrays, W)
        shuffled = rng.permutation(-(-records.shape[0] // 32) + 1) % 3
        for plan in [None] + _plans(W, rows.itemsize):
            for r in (rows, strided):
                got = am.assign(arrays, r, plan)
                assert got.dtype == np.int64
                assert got.tolist() == want.tolist(), (name, plan)
        # the kernel takes slices in a run-time order: any order gives the
        # same slots
        plan = am.kernel_plan(W, rows.itemsize)._replace(threads=128,
                                                         tile=32)
        assert am.assign_records(records, first, strided, plan,
                                 order=shuffled).tolist() == want.tolist()
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
    """kernel_plan: R = 8, 4 or 2 rows a block (16 consumer warps) where
    two buffers of R transposed rows and the ring fit 227 KB, else one row
    (31 consumer warps, 1,024 threads) in two buffers or one, else rows
    read from device memory; ids uint16 to 65,535 wide; D&C's backbones of
    1,500, 5,000 and 50,000 taxa; records of 80, 96, 112 and 144 bytes."""
    for width, item, want in ((1500, 4, (8, True, 2)), (1500, 8, (4, True, 2)),
                              (5000, 4, (4, True, 2)), (5000, 8, (2, True, 2)),
                              (12288, 8, (1, True, 1)),
                              (50000, 4, (1, True, 1)),
                              (50000, 8, (am.GLOBAL_ROWS, False, 0)),
                              (27000, 8, (1, True, 1)),
                              (27500, 8, (am.GLOBAL_ROWS, False, 0)),
                              (70000, 4, (am.GLOBAL_ROWS, False, 0))):
        plan = am.kernel_plan(width, item)
        assert (plan.rows, plan.staged, plan.buffers) == want, (width, item)
        assert plan.smem <= am.SMEM_BYTES
        assert plan.cluster == am.CLUSTER_CTAS
        assert plan.threads == 32 * (1 + (am.ONE_ROW_WARPS if plan.rows == 1
                                          and plan.staged
                                          else am.CONSUMER_WARPS))
        assert plan.id_bytes == (2 if width <= 65535 else 4)
        assert am.MIN_STAGES <= plan.stages <= am.MAX_STAGES
        if plan.staged:
            rows = plan.buffers * plan.rows * width * item
            assert plan.smem - rows == (
                am._head(plan.threads // 32 - 1, plan.rows, item)
                + plan.stages * plan.tile * plan.record_bytes)
    # a staged ring of RING_ROW_BYTES / (R x item) stages as fit, up to
    # MAX_STAGES: 4 at R = 8 in f32, 8 at R = 4, 8 at R = 2 in f64; a one-
    # row block takes what its row leaves (one 98 KB row at 12,288 in f64
    # leaves room for 16 or more, one 200 KB row at B = 50,000 in f32 for
    # six); rows from device memory GLOBAL_STAGES
    assert [am.kernel_plan(w, i).stages for w, i in
            ((1500, 4), (1500, 8), (5000, 4), (5000, 8), (12288, 8),
             (50000, 4), (50000, 8))] == [4, 4, 8, 8, 16, 6, 4]
    assert am.kernel_plan(1500, 4, stages=2).stages == 2
    assert [am.record_layout(b, i).bytes for b, i in
            ((2, 4), (4, 4), (2, 8), (4, 8))] == [80, 96, 112, 144]
    for bad in (dict(rows=3), dict(rows=4, staged=False),
                dict(cluster=3), dict(cluster=4), dict(cluster=8),
                dict(cluster=16),
                dict(rows=2, staged=True), dict(stages=1), dict(stages=17),
                dict(rows=1, stages=7)):
        with pytest.raises(ValueError):
            am.kernel_plan(50000, 4, **bad)


def test_kernel_source_matches_the_model():
    """Runs without a GPU: kernel 10 is in the build table, scores with
    edge_score.cuh's edge_score_only (the scorers' clamp sequence),
    feeds its records by bulk copies multicast over a cluster, and its
    plan's constants are the model's."""
    from dipper_tpu_torch.csrc import build as kernel_build

    assert kernel_build.KERNELS["dc_assign"] == "dc_assign.cu"
    with open(os.path.join(kernel_build.CSRC_DIR, "dc_assign.cu")) as f:
        src = f.read()
    code = re.sub(r"//.*", "", src)
    assert '#include "edge_score.cuh"' in code
    for call in ("edge_score_only(", "max_nan(", "key_before(",
                 "multicast::cluster", "mbarrier::complete_tx::",
                 "cudaOccupancyMaxActiveClusters",
                 "cudaLaunchAttributeClusterDimension"):
        assert call in code, call
    consts = dict(re.findall(r"constexpr [\w ]+ (k\w+) = ([\d *]+);", code))
    for name, value in (("kConsumerWarps", am.CONSUMER_WARPS),
                        ("kOneRowWarps", am.ONE_ROW_WARPS),
                        ("kTileRecords", am.TILE_RECORDS),
                        ("kSliceRecords", am.SLICE_RECORDS),
                        ("kPlanStages", am.PLAN_STAGES),
                        ("kRingRowBytes", am.RING_ROW_BYTES),
                        ("kGlobalStages", am.GLOBAL_STAGES),
                        ("kMaxStages", am.MAX_STAGES),
                        ("kMinStages", am.MIN_STAGES),
                        ("kClusterCtas", am.CLUSTER_CTAS),
                        ("kSmemBytes", am.SMEM_BYTES),
                        ("kBarrierBytes", am.BARRIER_BYTES),
                        ("kGlobalRows", am.GLOBAL_ROWS),
                        ("kMaxId16Width", am.MAX_ID16_WIDTH),
                        ("kPackThreads", am.PACK_THREADS),
                        ("kPackSlots", am.PACK_SLOTS)):
        assert eval(consts[name]) == value, name
    assert float(re.search(r"kSentDis = ([\d.]+);", code)[1]) == am.SENT_DIS
    assert "kPackTile = kPackThreads * kPackSlots;" in code


def _pack_state(rng, dtype, n_pairs, n_slots, width, first_valid=0,
                first_invalid=0):
    """A made-up state whose slots below `first_valid` are all invalid and
    whose slots below `first_invalid` are all valid."""
    d = sm.made_up_state(n_pairs, n_slots, width, dtype, rng)
    low = np.arange(n_slots) < first_valid
    d["belong"][low & (d["belong"] > d["e"])] = -1
    high = np.arange(n_slots) < first_invalid
    d["belong"][high] = np.maximum(d["belong"][high], d["e"][high] + 1)
    return d


@pytest.mark.parametrize("width", [1500, 70000])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pack_plain_keeps_slot_order(dtype, width):
    """pack_slots_plain: the valid slots in slot order, each record the
    slot's and its reverse's ids and distances, its length and the slot;
    uint16 ids (0xFFFF empty) to 65,535 wide, else int32 (-1); the lowest
    invalid slot; bytes equal to the model's pack, on made-up states, a
    built one, one whose only valid slots sit past the pack's first tile
    and one whose lowest invalid slot does."""
    rng = np.random.default_rng(4)
    states = [d for _, d, _, _ in sm.made_up_cases(dtype)]
    states.append(_cases(dtype)[-1][1])
    # the pack kernel's first block takes PACK_TILE slots: this state's
    # valid slots all sit past it, the next one's invalid slots
    tile = am.PACK_TILE
    late = _pack_state(rng, dtype, 2100, 4400, 200, first_valid=tile)
    late_invalid = _pack_state(rng, dtype, 2100, 4400, 200,
                               first_invalid=tile + 5)
    states += [late, late_invalid]
    idb = 2 if width <= 65535 else 4
    item = np.dtype(dtype).itemsize
    lay = am.record_layout(idb, item)
    for d in states:
        st = tk.tree_state_from_numpy(
            {k: v for k, v in d.items() if v is not None}, CPU)
        rec, meta = tk.pack_slots_plain(st, width)
        want, first = am.pack(_arrays(st), width)
        assert rec.dtype == torch.uint8 and rec.shape[1] == lay.bytes
        assert np.array_equal(rec.numpy(), want)
        valid = np.flatnonzero(d["belong"] > d["e"])
        invalid = np.flatnonzero(~(d["belong"] > d["e"]))
        assert meta.tolist() == [valid.size, first]
        assert first == (invalid[0] if invalid.size else am.NO_SLOT)
        u = am.unpack(want, idb, dtype)
        assert u["slot"].tolist() == valid.tolist()
        r = d["rev"][valid]
        assert np.array_equal(u["ids"], np.concatenate(
            [d["cid"][valid], d["cid"][r]], axis=1))
        assert np.array_equal(u["dist"], np.concatenate(
            [d["cdis"][valid], d["cdis"][r]], axis=1))
        assert np.array_equal(u["length"], d["length"][valid])
        assert not want[:, lay.dist + 2 * am.K * item:].any()   # padding
    assert not (late["belong"][:tile] > late["e"][:tile]).any()
    assert (late["belong"] > late["e"]).any()
    assert am.pack(late_invalid, width)[1] >= tile + 5


def test_model_scores_a_late_tile():
    """A state whose valid slots all sit past the first tile, 130 rows: the
    model under its plan and a plan of one warp equals the plain version."""
    rng = np.random.default_rng(6)
    for dtype in ("float32", "float64"):
        d = _pack_state(rng, dtype, 150, 400, 90, first_valid=130)
        st = tk.tree_state_from_numpy(d, CPU)
        rows = rng.random((130, 90)).astype(dtype)
        rows[5, ::7] = np.nan
        want = tk.score_edges_rows_plain(st, torch.from_numpy(rows))
        for plan in (None, am.kernel_plan(90, rows.itemsize)._replace(
                threads=64)):
            assert am.assign(_arrays(st), rows, plan).tolist() == \
                want.tolist()


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
    model under every plan of _plans, and the plain version, equal the JAX
    package's _phase2_chunk_mash / _phase2_chunk_msa on that state."""
    st, rows, want = (_mash_case if frontend == "mash" else _msa_case)(dtype)
    assert len(set(want.tolist())) > 3
    assert tk.score_edges_rows_plain(st, rows).tolist() == want.tolist()
    arrays = _arrays(st)
    for plan in [None] + _plans(rows.shape[1], rows.element_size()):
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
    with pytest.raises(ValueError, match="CUDA state"):
        assign_cuda.pack(st, rows.shape[1])
    assert tk.assign_records(st, rows.shape[1]) is None
    before = assign_cuda.ASSIGN_LAUNCHES, assign_cuda.PACK_LAUNCHES
    out = torch.full((2,), -1, dtype=torch.int64)
    got = tk.score_edges_rows(st, rows, out=out)
    assert got is out and not tk.uses_assign_kernel(st)
    assert got.tolist() == tk.score_edges_rows_plain(st, rows).tolist()
    assert (assign_cuda.ASSIGN_LAUNCHES, assign_cuda.PACK_LAUNCHES) == before

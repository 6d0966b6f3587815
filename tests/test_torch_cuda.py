"""The port on an NVIDIA GPU: the hand-written kernels (mash merge count,
mash distance rows, side vector, the edge scorer, the MinHash sketcher,
with device rank compression beside it, the insertion step, NJ's Q scan
and update) against their plain PyTorch versions, the MSA pair counts
and distances, and CUDA builds (k-closest and exact placement, --add,
the mash matrix, NJ) against CPU builds. Every test that takes the
`cuda` fixture skips without CUDA; test_scorer_sources_and_rounding and
test_nj_sources_and_rounding read the sources only and run anywhere.
Kernel 3 is also held by slot ranges (a rank's share of a sharded build).
The file imports no JAX, so it also runs on a machine without it (the
repo's conftest imports JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dipper_tpu_torch.distance import mash as tm
from dipper_tpu_torch.distance import mash_cuda
from dipper_tpu_torch.nj import neighbor_joining, nj_tree_newick
from dipper_tpu_torch.csrc import build as kernel_build
from dipper_tpu_torch.dc import assign_cuda
from dipper_tpu_torch.placement import kclosest as tk
from dipper_tpu_torch.placement import score_model as sm
from dipper_tpu_torch.sketch.native import sketch_sequences_native
from dipper_tpu_torch.utils.treecmp import rf_distance

from datagen import random_tree_edges, simulate_alignment, simulate_unaligned

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    return torch.device("cuda")


def _ranks(n, L, seed, k, ss):
    _, seqs = simulate_unaligned(n, L, np.random.default_rng(seed))
    return tm.pad_ranks(tm.rank_compress_host(
        sketch_sequences_native(seqs, k, ss)))


def _adversarial(n, S, M, rng):
    rows = np.sort(rng.integers(0, 60, (n, S)), axis=1)
    rows[rng.random(n) < 0.5, S - S // 3:] = 59  # sentinel-heavy tails
    pad = np.full((n, M - S), (tm._PAD_KEY - 1) // 2)
    return np.concatenate([rows, pad], axis=1).astype(np.int32)


@pytest.mark.parametrize("k, ss", [(12, 128), (11, 100), (15, 1000)])
def test_kernel_equals_plain(cuda, k, ss):
    r = torch.from_numpy(_ranks(300, 3000, 8, k, ss)).to(cuda)
    q = r[17:170].contiguous()  # 153 queries: not a multiple of the tile
    before = mash_cuda.LAUNCHES
    got = mash_cuda.mash_inter_cuda(r, q, sketch_size=ss)
    torch.cuda.synchronize()
    assert mash_cuda.LAUNCHES == before + 1
    assert torch.equal(got, tm.merged_inter_count_ref(r, q, sketch_size=ss))


def test_kernel_adversarial_rows(cuda):
    rng = np.random.default_rng(1)
    bank = torch.from_numpy(_adversarial(257, 100, 128, rng)).to(cuda)
    qry = torch.from_numpy(_adversarial(19, 100, 128, rng)).to(cuda)
    got = mash_cuda.mash_inter_cuda(bank, qry, sketch_size=100)
    assert torch.equal(got,
                       tm.merged_inter_count_ref(bank, qry, sketch_size=100))


def test_wrapper_rejects_non_contiguous(cuda):
    r = torch.from_numpy(_ranks(20, 800, 3, 12, 128)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mash_cuda.mash_inter_cuda(r, r[::2], sketch_size=128)


def test_wrapper_rejects_sketch_over_shared_memory(cuda):
    r = torch.zeros((4, 32768), dtype=torch.int32, device=cuda)
    before = mash_cuda.LAUNCHES
    with pytest.raises(ValueError, match="sketch_size 19368 is too large"):
        mash_cuda.mash_inter_cuda(r, r, sketch_size=19368)
    assert mash_cuda.LAUNCHES == before


def _sorted_rows(n, ss, M, universe, seed):
    """n ascending rows of ss ranks below `universe`, padded to M."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, universe, (n, ss)), axis=1)
    pad = np.full((n, M - ss), (tm._PAD_KEY - 1) // 2)
    return np.concatenate([rows, pad], axis=1).astype(np.int32)


# bank rows, query rows, sketch size: neither count a multiple of the tile
# (at most 16 rows a side at s = 1000 and 64 at s <= 128, fewer where the
# problem is small), down to one row a side
RAGGED = [(333, 77, 1000), (17, 1, 1000), (1, 1, 1000), (1, 19, 1000),
          (130, 70, 128), (65, 129, 33), (200, 3, 31), (67, 5, 1)]


@pytest.mark.parametrize("n, q, ss", RAGGED)
def test_kernel_ragged_tiles(cuda, n, q, ss):
    M = tm._pad_pow2(ss)
    bank = torch.from_numpy(_sorted_rows(n, ss, M, 3 * ss, 1)).to(cuda)
    qry = torch.from_numpy(_sorted_rows(q, ss, M, 3 * ss, 2)).to(cuda)
    got = mash_cuda.mash_inter_cuda(bank, qry, sketch_size=ss)
    want = tm.merged_inter_count_ref(bank, qry, sketch_size=ss)
    assert torch.equal(got, want)
    assert want.max() > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n, q, ss", RAGGED)
def test_rows_dist_kernel_ragged_tiles(cuda, n, q, ss, dtype):
    """Ragged tiles written through a row stride: only the block changes."""
    M = tm._pad_pow2(ss)
    bank = torch.from_numpy(_sorted_rows(n, ss, M, 3 * ss, 3)).to(cuda)
    qry = torch.from_numpy(_sorted_rows(q, ss, M, 3 * ss, 4)).to(cuda)
    big = torch.full((q + 2, n + 5), float("nan"), device=cuda,
                     dtype=getattr(torch, dtype))
    mash_cuda.mash_rows_dist_cuda(bank, qry, _table(13, ss, dtype, cuda),
                                  sketch_size=ss, out=big[1:q + 1, :n])
    assert torch.equal(big[1:q + 1, :n], tm.mash_rows_vs_bank(
        bank, qry, k=13, sketch_size=ss, dtype_name=dtype))
    assert big[0].isnan().all() and big[q + 1].isnan().all()
    assert big[:, n:].isnan().all()


@pytest.mark.parametrize("dtype", [None, "float32", "float64"])
def test_kernels_at_largest_sketch_size(cuda, dtype):
    """One row a side fills the block's shared memory at the largest
    sketch_size; one more and the wrapper raises before any launch."""
    ss = mash_cuda.max_sketch_size(dtype)
    M = tm._pad_pow2(ss + 1)
    bank = torch.from_numpy(_sorted_rows(3, ss, M, 3 * ss, 5)).to(cuda)
    qry = torch.from_numpy(_sorted_rows(2, ss, M, 3 * ss, 6)).to(cuda)
    want = tm.merged_inter_count_ref(bank, qry, sketch_size=ss)
    before = (mash_cuda.LAUNCHES, mash_cuda.ROWS_DIST_LAUNCHES)
    if dtype is None:
        assert torch.equal(
            mash_cuda.mash_inter_cuda(bank, qry, sketch_size=ss), want)
        with pytest.raises(ValueError, match=f"sketch_size {ss + 1} is too"):
            mash_cuda.mash_inter_cuda(bank, qry, sketch_size=ss + 1)
        assert mash_cuda.LAUNCHES == before[0] + 1
    else:
        tab = _table(15, ss, dtype, cuda)
        got = mash_cuda.mash_rows_dist_cuda(bank, qry, tab, sketch_size=ss)
        assert torch.equal(got, tab[want.long()])
        with pytest.raises(ValueError, match=f"sketch_size {ss + 1} is too"):
            mash_cuda.mash_rows_dist_cuda(
                bank, qry, _table(15, ss + 1, dtype, cuda),
                sketch_size=ss + 1)
        assert mash_cuda.ROWS_DIST_LAUNCHES == before[1] + 1


def test_kernel_rows_not_16_byte_aligned(cuda):
    """Row widths that are no multiple of 4 ranks take the 4-byte copies."""
    bank = torch.from_numpy(_sorted_rows(50, 1000, 1024, 3000, 7)).to(cuda)
    qry = torch.from_numpy(_sorted_rows(20, 1000, 1024, 3000, 8)).to(cuda)
    want = tm.merged_inter_count_ref(bank, qry, sketch_size=1000)
    got = mash_cuda.mash_inter_cuda(bank[:, :1001].contiguous(),
                                    qry[:, :1001].contiguous(),
                                    sketch_size=1000)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cuda_build_equals_cpu_build(cuda, dtype):
    """The whole chunked mash build on the card gives the CPU build's
    state, bit for bit."""
    r = _ranks(120, 2000, 4, 12, 100)
    kw = dict(num_sequences=120, frontend="mash", frontend_static=(12, 100),
              dtype_name=dtype, chunk=50)
    cpu = tk.run_placement_chunked((torch.from_numpy(r),), **kw)
    gpu = tk.run_placement_chunked((torch.from_numpy(r).to(cuda),), **kw)
    assert gpu.e.device.type == "cuda"
    a, b = tk.tree_state_to_numpy(cpu), tk.tree_state_to_numpy(gpu)
    for f in tk.TreeState.FIELDS:
        assert np.array_equal(a[f], b[f]), f


def _table(k, ss, dtype, dev):
    return torch.from_numpy(tm._dist_table(k, ss, dtype)).to(dev)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k, ss", [(12, 128), (11, 100), (15, 1000)])
def test_rows_dist_kernel_equals_plain(cuda, k, ss, dtype):
    r = torch.from_numpy(_ranks(300, 3000, 8, k, ss)).to(cuda)
    q = r[17:170].contiguous()  # 153 queries: not a multiple of the tile
    before = mash_cuda.ROWS_DIST_LAUNCHES
    got = mash_cuda.mash_rows_dist_cuda(r, q, _table(k, ss, dtype, cuda),
                                        sketch_size=ss)
    torch.cuda.synchronize()
    assert mash_cuda.ROWS_DIST_LAUNCHES == before + 1
    want = tm.mash_rows_vs_bank(r, q, k=k, sketch_size=ss, dtype_name=dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rows_dist_kernel_adversarial_rows(cuda, dtype):
    rng = np.random.default_rng(2)
    bank = torch.from_numpy(_adversarial(257, 100, 128, rng)).to(cuda)
    qry = torch.from_numpy(_adversarial(19, 100, 128, rng)).to(cuda)
    got = mash_cuda.mash_rows_dist_cuda(bank, qry, _table(9, 100, dtype, cuda),
                                        sketch_size=100)
    assert torch.equal(got, tm.mash_rows_vs_bank(
        bank, qry, k=9, sketch_size=100, dtype_name=dtype))


def test_rows_dist_kernel_writes_through_row_stride(cuda):
    """`out` may be a block of rows of a wider matrix: only that block
    changes."""
    r = torch.from_numpy(_ranks(90, 1500, 9, 12, 128)).to(cuda)
    big = torch.full((40, 97), float("nan"), device=cuda)
    got = mash_cuda.mash_rows_dist_cuda(r, r[5:35], _table(12, 128, "float32",
                                                           cuda),
                                        sketch_size=128, out=big[3:33, :90])
    assert got.data_ptr() == big[3:33].data_ptr()
    assert torch.equal(big[3:33, :90], tm.mash_rows_vs_bank(
        r, r[5:35], k=12, sketch_size=128, dtype_name="float32"))
    assert big[:3].isnan().all() and big[33:].isnan().all()
    assert big[:, 90:].isnan().all()


def test_rows_dist_wrapper_rejects_bad_inputs(cuda):
    r = torch.from_numpy(_ranks(20, 800, 3, 12, 128)).to(cuda)
    tab = _table(12, 128, "float32", cuda)
    before = mash_cuda.ROWS_DIST_LAUNCHES
    with pytest.raises(ValueError, match="table is on cpu"):
        mash_cuda.mash_rows_dist_cuda(r, r, tab.cpu(), sketch_size=128)
    with pytest.raises(ValueError, match="float32 or float64"):
        mash_cuda.mash_rows_dist_cuda(r, r, tab.half(), sketch_size=128)
    with pytest.raises(ValueError, match="contiguous rows"):
        mash_cuda.mash_rows_dist_cuda(
            r, r, tab, sketch_size=128,
            out=torch.empty((20, 20), device=cuda).T)
    wide = torch.zeros((4, 16384), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="sketch_size 11620 is too large"):
        mash_cuda.mash_rows_dist_cuda(wide, wide,
                                      _table(15, 11620, "float64", cuda),
                                      sketch_size=11620)
    assert mash_cuda.ROWS_DIST_LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_distance_matrix_cuda_equals_cpu(cuda, dtype, monkeypatch):
    """The whole [N, N] matrix, filled in row blocks on the card, is the
    CPU's bit for bit."""
    monkeypatch.setattr(tm, "MATRIX_ROW_BLOCK", 48)  # several launches
    r = _ranks(150, 2000, 5, 12, 100)
    cpu = tm.mash_distance_matrix(r, 12, 100, dtype, "cpu")
    gpu = tm.mash_distance_matrix(r, 12, 100, dtype, cuda)
    assert torch.equal(gpu.cpu(), cpu)


def _side_inputs(E, cap, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, cap, (E, tk.K)).astype(np.int32)
    cid[rng.random((E, tk.K)) < 0.3] = -1
    cid[::7] = -1                       # edges with no witness at all
    cdis = rng.random((E, tk.K)).astype(dtype)
    row = rng.random(cap).astype(dtype)
    row[::97] = np.nan                  # NaN distances propagate
    return tuple(torch.from_numpy(a).to(dev) for a in (cid, cdis, row))


def _same_bits(a, b):
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a[~a.isnan()], b[~b.isnan()]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_side_vector_kernel_equals_plain(cuda, dtype):
    cid, cdis, row = _side_inputs(4001, 1000, dtype, cuda, 3)
    before = tk.SIDE_VECTOR_LAUNCHES
    got = tk.side_vector(cid, cdis, row)
    torch.cuda.synchronize()
    assert tk.SIDE_VECTOR_LAUNCHES == before + 1
    want = tk._side_vector(cid, cdis, row)
    assert got.dtype == want.dtype and _same_bits(got, want)
    assert got.isnan().any() and (got[::7] == 0).all()


def test_side_vector_wrapper_rejects_bad_inputs(cuda):
    cid, cdis, row = _side_inputs(64, 50, "float32", cuda, 4)
    before = tk.SIDE_VECTOR_LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        tk.side_vector_cuda(cid.T.contiguous().T, cdis, row)
    with pytest.raises(ValueError, match="dtype"):
        tk.side_vector_cuda(cid, cdis.double(), row)
    with pytest.raises(ValueError, match="unit stride"):
        tk.side_vector_cuda(cid, cdis, torch.cat([row, row])[::2])
    with pytest.raises(ValueError, match="one device"):
        tk.side_vector_cuda(cid.cpu(), cdis, row)
    assert tk.SIDE_VECTOR_LAUNCHES == before


def test_side_vector_kernel_unaligned_base(cuda):
    """Lists that start 60 bytes into an allocation take the 4-byte
    copies; a last tile of fewer than 32 edges too."""
    cid, cdis, row = _side_inputs(1000, 300, "float32", cuda, 5)
    for lo, hi in ((3, 1000), (0, 31), (1, 2), (32, 96)):
        got = tk.side_vector_cuda(cid[lo:hi], cdis[lo:hi], row)
        assert _same_bits(got, tk._side_vector(cid[lo:hi], cdis[lo:hi], row))


def _same_six(got, want):
    assert tuple(got[:4]) == tuple(want[:4])
    for g, w in zip(got[4:], want[4:]):
        assert g.dtype == w.dtype and _same_bits(g.reshape(1), w.reshape(1))


SCORE_CASES = [c[0] for c in sm.made_up_cases("float32")]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", SCORE_CASES)
def test_score_edges_kernel_equals_plain(cuda, name, dtype):
    _, d, row, expected = next(c for c in sm.made_up_cases(dtype)
                               if c[0] == name)
    st = tk.tree_state_from_numpy(d, cuda)
    row = torch.from_numpy(row).to(cuda)
    before = tk.SCORE_EDGES_LAUNCHES
    got = tk.score_edges(st, row)
    got = (*got[:4], got[4].clone(), got[5].clone())
    assert tk.SCORE_EDGES_LAUNCHES == before + 1
    _same_six(got, tk._score_edges_plain(st, row))
    assert sm.meets(expected, got), (expected, got)
    # a second launch finds the ticket reset by the first
    _same_six(tk.score_edges(st, row), got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_edges_kernel_many_blocks(cuda, dtype):
    """More slots than one pass of the largest grid (528 blocks of 256):
    the grid-stride loop and the last block's reduction of 528 partials."""
    rng = np.random.default_rng(6)
    d = sm.made_up_state(100_000, 262_144, 5000, dtype, rng)
    st = tk.tree_state_from_numpy(d, cuda)
    for j in range(8):
        row = rng.random(5000).astype(dtype)
        if j % 2:
            row += 4.0
            keep = rng.integers(0, d["idx"])
            row[d["cid"][keep][d["cid"][keep] >= 0]] = 0.5
        row = torch.from_numpy(row).to(cuda)
        _same_six(tk.score_edges(st, row), tk._score_edges_plain(st, row))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_edges_kernel_on_built_states(cuda, dtype):
    """A state from a build on the card (unused tail, real witness
    lists), scored with the rows of taxa not yet placed."""
    n = 300
    rng = np.random.default_rng(9)
    D = rng.random((n, n))
    D = torch.from_numpy(((D + D.T) / 2.2).astype(dtype)).to(cuda)
    st = tk.init_placement_state((D,), num_sequences=n, frontend="matrix",
                                 dtype_name=dtype)
    assert st.scorer is not None
    tk._insert_range(st, 2, n - 40, D[2:], n)
    for i in range(n - 40, n):
        _same_six(tk.score_edges(st, D[i]), tk._score_edges_plain(st, D[i]))


def _slot_ranges(E, n_used, extra=()):
    """Splits of [0, E) into ranges: 2 and 3 even ones, borders off the
    kernel's 32-slot tiles, borders at the given slots, and, where the
    state has an unused tail, a range that holds n_used and ranges with
    no used slot."""
    sets = [{0, -(-E // 2), E}, {0, -(-E // 3), 2 * -(-E // 3), E},
            {0, 7, 45, E}]
    sets += [{0, s, s + 1, E} for s in extra]
    if n_used < E:
        sets += [{0, n_used, E}, {0, max(1, n_used - 1), n_used + 1, E},
                 {0, n_used, (n_used + E) // 2, E}]
    return [sorted(x for x in b if x <= E) for b in sets]


def _check_ranges(st, row, extra=()):
    """Every range launch equals the plain version on its range, and the
    ranges' choices, merged as the sharded build merges them, equal the
    full launch."""
    from dipper_tpu_torch.parallel.sharded import merge_choices

    full = tk.score_edges(st, row)
    full = (*full[:4], full[4].clone(), full[5].clone())
    E = st.e.shape[0]
    for bounds in _slot_ranges(E, st.idx, [full[0], max(0, full[0] - 1),
                                           *extra]):
        outs = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            got = tk.score_edges(st, row, lo=lo, hi=hi)
            got = (*got[:4], got[4].clone(), got[5].clone())
            assert lo <= got[0] < hi
            _same_six(got, tk._score_edges_plain(st, row, lo, hi))
            outs.append(got)
        trios = np.array([[float(o[5]), o[0]] for o in outs])
        _same_six(outs[merge_choices(trios)], full)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", SCORE_CASES)
def test_score_edges_kernel_by_ranges_equals_plain(cuda, name, dtype):
    _, d, row, _ = next(c for c in sm.made_up_cases(dtype) if c[0] == name)
    st = tk.tree_state_from_numpy(d, cuda)
    extra = ([int(np.flatnonzero(d["belong"] > d["e"])[60])]
             if name.startswith("tie") else [])
    _check_ranges(st, torch.from_numpy(row).to(cuda), extra)


def test_score_edges_kernel_by_ranges_on_a_built_state(cuda):
    n = 300
    rng = np.random.default_rng(10)
    D = rng.random((n, n))
    D = torch.from_numpy((D + D.T) / 2.2).to(cuda)
    st = tk.init_placement_state((D,), num_sequences=n, frontend="matrix",
                                 dtype_name="float64")
    tk._insert_range(st, 2, n - 10, D[2:], n)
    for i in range(n - 10, n):
        _check_ranges(st, D[i])


def test_score_edges_wrapper_rejects_bad_inputs(cuda):
    """The state's arrays are checked where a state is made and again when
    one of them is swapped; the row at every call."""
    _, d, row, _ = sm.made_up_cases("float32")[1]
    row = torch.from_numpy(row).to(cuda)
    before = tk.SCORE_EDGES_LAUNCHES

    def state():
        return tk.tree_state_from_numpy(d, cuda)

    st = state()
    st.cdis = st.cdis.double()
    with pytest.raises(ValueError, match="cdis must be torch.float32"):
        tk.prepare_scorer(st)
    with pytest.raises(ValueError, match="cdis must be torch.float32"):
        tk.score_edges(st, row)
    st = state()
    st.cid = st.cid.T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        tk.score_edges(st, row)
    st = state()
    st.belong = st.belong.cpu()
    with pytest.raises(ValueError, match="one CUDA device"):
        tk.score_edges(st, row)
    st = state()
    st.rev = st.rev.long()
    with pytest.raises(ValueError, match="rev must be torch.int32"):
        tk.score_edges(st, row)
    with pytest.raises(ValueError, match="rev must be torch.int32"):
        tk._resize_state(st, 2 * st.e.shape[0])
    st = state()
    with pytest.raises(ValueError, match="dist_row must be"):
        tk.score_edges_cuda(st, row.double())
    with pytest.raises(ValueError, match="dist_row must be"):
        tk.score_edges_cuda(st, torch.cat([row, row])[::2])
    with pytest.raises(ValueError, match="dist_row must be"):
        tk.score_edges_cuda(st, row.cpu())
    with pytest.raises(ValueError, match="needs a CUDA state"):
        tk.score_edges_cuda(tk.tree_state_from_numpy(d, "cpu"), row)
    assert tk.SCORE_EDGES_LAUNCHES == before


def test_scorer_sources_and_rounding():
    """Runs without a GPU: both entry points of TPU kernel 3 are built,
    from one shared header, and the scorers' clamp sequence (one copy in
    edge_score.cuh, which score_edges.cu and D&C's masked scorers include)
    cannot contract a multiply and an add into an FMA (it rounds once where
    the plain version rounds twice)."""
    import os
    import re

    assert kernel_build.KERNELS["side_vector"] == "side_vector.cu"
    assert kernel_build.KERNELS["score_edges"] == "score_edges.cu"
    src = {}
    for name in ("side_vector.cu", "score_edges.cu", "side_vector.cuh",
                 "edge_score.cuh", "dc_stream_block.cu",
                 "dc_cluster_build.cu"):
        with open(os.path.join(kernel_build.CSRC_DIR, name)) as f:
            src[name] = f.read()
    assert '#include "side_vector.cuh"' in src["side_vector.cu"]
    assert '#include "side_vector.cuh"' in src["edge_score.cuh"]
    assert '#include "edge_score.cuh"' in src["score_edges.cu"]
    for name in ("dc_stream_block.cu", "dc_cluster_build.cu"):
        assert '#include "insert_step.cuh"' in src[name]
    for name in ("score_edges.cu", "dc_stream_block.cu",
                 "dc_cluster_build.cu"):
        assert "edge_score(" in src[name]
    header = src["edge_score.cuh"]
    if "-fmad=false" not in kernel_build.NVCC_FLAGS:
        for fn in ("__fadd_rn", "__fsub_rn", "__fmul_rn", "__dadd_rn",
                   "__dsub_rn", "__dmul_rn"):
            assert fn in header
        body = header[header.index("__device__ __forceinline__ void "
                                   "edge_score("):
                      header.index("struct Cand")]
        code = re.sub(r"//.*", "", body)
        assert not re.search(r"[^,(]\s[-+*]\s", code), \
            "a bare arithmetic operator in the clamp sequence"


def test_nj_sources_and_rounding():
    """Runs without a GPU: NJ's two kernels are built, over one shared
    header, and no product or sum of theirs can contract into an FMA:
    every one is a round-to-nearest intrinsic (the f32 branch lengths
    are then the plain version's bytes), and no fma is written."""
    import os
    import re

    assert kernel_build.KERNELS["nj_q_argmin"] == "nj_q_argmin.cu"
    assert kernel_build.KERNELS["nj_update"] == "nj_update.cu"
    src = {}
    for name in ("nj_q_argmin.cu", "nj_update.cu", "nj_step.cuh"):
        with open(os.path.join(kernel_build.CSRC_DIR, name)) as f:
            src[name] = re.sub(r"//.*", "", f.read())
        assert not re.search(r"fma(f|_|\s*\()", src[name]), name
    for name in ("nj_q_argmin.cu", "nj_update.cu"):
        assert '#include "nj_step.cuh"' in src[name]
    for fn in ("__fadd_rn", "__fsub_rn", "__fmul_rn", "__fdiv_rn",
               "__dadd_rn", "__dsub_rn", "__dmul_rn", "__ddiv_rn"):
        assert fn in src["nj_step.cuh"]
    q = src["nj_q_argmin.cu"]
    # both of Q's roundings of an element (the half read's two candidates)
    assert "sub_rn(sub_rn(e[u][k], uni), unj[k])" in q
    assert "sub_rn(sub_rn(e[u][k], unj[k]), uni)" in q
    assert "div_rn(U[idx], denom)" in q
    u = src["nj_update.cu"]
    for expr in ("mul_rn(sub_rn(add_rn(rx, ry), d), half)",
                 "add_rn(uj, sub_rn(sub_rn(nr, rx), ry))",
                 "mul_rn(sub_rn(add_rn(d, unx), uny), half)",
                 "div_rn(ux0, denom)", "div_rn(uy0, denom)",
                 "sub_rn(d, blx)", "add_rn(bly, blx)", "add_rn(blx, bly)",
                 "mul_rn(sub_rn(add_rn(d, dyy), d), half)",
                 "add_rn(uy0, sub_rn(sub_rn(dxl, d), dyy))"):
        assert expr in u, expr


def _additive(n, seed):
    """Leaf-to-leaf path lengths of a random tree (an additive matrix)."""
    parent, blen, _ = random_tree_edges(n, np.random.default_rng(seed))
    up = {}
    for leaf in range(n):
        path, v, d = {}, leaf, 0.0
        while True:
            path[v] = d
            if v not in parent:
                break
            d += blen[v]
            v = parent[v]
        up[leaf] = path
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            lca = min((v for v in up[i] if v in up[j]),
                      key=lambda v: up[i][v])
            D[i, j] = D[j, i] = up[i][lca] + up[j][lca]
    return D


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nj_cuda_equals_cpu(cuda, dtype):
    """NJ on the card joins what the CPU joins: nRF = 0 (here the join
    sequences are the same too)."""
    D = _additive(300, 7)
    names = [f"T{i}" for i in range(300)]
    cpu = neighbor_joining(D, dtype_name=dtype, device="cpu")
    gpu = neighbor_joining(D, dtype_name=dtype, device=cuda)
    assert ([[c for c, _ in ch] for ch in gpu[0]]
            == [[c for c, _ in ch] for ch in cpu[0]])
    rf, _ = rf_distance(nj_tree_newick(*gpu, names),
                        nj_tree_newick(*cpu, names))
    assert rf == 0


def _nj_case(name, n, dtype, seed):
    """A matrix and row sums whose Q holds the case's values: with U = 0,
    Q off the diagonal is D, value for value (-0.0 included)."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) * np.exp(rng.normal(0, 1, (n, n)))
    D = (A + A.T).astype(dtype)
    np.fill_diagonal(D, 0)
    if name == "random":
        return D, D.sum(axis=1).astype(dtype)
    U = np.zeros(n, dtype)
    if name == "nan":
        D[0, 1] = D[n - 1, 0] = D[n - 2, n - 1] = np.nan
    elif name == "signed_zeros":
        D[n - 1, 1] = D[n // 2, 0] = -0.0
        D[1, n - 1] = 0.0
    elif name == "ties":
        cols = (7 * np.arange(n) + 3) % n
        cols = np.where(cols == np.arange(n), (cols + 1) % n, cols)
        D[np.arange(n), cols] = -1.0
    elif name == "inf":
        D[:] = np.inf
    return D, U


def _nj_state(D, U, dtype, dev):
    from dipper_tpu_torch.nj import engine

    st = engine._State(D, dtype, dev, None)
    if U is not None:
        st.U.copy_(torch.from_numpy(U))
    return st


def _q_plain_on(st, n, r0, r1):
    from dipper_tpu_torch.nj import engine

    Un = st.U[:n] / st.denom[n]
    Q = engine._q_rows(st.D[:n, :n], Un, st.q_buffer(), st.big, r0, r1)
    li = int(torch.argmin(Q))
    return li + r0 * n, float(Q.view(-1)[li])


@pytest.mark.parametrize("case", ["random", "nan", "signed_zeros", "ties",
                                  "inf"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [3, 5, 128, 129, 1000, 4099])
def test_nj_q_argmin_kernel_equals_plain(cuda, n, dtype, case):
    """Kernel A (csrc/nj_q_argmin.cu) against the plain Q pass and
    torch.argmin on the card: the flat index, and for two ranks' row
    ranges the pair (value, flat), bit for bit (NaN for NaN)."""
    from dipper_tpu_torch.nj import nj_cuda

    D, U = _nj_case(case, n, dtype, n)
    st = _nj_state(D, U, dtype, cuda)
    k = nj_cuda.Stepper(st.D, st.U, st.real, st.log_ids, st.log_bl)
    before = nj_cuda.Q_ARGMIN_LAUNCHES
    k.q_argmin(n)
    assert int(k.flat) == _q_plain_on(st, n, 0, n)[0]
    half = -(-n // 2)
    for r0, r1 in ((0, half), (half, n)):
        k.q_argmin(n, r0, r1)
        flat, v = _q_plain_on(st, n, r0, r1)
        got_v, got_flat = k.pair.tolist()
        assert got_flat == float(flat)
        assert got_v == v or (np.isnan(got_v) and np.isnan(v))
        assert np.signbit(got_v) == np.signbit(v)
    assert nj_cuda.Q_ARGMIN_LAUNCHES == before + 3


def _nj_half_case(name, n, dtype, seed):
    """_nj_case's values in mirrored pairs: D symmetric bit for bit."""
    D, U = _nj_case(name, n, dtype, seed)
    D = np.tril(D) + np.tril(D, -1).T
    if name == "signed_zeros":
        D[n - 1, 1] = D[1, n - 1] = 0.0
        D[n // 2, 0] = D[0, n // 2] = -0.0
    return D, U


@pytest.mark.parametrize("case", ["random", "nan", "signed_zeros", "ties",
                                  "inf"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [3, 5, 128, 129, 1000, 4099])
def test_nj_q_argmin_half_read_equals_plain(cuda, n, dtype, case):
    """Kernel A's half read against the plain full Q pass and
    torch.argmin on the card, on symmetric matrices: the flat index, also
    over active prefixes whose n is not a multiple of the 16-byte load
    (the leading dimension is the padded N)."""
    from dipper_tpu_torch.nj import nj_cuda

    D, U = _nj_half_case(case, n, dtype, n)
    st = _nj_state(D, U, dtype, cuda)
    k = nj_cuda.Stepper(st.D, st.U, st.real, st.log_ids, st.log_bl,
                        half=True)
    q0, h0 = nj_cuda.Q_ARGMIN_LAUNCHES, nj_cuda.HALF_READ_LAUNCHES
    for m in sorted({n, max(3, n - 1), max(3, n - 2)}):
        k.q_argmin(m)
        assert int(k.flat) == _q_plain_on(st, m, 0, m)[0], m
    launched = len({n, max(3, n - 1), max(3, n - 2)})
    assert nj_cuda.Q_ARGMIN_LAUNCHES - q0 == launched
    assert nj_cuda.HALF_READ_LAUNCHES - h0 == launched


def test_nj_stepper_rejects_unaligned_rows(cuda):
    """Kernel A's 16-byte loads need rows a multiple of 4 f32 (2 f64)
    elements apart and D aligned: a contiguous [N, N] with N = 4,099
    is refused, the padded working copy taken."""
    from dipper_tpu_torch.nj import nj_cuda

    D, U = _nj_half_case("random", 4099, "float32", 3)
    st = _nj_state(D, U, "float32", cuda)
    assert st.D.stride(0) % 32 == 0
    dense = st.D.contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        nj_cuda.Stepper(dense, st.U, st.real, st.log_ids, st.log_bl)
    nj_cuda.Stepper(st.D, st.U, st.real, st.log_ids, st.log_bl)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [3, 4, 5, 127, 128, 129, 300, 4099])
def test_nj_update_kernel_equals_plain_step(cuda, n, dtype):
    """Kernel B (csrc/nj_update.cu) against one plain step on the card,
    on the active prefix of a larger matrix, bit for bit: D, U, real and
    the log row; x = 0 and y = last among the pairs. In f64 above 128
    the two sum U[x] in their own orders, so there the values lie on a
    grid on which every order is exact."""
    from dipper_tpu_torch.nj import engine, nj_cuda

    rng = np.random.default_rng(n)
    N, step = n + 3, 3
    A = rng.random((N, N)) * np.exp(rng.normal(0, 1, (N, N)))
    D = (A + A.T).astype(dtype)
    np.fill_diagonal(D, 0)
    if dtype == "float64" and n > 128:
        D = np.round(D * 2.0**16) / 2.0**16
    flats = {n - 1, (n - 1) * n, 2 * n - 1,
             int(rng.integers(0, n)) * n + int(rng.integers(0, n))}
    for flat in sorted(f for f in flats if f // n != f % n):
        want = _nj_state(D, None, dtype, cuda)
        engine._update_plain(want, step, torch.tensor([flat], device=cuda))
        got = _nj_state(D, None, dtype, cuda)
        k = nj_cuda.Stepper(got.D, got.U, got.real, got.log_ids, got.log_bl)
        k.update(step, n, torch.tensor([flat], device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.D, want.D), flat
        assert torch.equal(got.U, want.U), flat
        assert torch.equal(got.real, want.real), flat
        assert torch.equal(got.log_ids[step], want.log_ids[step])
        assert torch.equal(got.log_bl[step], want.log_bl[step])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nj_kernel_route_equals_plain_route(cuda, dtype):
    """A whole NJ of 2,048 taxa by the kernels against merge_step_plain on
    the card: equal join ids; f32 branch lengths byte for byte, f64
    within 1e-12 relative (U[x]'s f64 sum order is each route's own)."""
    from dipper_tpu_torch.nj import neighbor_joining_plain, nj_cuda

    D = _additive(2048, 11)
    before = nj_cuda.UPDATE_LAUNCHES
    half = nj_cuda.HALF_READ_LAUNCHES
    got = neighbor_joining(D, dtype_name=dtype, device=cuda)
    assert nj_cuda.UPDATE_LAUNCHES == before + 2046
    # a symmetric matrix: every step's kernel A in the half read
    assert nj_cuda.HALF_READ_LAUNCHES == half + 2046
    want = neighbor_joining_plain(D, dtype_name=dtype, device=cuda)
    assert got[1] == want[1]
    assert ([[c for c, _ in ch] for ch in got[0]]
            == [[c for c, _ in ch] for ch in want[0]])
    gl = np.array([bl for ch in got[0] for _, bl in ch])
    wl = np.array([bl for ch in want[0] for _, bl in ch])
    if dtype == "float32":
        assert np.array_equal(gl, wl)
    else:
        np.testing.assert_allclose(gl, wl, rtol=1e-12, atol=0)


def test_nj_steps_make_no_host_sync(cuda):
    """Merge steps by the kernels under sync_debug_mode "error": two
    launches a step, no sync; a refused launch raises and is not
    counted."""
    from dipper_tpu_torch.nj import engine, nj_cuda

    D, _ = _nj_case("random", 1000, "float32", 2)
    st = _nj_state(D, None, "float32", cuda)
    k = engine._stepper(st, engine._read_mode(st, None))
    assert k.half
    q0, u0 = nj_cuda.Q_ARGMIN_LAUNCHES, nj_cuda.UPDATE_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(50):
            engine._merge_step_kernels(k, st, step, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert nj_cuda.Q_ARGMIN_LAUNCHES - q0 == 50
    assert nj_cuda.UPDATE_LAUNCHES - u0 == 50
    with pytest.raises(RuntimeError, match="nj_q_argmin launch failed"):
        k.q_argmin(2)
    assert nj_cuda.Q_ARGMIN_LAUNCHES - q0 == 50


def _aligned_codes(n, L, seed, gap_frac=0.05, blen_scale=1.0):
    from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes

    _, seqs = simulate_alignment(n, L, np.random.default_rng(seed),
                                 gap_frac=gap_frac, blen_scale=blen_scale)
    return batch_codes(seqs, encode_4bit_codes, pad_value=4)[0]


@pytest.mark.parametrize("n, q, L", [(300, 37, 1003), (9, 2, 64), (1, 1, 5)])
def test_msa_pair_counts_cuda_equal_cpu(cuda, n, q, L):
    """The card's int8 product gives the CPU's counts bit for bit, also
    where its operands are padded (few rows, L and 5 * Bj not multiples
    of 8)."""
    from dipper_tpu_torch.distance import msa

    codes = torch.from_numpy(_aligned_codes(n, L, 5))
    phi = msa.one_hot_channels(codes)
    want = msa.pair_counts(phi[:q], phi)
    got = msa.pair_counts(phi[:q].to(cuda), phi.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (q, 5, n, 5)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
def test_msa_distances_cuda_close_to_cpu(cuda, dt, dtype):
    """Equal counts, then the same formulas: the card's log and sqrt may
    differ from the CPU's in the last place (rtol 1e-12 in f64, 2e-6 in
    f32, with an atol of 64 ulps of 1 for the formulas' O(1)
    intermediates), NaN and inf in the same places. Close relatives
    (branch scale 0.3), so that no pair sits next to a model's pole, where
    a last place is amplified without bound."""
    from dipper_tpu_torch.distance import msa

    codes = _aligned_codes(150, 500, 6, blen_scale=0.3)
    cpu = msa.msa_distance_matrix(codes, dt, dtype, "cpu")
    gpu = msa.msa_distance_matrix(codes, dt, dtype, cuda).cpu()
    assert torch.equal(gpu.isnan(), cpu.isnan())
    assert torch.equal(gpu.isinf(), cpu.isinf())
    rtol = 1e-12 if dtype == "float64" else 2e-6
    atol = 64 * torch.finfo(cpu.dtype).eps
    assert torch.allclose(gpu, cpu, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_cuda_build_equals_cpu_build(cuda, dtype):
    """Exact placement of 256 taxa from a matrix: the card's final state
    is the CPU's, bit for bit."""
    from dipper_tpu_torch.placement import exact

    D = _additive(256, 9)
    D = torch.from_numpy(D / (D.max() * 1.05)).to(getattr(torch, dtype))
    kw = dict(num_sequences=256, frontend="matrix", dtype_name=dtype,
              chunk=100)
    cpu = exact.run_exact_chunked((D,), **kw)
    gpu = exact.run_exact_chunked((D.to(cuda),), **kw)
    assert gpu.e.device.type == "cuda"
    a, b = tk.tree_state_to_numpy(cpu), tk.tree_state_to_numpy(gpu)
    for f in exact.ExactState.FIELDS:
        assert np.array_equal(a[f], b[f]), f


def _exact_fields_equal(a, b) -> None:
    """Two exact states (or their numpy dicts) bit for bit, adj too."""
    from dipper_tpu_torch.placement import exact

    a, b = (x if isinstance(x, dict) else dict(
        tk.tree_state_to_numpy(x), adj=x.adj.cpu().numpy()) for x in (a, b))
    for f in exact.ExactState.FIELDS + ("adj",):
        nan = np.asarray(a[f]).dtype.kind == "f"
        assert np.array_equal(a[f], b[f], equal_nan=nan), f


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_kernel_route_equals_plain_route(cuda, dtype, tmp_path):
    """256 insertions (N = 258) on the card in ranges of 100 (graphs of 64
    replayed, remainders by direct launches): the kernel route's state is
    the plain route's on the card bit for bit, also when the build is
    checkpointed and when it is resumed from a checkpoint at insertion 100;
    one exact_step launch an insertion."""
    from dipper_tpu_torch.placement import exact, exact_cuda

    n = 258
    D = _additive(n, 12)
    D = torch.from_numpy(D / (D.max() * 1.05)).to(getattr(torch, dtype))
    Dc = D.to(cuda)
    kw = dict(num_sequences=n, frontend="matrix", dtype_name=dtype,
              chunk=100)
    plain = exact.run_exact_chunked((Dc,), plain=True, **kw)
    before = exact_cuda.EXACT_STEP_LAUNCHES
    ck = str(tmp_path / "exact.npz")
    got = exact.run_exact_chunked((Dc,), save_state=ck, **kw)
    assert exact_cuda.EXACT_STEP_LAUNCHES - before == n - 2
    assert got.stepper is not None
    assert exact_cuda.last_out(got)["status"] == 0
    _exact_fields_equal(got, plain)
    # a checkpoint at insertion 100, resumed by the kernel route
    first = exact.init_exact_state((Dc,), num_sequences=n,
                                   frontend="matrix", dtype_name=dtype)
    exact.run_exact_range(first, 2, 100, Dc[2:100], n)
    tk.save_tree_state(ck, first, 100, n, {"frontend": "matrix",
                                           "dtype": dtype,
                                           "placement": "exact"})
    resumed = exact.run_exact_chunked((Dc,), load_state=ck, **kw)
    _exact_fields_equal(resumed, plain)


def test_exact_one_launch_no_sync_an_insertion(cuda):
    """A range of 2 x 64 + 5 insertions after the state's graph was
    captured: one exact_step launch an insertion, two graph replays, no
    host sync (sync_debug_mode "error"), and the launch's record: status 0
    and the plain version's greatest depth."""
    from dipper_tpu_torch.placement import exact, exact_cuda, insert_cuda

    n = 400
    D = _additive(n, 4)
    D = torch.from_numpy(D / (D.max() * 1.05)).to(cuda)
    st = exact.init_exact_state((D,), num_sequences=n, frontend="matrix",
                                dtype_name="float64")
    exact.run_exact_range(st, 2, 200, D[2:200], n)      # captures the graph
    k = 2 * exact_cuda.GRAPH_INSERTIONS + 5
    launches, replays = (exact_cuda.EXACT_STEP_LAUNCHES,
                         insert_cuda.GRAPH_REPLAYS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exact.run_exact_range(st, 200, 200 + k, D[200:200 + k], n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert exact_cuda.EXACT_STEP_LAUNCHES - launches == k
    assert insert_cuda.GRAPH_REPLAYS - replays == 2
    want = exact.ExactState.from_numpy(tk.tree_state_to_numpy(st), cuda)
    depth = exact._max_depth(want)
    exact.run_exact_range(st, 200 + k, 201 + k, D[200 + k:201 + k], n)
    out = exact_cuda.last_out(st)
    assert out["status"] == 0 and out["maxdep"] == depth
    exact.run_exact_range(want, 200 + k, 201 + k, D[200 + k:201 + k], n,
                          plain=True)
    _exact_fields_equal(st, want)


def test_exact_failed_insertion_raises(cuda, monkeypatch):
    """A walk that overflows (a cycle in adj) at the first insertion of a
    range of 198, inside replayed graphs: every later launch does
    nothing, run_exact_chunked raises after the range naming insertion 2,
    and the tree, adj and the cursor are as they were."""
    from dipper_tpu_torch.placement import exact, exact_cuda

    n = 200
    D = _additive(n, 6)
    D = torch.from_numpy(D / (D.max() * 1.05)).to(cuda)
    made = []
    init = exact.init_exact_state

    def init_with_cycle(*args, **kw):
        st = init(*args, **kw)
        st.adj[0] = torch.tensor([0, 3, -1], dtype=torch.int32, device=cuda)
        st.e[3] = 0
        made.append((st, dict(tk.tree_state_to_numpy(st),
                              adj=st.adj.cpu().numpy())))
        return st

    monkeypatch.setattr(exact, "init_exact_state", init_with_cycle)
    launches = exact_cuda.EXACT_STEP_LAUNCHES
    with pytest.raises(RuntimeError, match="at insertion 2:.*more nodes"):
        exact.run_exact_chunked((D,), num_sequences=n, frontend="matrix",
                                dtype_name="float64")
    assert exact_cuda.EXACT_STEP_LAUNCHES - launches == n - 2
    (st, before), = made
    _exact_fields_equal(st, before)
    out = exact_cuda.last_out(st)
    assert out["status"] == out["error"] == 2
    assert int(st.stepper.cursor[0]) == 2


def test_exact_kernel_special_rows(cuda):
    """Rows with NaN and inf, and rows far above every length (the first
    minimum on slot 0), f32 and f64: the kernel route's state after every
    insertion is the plain route's on the card."""
    from dipper_tpu_torch.placement import exact

    n = 40
    D = _additive(n, 2)
    D = D / (D.max() * 1.05)
    R = D.copy()
    for i in range(2, n):
        if i % 4 == 1:
            R[i, (i * 7) % i] = np.nan
        if i % 5 == 2:
            R[i, (i * 3) % i] = np.inf
        if i % 6 == 3:
            R[i, (i * 5) % i] = -np.inf
    for rows in (R, D + 50.0):
        for dtype in (torch.float32, torch.float64):
            Rc = torch.from_numpy(rows).to(dtype).to(cuda)
            kw = dict(num_sequences=n, frontend="matrix",
                      dtype_name=str(dtype).split(".")[1])
            a = exact.init_exact_state((Rc,), **kw)
            b = exact.init_exact_state((Rc,), **kw)
            for i in range(2, n):
                exact.run_exact_range(a, i, i + 1, Rc[i:i + 1], n)
                exact.run_exact_range(b, i, i + 1, Rc[i:i + 1], n,
                                      plain=True)
                _exact_fields_equal(a, b)


def _points(n, seed):
    """Distances of n random points in the unit cube, scaled below 1."""
    x = np.random.default_rng(seed).random((n, 3))
    D = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    return D / (D.max() * 1.05)


def _balanced(n, seed):
    """Leaf-to-leaf path lengths (scaled below 1) of a complete binary tree
    of n = 2^k leaves with random branch lengths: exact placement grows it
    back level by level, so its levels are wide."""
    k = n.bit_length() - 1
    rng = np.random.default_rng(seed)
    # depth[h][a]: the distance from the root to node a of height h
    depth = [None] * (k + 1)
    depth[k] = np.zeros(1)
    for h in range(k - 1, -1, -1):
        depth[h] = (np.repeat(depth[h + 1], 2)
                    + rng.uniform(0.5, 1.5, 2 ** (k - h)))
    i = np.arange(n)
    x = i[:, None] ^ i[None, :]
    h = np.zeros_like(x)
    for b in range(k):
        h = np.where(x >> b > 0, b + 1, h)
    lca = np.zeros(x.shape)
    for b in range(k + 1):
        at = h == b
        lca[at] = depth[b][(i[:, None] >> b).repeat(n, 1)[at]]
    D = depth[0][:, None] + depth[0][None, :] - 2 * lca
    return D / (D.max() * 1.05)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_cluster_wide_tree_equals_plain_route(cuda, dtype):
    """A 4,096-taxon balanced tree built by the kernel route, then ranges
    of 48 insertions from copies of its state at three launch shapes: the
    main path's cluster of 8 blocks at W = 64 (ten levels wider) and at
    W = 1 (every level past the root's split, so every block has work),
    and 2 blocks at W = 1 (levels of more than 2 x 512 entries walked in
    rounds). The first launch of a copy is block 0's; before and after each
    later range of 16 the launch before found at least CLUSTER_LEVELS wide
    levels (so the range ran on the whole cluster), and a level was split.
    After every range the state, adj and the node records kept by the
    splices equal the plain route's on the card bit for bit (records
    rebuilt from its state)."""
    import dataclasses

    from dipper_tpu_torch.placement import exact, exact_cuda

    n, k = 4096, 48
    Dc = torch.from_numpy(_balanced(n, 21)).to(getattr(torch, dtype)).to(cuda)
    kw = dict(num_sequences=n, frontend="matrix", dtype_name=dtype)
    st = exact.init_exact_state((Dc,), **kw)
    lo = n - 3 * k
    exact.run_exact_range(st, 2, lo, Dc[2:lo], n)
    exact_cuda.check_done(st)

    fields = exact.ExactState.FIELDS[:-1] + ("adj",)

    def clone(**shape):
        c = dataclasses.replace(st, **{f: getattr(st, f).clone()
                                       for f in fields})
        return exact_cuda.prepare_stepper(c, **shape)

    def on_cluster(a, wide, widest):
        out = exact_cuda.last_out(a)
        assert out["wide_levels"] >= exact_cuda.CLUSTER_LEVELS, out
        starts = a.stepper.scratch_i[3].cpu().numpy()
        widths = np.diff(starts[:out["maxdep"] + 2])
        assert int(widths.max()) > max(wide, widest), widths

    for j, (ctas, wide) in enumerate(((8, 64), (8, 1), (2, 1))):
        a, b = clone(ctas=ctas, wide=wide), clone()
        bounds = [lo + k * j, lo + k * j + 1] + list(
            range(lo + k * j + 17, lo + k * (j + 1), 16)) + [lo + k * (j + 1)]
        for r0, r1 in zip(bounds, bounds[1:]):
            if r0 > bounds[0]:
                on_cluster(a, wide, 0)
            exact.run_exact_range(a, r0, r1, Dc[r0:r1], n)
            exact.run_exact_range(b, r0, r1, Dc[r0:r1], n, plain=True)
            exact_cuda.check_done(a)
            _exact_fields_equal(a, b)
            assert torch.equal(a.stepper.rec, exact_cuda.node_records(b))
            on_cluster(a, wide, 2 * exact_cuda.THREADS if ctas == 2 else 0)


def test_exact_preload_raises_when_no_cluster_fits(cuda, monkeypatch):
    """prepare_stepper raises, before any launch or capture, where the card
    cannot hold one cluster of the launch's shape (the occupancy query
    patched to 0); nothing falls back to one block."""
    from dipper_tpu_torch.placement import exact, exact_cuda

    n = 64
    D = torch.from_numpy(_points(n, 3)).to(cuda)
    monkeypatch.setattr(exact_cuda, "_preloaded", set())
    monkeypatch.setattr(exact_cuda, "max_active_clusters",
                        lambda lib, device, ctas: 0)
    launches = exact_cuda.EXACT_STEP_LAUNCHES
    with pytest.raises(RuntimeError, match="cannot schedule a cluster"):
        exact.init_exact_state((D,), num_sequences=n, frontend="matrix",
                               dtype_name="float64")
    assert exact_cuda.EXACT_STEP_LAUNCHES == launches


def test_exact_records_built_by_the_card_equal_plain(cuda):
    """The node records that a cursor write rebuilds on the card equal
    exact_cuda.node_records on the same state, f32 and f64 (a 300-taxon
    build), and a real occupancy query finds room for the main path's
    cluster."""
    from dipper_tpu_torch.csrc.build import load
    from dipper_tpu_torch.placement import exact, exact_cuda

    n = 300
    for dtype in (torch.float32, torch.float64):
        D = torch.from_numpy(_points(n, 8)).to(dtype).to(cuda)
        st = exact.init_exact_state((D,), num_sequences=n,
                                    frontend="matrix",
                                    dtype_name=str(dtype).split(".")[1])
        exact.run_exact_range(st, 2, n, D[2:n], n)
        exact_cuda.set_cursor(st, n - 1, D[n - 1:], n - 1)
        assert torch.equal(st.stepper.rec, exact_cuda.node_records(st))
    lib = load("exact_step", exact_cuda._STEP_ARGS)
    assert exact_cuda.max_active_clusters(
        lib, torch.cuda.current_device(), exact_cuda.CLUSTER_CTAS) >= 1


@pytest.mark.parametrize("use_adj", [True, False])
def test_add_queries_cuda_equals_cpu(cuda, use_adj):
    """--add of 64 queries onto a 192-leaf backbone (mash rows, f64): the
    card's final edge arrays are the CPU's, bit for bit, and the scorer
    kernel ran once per query."""
    from dipper_tpu_torch.io.newick import parse_newick
    from dipper_tpu_torch.placement.api import backbone_tree_to_arrays

    n, B = 256, 192
    r = torch.from_numpy(_ranks(n, 2000, 4, 12, 100))
    kw = dict(frontend="mash", frontend_static=(12, 100),
              dtype_name="float64")
    e, belong, length = tk.run_placement((r[:B],), num_sequences=B, **kw)
    nwk = tk.edges_to_newick(e, belong, length, [f"L{i}" for i in range(B)],
                             B)
    tree = parse_newick(nwk, n)
    order = [int(nm[1:]) for nm in tree.leaf_names_in_idx_order()]
    r = r[order + list(range(B, n))].contiguous()
    arrays = backbone_tree_to_arrays(tree, n)
    out = {}
    for dev in ("cpu", cuda):
        before = tk.SCORE_EDGES_LAUNCHES
        out[str(dev)] = tk.run_add_queries(
            (r.to(dev),), *(torch.from_numpy(a).to(dev) for a in arrays),
            num_sequences=n, backbone_size=B, use_adj=use_adj, **kw)
        launched = tk.SCORE_EDGES_LAUNCHES - before
        assert launched == (n - B if dev == cuda else 0)
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# Kernel 4 (csrc/mash_cluster_inter.cu) and divide-and-conquer
# ---------------------------------------------------------------------------


def _cluster_lists(n_rows, c, cmax, seed):
    """c clusters of ragged sizes 1..cmax (members padded by repeating the
    last), witnesses 10 heads then the members, as D&C's phase 3 makes
    them."""
    rng = np.random.default_rng(seed)
    sz = rng.integers(1, cmax + 1, c)
    sz[0], sz[-1] = 1, cmax
    mem = np.empty((c, cmax), np.int32)
    for i in range(c):
        ids = rng.choice(n_rows, min(sz[i], n_rows), replace=False)
        mem[i] = ids[np.minimum(np.arange(cmax), len(ids) - 1)]
    wit = np.concatenate([rng.integers(0, n_rows, (c, 10)), mem],
                         axis=1).astype(np.int32)
    return wit, mem


# (400, 8), (300, 16), (200, 32): the narrow path over more than one wave
# of blocks; (100, 33): just above its crossover (32 members)
@pytest.mark.parametrize("c, cmax", [(13, 8), (13, 16), (13, 64), (5, 128),
                                     (1, 300), (9, 1), (400, 8), (300, 16),
                                     (200, 32), (100, 33)])
@pytest.mark.parametrize("ss", [1000, 100, 33, 1])
@pytest.mark.parametrize("layout", ["tail", "generic"])
def test_cluster_kernel_equals_plain(cuda, c, cmax, ss, layout):
    """mash_cluster_inter_cuda == cluster_inter_ref, bitwise: real
    sketches (S = 1000 and 100), sorted rows of a small universe (S = 33,
    S = 1), ragged sizes with the repeat pad, c not a multiple of 8, one
    cluster. "tail": the members passed as a view of the witness lists'
    tail, as D&C passes them; "generic": a witness tail that is not the
    member list, the members a tensor of their own."""
    if ss in (1000, 100):
        r = _ranks(400, 3000, 8, 15 if ss == 1000 else 12, ss)
    else:
        r = _sorted_rows(400, ss, tm._pad_pow2(ss), 3 * ss, 4)
    wit, mem = _cluster_lists(400, c, cmax, c * cmax + ss)
    if layout == "generic":
        wit[:, 10:] = np.random.default_rng(ss).integers(0, 400, (c, cmax))
    r, wit, mem = (torch.from_numpy(a).to(cuda) for a in (r, wit, mem))
    if layout == "tail":
        mem = wit[:, 10:]
    before = mash_cuda.CLUSTER_LAUNCHES
    got = mash_cuda.mash_cluster_inter_cuda(r, wit, mem, sketch_size=ss)
    torch.cuda.synchronize()
    assert mash_cuda.CLUSTER_LAUNCHES == before + 1
    want = tm.cluster_inter_ref(r, wit, mem, sketch_size=ss)
    assert torch.equal(got, want)
    # and kernel 1 on the gathered rows of one cluster
    k1 = mash_cuda.mash_inter_cuda(r[wit[-1].long()].contiguous(),
                                   r[mem[-1].long()].contiguous(),
                                   sketch_size=ss)
    assert torch.equal(got[-1], k1)


def test_cluster_wrapper_rejects_strided_members(cuda):
    r = torch.from_numpy(_ranks(20, 800, 3, 12, 128)).to(cuda)
    wit = torch.zeros((3, 12), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rows contiguous"):
        mash_cuda.mash_cluster_inter_cuda(r, wit, wit[:, ::2],
                                          sketch_size=128)


def test_cluster_kernel_adversarial_rows(cuda):
    rng = np.random.default_rng(3)
    r = torch.from_numpy(_adversarial(300, 100, 128, rng)).to(cuda)
    wit, mem = (torch.from_numpy(a).to(cuda)
                for a in _cluster_lists(300, 11, 24, 9))
    got = mash_cuda.mash_cluster_inter_cuda(r, wit, mem, sketch_size=100)
    assert torch.equal(got, tm.cluster_inter_ref(r, wit, mem,
                                                 sketch_size=100))


@pytest.mark.parametrize("frontend", ["mash", "matrix"])
def test_dc_cuda_equals_cpu(cuda, frontend, monkeypatch):
    """D&C on the card gives the CPU's f64 Newick bytes, with several
    buckets, chunked builds and streamed clusters; the mash path launches
    the per-cluster count kernel."""
    from dipper_tpu_torch.dc import pipeline as dc
    from dipper_tpu_torch.utils.params import Param

    names, seqs = simulate_unaligned(300, 900, np.random.default_rng(17))
    monkeypatch.setattr(dc, "_STREAM_CLUSTER_MIN", 32)
    monkeypatch.setattr(dc, "_STREAM_ROW_BLOCK", 5)
    monkeypatch.setattr(dc, "PHASE3_BUDGET", 100)
    if frontend == "mash":
        p = Param(in_format="r", kmer_size=12, sketch_size=100,
                  dtype="float64", backbone_size=15)
        run = lambda dev: dc.build_dc_tree(seqs, names, p, device=dev,
                                           log=lambda m: None)
    else:
        D = tm.mash_distance_matrix(_ranks(300, 900, 17, 12, 100), 12, 100,
                                    "float64", "cpu").numpy()
        p = Param(in_format="d", dtype="float64", backbone_size=15)
        run = lambda dev: dc.build_dc_tree_from_matrix(
            D, names, p, device=dev, log=lambda m: None)
    want = run(torch.device("cpu"))
    before = mash_cuda.CLUSTER_LAUNCHES
    assigned = assign_cuda.ASSIGN_LAUNCHES
    packed = assign_cuda.PACK_LAUNCHES
    got = run(cuda)
    assert got == want
    assert (mash_cuda.CLUSTER_LAUNCHES > before) == (frontend == "mash")
    # phase 2: 285 queries, one chunk, one kernel-10 launch, one pack
    assert assign_cuda.ASSIGN_LAUNCHES == assigned + 1
    assert assign_cuda.PACK_LAUNCHES == packed + 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_edges_rows_cuda_equals_kernel_loop(cuda, dtype):
    """D&C's phase-2 scorer on the card by kernel 10 (csrc/dc_assign.cu),
    called by its wrapper and through score_edges_rows, one launch each:
    the eids of the scorer kernel called row by row, of the plain version
    on the card and of the plain scorer on the CPU."""
    r = torch.from_numpy(_ranks(200, 2000, 6, 12, 100))
    kw = dict(num_sequences=150, frontend="mash", frontend_static=(12, 100),
              dtype_name=dtype)
    st = tk.run_placement_full((r[:150].to(cuda),), **kw)
    rows = tm.mash_pairwise(r[:150].to(cuda), r[150:].to(cuda), k=12,
                            sketch_size=100, dtype_name=dtype)
    want = [tk.score_edges(st, rows[i])[0] for i in range(rows.shape[0])]
    before = assign_cuda.ASSIGN_LAUNCHES
    packed = assign_cuda.PACK_LAUNCHES
    assert assign_cuda.assign(st, rows).tolist() == want
    assert tk.uses_assign_kernel(st)
    records = tk.assign_records(st, rows.shape[1])
    assert tk.score_edges_rows(st, rows, records=records).tolist() == want
    assert tk.score_edges_rows(st, rows).tolist() == want
    assert assign_cuda.ASSIGN_LAUNCHES == before + 3
    assert assign_cuda.PACK_LAUNCHES == packed + 3
    assert tk.score_edges_rows_plain(st, rows).tolist() == want
    cpu = tk.tree_state_from_numpy(tk.tree_state_to_numpy(st), "cpu")
    assert tk.score_edges_rows(cpu, rows.cpu()).tolist() == want


ASSIGN_FIELDS = ("e", "belong", "length", "rev", "cdis", "cid")
# instances of kernel 10: (rows a block, staged, blocks a cluster, ring
# stages), None the plan's; rows read from device memory are GLOBAL_ROWS
# a block (4 of them an instance that does not exist); two stages wrap
# the ring every other tile, 16 fill it
ASSIGN_INSTANCES = [(None, None, None, None), (None, None, 1, None),
                    (None, None, 2, None), (None, None, 1, 2),
                    (None, None, None, 2), (None, None, 2, 16),
                    (1, True, None, None), (1, True, 1, 2),
                    (2, True, None, None), (4, True, None, None),
                    (8, True, None, None), (8, True, 1, None),
                    (2, False, None, None), (2, False, 1, 2),
                    (4, False, None, None)]


def _assign_all_plans(st, rows, want, tag):
    """Kernel 10 under its plan and every instance of ASSIGN_INSTANCES, over
    records packed once: equal to `want` where the instance fits (its plan
    the model's), a launch that raises where it does not."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.dc import assign_model as am

    W, item = rows.shape[1], rows.element_size()
    records = assign_cuda.pack(st, W)
    for R, staged, cl, stages in ASSIGN_INSTANCES:
        kw = dict(rows_per_block=R, staged=staged, cluster=cl, stages=stages)
        try:
            plan = am.kernel_plan(W, item, R, staged, cl, stages)
        except ValueError:
            with pytest.raises(RuntimeError, match="invalid argument"):
                assign_cuda.assign(st, rows, records=records, **kw)
            continue
        assert assign_cuda.plan(W, rows.dtype, **kw) == plan, (tag, kw)
        before = assign_cuda.ASSIGN_LAUNCHES
        got = assign_cuda.assign(st, rows, records=records, **kw)
        torch.cuda.synchronize()
        assert assign_cuda.ASSIGN_LAUNCHES == before + 1
        assert got.dtype == torch.int64
        assert torch.equal(got, want), (tag, kw)


def _assert_pack_equals_plain(st, width, tag):
    """The pack kernel against pack_slots_plain, byte for byte: the
    records of the valid slots and meta (count, lowest invalid slot)."""
    from dipper_tpu_torch.dc import assign_cuda

    before = assign_cuda.PACK_LAUNCHES
    got = assign_cuda.pack(st, width)
    rec, meta = tk.pack_slots_plain(st, width)
    torch.cuda.synchronize()
    assert assign_cuda.PACK_LAUNCHES == before + 1
    assert torch.equal(got.meta, meta), (tag, got.meta, meta)
    assert got.data.shape[1] == rec.shape[1]
    assert torch.equal(got.data[:rec.shape[0]], rec), tag


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_assign_kernel_equals_plain_and_model(cuda, dtype):
    """Kernel 10 against score_edges_rows_plain on the card and
    dc/assign_model.py, bit for bit, under its plan and every forced
    instance: the scorer's made-up states (ties between two valid edges,
    every valid score above 2.0, NaN and +inf in rows, four edges, unused
    tails; record counts ragged against the tile), 13 rows (ragged
    against every plan's rows a block), contiguous and as a strided view
    of wider rows; the pack against its plain version on each state."""
    from dipper_tpu_torch.dc import assign_model as am

    rng = np.random.default_rng(5)
    for name, d, row, _ in sm.made_up_cases(dtype):
        st = tk.tree_state_from_numpy(
            {k: v for k, v in d.items() if v is not None}, cuda)
        rows_h = np.stack([row] + [rng.permutation(row) for _ in range(11)]
                          + [np.full_like(row, row[0])])
        wide_h = np.concatenate(
            [rows_h, rng.random((13, 5)).astype(dtype)], axis=1)
        rows = torch.from_numpy(rows_h).to(cuda)
        strided = torch.from_numpy(wide_h).to(cuda)[:, :rows_h.shape[1]]
        want = tk.score_edges_rows_plain(st, rows)
        model = am.assign({f: d[f] for f in ASSIGN_FIELDS}, rows_h)
        assert want.tolist() == model.tolist(), name
        _assert_pack_equals_plain(st, rows_h.shape[1], name)
        for r, tag in ((rows, "contiguous"), (strided, "strided")):
            _assign_all_plans(st, r, want, f"{name} {tag}")


@pytest.mark.parametrize("width", [1500, 50000])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_assign_kernel_wide_rows(cuda, dtype, width):
    """Rows of D&C's widths at 30K (B = 1,500: R = 8 rows a block in f32,
    4 in f64) and at the 1M band (B = 50,000: one row a block in f32, rows
    read from device memory in f64), 9 rows with NaN in one, on a made-up
    state of 4B slots (half of the used ones valid, the witnesses spread
    over the row): the pack and the kernel under its plan and every forced
    instance equal the plain versions and the model; the kernel's plans
    are the model's at the widths where they change."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.dc import assign_model as am

    rng = np.random.default_rng(8)
    d = sm.made_up_state(2 * width - 2, 4 * width, width, dtype, rng,
                         bare=False)
    st = tk.tree_state_from_numpy(d, cuda)
    rows_h = rng.random((9, width)).astype(dtype)
    rows_h[3, ::97] = np.nan
    rows = torch.from_numpy(rows_h).to(cuda)
    want = tk.score_edges_rows_plain(st, rows)
    assert want.tolist() == am.assign(
        {f: d[f] for f in ASSIGN_FIELDS}, rows_h).tolist()
    _assert_pack_equals_plain(st, width, f"wide {width}")
    _assign_all_plans(st, rows, want, f"wide {width}")
    for w in (1500, 5000, 12288, 27000, 27500, 50000, 70000):
        for dt in (torch.float32, torch.float64):
            plan = am.kernel_plan(w, 8 if dt == torch.float64 else 4)
            assert assign_cuda.plan(w, dt) == plan, (w, dt)


def test_assign_kernel_int32_ids(cuda):
    """Rows 70,000 wide (over uint16's 65,535): the pack writes int32 ids
    and kernel 10 reads its rows from device memory; 5 rows on a made-up
    state of 4,100 slots whose witnesses span the row."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.dc import assign_model as am

    rng = np.random.default_rng(12)
    width = 70000
    d = sm.made_up_state(2000, 4100, width, "float32", rng)
    st = tk.tree_state_from_numpy(d, cuda)
    rows_h = rng.random((5, width)).astype(np.float32)
    rows = torch.from_numpy(rows_h).to(cuda)
    want = tk.score_edges_rows_plain(st, rows)
    assert want.tolist() == am.assign(
        {f: d[f] for f in ASSIGN_FIELDS}, rows_h).tolist()
    assert assign_cuda.pack(st, width).id_bytes == 4
    _assert_pack_equals_plain(st, width, "int32 ids")
    _assign_all_plans(st, rows, want, "int32 ids")


def test_pack_kernel_equals_plain(cuda):
    """The pack against pack_slots_plain, byte for byte, on states whose
    valid slots all sit past the pack's first tile (1,024 slots), whose
    lowest invalid slot does, a state with no valid slot, one with no
    invalid slot, and one of 200,000 slots (196 tiles, the blocks' look-back
    over many tiles)."""
    from dipper_tpu_torch.dc import assign_model as am

    rng = np.random.default_rng(13)
    tile = am.PACK_TILE
    for dtype in ("float32", "float64"):
        d = sm.made_up_state(2100, 4400, 300, dtype, rng)
        low = np.arange(4400) < tile
        d["belong"][low & (d["belong"] > d["e"])] = -1
        st = tk.tree_state_from_numpy(d, cuda)
        _assert_pack_equals_plain(st, 300, f"late {dtype}")
        _assert_pack_equals_plain(st, 70000, f"late int32 {dtype}")
        high = np.arange(4400) < 3 * tile + 7
        d["belong"][high] = np.maximum(d["belong"][high], d["e"][high] + 1)
        assert (d["belong"][:3 * tile + 7] > d["e"][:3 * tile + 7]).all()
        _assert_pack_equals_plain(tk.tree_state_from_numpy(d, cuda), 300,
                                  f"late invalid {dtype}")
        big = sm.made_up_state(99999, 200000, 50000, dtype, rng, bare=False)
        _assert_pack_equals_plain(tk.tree_state_from_numpy(big, cuda), 50000,
                                  f"200,000 slots {dtype}")
        none = dict(d, belong=np.full_like(d["belong"], -1))
        _assert_pack_equals_plain(tk.tree_state_from_numpy(none, cuda), 300,
                                  f"no valid slot {dtype}")
        pairs = sm.made_up_state(50, 100, 300, dtype, rng)
        full = dict(pairs, belong=np.full_like(pairs["belong"], 5),
                    e=np.full_like(pairs["e"], 1),
                    rev=np.arange(100, dtype=np.int32)[::-1].copy())
        _assert_pack_equals_plain(tk.tree_state_from_numpy(full, cuda), 300,
                                  f"no invalid slot {dtype}")


def test_assign_wrapper_rejects_bad_inputs(cuda):
    """Kernel 10's wrapper raises on rows of another type or device, rows
    that are not unit stride along a row, a wrong output buffer, records
    whose ids do not fit the rows' width, and the launch on a refused
    cluster size, ring or instance."""
    from dipper_tpu_torch.dc import assign_cuda

    name, d, row, _ = sm.made_up_cases("float32")[0]
    st = tk.tree_state_from_numpy(d, cuda)
    rows = torch.from_numpy(np.stack([row, row])).to(cuda)
    with pytest.raises(ValueError, match="rows must be"):
        assign_cuda.assign(st, rows.double())
    with pytest.raises(ValueError, match="rows must be"):
        assign_cuda.assign(st, rows.cpu())
    with pytest.raises(ValueError, match="rows must be"):
        assign_cuda.assign(st, rows.t())
    with pytest.raises(ValueError, match="out must be"):
        assign_cuda.assign(st, rows, torch.empty(2, dtype=torch.int32,
                                                 device=cuda))
    narrow = assign_cuda.pack(st, rows.shape[1])
    wide = torch.zeros((2, 70000), dtype=torch.float32, device=cuda)
    wide[:, :rows.shape[1]] = rows
    with pytest.raises(ValueError, match="do not fit"):
        assign_cuda.assign(st, wide, records=narrow)
    for kw in (dict(cluster=3), dict(cluster=4), dict(cluster=8),
               dict(cluster=16), dict(stages=1), dict(stages=17),
               dict(rows_per_block=4, staged=False),
               dict(rows_per_block=3)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            assign_cuda.assign(st, rows, records=narrow, **kw)
        with pytest.raises(RuntimeError, match="invalid argument"):
            assign_cuda.plan(rows.shape[1], torch.float32, **kw)


def _sketch_rows(k, seed):
    """Ragged and adversarial rows: lengths 0, k-1, k, k+1, around the
    kernel's tile edge (4,095 to 4,097 windows and bases), 10,000; N,
    lowercase and U bytes; a repeat-heavy row; in a ragged order."""
    rng = np.random.default_rng(seed)
    lens = (0, k - 1, k, k + 1, 4095, 4096, 4097, 4095 + k, 4096 + k,
            10000)
    seqs = [bytes(rng.choice(list(b"ACGTNacgtU"), L).astype(np.uint8))
            for L in lens]
    seqs.append(b"ACGT" * 2500)
    return [seqs[i] for i in rng.permutation(len(seqs))]


@pytest.mark.parametrize("ss", [1, 100, 1000, 1024, 5000])
@pytest.mark.parametrize("k", [4, 11, 15])
def test_sketch_kernel_equals_plain(cuda, k, ss):
    from dipper_tpu_torch.sketch import minhash, minhash_cuda

    seqs = _sketch_rows(k, 100 * k + ss)
    before = minhash_cuda.LAUNCHES
    got = minhash.sketch_sequences(seqs, k, ss, device=cuda, as_device=True)
    torch.cuda.synchronize()
    assert minhash_cuda.LAUNCHES > before
    want = minhash.sketch_sequences(seqs, k, ss, device="cpu",
                                    as_device=True)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(got.cpu().numpy().view(np.uint64),
                          sketch_sequences_native(seqs, k, ss))


def test_sketch_kernel_long_row_and_largest_sketch(cuda):
    """A 2 Mbp row (489 tiles, nine merge rounds) at s = 1000, and the
    kernel's largest sketch size on a 100 kb row (every window kept, the
    rest sentinels): the kernel against the plain version on the card."""
    from dipper_tpu_torch.io.encode import encode_2bit_codes
    from dipper_tpu_torch.sketch import minhash, minhash_cuda

    rng = np.random.default_rng(4)
    long_row = bytes(rng.choice(list(b"ACGT"), 2_000_000).astype(np.uint8))
    for seqs, ss in (([long_row, long_row[:5000]], 1000),
                     ([long_row[:100_000], long_row[:33]],
                      minhash_cuda.MAX_SKETCH_SIZE)):
        got = minhash.sketch_sequences(seqs, 15, ss, device=cuda,
                                       as_device=True)
        codes = np.zeros((len(seqs), max(map(len, seqs))), np.uint8)
        for i, s in enumerate(seqs):
            codes[i, :len(s)] = encode_2bit_codes(s)
        words = minhash.pack_codes(torch.from_numpy(codes).to(cuda))
        lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32,
                            device=cuda)
        want = minhash.sketch_batch_plain(words, lens, k=15, sketch_size=ss)
        assert torch.equal(got, want)


def test_sketch_wrapper_rejects_bad_inputs(cuda):
    from dipper_tpu_torch.sketch import minhash_cuda as mc

    words = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    lens = torch.full((4,), 1000, dtype=torch.int32, device=cuda)
    before = mc.LAUNCHES
    bad = [((words[:, ::2], lens), dict(k=15, sketch_size=100), "contiguous"),
           ((words.long(), lens), dict(k=15, sketch_size=100), "int32"),
           ((words, lens), dict(k=16, sketch_size=100), "k 16"),
           ((words, lens), dict(k=15, sketch_size=mc.MAX_SKETCH_SIZE + 1),
            "the sketch kernel's limit"),
           ((words.cpu(), lens), dict(k=15, sketch_size=100), "CUDA")]
    for args, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            mc.minhash_sketch_cuda(*args, **kw)
    assert mc.LAUNCHES == before


def test_sketch_launches_count_one_a_batch(cuda, monkeypatch):
    """sketch_sequences makes one kernel call a batch: three batches,
    three launches, and the rows come back in input order."""
    from dipper_tpu_torch.sketch import minhash, minhash_cuda

    _, seqs = simulate_unaligned(30, 3000, np.random.default_rng(12))
    per_row = minhash._row_bytes(np.array([max(map(len, seqs))]), 15,
                                 1000)[0]
    monkeypatch.setattr(minhash, "_BATCH_BYTES", int(per_row * 10))
    before = minhash_cuda.LAUNCHES
    got = minhash.sketch_sequences(seqs, 15, 1000, device=cuda)
    assert minhash_cuda.LAUNCHES - before == 3
    assert np.array_equal(got, sketch_sequences_native(seqs, 15, 1000))


def _select_case_rows(case: str):
    """The select path's adversarial rows (k = 15): one 200 kb row (split
    into segments), rows shorter than k beside normal ones, poly-A rows
    (every window one hash) and a 4-periodic one, one 10 kb row."""
    rng = np.random.default_rng(31)

    def acgt(L):
        return bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8))

    return {"row_200kb": lambda: [acgt(200_000)],
            "short_rows": lambda: [b"", acgt(7), acgt(14), acgt(15),
                                   acgt(10_000)],
            "poly_a": lambda: [b"A" * 10_000, b"A" * 4111,
                               b"ACGT" * 2500],
            "b1": lambda: [acgt(10_000)]}[case]()


@pytest.mark.parametrize("ss", [1, 1000, 1024, 1 << 20])
@pytest.mark.parametrize("case", ["row_200kb", "short_rows", "poly_a",
                                  "b1"])
def test_sketch_kernel_select_cases(cuda, case, ss):
    """The kernel (select path below s = 8,193, the tile path above)
    against the plain version on the card, bitwise, on one batch."""
    from dipper_tpu_torch.io.encode import encode_2bit_codes
    from dipper_tpu_torch.sketch import minhash, minhash_cuda

    seqs = _select_case_rows(case)
    codes = np.zeros((len(seqs), max(15, max(map(len, seqs)))), np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = encode_2bit_codes(s)
    words = minhash.pack_codes(torch.from_numpy(codes).to(cuda))
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32,
                        device=cuda)
    before = minhash_cuda.LAUNCHES
    got = minhash_cuda.minhash_sketch_cuda(words, lens, k=15,
                                           sketch_size=ss)
    torch.cuda.synchronize()
    assert minhash_cuda.LAUNCHES == before + 1
    want = minhash.sketch_batch_plain(words, lens, k=15, sketch_size=ss)
    assert torch.equal(got, want)


def test_device_route_rank_bank_equals_host(cuda, tmp_path):
    """mash_rank_bank's device route (the kernel, rank_compress_dense) on
    the card gives the padded rank bank of the host route (native
    sketcher, np.unique; forced by --save-sketches) and of the device
    route on the CPU, byte for byte, on 2,048 rows."""
    from dipper_tpu_torch.sketch import minhash_cuda
    from dipper_tpu_torch.utils.params import Param

    _, seqs = simulate_unaligned(2048, 3000, np.random.default_rng(14))
    lines = []
    before = minhash_cuda.LAUNCHES
    got = tm.mash_rank_bank(seqs, Param(), cuda, log=lines.append)
    assert minhash_cuda.LAUNCHES > before
    assert got.device.type == "cuda"
    assert any(ln.startswith("Rank bank route: device") for ln in lines)
    host = tm.mash_rank_bank(
        seqs, Param(save_sketches=str(tmp_path / "sk.npz")), cuda)
    cpu = tm.mash_rank_bank(seqs, Param(), torch.device("cpu"))
    assert torch.equal(got, host)
    assert torch.equal(got.cpu(), cpu)


def test_rank_compress_cuda_equals_cpu(cuda):
    from dipper_tpu_torch.sketch import minhash

    _, seqs = simulate_unaligned(64, 2000, np.random.default_rng(13))
    sk = minhash.sketch_sequences(seqs, 12, 300, device=cuda, as_device=True)
    got = tm.rank_compress(sk)
    assert torch.equal(got.cpu(), tm.rank_compress(sk.cpu()))
    host = torch.from_numpy(tm.pad_ranks(tm.rank_compress_host(
        sk.cpu().numpy().view(np.uint64)))).to(cuda)
    for dtype in ("float32", "float64"):
        a = tm.mash_distance_matrix(tm.pad_ranks(got), 12, 300, dtype, cuda)
        b = tm.mash_distance_matrix(host, 12, 300, dtype, cuda)
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The insertion-step kernel (csrc/insert_step.cu) against its plain version
# ---------------------------------------------------------------------------


def _clone7(st):
    import dataclasses

    from dipper_tpu_torch.placement.insert_model import FIELDS

    return dataclasses.replace(st, **{f: getattr(st, f).clone()
                                      for f in FIELDS})


def _same7(a, b):
    """The seven state arrays and idx equal bit for bit."""
    from dipper_tpu_torch.placement.insert_model import FIELDS

    assert a.idx == b.idx
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            bits = torch.int32 if x.dtype == torch.float32 else torch.int64
            x, y = x.view(bits), y.view(bits)
        assert torch.equal(x, y), f


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind, n", [("random", 200), ("caterpillar", 128),
                                     ("some_nan", 120), ("all_nan", 40)])
def test_insert_step_kernel_equals_plain_on_builds(cuda, kind, n, dtype):
    """A build on the card whose every insertion is the kernel path, held
    after each insertion against a copy stepped by the plain version."""
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import insert_model as im

    D = torch.from_numpy(im.made_up_matrix(kind, n, seed=n)
                         .astype(dtype)).to(cuda)
    st = tk.init_placement_state((D,), num_sequences=n, frontend="matrix",
                                 dtype_name=dtype)
    assert st.inserter is not None and tk.uses_insert_kernel(st)
    pl = _clone7(st)
    stream = torch.cuda.current_stream().cuda_stream
    before = insert_cuda.INSERT_STEP_LAUNCHES
    for i in range(2, n):
        tk.kernel_insertion_step(st, D[i], i, n, stream)
        eid, x, y, ye, frac, add = tk._score_edges_plain(pl, D[i])
        tk.splice(pl, eid, frac, add, i, n, (x, y, ye))
        tk._update_closest_bfs_compact(pl, i, 2 * n)
        _same7(st, pl)
    assert insert_cuda.INSERT_STEP_LAUNCHES - before == n - 2


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_insert_step_kernel_made_up_splices(cuda, dtype):
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import insert_model as im

    dt = getattr(torch, dtype)
    for name, (cd_x, id_x, cd_y, id_y, orig, frac) in im.SPLICE_CASES.items():
        st = tk.init_state(4, dt, cuda)
        tk.build_initial_tree(st, torch.tensor(2 * orig, dtype=dt,
                                               device=cuda), 4)
        st.cdis[0] = torch.tensor(cd_x, dtype=dt)
        st.cid[0] = torch.tensor(id_x, dtype=torch.int32)
        st.cdis[2] = torch.tensor(cd_y, dtype=dt)
        st.cid[2] = torch.tensor(id_y, dtype=torch.int32)
        pl = _clone7(st)
        f = torch.tensor([frac], dtype=dt, device=cuda)
        a = torch.tensor([im.SPLICE_ADD], dtype=dt, device=cuda)
        xy = insert_cuda.insert_step(
            st, torch.zeros((1,), dtype=torch.int32, device=cuda), f, a,
            middle=5, outside=2, label=2)
        assert xy.tolist() == [0, 2], name
        tk.splice(pl, 0, f[0], a[0], 2, 4)
        tk._update_closest_bfs_compact(pl, 2, 8)
        _same7(st, pl)


def test_closest_bfs_kernel_seeding_wide_backbone(cuda):
    """--add's seeding of a balanced 1,024-leaf backbone (levels wider
    than the kernel's block), leaf by leaf against the plain BFS."""
    from dipper_tpu_torch.io.newick import parse_newick
    from dipper_tpu_torch.placement import api as tapi
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import insert_model as im

    n = B = 1024
    tree = parse_newick(im.balanced_newick(B, np.random.default_rng(3)), n)
    e0, belong0, length0, rev0 = tapi.backbone_tree_to_arrays(tree, n)
    st = tk.prepare_kernels(tk.TreeState(
        e=torch.from_numpy(e0).to(cuda),
        belong=torch.from_numpy(belong0).to(cuda),
        length=torch.from_numpy(length0).to(cuda),
        rev=torch.from_numpy(rev0).to(cuda),
        cdis=torch.full((4 * n, tk.K), tk.SENT_DIS, dtype=torch.float64,
                        device=cuda),
        cid=torch.full((4 * n, tk.K), -1, dtype=torch.int32, device=cuda),
        idx=4 * B - 4,
        adj=tk.adjacency_from_edges(torch.from_numpy(belong0).to(cuda),
                                    2 * n)))
    pl = _clone7(st)
    for i in range(B):
        insert_cuda.closest_bfs(st, i)
        tk._update_closest_bfs_compact(pl, i, 2 * n)
        if i % 64 == 0 or i == B - 1:
            _same7(st, pl)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streamed_cluster_kernel_equals_plain_route(cuda, dtype, monkeypatch):
    """D&C's streamed cluster on the card (label, blocked slot 0, scoreable
    cleared from the kernel's output) against its plain route."""
    from dipper_tpu_torch.dc import cluster as tc

    rng = np.random.default_rng(4)
    cmax, W, rb = 60, 70, 16
    Dq = torch.from_numpy(rng.uniform(0.05, 0.6, (cmax, W)).astype(dtype)
                          ).to(cuda)
    cd = np.sort(rng.uniform(0, 0.3, (2, 5)), axis=-1).astype(dtype)
    cid = np.arange(10, dtype=np.int32).reshape(2, 5)
    cid[1, 3:], cd[1, 3:] = -1, 2.0
    lens = rng.uniform(0.01, 0.2, 2).astype(dtype)
    lens[1] = lens[0]
    init = tuple(torch.from_numpy(x).to(cuda) for x in (cd, cid, lens))
    got = tc.build_streamed(lambda s: Dq[s:s + rb], *init, cmax, cmax, rb)
    monkeypatch.setattr(tk, "uses_insert_kernel", lambda st: False)
    want = tc.build_streamed(lambda s: Dq[s:s + rb], *init, cmax, cmax, rb)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_insert_step_wrapper_rejects_bad_inputs(cuda):
    from dipper_tpu_torch.placement import insert_cuda

    D = torch.rand((20, 20), dtype=torch.float64, device=cuda)
    st = tk.init_placement_state((D,), num_sequences=20, frontend="matrix",
                                 dtype_name="float64")
    one = torch.zeros((1,), dtype=torch.int32, device=cuda)
    f = torch.zeros((1,), dtype=torch.float64, device=cuda)
    kw = dict(middle=25, outside=3, label=3)
    with pytest.raises(ValueError, match="frac must be one torch.float64"):
        insert_cuda.insert_step(st, one, f.float(), f, **kw)
    with pytest.raises(ValueError, match="eid must be one torch.int32"):
        insert_cuda.insert_step(st, one.cpu(), f, f, **kw)
    with pytest.raises(ValueError, match="must be nodes"):
        insert_cuda.insert_step(st, one, f, f, middle=40, outside=3, label=3)
    with pytest.raises(ValueError, match="blocked must be"):
        insert_cuda.closest_bfs(st, 0, blocked=one.long())
    st.cdis = st.cdis.float()
    with pytest.raises(ValueError, match="cdis must be torch.float64"):
        insert_cuda.closest_bfs(st, 0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_insert_step_kernel_overlapping_splice(cuda, dtype):
    """A choice whose writes overlap (insert_model.overlap_state): the
    warp's splice keeps the plain version's later write at each address."""
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import insert_model as im

    d, eid, frac, add, middle, outside = im.overlap_state(dtype)
    st = tk.tree_state_from_numpy(d, cuda)
    pl = _clone7(st)
    dt = getattr(torch, dtype)
    xy = insert_cuda.insert_step(
        st, torch.full((1,), eid, dtype=torch.int32, device=cuda),
        torch.tensor([frac], dtype=dt, device=cuda),
        torch.tensor([add], dtype=dt, device=cuda), middle=middle,
        outside=outside, label=outside)
    assert xy.tolist() == [eid, 15]
    tk.splice(pl, eid, torch.tensor(frac, dtype=dt, device=cuda),
              torch.tensor(add, dtype=dt, device=cuda), outside, 4,
              middle=middle, outside=outside)
    tk._update_closest_bfs_compact(pl, outside, 8)
    _same7(st, pl)


def _balanced_backbone(cuda, dtype, n=1280, B=1024):
    from dipper_tpu_torch.io.newick import parse_newick
    from dipper_tpu_torch.placement import api as tapi
    from dipper_tpu_torch.placement import insert_model as im

    tree = parse_newick(im.balanced_newick(B, np.random.default_rng(3)), n)
    e0, belong0, length0, rev0 = tapi.backbone_tree_to_arrays(tree, n)
    dt = getattr(torch, dtype)
    return tk.prepare_kernels(tk.TreeState(
        e=torch.from_numpy(e0).to(cuda),
        belong=torch.from_numpy(belong0).to(cuda),
        length=torch.from_numpy(length0).to(cuda, dt),
        rev=torch.from_numpy(rev0).to(cuda),
        cdis=torch.full((4 * n, tk.K), tk.SENT_DIS, dtype=dt, device=cuda),
        cid=torch.full((4 * n, tk.K), -1, dtype=torch.int32, device=cuda),
        idx=4 * B - 4,
        adj=tk.adjacency_from_edges(torch.from_numpy(belong0).to(cuda),
                                    2 * n)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_insert_step_kernel_spills_on_a_balanced_backbone(cuda, dtype):
    """Insertions onto a balanced 1,024-leaf backbone whose lists are
    empty: the first BFSs have levels of 512 nodes, beyond the kernel's
    shared frontier (they spill), after narrow levels; each insertion
    equals the plain version."""
    n, B = 1280, 1024
    st = _balanced_backbone(cuda, dtype, n, B)
    pl = _clone7(st)
    rows = torch.from_numpy(np.random.default_rng(25).uniform(
        0.05, 0.5, (12, n)).astype(dtype)).to(cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for j in range(rows.shape[0]):
        i = B + j
        tk.kernel_insertion_step(st, rows[j], i, n, stream)
        eid, x, y, ye, frac, add = tk._score_edges_plain(pl, rows[j])
        tk.splice(pl, eid, frac, add, i, n, (x, y, ye))
        tk._update_closest_bfs_compact(pl, i, 2 * n)
        _same7(st, pl)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_replayed_range_equals_direct_launches(cuda, dtype, monkeypatch):
    """One insert range by the cursor route (a cursor write, replays of a
    captured graph of 16 insertions, a remainder of 10 direct cursor
    launches) against the same range by direct launches, bit for bit;
    and --add's seeding by replays against direct BFS launches."""
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import insert_model as im

    monkeypatch.setattr(tk, "GRAPH_INSERTIONS", 16)
    n = 300
    D = torch.from_numpy(im.made_up_matrix("random", n, seed=7)
                         .astype(dtype)).to(cuda)
    st = tk.init_placement_state((D,), num_sequences=n, frontend="matrix",
                                 dtype_name=dtype)
    direct = _clone7(st)
    tk.prepare_kernels(direct)
    before = (insert_cuda.GRAPH_CAPTURES, insert_cuda.GRAPH_REPLAYS,
              insert_cuda.INSERT_STEP_LAUNCHES)
    tk._insert_range(st, 2, 300, D[2:], n)
    assert (insert_cuda.GRAPH_CAPTURES - before[0],
            insert_cuda.GRAPH_REPLAYS - before[1],
            insert_cuda.INSERT_STEP_LAUNCHES - before[2]) == (1, 18, 298)
    stream = torch.cuda.current_stream().cuda_stream
    for i in range(2, n):
        tk.kernel_insertion_step(direct, D[i], i, n, stream)
    assert st.idx == direct.idx
    _same7(st, direct)
    seeded = _balanced_backbone(cuda, dtype)
    direct = _clone7(seeded)
    tk.prepare_kernels(direct)
    tk._replay_seeding(seeded, 0, 1024)
    for leaf in range(1024):
        insert_cuda.closest_bfs(direct, leaf)
    _same7(seeded, direct)


def test_cursor_route_across_caps_equals_cpu(cuda, monkeypatch):
    """run_placement_chunked on the card in ranges of 50 with prefix caps
    from 64 (a graph captured again at each cap, replays and remainders)
    against the CPU's plain loop: the same arrays."""
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import insert_model as im

    monkeypatch.setattr(tk, "GRAPH_INSERTIONS", 16)
    monkeypatch.setattr(tk, "_CAP_MIN", 64)
    n = 300
    D = im.made_up_matrix("random", n, seed=8).astype("float64")
    kw = dict(num_sequences=n, frontend="matrix", dtype_name="float64",
              chunk=50)
    c0 = insert_cuda.GRAPH_CAPTURES
    got = tk.run_placement_chunked((torch.from_numpy(D).to(cuda),), **kw)
    assert insert_cuda.GRAPH_CAPTURES - c0 == 4  # caps 64, 128, 256, 300
    want = tk.run_placement_chunked((torch.from_numpy(D),), **kw)
    for f in ("e", "belong", "length", "rev", "cdis", "cid", "adj"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


# ---------------------------------------------------------------------------
# D&C phase 3's kernels (csrc/dc_stream_block.cu, csrc/dc_cluster_build.cu)
# against their plain versions
# ---------------------------------------------------------------------------

_PHASE3_CASES = ["random", "ties", "nan_row", "over_two"]


def _chunk_on(dev, case, C, cmax, dtype, seed):
    from dipper_tpu_torch.dc import cluster_model as cm

    Dq, cd, cid, lens, sizes = cm.made_up_chunk(case, C, cmax, dtype, seed)
    return (*(torch.from_numpy(x).to(dev) for x in (Dq, cd, cid, lens)),
            sizes)


def _bits_equal(x, y):
    if x.is_floating_point():
        bits = torch.int32 if x.dtype == torch.float32 else torch.int64
        x, y = x.view(bits), y.view(bits)
    return x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", _PHASE3_CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_masked_kernel_equals_plain(cuda, case, dtype):
    """Kernel 8a one member a launch, on a copy of a streamed cluster's
    state before each of its 64 members, against the plain route's member
    (_score_masked, the flags, the splice and the compact BFS): the choice
    (eid, frac, add), the whole state and the flags bit for bit."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_cuda

    cmax = 64
    Dq, cd, cid, lens, _ = _chunk_on(cuda, case, 2, cmax, dtype, 5)
    st, flags = tc.one_cluster(*tc.cluster_init_state(
        cd[1:], cid[1:], lens[1:], cmax, with_adj=True))
    order = tc._Order.of(cmax, cuda)
    before = cluster_cuda.STREAM_BLOCK_LAUNCHES
    for kq in range(cmax):
        kst, kfl = _clone7(st), flags.clone()
        out_i, out_f = cluster_cuda.stream_block(kst, kfl, Dq[1, kq:kq + 1],
                                                 kq, cmax)
        eid, frac, add = tc.stream_member_plain(st, flags, Dq[1, kq], kq,
                                                cmax, order)
        kst.idx = st.idx  # the plain splice advanced it
        assert int(out_i[0]) == eid, (case, kq)
        assert _bits_equal(out_f, torch.stack((frac, add))), (case, kq)
        _same7(kst, st)
        assert torch.equal(kfl, flags), (case, kq)
    assert cluster_cuda.STREAM_BLOCK_LAUNCHES - before == cmax


@pytest.mark.parametrize("case", _PHASE3_CASES)
@pytest.mark.parametrize("cmax, C, plan", [
    (8, 40, "warp"), (16, 33, "warp"), (32, 17, "warp"), (64, 9, "block"),
    (128, 5, "block"), (512, 3, "block"), (520, 2, "global")])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cluster_build_kernel_equals_plain(cuda, monkeypatch, case, cmax, C,
                                           plan, dtype):
    """Kernel 8b (one launch for the chunk by the bucket's plan, the one
    cluster_model.kernel_config chooses; ragged sizes) against
    build_clusters_plain on the card: the whole state and the flags bit for
    bit, the adjacency tables the ones the edges give; no host sync."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_cuda
    from dipper_tpu_torch.dc import cluster_model as cm

    want_plan = cm.kernel_config(cmax, np.dtype(dtype).itemsize)
    assert want_plan.kind == plan
    assert cluster_cuda.kernel_plan(cmax, getattr(torch, dtype)) == (
        want_plan.kind, want_plan.threads, want_plan.clusters,
        want_plan.smem)
    Dq, cd, cid, lens, sizes = _chunk_on(cuda, case, C, cmax, dtype, cmax)
    made = []
    orig = tc.cluster_init_state

    def keep(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    monkeypatch.setattr(tc, "cluster_init_state", keep)
    before = (cluster_cuda.CLUSTER_BUILD_LAUNCHES, tc.BFS_LEVELS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tc.build_clusters(Dq, cd, cid, lens, sizes, cmax)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (cluster_cuda.CLUSTER_BUILD_LAUNCHES - before[0],
            tc.BFS_LEVELS - before[1]) == (1, 0)
    want = tc.build_clusters_plain(Dq, cd, cid, lens, sizes, cmax)
    (kst, kfl), (pst, pfl) = made
    for a, b in zip(got, want):
        assert _bits_equal(a, b), case
    for f in ("e", "belong", "length", "rev", "cdis", "cid"):
        assert _bits_equal(getattr(kst, f), getattr(pst, f)), (case, f)
    assert torch.equal(kfl, pfl), case
    for c in range(C):
        assert torch.equal(kst.adj[c], tk.adjacency_from_edges(
            kst.belong[c], 2 + 2 * cmax)), (case, c)


@pytest.mark.parametrize("ctas", [1, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streamed_route_replays_graphs_across_a_ragged_block(cuda, dtype,
                                                             monkeypatch,
                                                             ctas):
    """A streamed cluster of 300 members in row blocks of 128 (the last 44)
    by kernel 8a on a cluster of `ctas` blocks: one launch a row block (3),
    no host sync; the state equals the plain route's on the card bit for
    bit."""
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_cuda

    monkeypatch.setattr(cluster_cuda, "STREAM_CTAS", ctas)
    cmax, rb = 300, 128
    Dq, cd, cid, lens, _ = _chunk_on(cuda, "random", 1, cmax, dtype, 11)
    made = []
    orig = tc.one_cluster

    def keep(*a):
        made.append(orig(*a))
        return made[-1]

    monkeypatch.setattr(tc, "one_cluster", keep)
    blocks = []

    def block_fn(s):
        blocks.append(s)
        return Dq[0, s:s + rb].clone()  # a new tensor a block

    before = cluster_cuda.STREAM_BLOCK_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tc.build_streamed(block_fn, cd[0], cid[0], lens[0], cmax,
                                cmax, rb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cluster_cuda.STREAM_BLOCK_LAUNCHES - before == 3
    assert blocks == [0, 128, 256]
    monkeypatch.setattr(tk, "uses_insert_kernel", lambda st: False)
    want = tc.build_streamed(block_fn, cd[0], cid[0], lens[0], cmax, cmax,
                             rb)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    (kst, kfl), (pst, pfl) = made
    _same7(kst, pst)
    assert torch.equal(kfl, pfl)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_insert_range_by_offsets_equals_plain_route(cuda, dtype,
                                                    monkeypatch):
    """Placement's _insert_range through insert_step's cursor entry with
    placement's offsets (replays and a remainder) against the plain route
    on the card: the same state, byte for byte."""
    from dipper_tpu_torch.placement import insert_model as im

    monkeypatch.setattr(tk, "GRAPH_INSERTIONS", 16)
    n = 300
    D = torch.from_numpy(im.made_up_matrix("some_nan", n, seed=3)
                         .astype(dtype)).to(cuda)
    st = tk.init_placement_state((D,), num_sequences=n, frontend="matrix",
                                 dtype_name=dtype)
    pl = _clone7(st)
    tk._insert_range(st, 2, n, D[2:], n)
    monkeypatch.setattr(tk, "uses_insert_kernel", lambda st: False)
    tk._insert_range(pl, 2, n, D[2:], n)
    _same7(st, pl)


def test_phase3_wrappers_reject_bad_inputs(cuda):
    from dipper_tpu_torch.dc import cluster as tc
    from dipper_tpu_torch.dc import cluster_cuda

    Dq, cd, cid, lens, sizes = _chunk_on(cuda, "random", 3, 8, "float32", 1)
    st, flags = tc.cluster_init_state(cd, cid, lens, 8, with_adj=True)
    s32 = torch.from_numpy(sizes.astype(np.int32)).to(cuda)
    with pytest.raises(ValueError, match="Dq must be"):
        cluster_cuda.build_chunk(st, flags, Dq.double(), s32, 8)
    with pytest.raises(ValueError, match="Dq must be"):
        cluster_cuda.build_chunk(st, flags, Dq[:, :7], s32, 8)
    with pytest.raises(ValueError, match="sizes must be"):
        cluster_cuda.build_chunk(st, flags, Dq, s32.long(), 8)
    with pytest.raises(ValueError, match="edge slots for bucket width"):
        cluster_cuda.build_chunk(st, flags, Dq, s32, 16)
    one, f1 = tc.one_cluster(*tc.cluster_init_state(
        cd[:1], cid[:1], lens[:1], 8, with_adj=True))
    with pytest.raises(ValueError, match="scoreable must be"):
        cluster_cuda.stream_block(one, f1.int(), Dq[0, :2], 0, 8)
    with pytest.raises(ValueError, match="rows must be"):
        cluster_cuda.stream_block(one, f1, Dq[0, :2, ::2], 0, 8)
    with pytest.raises(ValueError, match="members"):
        cluster_cuda.stream_block(one, f1, Dq[0, :2], 7, 8)
    with pytest.raises(ValueError, match="edge slots for bucket width"):
        cluster_cuda.stream_block(one, f1, Dq[0, :2], 0, 16)
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        cluster_cuda.stream_block(one, f1, Dq[0, :2], 0, 8, ctas=17)

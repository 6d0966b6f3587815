"""Kernel 12 (csrc/msa_cluster_dist.cu, D&C phase 3's per-cluster MSA
distances read by index from an aligned set's bit planes) and its pack on
the CPU: the plain versions (distance/msa.py::cluster_dist_by_index_plain,
pack_planes_plain) against the JAX package (_dc_pair_distances' aligned
branch at rtol 1e-12 in f64, 2e-6 in f32 and 2e-5 beside the poles in
f32, as tests/test_torch_msa.py, NaN and +-inf in the same places; the
planes bit for bit against one_hot_channels); the numpy model
(distance/msa_cluster_model.py): the pack, the b1 product's fragments
and the plan's tiles bit for bit against pair_counts, the distances bit
for bit against the plain version, the plan's constants against the
kernel's source; the wrappers' CPU routes; and phase 3's card route on
CPU tensors with the models in the kernels' place, whose Newick is
JAX's."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipper_tpu.dc import pipeline as jpl
from dipper_tpu.distance import msa as jmsa
from dipper_tpu.utils.params import Param as JaxParam
from dipper_tpu_torch.csrc import build as kernel_build
from dipper_tpu_torch.distance import msa as tmsa
from dipper_tpu_torch.distance import msa_cluster_model as mm
from dipper_tpu_torch.distance import msa_cuda
from dipper_tpu_torch.utils.params import Param

import dipper_tpu_torch.dc.pipeline as tpl

from datagen import simulate_alignment
from test_torch_msa import RTOL_NEAR_POLE_F32, _close, _codes, _hard_codes

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _bank(kind):
    """uint8 codes: "hard" tests/test_torch_msa.py's hard rows (L = 203:
    unrelated rows, an all-gap row, a duplicate) after 12 simulated ones;
    "sim" 40 simulated rows of L = 301 (8% gaps) and an all-gap row.
    Neither length is a multiple of 32."""
    if kind == "hard":
        return np.concatenate([_codes(12, 203, 21, 0.08), _hard_codes()])
    return np.concatenate([_codes(40, 301, 22, 0.08),
                           np.full((1, 301), 4, np.uint8)])


def _lists(n_rows, sizes, cmax, head, seed):
    """(wit [c, head + cmax], mem [c, cmax]) as phase 3 builds them: ragged
    member lists padded by repeating the last member, wit = [head, mem];
    cluster 0's members are the bank's last rows (the hard ones, or the
    all-gap row), and every cluster's first two head witnesses are the
    same rows (a backbone witness shared by many clusters)."""
    rng = np.random.default_rng(seed)
    c = len(sizes)
    mem = np.empty((c, cmax), np.int64)
    for i, s in enumerate(sizes):
        ids = (np.arange(n_rows - s, n_rows) if i == 0
               else rng.integers(0, n_rows, s))
        mem[i] = np.concatenate([ids, np.full(cmax - s, ids[-1])])
    heads = rng.integers(0, n_rows, (c, head))
    heads[:, :2] = heads[0, :2]
    return np.concatenate([heads, mem], axis=1), mem


def _chunk(kind, seed=3):
    """A chunk: "hard" W = 4 + 8; "sim" W = 5 + 16 (odd: a ragged
    n-tile)."""
    bank = _bank(kind)
    cmax, head = (8, 4) if kind == "hard" else (16, 5)
    wit, mem = _lists(len(bank), [cmax, 1, 5, cmax, 3], cmax, head, seed)
    return bank, wit, mem


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kind", ["hard", "sim"])
def test_plain_equals_jax(kind, dt, dtype):
    bank, wit, mem = _chunk(kind)
    jp = JaxParam(in_format="m", distance_type=dt, dtype=dtype)
    want = np.asarray(jpl._dc_pair_distances(
        "msa", jp, dtype, wit, mem, (bank, (bank < 4).sum(axis=1))))
    got = tmsa.cluster_dist_by_index_plain(
        bank, wit, mem.shape[1], distance_type=dt, dtype_name=dtype).numpy()
    assert got.shape == want.shape == mem.shape + (wit.shape[1],)
    if dt == 2:
        # JC's pole: where p = 1 - match / useful is 0.75 exactly (the
        # "sim" chunk pairs rows 10 and 35 so), the port divides p by 0.75
        # exactly (a tensor divisor, as PyTorch's CUDA division needs), so
        # log(1 - 1) gives +inf; XLA divides by a constant as a product by
        # its rounded reciprocal and gives a finite ~28 in f64 and NaN (the
        # log of a negative) in f32. That is an open difference from the
        # reference (ROADMAP.md, section 3, "JC at its pole"), not an
        # agreed behaviour: those pairs are held to each side's value as it
        # stands, so that a change on either side shows; the others as
        # every pair of every model.
        p = tmsa.cluster_dist_by_index_plain(
            bank, wit, mem.shape[1], distance_type=1,
            dtype_name=dtype).numpy()
        pole = p == 0.75
        assert np.isposinf(got[pole]).all()
        with np.errstate(invalid="ignore"):
            assert (np.isnan(want[pole]) if dtype == "float32"
                    else np.isfinite(want[pole]) & (want[pole] > 10)).all()
        got, want = got[~pole], want[~pole]
    rtol = RTOL_NEAR_POLE_F32 if (kind, dtype) == ("hard", "float32") \
        else None
    _close(got, want, dtype, rtol)
    if dt != 1:
        assert np.isnan(got).any() or np.isinf(got).any()


def _planes_from_jax(codes):
    """The planes and non-gap counts made from JAX's one_hot_channels: its
    four base channels, bit j of word t the column 32 t + j, zero past L
    up to whole k-steps."""
    phi = np.asarray(jmsa.one_hot_channels(jnp.asarray(codes)))
    R, _, L = phi.shape
    words = tmsa.plane_words(L)
    bits = np.zeros((R, 4, words * 32), np.uint8)
    bits[:, :, :L] = phi[:, :4]
    planes = np.packbits(bits, axis=2, bitorder="little").view(np.uint32)
    return planes, phi[:, 4].sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("gap_frac", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 31, 32, 255, 257, 1000])
def test_pack_equals_one_hot_channels(L, gap_frac):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 4, (9, L)).astype(np.uint8)
    codes[rng.random((9, L)) < gap_frac] = 4
    codes[rng.random((9, L)) < gap_frac / 3] = 15  # other gap codes
    codes[3] = 4
    want_p, want_ng = _planes_from_jax(codes)
    assert want_p.shape == (9, 4, -(-L // 256) * 8)
    got_p, got_ng = mm.pack(codes)
    assert got_p.dtype == np.uint32 and np.array_equal(got_p, want_p)
    assert np.array_equal(got_ng, want_ng)
    plain_p, plain_ng = tmsa.pack_planes_plain(torch.from_numpy(codes))
    assert plain_p.dtype == plain_ng.dtype == torch.int32
    assert np.array_equal(plain_p.numpy().view(np.uint32), want_p)
    assert np.array_equal(plain_ng.numpy(), want_ng)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mma_fragments_give_the_product(seed):
    """The lanes' registers, by the layout the kernel assumes (the one the
    card's m16n8k256 .b1 gave in scripts/mma_b1_probe_torch.py), round
    trip to the tiles, and the modelled instruction is popcount(A & B)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
    B = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    a, b = mm.a_fragment(A), mm.b_fragment(B)
    assert a.shape == (32, 4) and b.shape == (32, 2)
    bits_a = np.unpackbits(A.view(np.uint8), axis=1, bitorder="little")
    bits_b = np.unpackbits(B.view(np.uint8), axis=1, bitorder="little")
    want = bits_a.astype(np.int64) @ bits_b.astype(np.int64).T
    c0 = rng.integers(0, 100, (32, 4))
    d = mm.mma_b1(a, b, c0)
    assert np.array_equal(mm.c_scatter(d), want + mm.c_scatter(c0))
    # each lane holds distinct words: every register of A and B is a
    # different (row, word) of the tiles
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    cells = {(int(r), int(k)) for r, k in zip(
        np.concatenate([g, g + 8, g, g + 8]),
        np.concatenate([t, t, t + 4, t + 4]))}
    assert len(cells) == 128


# (Q, W) of D&C's 20K buckets (8, 16, 32) and plans that split the
# members (bm < m_tiles) and the witnesses (members staged apart)
PLAN_SHAPES = [(8, 18), (16, 26), (32, 42), (90, 96), (5, 93)]


@pytest.mark.parametrize("L", [203, 700])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_model_bins_equal_pair_counts(shape, L):
    """The plan's blocks, warps and k-steps of b1 products give
    pair_counts' bins for every pair, repeated rows included."""
    Q, W = shape
    codes = _codes(31, L, L + Q, 0.08)
    codes[5] = 4
    rng = np.random.default_rng(Q)
    wit = rng.integers(0, len(codes), (2, W))
    wit[:, :3] = 5   # a shared all-gap witness
    wit[1, W - Q // 2:] = wit[1, W - Q // 2 - 1]  # padded members
    planes, ng = mm.pack(codes)
    assert np.array_equal(ng, (codes < 4).sum(axis=1))
    bins = mm.cluster_bins(planes, wit, Q)
    phi = tmsa.one_hot_channels(torch.from_numpy(codes))
    for i in range(2):
        want = tmsa.pair_counts(phi[wit[i, W - Q:]], phi[wit[i]]).numpy()
        assert np.array_equal(mm.counts_from_bins(bins[i]), want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kind", ["hard", "sim"])
def test_model_equals_plain(kind, dt, dtype):
    """The model's bins on the packed planes, through the plain formulas,
    give the plain version's bits, NaN and +-inf included."""
    bank, wit, mem = _chunk(kind, seed=9)
    kw = dict(distance_type=dt, dtype_name=dtype)
    want = tmsa.cluster_dist_by_index_plain(bank, wit, mem.shape[1], **kw)
    planes, ng = mm.pack(bank)
    got = mm.cluster_dist_model(planes, ng, wit, mem.shape[1], **kw)
    iv = torch.int32 if dtype == "float32" else torch.int64
    assert got.dtype == want.dtype
    assert torch.equal(got.view(iv), want.view(iv))


def test_plan_constants_equal_kernel_source():
    assert kernel_build.KERNELS["msa_cluster_dist"] == "msa_cluster_dist.cu"
    with open(os.path.join(kernel_build.CSRC_DIR, "msa_cluster_dist.cu")) as f:
        code = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([\w *+]+);", code))
    assert int(consts["kStepWords"]) == mm.STEP_WORDS == tmsa.PLANE_STEP_WORDS
    assert int(consts["kStages"]) == mm.STAGES
    assert int(consts["kStageStride"]) == mm.STAGE_STRIDE
    assert int(consts["kMaxNTiles"]) == mm.MAX_NTILES
    assert int(consts["kMaxWarps"]) == mm.MAX_WARPS
    assert int(consts["kEpilogueNTiles"]) == mm.EPILOGUE_NTILES
    assert int(consts["kBinStride"]) == mm.BIN_STRIDE
    assert int(consts["kPackThreads"]) == mm.PACK_THREADS
    assert "m16n8k256.row.col.s32.b1.b1.s32.and.popc" in code
    assert "__popc(m[a] & w[b])" not in code
    # bucket 8 of the 20K set: a block a cluster, 2 warps, 18 rows once
    assert mm.plan(18, 8) == {
        "m_tiles": 2, "n_tiles": 9, "groups": 1, "ntg": 9, "bm": 2, "bg": 1,
        "mem_chunks": 1, "wit_chunks": 1, "separate": 0, "wit_slots": 18,
        "rows": 18, "warps": 2, "blocks_per_cluster": 1,
        "smem": 80 + 18 * 4 * 12 * 4 * 4}
    # bucket 226: 4 x 4 warps, members staged apart
    p = mm.plan(236, 226)
    assert (p["bm"], p["bg"], p["separate"], p["rows"],
            p["blocks_per_cluster"]) == (4, 4, 1, 96, 15 * 3)


@pytest.mark.parametrize("Q", [1, 3, 8, 16, 32, 64, 128, 226, 256, 512, 1023])
def test_plan_covers_every_pair(Q):
    """Every plan of D&C's buckets (W = Q + 10) and of the ragged shapes
    fits a block (16 warps, the card's 227 KB), and its blocks' warps
    cover each (member, witness) pair exactly once."""
    for W in (Q, Q + 1, Q + 10):
        p = mm.plan(W, Q)
        assert 1 <= p["warps"] <= mm.MAX_WARPS
        assert p["smem"] <= 227 * 1024
        assert p["ntg"] <= mm.MAX_NTILES and p["smem"] % 16 == 0
        seen = np.zeros((p["m_tiles"], p["n_tiles"]), np.int64)
        for mc in range(p["mem_chunks"]):
            for wc in range(p["wit_chunks"]):
                for w in range(p["warps"]):
                    mt = mc * p["bm"] + w // p["bg"]
                    grp = wc * p["bg"] + w % p["bg"]
                    if mt < p["m_tiles"] and grp < p["groups"]:
                        nt0 = grp * p["ntg"]
                        nt1 = min(p["n_tiles"], nt0 + p["ntg"])
                        assert nt1 - nt0 <= p["wit_slots"] // 2
                        seen[mt, nt0:nt1] += 1
        assert (seen == 1).all()


def test_wrappers_on_cpu_take_plain_route():
    bank, wit, mem = _chunk("hard")
    kw = dict(distance_type=5, dtype_name="float64")
    cb = tmsa.ClusterBank(bank)
    before = msa_cuda.CLUSTER_DIST_LAUNCHES
    assert not tmsa.packs_planes(CPU)
    assert not tmsa.uses_cluster_dist_kernel(cb)
    g0 = tmsa.GATHERED_BYTES
    got = tmsa.cluster_distances(cb, wit, 8, device=CPU, **kw)
    assert tmsa.GATHERED_BYTES - g0 == wit.size * bank.shape[1]
    want = tmsa.cluster_dist_by_index_plain(torch.from_numpy(bank),
                                            torch.from_numpy(wit), 8, **kw)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert msa_cuda.CLUSTER_DIST_LAUNCHES == before
    planes, ng = tmsa.pack_planes_plain(torch.from_numpy(bank))
    wit_t = torch.from_numpy(wit.astype(np.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        msa_cuda.cluster_dist(planes, ng, wit_t, 8, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        msa_cuda.pack(torch.from_numpy(bank), planes, ng)
    bad = wit.copy()
    bad[2, 3] = len(bank)
    with pytest.raises(ValueError, match="outside the bank"):
        msa_cuda.witness_lists(bad, len(bank), CPU)
    with pytest.raises(ValueError, match="outside the bank"):
        tmsa.cluster_dist_by_index_plain(bank, bad, 8, **kw)
    assert msa_cuda.PACK_LAUNCHES == 0
    empty = tmsa.cluster_distances(cb, wit[:0], 8, device=CPU, **kw)
    assert empty.shape == (0, 8, wit.shape[1])


def test_modules_import_without_nvcc(tmp_path):
    """The wrapper and the model import (and build nothing) where no CUDA
    toolkit is found."""
    env = dict(os.environ, PATH="/usr/bin:/bin",
               CUDA_HOME=str(tmp_path / "none"))
    code = ("import dipper_tpu_torch.distance.msa_cuda as w, "
            "dipper_tpu_torch.distance.msa_cluster_model, "
            "dipper_tpu_torch.csrc.build as b; "
            "assert w.CLUSTER_DIST_LAUNCHES == w.PACK_LAUNCHES == 0 "
            "and not b._loaded")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root)


def test_card_route_with_model_as_kernel_equals_jax(monkeypatch):
    """Phase 3's card route on CPU tensors: the set packed once (the
    pack's model in the pack's place), each batched chunk's witness lists
    checked and handed over, one call of the kernel's wrapper (here the
    model, on the planes by index) a chunk, no codes gathered on the host;
    the Newick is the JAX package's."""
    names, seqs = simulate_alignment(50, 800, np.random.default_rng(5),
                                     gap_frac=0.03, blen_scale=0.5)
    kw = dict(in_format="m", distance_type=4, dtype="float64",
              backbone_size=10, batch_size=10)
    want = jpl.build_dc_tree(seqs, names, JaxParam(**kw))
    calls, packs = [], []

    def pack_bank(codes, device, log=None):
        packs.append(codes.shape)
        planes, ng = mm.pack(codes)
        return torch.from_numpy(planes.view(np.int32)), torch.from_numpy(ng)

    def witness_lists(wit, n_rows, device):
        tmsa.check_lists(wit, n_rows)
        return torch.from_numpy(wit.astype(np.int32))

    def model(planes, nongap, wit, members, **k):
        calls.append((tuple(planes.shape), tuple(wit.shape), members))
        return mm.cluster_dist_model(planes, nongap, wit, members, **k)

    monkeypatch.setattr(tmsa, "packs_planes", lambda device: True)
    monkeypatch.setattr(tmsa, "uses_cluster_dist_kernel", lambda bank: True)
    monkeypatch.setattr(msa_cuda, "pack_bank", pack_bank)
    monkeypatch.setattr(msa_cuda, "witness_lists", witness_lists)
    monkeypatch.setattr(msa_cuda, "cluster_dist", model)
    logs = []
    got = tpl.build_dc_tree(seqs, names, Param(**kw), device=CPU,
                            log=logs.append)
    assert got == want
    text = "\n".join(logs)
    chunks = sum(int(k) for k in re.findall(
        r"path=batch members=\d+ launches=(\d+)", text))
    assert len(calls) == chunks > 0 and packs == [(50, 800)]
    assert all(p == (50, 4, 32) for p, _, _ in calls)
    gathered = re.findall(r"path=batch .* gathered_bytes=(\d+)", text)
    assert gathered and all(g == "0" for g in gathered)

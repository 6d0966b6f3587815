"""Kernel 12 (csrc/msa_cluster_dist.cu, D&C phase 3's per-cluster MSA
distances) on the CPU: its plain version (distance/msa.py::
cluster_block_distances_plain) against the JAX package's
_dc_pair_distances (rtol 1e-12 in f64, 2e-6 in f32 and 2e-5 beside the
poles in f32, as tests/test_torch_msa.py; NaN and +-inf in the same
places); its numpy model (distance/msa_cluster_model.py): the counts bit
for bit against pair_counts, the distances bit for bit against the plain
version, the plan's constants against the kernel's source; the wrapper's
CPU route; and phase 3's card route on CPU tensors with the model in the
kernel's place, whose Newick is JAX's."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dipper_tpu.dc import pipeline as jpl
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
# head witnesses of a cluster (phase 3's 2K; fewer keeps the cases small)
HEAD = 4


def _bank(kind):
    """uint8 codes: "hard" tests/test_torch_msa.py's hard rows (L = 203)
    after 12 simulated ones; "sim" 40 simulated rows of L = 301 (8% gaps).
    Neither length is a multiple of 32."""
    if kind == "hard":
        return np.concatenate([_codes(12, 203, 21, 0.08), _hard_codes()])
    return _codes(40, 301, 22, 0.08)


def _lists(n_rows, sizes, cmax, seed):
    """(wit [c, HEAD + cmax], mem [c, cmax]) as phase 3 builds them: ragged
    member lists padded by repeating the last member, wit = [head, mem];
    cluster 0's members are the bank's last rows (the hard ones)."""
    rng = np.random.default_rng(seed)
    c = len(sizes)
    mem = np.empty((c, cmax), np.int64)
    for i, s in enumerate(sizes):
        ids = (np.arange(n_rows - s, n_rows) if i == 0
               else rng.integers(0, n_rows, s))
        mem[i] = np.concatenate([ids, np.full(cmax - s, ids[-1])])
    head = rng.integers(0, n_rows, (c, HEAD))
    return np.concatenate([head, mem], axis=1), mem


def _chunk(kind, cmax=8, seed=3):
    bank = _bank(kind)
    wit, mem = _lists(len(bank), [cmax, 1, 5, cmax, 3][:5], cmax, seed)
    return bank, wit, mem


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kind", ["hard", "sim"])
def test_plain_equals_jax(kind, dt, dtype):
    bank, wit, mem = _chunk(kind, cmax=8 if kind == "hard" else 16)
    jp = JaxParam(in_format="m", distance_type=dt, dtype=dtype)
    want = np.asarray(jpl._dc_pair_distances(
        "msa", jp, dtype, wit, mem, (bank, (bank < 4).sum(axis=1))))
    got = tmsa.cluster_block_distances_plain(
        torch.from_numpy(bank[wit]), mem.shape[1], distance_type=dt,
        dtype_name=dtype).numpy()
    assert got.shape == want.shape == mem.shape + (wit.shape[1],)
    rtol = RTOL_NEAR_POLE_F32 if (kind, dtype) == ("hard", "float32") \
        else None
    _close(got, want, dtype, rtol)
    if kind == "hard" and dt != 1:
        assert np.isnan(got).any() or np.isinf(got).any()


@pytest.mark.parametrize("gap_frac", [0.0, 0.08])
@pytest.mark.parametrize("L", [203, 256, 301, 700])
def test_model_counts_equal_pair_counts(L, gap_frac):
    codes = _codes(23, L, L, gap_frac)
    words = mm.one_hot_words(codes)
    assert words.dtype == np.uint32
    assert words.shape == (23, 4, -(-L // 256) * 8)
    assert np.array_equal(mm.nongap_of(words), (codes < 4).sum(axis=1))
    bins = mm.pair_bins(words[17:], words)
    phi = tmsa.one_hot_channels(torch.from_numpy(codes))
    want = tmsa.pair_counts(phi[17:], phi).numpy()
    got = mm.counts_from_bins(bins)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kind", ["hard", "sim"])
def test_model_equals_plain(kind, dt, dtype):
    """The model's counts, through the plain formulas, give the plain
    version's bits, NaN and +-inf included."""
    bank, wit, mem = _chunk(kind, cmax=8 if kind == "hard" else 16, seed=9)
    codes = torch.from_numpy(bank[wit])
    kw = dict(distance_type=dt, dtype_name=dtype)
    want = tmsa.cluster_block_distances_plain(codes, mem.shape[1], **kw)
    got = mm.cluster_dist_model(codes, mem.shape[1], **kw)
    iv = torch.int32 if dtype == "float32" else torch.int64
    assert got.dtype == want.dtype
    assert torch.equal(got.view(iv), want.view(iv))


def test_plan_constants_equal_kernel_source():
    assert kernel_build.KERNELS["msa_cluster_dist"] == "msa_cluster_dist.cu"
    with open(os.path.join(kernel_build.CSRC_DIR, "msa_cluster_dist.cu")) as f:
        code = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([\w *+]+);", code))
    assert int(consts["kTileMembers"]) == mm.TILE_MEMBERS
    assert int(consts["kTileWitnesses"]) == mm.TILE_WITNESSES
    assert int(consts["kTileWords"]) == mm.TILE_WORDS
    assert consts["kThreads"] == "kTileMembers * 32"
    p = mm.plan(13, 138, 128, 10000)
    assert p == {"tiles_mem": 16, "tiles_wit": 5, "blocks": 13 * 16 * 5,
                 "threads": 256, "rounds": 40}


def test_wrapper_on_cpu_takes_plain_route():
    bank, wit, mem = _chunk("hard")
    codes = torch.from_numpy(bank[wit])
    kw = dict(distance_type=5, dtype_name="float64")
    before = msa_cuda.CLUSTER_DIST_LAUNCHES
    assert not tmsa.uses_cluster_dist_kernel(codes)
    got = tmsa.cluster_block_distances(codes, 8, **kw)
    want = tmsa.cluster_block_distances_plain(codes, 8, **kw)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert msa_cuda.CLUSTER_DIST_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        msa_cuda.cluster_dist(codes, 8, **kw)
    empty = tmsa.cluster_block_distances(codes[:0], 8, **kw)
    assert empty.shape == (0, 8, wit.shape[1])


def test_modules_import_without_nvcc(tmp_path):
    """The wrapper and the model import (and build nothing) where no CUDA
    toolkit is found."""
    env = dict(os.environ, PATH="/usr/bin:/bin",
               CUDA_HOME=str(tmp_path / "none"))
    code = ("import dipper_tpu_torch.distance.msa_cuda as w, "
            "dipper_tpu_torch.distance.msa_cluster_model, "
            "dipper_tpu_torch.csrc.build as b; "
            "assert w.CLUSTER_DIST_LAUNCHES == 0 and not b._loaded")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root)


def test_card_route_with_model_as_kernel_equals_jax(monkeypatch):
    """Phase 3's card route on CPU tensors: the witness lists' codes
    gathered once a chunk, one call of the kernel's wrapper (here the
    model) a batched chunk; the Newick is the JAX package's."""
    names, seqs = simulate_alignment(50, 800, np.random.default_rng(5),
                                     gap_frac=0.03, blen_scale=0.5)
    kw = dict(in_format="m", distance_type=4, dtype="float64",
              backbone_size=10, batch_size=10)
    want = jpl.build_dc_tree(seqs, names, JaxParam(**kw))
    calls = []

    def model(codes, members, **k):
        calls.append(tuple(codes.shape))
        return mm.cluster_dist_model(codes, members, **k)

    monkeypatch.setattr(tmsa, "uses_cluster_dist_kernel", lambda codes: True)
    monkeypatch.setattr(msa_cuda, "cluster_dist", model)
    logs = []
    got = tpl.build_dc_tree(seqs, names, Param(**kw), device=CPU,
                            log=logs.append)
    assert got == want
    chunks = sum(int(k) for k in re.findall(
        r"path=batch members=\d+ launches=(\d+)", "\n".join(logs)))
    assert len(calls) == chunks > 0
    assert all(L == 800 for _, _, L in calls)

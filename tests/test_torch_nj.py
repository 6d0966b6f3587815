"""Conventional NJ: the PyTorch port (dipper_tpu_torch.nj) vs the JAX
package (dipper_tpu.nj.neighbor_joining_device) on the CPU.

The same matrices (numpy, from seeds) go through both. Required: the same
join sequence (the child ids of every join); in f64, leaf-to-leaf path
lengths equal to rtol 1e-9 (the two engines round their row sums in
different orders above 128 active nodes); in f32, nRF = 0 and path
lengths to rtol 1e-5 (f32 drift over a few hundred joins). Sizes 130 and
300 cross the JAX engine's bucket halvings, where both recompute U.
"""

import collections

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dipper_tpu.distance.mash import mash_distance_matrix_device
from dipper_tpu.nj import neighbor_joining_device
from dipper_tpu.nj import nj_tree_newick as jax_newick
from dipper_tpu.sketch.minhash import sketch_sequences
from dipper_tpu_torch.nj import engine, neighbor_joining, nj_tree_newick
from dipper_tpu_torch.utils.treecmp import rf_distance

from datagen import simulate_unaligned
from test_nj import random_additive_matrix

torch.set_num_threads(2)

RTOL = {"float64": 1e-9, "float32": 1e-5}


def _joins(children):
    return [[c for c, _ in ch] for ch in children]


def _path_lengths(children, root, n):
    """[n, n] leaf-to-leaf path lengths of an NJ join tree."""
    adj = collections.defaultdict(list)
    for v, ch in enumerate(children):
        for c, bl in ch:
            adj[v].append((c, bl))
            adj[c].append((v, bl))
    out = np.zeros((n, n))
    for s in range(n):
        dist = {s: 0.0}
        todo = [s]
        while todo:
            u = todo.pop()
            for v, bl in adj[u]:
                if v not in dist:
                    dist[v] = dist[u] + bl
                    todo.append(v)
        out[s] = [dist[t] for t in range(n)]
    return out


def _check_same(D, dtype):
    n = D.shape[0]
    cj, rj = neighbor_joining_device(D, dtype=dtype)
    cp, rp = neighbor_joining(D, dtype_name=dtype, device="cpu")
    assert rp == rj
    assert _joins(cp) == _joins(cj)
    np.testing.assert_allclose(_path_lengths(cp, rp, n),
                               _path_lengths(cj, rj, n), rtol=RTOL[dtype],
                               atol=0)
    if dtype == "float32":
        names = [f"T{i}" for i in range(n)]
        assert rf_distance(nj_tree_newick(cp, rp, names),
                           jax_newick(cj, rj, names))[0] == 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [2, 3, 5, 16, 130, 300])
def test_matches_jax_additive(n, dtype):
    _check_same(random_additive_matrix(n, np.random.default_rng(n)), dtype)


@pytest.fixture(scope="module")
def mash_matrices():
    """The JAX package's device mash matrix of 200 simulated taxa, in f64
    and f32 (many equal distances: the table has s+1 values)."""
    _, seqs = simulate_unaligned(200, 1500, np.random.default_rng(5))
    sk = np.asarray(sketch_sequences(seqs, 12, 150))
    return {dt: np.asarray(mash_distance_matrix_device(sk, 12, 150, dtype=dt))
            for dt in ("float64", "float32")}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matches_jax_mash(mash_matrices, dtype):
    _check_same(mash_matrices[dtype], dtype)


def test_newick_matches_jax():
    D = random_additive_matrix(40, np.random.default_rng(3))
    names = [f"L{i}" for i in range(40)]
    cj, rj = neighbor_joining_device(D, dtype="float64")
    cp, rp = neighbor_joining(D, dtype_name="float64", device="cpu")
    assert nj_tree_newick(cp, rp, names) == jax_newick(cj, rj, names)


def test_fewer_than_two_taxa_raise():
    with pytest.raises(ValueError, match="at least 2 taxa"):
        neighbor_joining(np.zeros((1, 1)), device="cpu")


def test_input_matrix_is_not_modified():
    D = torch.from_numpy(random_additive_matrix(20, np.random.default_rng(4)))
    before = D.clone()
    neighbor_joining(D, dtype_name="float64", device="cpu")
    assert torch.equal(D, before)


def test_default_device_is_the_card(monkeypatch):
    """Called without a device, NJ asks for the card: on a machine
    without CUDA it raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    D = random_additive_matrix(6, np.random.default_rng(5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        neighbor_joining(D)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        neighbor_joining(D[:2, :2])


def _jax_recompute_points(N):
    """Active counts at which dipper_tpu/nj/engine.py's bucket loop
    recomputes U (its _shrink calls), from its own schedule."""
    S = max(128, int(2 ** np.ceil(np.log2(N))))
    done, n_val, points = 0, N, []
    while done < N - 2:
        if S > 128 and n_val <= S // 2:
            S = max(128, S // 2)
            points.append(n_val)
        iters = N - 2 - done if S == 128 else min(N - 2 - done,
                                                  n_val - S // 2)
        done += iters
        n_val -= iters
    return points


@pytest.mark.parametrize("N", [3, 100, 128, 129, 130, 255, 256, 257, 300,
                               1000, 1024, 5000])
def test_u_recompute_points_match_jax_buckets(N):
    assert [n for n in range(N, 2, -1)
            if engine._recomputes_u(n, N)] == _jax_recompute_points(N)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("L", [3, 32, 77, 128])
def test_small_sums_match_xla_bitwise(L, dtype):
    """At most 128 elements, sums give the bits of the JAX engine's sums
    over its 128-wide last bucket (zeros past the active nodes): the last
    steps' structural Q ties (4 active nodes) then break as they do
    there."""
    rng = np.random.default_rng(L)
    x = (rng.random((16, L)) * np.exp(rng.normal(0, 3, (16, L)))).astype(dtype)
    bucket = np.zeros((16, 128), dtype)
    bucket[:, :L] = x
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(bucket))
    got = engine._sum_last(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)

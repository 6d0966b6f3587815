"""Conventional NJ: the PyTorch port (dipper_tpu_torch.nj) vs the JAX
package (dipper_tpu.nj.neighbor_joining_device) on the CPU.

The same matrices (numpy, from seeds) go through both. Required: the same
join sequence (the child ids of every join); in f64, leaf-to-leaf path
lengths equal to rtol 1e-9 (the two engines round their row sums in
different orders above 128 active nodes); in f32, nRF = 0 and path
lengths to rtol 1e-5 (f32 drift over a few hundred joins). Sizes 130 and
300 cross the JAX engine's bucket halvings, where both recompute U.

The card's merge step is two kernels (csrc/nj_q_argmin.cu,
csrc/nj_update.cu); their numpy model (nj/step_model.py) is held to the
plain step here, alone and in the kernels' place over whole runs.
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
from dipper_tpu_torch.nj import step_model
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


# --- the merge-step kernels' model (nj/step_model.py) against the plain
# version: csrc/nj_q_argmin.cu's tiles and two-stage first minimum, and
# csrc/nj_update.cu's read-then-write columns and last block

def _q_plain(D, U, r0, r1):
    """(flat, value) of the plain Q pass and argmin over rows [r0, r1):
    _sharded_argmin's pair, (inf, 2^62) for no rows."""
    n = D.shape[0]
    if r1 == r0:
        return step_model.NO_ROWS, float("inf")
    Dt, Ut = torch.from_numpy(D), torch.from_numpy(U)
    Un = Ut / torch.tensor(float(n - 2), dtype=Dt.dtype)
    qbuf = torch.empty(n * n, dtype=Dt.dtype)
    Q = engine._q_rows(Dt, Un, qbuf, torch.finfo(Dt.dtype).max, r0, r1)
    li = int(torch.argmin(Q))
    return li + r0 * n, float(Q.view(-1)[li])


def _q_case(name, n, dtype, rng):
    """A matrix D and row sums U whose Q holds the case's adversarial
    values. With U = 0, Q = (D - 0) - 0 is D off the diagonal, value for
    value (-0.0 included)."""
    A = rng.random((n, n))
    D = (A + A.T).astype(dtype)
    np.fill_diagonal(D, 0)
    if name == "random":
        return D, D.sum(axis=1).astype(dtype)
    U = np.zeros(n, dtype)
    if name == "nan_first":
        D[0, 1] = np.nan
        D[n - 1, 0] = np.nan
    elif name == "nan_later":
        D[n - 2, n - 1] = np.nan
        D[n - 1, n - 3] = np.nan
    elif name == "signed_zeros":
        D[n - 1, 1] = -0.0      # later, -0.0
        D[1, n - 1] = 0.0       # earlier, +0.0: the first minimum
        D[n // 2, 0] = -0.0
    elif name == "ties_across_blocks":
        # the same least value in every row at a spread of columns
        for i in range(n):
            D[i, (7 * i + 3) % n if (7 * i + 3) % n != i else (i + 1) % n] \
                = -1.0
    elif name == "inf_big_wins":
        # every off-diagonal Q is +inf: the diagonal's largest finite
        # value is the first minimum
        D[:] = np.inf
    return D, U


Q_CASES = ["random", "nan_first", "nan_later", "signed_zeros",
           "ties_across_blocks", "inf_big_wins"]


@pytest.mark.parametrize("threads", [1, 7, 32, 256])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", Q_CASES)
def test_q_argmin_model_equals_plain(case, dtype, threads):
    """The kernel's two-stage first minimum (thread, block and partial
    candidates) is the plain Q pass's torch.argmin, value and flat index,
    over row ranges, with tiles of one row (many block borders) and of
    the kernel's size."""
    rng = np.random.default_rng(Q_CASES.index(case))
    for n in (3, 5, 37):
        D, U = _q_case(case, n, dtype, rng)
        for r0, r1 in ((0, n), (1, n), (0, n - 1), (n // 2, n // 2 + 1),
                       (2, 2)):
            want = _q_plain(D, U, r0, r1)
            for mte in (1, step_model.MIN_TILE_ELEMS):
                got = step_model.q_argmin(D, U, n, r0, r1, threads=threads,
                                          min_tile_elems=mte)
                assert got[0] == want[0], (n, r0, r1, mte, got, want)
                assert (np.isnan(got[1]) and np.isnan(want[1])
                        or got[1] == want[1]), (n, r0, r1, got, want)
                assert np.signbit(got[1]) == np.signbit(want[1])


def test_q_plan_covers_rows_within_the_partials():
    for n in (3, 1000, 1025, 4099, 20000, 100000):
        for rows in (0, 1, n // 3, n):
            ct, rt, tr = step_model.q_plan(n, rows)
            assert ct * rt <= step_model.MAX_PARTIALS
            assert rows == 0 or (rt - 1) * tr < rows <= rt * tr


def _update_matrix(N, dtype, rng, grid):
    A = rng.random((N, N)) * np.exp(rng.normal(0, 1, (N, N)))
    D = (A + A.T).astype(dtype)
    np.fill_diagonal(D, 0)
    if grid:  # multiples of 2^-16: f64 sums exact in any order
        D = np.round(D * 2.0**16) / 2.0**16
    return D


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [3, 4, 5, 127, 128, 129, 300])
def test_update_model_equals_plain_step(n, dtype):
    """The kernel's update (each column read, then written, by its own
    thread, the blocks in reverse; the last block's columns x and y, sum,
    join and log) is one plain step bit for bit: D, U, real and the log
    row, on the active prefix of a larger matrix. x = 0 and y = last are
    among the pairs, and the pair of the step's own first minimum. In
    f64 above 128 active nodes the kernel sums U[x] in its own order, so
    there the values lie on a grid on which every order is exact."""
    rng = np.random.default_rng(n)
    N, step = n + 3, 3
    D = _update_matrix(N, dtype, rng, grid=dtype == "float64" and n > 128)
    cpu = torch.device("cpu")
    st = engine._State(D, dtype, cpu, None)
    Un = st.U[:n] / st.denom[n]
    first = int(engine._argmin_plain(st.D[:n, :n], Un, st.q_buffer(),
                                     st.big))
    flats = {n - 1, (n - 1) * n, n + n - 1, first,
             int(rng.integers(0, n)) * n + int(rng.integers(0, n))}
    for flat in sorted(f for f in flats if f // n != f % n):
        want = engine._State(D, dtype, cpu, None)
        engine._update_plain(want, step, torch.tensor([flat]))
        for threads in (256, 32):
            got = engine._State(D, dtype, cpu, None)
            blocks = -(-n // threads)
            ids, bls = step_model.update(
                got.D.numpy(), got.U.numpy(), got.real.numpy(), flat, n,
                N + step, threads=threads, order=range(blocks - 1, -1, -1))
            assert torch.equal(got.D, want.D), flat
            assert torch.equal(got.U, want.U), flat
            assert torch.equal(got.real, want.real), flat
            assert list(ids) == want.log_ids[step].tolist()
            assert torch.equal(torch.tensor(bls, dtype=want.log_bl.dtype),
                               want.log_bl[step])


class _OneRankMesh:
    """A mesh of one rank on the CPU: the sharded route's code with the
    whole matrix as the rank's share."""
    size, rank, backend = 1, 0, "gloo"
    device = torch.device("cpu")

    def share(self, n):
        return 0, n

    def all_gather(self, t):
        return t[None]


@pytest.fixture
def model_as_kernels(monkeypatch):
    """The kernels' route on CPU tensors, with step_model in the kernels'
    place: the steppers made, for their launch counts."""
    made = []

    def stepper(st):
        made.append(step_model.ModelStepper(st.D, st.U, st.real, st.log_ids,
                                            st.log_bl, threads=32))
        return made[-1]

    monkeypatch.setattr(engine, "_on_card", lambda D: True)
    monkeypatch.setattr(engine, "_stepper", stepper)
    return made


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_route_equals_plain_route(model_as_kernels, dtype, sharded):
    """The card's loop (kernel A, then kernel B reading its index; U
    recomputed at 128) driven by the model, against merge_step_plain over
    the whole NJ: f32 join ids and branch-length bytes equal; f64 ids
    equal and lengths within 1e-12 relative (U[x]'s f64 sum order)."""
    D = random_additive_matrix(140, np.random.default_rng(8))
    mesh = _OneRankMesh() if sharded else None
    want = engine.neighbor_joining_plain(D, dtype_name=dtype, mesh=mesh)
    got = engine.neighbor_joining(D, dtype_name=dtype, device="cpu",
                                  mesh=mesh)
    (k,) = model_as_kernels
    assert k.q_launches == k.update_launches == 138
    assert got[1] == want[1] and _joins(got[0]) == _joins(want[0])
    gl = np.array([bl for ch in got[0] for _, bl in ch])
    wl = np.array([bl for ch in want[0] for _, bl in ch])
    if dtype == "float32":
        assert np.array_equal(gl, wl)
    else:
        np.testing.assert_allclose(gl, wl, rtol=1e-12, atol=0)


def test_kernel_route_matches_jax(model_as_kernels):
    """The kernel route's schedule gives the JAX package's join sequence."""
    _check_same(random_additive_matrix(130, np.random.default_rng(130)),
                "float32")
    assert model_as_kernels


def test_stepper_rejects_cpu_tensors():
    from dipper_tpu_torch.nj import nj_cuda

    st = engine._State(random_additive_matrix(6, np.random.default_rng(6)),
                       "float32", torch.device("cpu"), None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nj_cuda.Stepper(st.D, st.U, st.real, st.log_ids, st.log_bl)

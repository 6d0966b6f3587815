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
# version: csrc/nj_q_argmin.cu's tiles, persistent grid and two-stage first
# minimum in both modes, and csrc/nj_update.cu's read-then-write columns
# and last block

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
# the kernel's grid on one H100 (132 SMs x 4 blocks), and smaller ones
GRIDS = (1, 3, 132, step_model.RESIDENT)


def _same_first(got, want, *ctx):
    assert got[0] == want[0], (ctx, got, want)
    assert (np.isnan(got[1]) and np.isnan(want[1])
            or got[1] == want[1]), (ctx, got, want)
    assert np.signbit(got[1]) == np.signbit(want[1]), (ctx, got, want)


@pytest.mark.parametrize("threads", [1, 7, 32, 256])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", Q_CASES)
def test_q_argmin_model_equals_plain(case, dtype, threads):
    """The kernel's full read (each thread's first minimum a tile, the
    tiles' merge, the block and partial candidates) is the plain Q pass's
    torch.argmin, value and flat index, over row ranges, with tiles of one
    row (many block borders) and of the kernel's size, on grids of one
    block to the card's."""
    rng = np.random.default_rng(Q_CASES.index(case))
    for n in (3, 5, 37):
        D, U = _q_case(case, n, dtype, rng)
        for r0, r1 in ((0, n), (1, n), (0, n - 1), (n // 2, n // 2 + 1),
                       (2, 2)):
            want = _q_plain(D, U, r0, r1)
            for tile_rows in (1, None):
                for grid in GRIDS:
                    got = step_model.q_argmin(D, U, n, r0, r1,
                                              threads=threads, grid=grid,
                                              tile_rows=tile_rows)
                    _same_first(got, want, n, r0, r1, tile_rows, grid)


def _rounding_tie(n, dtype, rng):
    """A symmetric D and U in which Q[1, 0] (a mirrored candidate) and
    Q[0, k] (an upper one, earlier in flat order) tie at the least value,
    while Q[0, 1], the same element's other rounding, is larger: a half
    read that took one rounding for both would pick another index."""
    dt = np.dtype(dtype).type
    A = rng.random((n, n)) + 10
    D = (A + A.T).astype(dtype)
    np.fill_diagonal(D, 0)
    U = (rng.random(n) * 3).astype(dtype)
    un = (U / dt(n - 2)).astype(dtype)
    for _ in range(100000):
        v = dt(rng.random())
        q_up, q_mi = (v - un[0]) - un[1], (v - un[1]) - un[0]
        if q_mi < q_up:
            break
        U[:2] = (rng.random(2) * 3).astype(dtype)
        un = (U / dt(n - 2)).astype(dtype)
    else:
        raise AssertionError("no pair of roundings found")
    D[0, 1] = D[1, 0] = v
    k = n - 1
    for _ in range(1000):
        w = (q_mi + un[0]) + un[k]
        for _ in range(64):
            if (w - un[0]) - un[k] == q_mi:
                break
            w = np.nextafter(w, dt(np.inf) if (w - un[0]) - un[k] < q_mi
                             else dt(-np.inf))
        if ((w - un[0]) - un[k] == q_mi and (w - un[k]) - un[0] >= q_mi):
            D[0, k] = D[k, 0] = w
            return D, U, k
        U[k] = dt(rng.random() * 3)
        un[k] = U[k] / dt(n - 2)
    raise AssertionError("no tying upper candidate found")


HALF_CASES = ["random", "nan_mirrored", "signed_zeros", "rounding_tie",
              "ties_across_tiles", "inf_big_wins"]


def _half_case(name, n, dtype, rng):
    """A symmetric D (bit for bit) and U for the half read."""
    if name == "rounding_tie":
        D, U, k = _rounding_tie(n, dtype, rng)
        return D, U
    A = rng.random((n, n))
    D = (A + A.T).astype(dtype)
    np.fill_diagonal(D, 0)
    if name == "random":
        return D, D.sum(axis=1).astype(dtype)
    U = np.zeros(n, dtype)
    if name == "nan_mirrored":
        D[n - 2, n - 1] = D[n - 1, n - 2] = np.nan
        D[n // 2, 0] = D[0, n // 2] = np.nan
    elif name == "signed_zeros":
        D[n - 1, 1] = D[1, n - 1] = 0.0
        D[n // 2, 0] = D[0, n // 2] = -0.0    # earlier: the first minimum
    elif name == "ties_across_tiles":
        for i in range(n):
            j = (7 * i + 3) % n
            if j != i:
                D[i, j] = D[j, i] = -1.0
    elif name == "inf_big_wins":
        D[:] = np.inf
    assert np.array_equal(D.view(f"i{D.itemsize}"), D.T.view(f"i{D.itemsize}"))
    return D, U


@pytest.mark.parametrize("threads", [1, 7, 32, 256])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", HALF_CASES)
def test_q_argmin_half_model_equals_plain(case, dtype, threads):
    """The kernel's half read (one triangle of a symmetric D, two
    candidates an element with Q's two roundings kept apart, the upper
    and the mirrored running minima merged at each tile's end) is the
    plain full Q pass's torch.argmin, value and flat index, bit for bit:
    at n from 3 to 300, with tiles of one row and of the kernel's size,
    on grids of one block to the card's."""
    rng = np.random.default_rng(HALF_CASES.index(case))
    for n in (3, 4, 5, 37, 129, 300):
        if case == "rounding_tie" and n < 4:
            continue
        D, U = _half_case(case, n, dtype, rng)
        want = _q_plain(D, U, 0, n)
        for tile_rows in (1, None):
            for grid in GRIDS:
                got = step_model.q_argmin(D, U, n, 0, n, half=True,
                                          threads=threads, grid=grid,
                                          tile_rows=tile_rows)
                _same_first(got, want, n, tile_rows, grid)


def test_rounding_tie_needs_both_roundings():
    """The rounding_tie case's first minimum is a mirrored candidate's
    tie with an upper one, so a half read that mirrored the upper
    rounding would miss it."""
    for dtype in ("float32", "float64"):
        D, U, k = _rounding_tie(37, dtype, np.random.default_rng(1))
        flat, v = _q_plain(D, U, 0, 37)
        assert flat == k and v == _q_plain(D, U, 1, 2)[1]


def test_q_plan_covers_rows_within_the_partials():
    """The kernel's plan: tiles of 32 lanes x one 16-byte load of columns
    and as many rows (fewer, down to an eighth, where that leaves fewer
    tiles than resident blocks), a grid within the partials and the
    tiles; the half read's tiles band by band, whose starts are
    nj_q_argmin.cu::band_start; every element of the scanned rows (the
    half read: of the upper triangle and the diagonal) in exactly one
    tile."""
    for itemsize in (4, 8):
        for n in (3, 1000, 1025, 2048, 4099, 20000, 100000):
            for rows, half in ((0, False), (1, False), (n // 3, False),
                               (n, False), (n, True)):
                p = step_model.q_plan(n, rows, half, itemsize)
                tc = 32 * 16 // itemsize
                assert p["tile_cols"] == tc
                assert p["tile_rows"] == tc >> p["shift"]
                assert (p["tiles"] >= step_model.RESIDENT
                        or p["shift"] == step_model.MAX_SHIFT)
                if p["shift"]:
                    fewer = step_model.q_plan(n, rows, half, itemsize,
                                              tile_rows=tc >> p["shift"] - 1)
                    assert fewer["tiles"] < step_model.RESIDENT
                assert 1 <= p["grid"] <= min(step_model.MAX_PARTIALS,
                                             max(1, p["tiles"]))
                tr = p["tile_rows"]
                assert (p["bands"] - 1) * tr < max(rows, 1) <= p["bands"] * tr \
                    or rows == 0
                if half:
                    assert all(p["starts"][b] == step_model.band_start(
                        b, p["chunks"], p["shift"])
                        for b in range(p["bands"] + 1))
                else:
                    assert p["tiles"] == p["bands"] * p["chunks"]
    for n in (3, 37, 300):
        for itemsize, lanes, tile_rows in ((4, 32, None), (8, 7, 1),
                                           (4, 1, None), (8, 32, 1)):
            for half, r0, r1 in ((True, 0, n), (False, 1, n - 1)):
                p = step_model.q_plan(n, r1 - r0, half, itemsize,
                                      lanes=lanes, tile_rows=tile_rows)
                seen = np.zeros((n, n), int)
                for t in range(p["tiles"]):
                    band, chunk = step_model.locate(t, p)
                    i0 = r0 + band * p["tile_rows"]
                    c0 = chunk * p["tile_cols"]
                    seen[i0:min(r1, i0 + p["tile_rows"]),
                         c0:c0 + p["tile_cols"]] += 1
                want = np.zeros((n, n), int)
                want[r0:r1] = 1
                if half:
                    want = np.triu(want)
                    seen = np.triu(seen)
                assert np.array_equal(seen, want), (n, itemsize, lanes, half)


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
    place: the steppers made, for their launch counts (the mode is
    engine._read_mode's)."""
    made = []

    def stepper(st, half):
        made.append(step_model.ModelStepper(st.D, st.U, st.real, st.log_ids,
                                            st.log_bl, half=half, threads=32))
        return made[-1]

    monkeypatch.setattr(engine, "_on_card", lambda D: True)
    monkeypatch.setattr(engine, "_stepper", stepper)
    return made


def _same_route(got, want, dtype):
    """f32 join ids and branch-length bytes equal; f64 ids equal and
    lengths within 1e-12 relative (U[x]'s f64 sum order)."""
    assert got[1] == want[1] and _joins(got[0]) == _joins(want[0])
    gl = np.array([bl for ch in got[0] for _, bl in ch])
    wl = np.array([bl for ch in want[0] for _, bl in ch])
    if dtype == "float32":
        assert np.array_equal(gl, wl)
    else:
        np.testing.assert_allclose(gl, wl, rtol=1e-12, atol=0)


def _symmetric(D):
    """D's lower triangle mirrored: symmetric bit for bit (the generator's
    matrices sum each row's paths in its own order, so D[i, j] and D[j, i]
    may differ in the last place)."""
    return np.tril(D) + np.tril(D, -1).T


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_route_equals_plain_route(model_as_kernels, dtype, sharded):
    """The card's loop (kernel A, then kernel B reading its index; U
    recomputed at 128) driven by the model, against merge_step_plain over
    the whole NJ: f32 join ids and branch-length bytes equal; f64 ids
    equal and lengths within 1e-12 relative (U[x]'s f64 sum order). The
    generator's matrix is not symmetric bit for bit in f64 (each row sums
    its paths in its own order), so f64 takes the full read, f32 the half
    read where the cast makes it symmetric, the sharded route the full
    read."""
    D = random_additive_matrix(140, np.random.default_rng(8))
    mesh = _OneRankMesh() if sharded else None
    want = engine.neighbor_joining_plain(D, dtype_name=dtype, mesh=mesh)
    got = engine.neighbor_joining(D, dtype_name=dtype, device="cpu",
                                  mesh=mesh)
    (k,) = model_as_kernels
    assert k.q_launches == k.update_launches == 138
    Dt = _bits(D.astype(dtype))
    symmetric = np.array_equal(Dt, Dt.T)
    assert symmetric == (dtype == "float32")
    assert k.half_launches == (138 if symmetric and not sharded else 0)
    _same_route(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_route_half_read_equals_plain_route(model_as_kernels, dtype):
    """The same over a matrix that is symmetric bit for bit: the half read
    every step, the plain route's tree (f32 bytes, f64 1e-12), and the
    JAX package's join sequence."""
    D = _symmetric(random_additive_matrix(140, np.random.default_rng(8)))
    want = engine.neighbor_joining_plain(D, dtype_name=dtype)
    got = engine.neighbor_joining(D, dtype_name=dtype, device="cpu")
    (k,) = model_as_kernels
    assert k.q_launches == k.half_launches == k.update_launches == 138
    _same_route(got, want, dtype)
    _check_same(D, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_route_full_read_on_an_asymmetric_matrix(model_as_kernels,
                                                        dtype):
    """A matrix that is not symmetric takes the full read over the whole
    run, the log names the first asymmetric place, and the run is the
    plain route's."""
    D = _symmetric(random_additive_matrix(140, np.random.default_rng(9)))
    D[3, 70] = np.nextafter(np.float32(D[3, 70]), np.float32(np.inf))
    lines = []
    want = engine.neighbor_joining_plain(D, dtype_name=dtype)
    got = engine.neighbor_joining(D, dtype_name=dtype, device="cpu",
                                  log=lines.append)
    (k,) = model_as_kernels
    assert k.q_launches == 138 and k.half_launches == 0
    assert any("full read" in ln and "D[3, 70] != D[70, 3]" in ln
               for ln in lines), lines
    _same_route(got, want, dtype)


@pytest.mark.parametrize("matrix,dtype,half", [
    ("symmetric", "float32", True), ("raw", "float64", False)])
def test_kernel_route_matches_jax(model_as_kernels, matrix, dtype, half):
    """The kernel route's schedule gives the JAX package's join sequence
    in both of kernel A's reads: the half read on a matrix symmetric bit
    for bit, the full read on the generator's own matrix in f64 (not
    symmetric in the last place)."""
    D = random_additive_matrix(130, np.random.default_rng(130))
    _check_same(_symmetric(D) if matrix == "symmetric" else D, dtype)
    (k,) = model_as_kernels
    assert k.q_launches == 128
    assert k.half_launches == (128 if half else 0)


def _bits(a):
    return a.view(f"i{a.itemsize}")


def _asymmetric(name, dtype):
    """A symmetric matrix made asymmetric in its bits only."""
    D = _symmetric(random_additive_matrix(12, np.random.default_rng(12))
                   ).astype(dtype)
    if name == "one_ulp":
        D[2, 5] = np.nextafter(D[2, 5], np.inf, dtype=D.dtype)
    elif name == "signed_zeros":
        D[2, 5], D[5, 2] = 0.0, -0.0
    elif name == "nan_payloads":
        D[2, 5] = D[5, 2] = np.nan
        _bits(D)[5, 2] += 1
        assert np.isnan(D[5, 2]) and _bits(D)[2, 5] != _bits(D)[5, 2]
    return D


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["one_ulp", "signed_zeros", "nan_payloads"])
def test_read_mode_takes_the_full_read_on_asymmetric_bits(name, dtype):
    """engine._read_mode compares bit patterns: one ulp, -0.0 against
    +0.0 and two NaN payloads in mirrored places each take the full read,
    and the log names the place; the sharded route takes it always."""
    lines = []
    st = engine._State(_asymmetric(name, dtype), dtype, torch.device("cpu"),
                       None)
    assert engine._read_mode(st, None, lines.append) is False
    assert "full read" in lines[0] and "D[2, 5] != D[5, 2]" in lines[0]
    st = engine._State(_symmetric(random_additive_matrix(
        12, np.random.default_rng(2))), dtype, torch.device("cpu"), None)
    assert engine._read_mode(st, None) is True
    assert engine._read_mode(st, _OneRankMesh(), lines.append) is False


def _cli_matrices(tmp_path):
    """The matrices the CLI's NJ is given, made by the port's own code:
    mash (-i r), MSA (-i m, models 1 and 4) and PHYLIP (-i d)."""
    from dipper_tpu_torch.distance import mash as tmash
    from dipper_tpu_torch.distance import msa as tmsa
    from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes
    from dipper_tpu_torch.io.phylip import (read_phylip_lower_triangular,
                                            write_phylip_lower_triangular)
    from datagen import simulate_alignment

    cpu = torch.device("cpu")
    _, seqs = simulate_unaligned(24, 600, np.random.default_rng(21))
    ranks = tmash.pad_ranks(tmash.rank_compress_host(
        np.asarray(sketch_sequences(seqs, 12, 64))))
    out = {f"mash_{dt}": tmash.mash_distance_matrix(ranks, 12, 64, dt, cpu)
           for dt in ("float32", "float64")}
    _, aln = simulate_alignment(24, 400, np.random.default_rng(22))
    codes = batch_codes(aln, encode_4bit_codes, pad_value=4)[0]
    for model in (1, 4):
        out[f"msa{model}"] = tmsa.msa_distance_matrix(codes, model,
                                                      "float32", cpu)
    path = str(tmp_path / "d.phy")
    write_phylip_lower_triangular(
        [f"T{i}" for i in range(30)],
        random_additive_matrix(30, np.random.default_rng(23)), path)
    out["phylip"] = read_phylip_lower_triangular(path)[1]
    return out


def test_read_mode_takes_the_half_read_on_the_cli_matrices(tmp_path):
    """The matrices of every NJ path of the CLI are symmetric bit for bit,
    so their runs take the half read, in f32 and f64."""
    for name, D in _cli_matrices(tmp_path).items():
        for dtype in ("float32", "float64"):
            lines = []
            st = engine._State(D, dtype, torch.device("cpu"), None)
            assert engine._read_mode(st, None, lines.append), (name, dtype)
            assert "half read" in lines[0], lines


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_symmetry_is_kept_over_a_run(dtype):
    """Kernel B (the model, in the half read's loop) and the plain step
    keep the active block symmetric bit for bit after every merge step,
    U recomputes included, so the mode chosen once holds for the run."""
    D = _symmetric(random_additive_matrix(140, np.random.default_rng(14)))
    cpu = torch.device("cpu")
    st, plain = (engine._State(D, dtype, cpu, None) for _ in range(2))
    k = step_model.ModelStepper(st.D, st.U, st.real, st.log_ids, st.log_bl,
                                half=True, threads=32)
    N = st.N
    for step in range(N - 2):
        n = N - step
        for s in (st, plain):
            if engine._recomputes_u(n, N):
                s.U[:n] = engine._sum_last(s.D[:n, :n])
        engine._merge_step_kernels(k, st, step, None)
        engine.merge_step_plain(plain, step)
        for s in (st, plain):
            a = _bits(s.D[:n - 1, :n - 1].numpy())
            assert np.array_equal(a, a.T), (step, dtype)
    assert k.half_launches == N - 2


def test_stepper_rejects_cpu_tensors():
    from dipper_tpu_torch.nj import nj_cuda

    st = engine._State(random_additive_matrix(6, np.random.default_rng(6)),
                       "float32", torch.device("cpu"), None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nj_cuda.Stepper(st.D, st.U, st.real, st.log_ids, st.log_bl)

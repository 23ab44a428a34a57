"""KNN search of the PyTorch port against wisecondorx_tpu.

* the exact path against JAX ``knn_search(merge_method="sort")`` in
  float64: indexes equal (ties included, on integer data where both sides
  compute identical distances) and distances to rtol 1e-10;
* the plain versions of the two CUDA kernels against the JAX Pallas
  kernels run in interpret mode, at the small geometry of
  tests/test_knn_pallas.py, on integer-valued float32 inputs, where every
  distance is exact: pools, drops and flags must be equal;
* the plain K2 at its edges (negative values, -0.0 beside +0.0, ties at
  the k-th value, unfilled and short pools) against a Python sort;
* the kernel wrapper's collision-and-rerun path (plain versions on CPU);
* the null ratios (rtol 1e-12), including the -1 wraparound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import layout, t64
from wisecondorx_tpu.ops import knn as jknn
from wisecondorx_tpu.ops import knn_pallas as jpallas
from wisecondorx_tpu_torch.ops import knn as tknn
from wisecondorx_tpu_torch.ops import knn_cuda

GEOM = dict(lanes=128, depth=4, row_tile=64)


def _jax_sort(data, chr_of_bin, starts, sizes, k, row_range=None):
    return jknn.knn_search(
        data, chr_of_bin, starts, sizes, ref_size=k, row_range=row_range,
        col_tile=128, merge_method="sort",
    )


@pytest.mark.parametrize(
    "kind,k,row_range",
    [
        ("lognormal", 25, None),
        ("lognormal", 15, (700, 1024)),  # gonosomal-style row range
        ("integer", 20, None),  # engineered ties
        ("integer", 1024, None),  # k > every row's pool: unfilled slots
    ],
)
def test_exact_path_matches_jax_sort(kind, k, row_range):
    rng = np.random.default_rng(11)
    bins = [400, 350, 274]
    starts, chr_of_bin = layout(bins)
    n = sum(bins)
    if kind == "integer":
        data = rng.integers(0, 4, size=(n, 8)).astype(np.float64)
    else:
        data = rng.lognormal(0, 0.02, size=(n, 24))
    want_i, want_d = _jax_sort(data, chr_of_bin, starts, bins, k, row_range)
    got_i, got_d = tknn.knn_search_exact(
        t64(data), chr_of_bin, starts, bins, k, row_range=row_range,
        col_tile=300, row_tile=200,
    )
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-10)
    if k > n:
        assert (got_i.numpy() == -1).any()
        assert (got_d.numpy()[got_i.numpy() == -1] == tknn.SENTINEL_DISTANCE).all()


def _kernel_inputs(seed, n=1500, s=16, r=192, offset=64, collide=True):
    """Integer-valued float32 candidates in the wrapper's padded layout,
    with a planted bucket collision (> depth clones of row `offset` in one
    residue class mod lanes) so that some drops and flags are live."""
    rng = np.random.default_rng(seed)
    bins = [300, 250, n - 550]
    starts, chr_of_bin = layout(bins)
    lanes = GEOM["lanes"]
    n_pad, s_pad = -(-n // lanes) * lanes, 128
    cand = np.zeros((n_pad, s_pad), np.float32)
    cand[:n, :s] = rng.integers(0, 6, size=(n, s))
    if collide:
        for c in range(300 + offset % lanes, n, lanes):
            cand[c] = cand[offset]
    cnorm = (cand * cand).sum(axis=1)
    cchr = np.full(n_pad, -2, np.int32)
    cchr[:n] = chr_of_bin
    rows = cand[offset : offset + r]
    rchr = cchr[offset : offset + r]
    rstart = np.asarray(starts, np.int32)[rchr]
    rsize = np.asarray(bins, np.int32)[rchr]
    return rows, cnorm[offset : offset + r], rchr, rstart, rsize, cand, cnorm, cchr, n


@pytest.mark.parametrize("seed,sentinel", [(1, 1e30), (2, 60.0)])
def test_kernel_plain_versions_match_pallas(seed, sentinel):
    rows, rnorm, rchr, rstart, rsize, cand, cnorm, cchr, n = _kernel_inputs(seed)
    want = jpallas._bucket_scan(
        jnp.asarray(rows), jnp.asarray(rnorm[:, None]),
        jnp.asarray(rchr[:, None]), jnp.asarray(rstart[:, None]),
        jnp.asarray(rsize[:, None]), jnp.asarray(cand),
        jnp.asarray(cnorm[None, :]), jnp.asarray(cchr[None, :]),
        jnp.asarray([[n]], jnp.int32), jnp.asarray([[sentinel]], jnp.float32),
        interpret=True, **GEOM,
    )
    got = knn_cuda.bucket_scan(
        *(torch.as_tensor(a) for a in (rows, rnorm, rchr, rstart, rsize,
                                        cand, cnorm, cchr)),
        n, sentinel, lanes=GEOM["lanes"], depth=GEOM["depth"],
    )
    for g, w, name in zip(got, want, ("vals", "idx", "drop")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert np.isfinite(got[2].numpy()).any()  # some buckets dropped values

    for k in (20, 130):
        want_f = jpallas._finalize(*want, ref_size=k,
                                   row_tile=GEOM["row_tile"], interpret=True)
        got_f = knn_cuda.extract_topk(*got, k)
        np.testing.assert_array_equal(got_f[0].numpy(), np.asarray(want_f[0]))
        np.testing.assert_array_equal(got_f[2].numpy(), np.asarray(want_f[2]))
        # The index of a non-finite slot is unspecified (the wrapper turns
        # it into -1); the TPU kernel repeats its last extracted lane's.
        finite = np.isfinite(got_f[0].numpy())
        np.testing.assert_array_equal(
            got_f[1].numpy()[finite], np.asarray(want_f[1])[finite]
        )
        if k == 20:
            assert got_f[2].numpy().any()  # the planted collision is flagged


def test_flag_catches_overflow_with_short_pool():
    """A bucket that drops values while the pool holds fewer than k finite
    entries loses true neighbours even though every drop exceeds the kept
    maximum; the port flags that row (the TPU rule does not)."""
    vals = torch.tensor([[1.0, torch.inf, 2.0, torch.inf]])  # lanes 2, depth 2
    idx = torch.tensor([[4, -1, 8, -1]], dtype=torch.int32)
    drop = torch.tensor([[3.0, torch.inf]])
    _, _, flagged = knn_cuda.extract_topk(vals, idx, drop, 3)
    assert flagged.tolist() == [True]


@pytest.mark.parametrize("case", chip_smoke.k2_edge_cases(), ids=lambda c: c[0])
def test_plain_k2_at_the_edges(case):
    """The contract K2 must meet on the card, where chip_smoke.py holds the
    kernel bit for bit to this plain version on the same fixtures: the k
    smallest in ascending order, equal values -- -0.0 beside +0.0 included
    -- by lowest pool position, the pool's own values (zero's sign kept)
    and indexes, and the flag rule."""
    name, vals, idx, drop, k = case
    top_v, top_i, flagged = knn_cuda.extract_topk(
        *(torch.as_tensor(a) for a in (vals, idx, drop)), k
    )
    for r in range(vals.shape[0]):
        order = sorted(range(vals.shape[1]), key=lambda p: (vals[r, p], p))[:k]
        kept = vals[r, order]
        np.testing.assert_array_equal(top_v[r].numpy().view(np.int32),
                                      kept.view(np.int32))
        np.testing.assert_array_equal(top_i[r].numpy(), idx[r, order])
        fin = kept[np.isfinite(kept)]
        tau = fin.max() if fin.size else -np.inf
        md = drop[r].min()
        want = bool(np.isfinite(md) and (md <= tau or fin.size < k))
        assert bool(flagged[r]) == want, r
    if name == "short_pool":
        assert flagged[1:].all() and not flagged[0]
    if name == "signed_zero":
        assert (np.signbit(top_v.numpy()) & (top_v.numpy() == 0)).any()


def test_collision_rerun_recovers_exact_neighbours():
    """> depth duplicates of a row in one residue class mod lanes on other
    chromosomes: the drop certificate flags the row and the exact rerun
    recovers every zero-distance neighbour (the wrapper runs the kernels'
    plain versions on CPU tensors)."""
    rng = np.random.default_rng(3)
    bins = [400, 350, 274]
    starts, chr_of_bin = layout(bins)
    n = sum(bins)
    data = rng.integers(0, 8, size=(n, 16)).astype(np.float64)
    target = 5
    clones = list(range(405, n, 128))
    assert len(clones) > GEOM["depth"]
    data[clones] = data[target]

    want_i, want_d = _jax_sort(data, chr_of_bin, starts, bins, 20)
    stats = {}
    got_i, got_d = knn_cuda.knn_search_cuda(
        t64(data), chr_of_bin, starts, bins, 20, lanes=128, depth=4,
        row_chunk=256, stats=stats,
    )
    assert stats["flagged_rows"] >= 1
    # float32 norm-trick distances carry an absolute error of about
    # eps32 * ||x||^2 / scale^2 (~2e-5 here, where ||x||^2 ~ 16 after the
    # rescale by 0.43): exact clones come out near 0, not at 0.
    assert (np.abs(got_d.numpy()[target]) < 1e-4).sum() == len(clones)
    np.testing.assert_allclose(
        np.sort(got_d.numpy(), axis=1), np.sort(want_d, axis=1),
        rtol=1e-5, atol=1e-4,
    )
    # Where the k boundary is not tied, the neighbour sets are equal.
    _, d21 = _jax_sort(data, chr_of_bin, starts, bins, 21)
    s21 = np.sort(d21, axis=1)
    for r in np.nonzero(s21[:, 20] > s21[:, 19])[0]:
        assert set(got_i.numpy()[r]) == set(want_i[r]), r


def test_knn_search_dispatches_cpu_tensors_to_exact_path():
    rng = np.random.default_rng(4)
    bins = [60, 50, 40]
    starts, chr_of_bin = layout(bins)
    data = t64(rng.lognormal(0, 0.05, size=(150, 6)))
    got = tknn.knn_search(data, chr_of_bin, starts, bins, 10)
    want = tknn.knn_search_exact(data, chr_of_bin, starts, bins, 10)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_null_ratios_match_jax():
    rng = np.random.default_rng(17)
    n, s, k = 700, 12, 9
    data = rng.lognormal(0, 0.1, size=(n, s))
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    idx[3, :4] = -1  # unfilled slots wrap to the last bin
    chosen = np.array([0, 2, 5, 7])
    want = jknn.compute_null_ratios(data, idx, chosen, backend="numpy")
    got = tknn.compute_null_ratios(t64(data), torch.as_tensor(idx), chosen)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)

    # Gonosomal shape: zero-index placeholder rows for the autosomes.
    r0 = 300
    idx_g = idx.copy()
    idx_g[:r0] = 0
    want_g = jknn.compute_null_ratios(data, idx_g, chosen, backend="numpy")
    got_g = tknn.compute_null_ratios(
        t64(data), torch.as_tensor(idx[r0:]), chosen, placeholder_rows=r0
    )
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-12)

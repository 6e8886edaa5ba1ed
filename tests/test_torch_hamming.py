"""Hamming matrices and the match-selection gates: the port's plain PyTorch
path against the reference, exactly (integers, masks and indices).

The Hamming cases mirror tests/test_pallas.py: a tiling shape, a large one,
a ragged one (where the reference's Pallas wrapper falls back to XLA) and
the masking contract. Descriptors are uint32 words on the reference side and
their int32 bit patterns in the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.ops import hamming as ref_hamming
from gfplslam_tpu.ops import matching as ref_matching

from gfplslam_torch.ops import hamming, matching

torch.set_num_threads(2)


def _desc(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _t(d):
    return torch.from_numpy(d.view(np.int32).copy())


@pytest.mark.parametrize("n,m", [(256, 128), (1024, 512), (100, 60), (1, 7)])
def test_hamming_exact(n, m):
    a, b = _desc(n, n), _desc(m, m + 1)
    ref = np.asarray(ref_hamming.hamming_matrix_xla(jnp.asarray(a), jnp.asarray(b)))
    got = hamming.hamming_matrix(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("n,m", [(256, 128), (100, 60)])
def test_hamming_masks_exact(n, m):
    a, b = _desc(n, 6), _desc(m, 7)
    va = np.arange(n) % 3 != 0
    vb = np.arange(m) % 2 == 0
    ref = np.asarray(ref_hamming.hamming_matrix(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
        use_pallas=False))
    got = hamming.hamming_matrix(_t(a), _t(b), torch.from_numpy(va),
                                 torch.from_numpy(vb)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert (got[~va] == hamming.BIG).all() and (got[:, ~vb] == hamming.BIG).all()


def test_hamming_extreme_words():
    a = np.array([[0] * 8, [0xFFFFFFFF] * 8, [0x80000000] * 8], np.uint32)
    got = hamming.hamming_matrix(_t(a), _t(a)).numpy()
    np.testing.assert_array_equal(got, [[0, 256, 8], [256, 0, 248], [8, 248, 0]])


def test_hamming_dispatch_by_device_only():
    a = _t(_desc(4, 1))
    with pytest.raises(ValueError):
        hamming.hamming_matrix(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError):
        hamming.hamming_cuda(a, a)


@pytest.mark.parametrize("shapes", [
    [(5, 9)], [(0, 7), (33, 1)], [(128, 129), (7, 0), (1, 1)],
    [(64, 300), (17, 15), (0, 0), (100, 60)]])
def test_hamming_matrices_one_plain_matrix_per_problem(shapes):
    """The grouped form (one kernel launch on the card) on the CPU: one
    plain matrix per problem, masks none / rows / columns / both, empty and
    ragged shapes among them; each equal to the reference's masked
    matrix."""
    rng = np.random.default_rng(len(shapes))
    problems, refs = [], []
    for i, (n, m) in enumerate(shapes):
        a, b = _desc(n, 10 * i), _desc(m, 10 * i + 1)
        va = rng.random(n) < 0.7 if i % 2 else None
        vb = rng.random(m) < 0.7 if i % 4 in (2, 3) or i == 0 else None
        problems.append((_t(a), _t(b), None if va is None else torch.from_numpy(va),
                         None if vb is None else torch.from_numpy(vb)))
        refs.append(np.asarray(ref_hamming.hamming_matrix(
            jnp.asarray(a), jnp.asarray(b),
            None if va is None else jnp.asarray(va),
            None if vb is None else jnp.asarray(vb), use_pallas=False)))
    got = hamming.hamming_matrices(problems)
    assert len(got) == len(shapes)
    for g, p, want, (n, m) in zip(got, problems, refs, shapes):
        assert g.dtype == torch.int32 and tuple(g.shape) == (n, m)
        assert torch.equal(g, hamming.hamming_matrix_torch(*p))
        np.testing.assert_array_equal(g.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("count", [0, 5])
def test_hamming_matrices_take_one_to_four_problems(count):
    """The kernel's problem table holds four: the grouped form refuses
    other counts on the CPU too, so a call that passes here fits the
    card's."""
    a = _t(_desc(4, 1))
    with pytest.raises(ValueError):
        hamming.hamming_matrices([(a, a, None, None)] * count)


def _tied_distances(n, m, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(20, 40, (n, m)).astype(np.float32)   # many exact ties
    d[rng.random((n, m)) < 0.1] = float(hamming.BIG)
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_best2_and_mutual_best_exact(seed):
    d = _tied_distances(40, 30, seed)
    for got, want in zip(matching.best2(torch.from_numpy(d)),
                         ref_matching.best2(jnp.asarray(d))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = matching.mutual_best(torch.from_numpy(d))
    want = ref_matching.mutual_best(jnp.asarray(d))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("budget", [5, 17, 64])
def test_budget_gate_and_dedup_exact(budget):
    rng = np.random.default_rng(budget)
    n, n_t = 50, 20
    idx = rng.integers(0, n_t, n)
    dist = rng.integers(0, 8, n).astype(np.float32)      # ties everywhere
    valid = rng.random(n) < 0.8
    ref_m = ref_matching.Matches(idx=jnp.asarray(idx, jnp.int32),
                                 dist=jnp.asarray(dist), valid=jnp.asarray(valid))
    m = matching.Matches(idx=torch.from_numpy(idx), dist=torch.from_numpy(dist),
                         valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(
        matching.dedup_per_target(m, n_t).valid.numpy(),
        np.asarray(ref_matching.dedup_per_target(ref_m, n_t).valid))
    np.testing.assert_array_equal(
        matching.budget_gate(m, budget).valid.numpy(),
        np.asarray(ref_matching.budget_gate(ref_m, budget).valid))

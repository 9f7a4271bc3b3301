"""The torch port's grouped matmul (automodel_tpu_torch/ops/grouped_matmul.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU:
gmm, gmm with a transposed rhs and tgmm on the cases of
tests/test_grouped_matmul.py, ragged_dot's grads against the JAX custom
VJP, and the gmm work plan. The same numpy-made fp32 inputs go to both;
atol 1e-4 (fp32 sums over up to 128 products in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import grouped_matmul as jgm
from automodel_tpu_torch.ops import grouped_matmul as tgm
import torch_port_parity  # noqa: F401  (caps torch at one thread)

CASES = [
    (64, 48, 40, 4, None),  # nothing divisible by tiles
    (256, 128, 128, 8, None),
    (128, 64, 96, 5, [0, 50, 0, 78, 0]),  # empty groups, incl. edges
    (96, 32, 32, 3, [96, 0, 0]),  # one group takes all rows
    (130, 128, 128, 2, [1, 129]),  # tile spans a group boundary
]


def _case(rng, M, K, N, G, sizes=None):
    if sizes is None:
        cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [M]]))
    sizes = np.asarray(sizes, np.int32)
    return (rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(G, K, N)).astype(np.float32),
            sizes, rng.normal(size=(M, N)).astype(np.float32))


@pytest.mark.parametrize("M,K,N,G,sizes", CASES)
def test_gmm_gmm_t_and_tgmm_match_the_pallas_kernels(M, K, N, G, sizes):
    lhs, rhs, gs, dout = _case(np.random.default_rng(0), M, K, N, G, sizes)
    tl, tr, tg, td = map(torch.from_numpy, (lhs, rhs, gs, dout))
    want = jgm._gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs), interpret=True)
    np.testing.assert_allclose(tgm.gmm(tl, tr, tg).numpy(), np.asarray(want), atol=1e-4)
    # dlhs of the backward: dout [M, N] against rhs read as [G, N, K]
    want_t = jgm._gmm(jnp.asarray(dout), jnp.asarray(rhs), jnp.asarray(gs), interpret=True, transpose_rhs=True)
    np.testing.assert_allclose(tgm.gmm(td, tr, tg, transpose_rhs=True).numpy(), np.asarray(want_t), atol=1e-4)
    want_w = jgm._tgmm(jnp.asarray(lhs), jnp.asarray(dout), jnp.asarray(gs), interpret=True)
    got_w = tgm.tgmm(tl, td, tg)
    assert got_w.dtype == torch.float32 and tuple(got_w.shape) == (G, K, N)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-4)


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_ragged_dot_grads_match_the_jax_vjp(transpose_rhs):
    rng = np.random.default_rng(1)
    lhs, rhs, gs, _ = _case(rng, 192, 64, 80, 6)
    if transpose_rhs:
        rhs = np.ascontiguousarray(rhs.transpose(0, 2, 1))  # [G, N, K]
    w = rng.normal(size=(192, 80)).astype(np.float32)

    def jloss(l, r):
        return (jgm._grouped_matmul(l, r, jnp.asarray(gs), True, transpose_rhs) * w).sum()

    jl, jr = jax.grad(jloss, (0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl = torch.tensor(lhs, requires_grad=True)
    tr = torch.tensor(rhs, requires_grad=True)
    (tgm.ragged_dot(tl, tr, torch.from_numpy(gs), transpose_rhs=transpose_rhs) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jr), atol=1e-4)


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_ragged_dot_bf16_grads_match_the_jax_vjp(transpose_rhs):
    """In bf16, as the MoE layer runs it: the port's backward takes drhs's
    cast to rhs.dtype inside tgmm (an fp32 sum rounded once), JAX's VJP
    casts tgmm's fp32 result after it (:330-333). The same inputs go to
    both; fp32 sums in another order may round one bf16 ulp apart, 2^-7 of
    an element at most."""
    rng = np.random.default_rng(4)
    lhs, rhs, gs, _ = _case(rng, 192, 64, 80, 6, [40, 0, 70, 1, 81, 0])
    if transpose_rhs:
        rhs = np.ascontiguousarray(rhs.transpose(0, 2, 1))  # [G, N, K]
    w = rng.normal(size=(192, 80)).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)

    def jloss(l, r):
        return (jgm._grouped_matmul(l, r, jnp.asarray(gs), True, transpose_rhs) * w).sum()

    jl, jr = jax.grad(jloss, (0, 1))(bf(lhs), bf(rhs))
    tl = torch.tensor(lhs).to(torch.bfloat16).requires_grad_(True)
    tr = torch.tensor(rhs).to(torch.bfloat16).requires_grad_(True)
    (tgm.ragged_dot(tl, tr, torch.from_numpy(gs), transpose_rhs=transpose_rhs) * torch.from_numpy(w)).sum().backward()
    assert tl.grad.dtype == torch.bfloat16 and tr.grad.dtype == torch.bfloat16
    for got, want in ((tl.grad, jl), (tr.grad, jr)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2.0**-7, atol=1e-30)


def test_tgmm_bf16_output_is_the_fp32_sum_rounded_once():
    """tgmm's bf16 output (the backward's drhs) is its fp32 output cast to
    bf16, bit for bit, on the CPU's plain version as on the card's kernel."""
    lhs, _, gs, dout = _case(np.random.default_rng(5), 200, 48, 40, 5, [60, 0, 1, 100, 39])
    tl, td = torch.from_numpy(lhs).to(torch.bfloat16), torch.from_numpy(dout).to(torch.bfloat16)
    tg = torch.from_numpy(gs)
    want = tgm._tgmm_plain(tl, td, tg)
    for got in (tgm._tgmm_plain(tl, td, tg, torch.bfloat16), tgm.tgmm(tl, td, tg, torch.bfloat16)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert tgm.tgmm(tl, td, tg).dtype == torch.float32 and torch.equal(tgm.tgmm(tl, td, tg), want)


@pytest.mark.parametrize("sizes", [[5, 0, 9, 9, 0, 30, 1], [0, 0, 0], [7] * 6 + [0] * 2 + [300], [3]])
def test_tgmm_group_order_covers_every_item_once_largest_group_first(sizes):
    """The order in which the tgmm kernel takes the groups' items: every
    group exactly once, empty groups included, the largest first, ties in
    index order."""
    gs = torch.tensor(sizes, dtype=torch.int32)
    order = tgm.tgmm_group_order(gs)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(len(sizes)))
    ordered = [sizes[g] for g in order.tolist()]
    assert ordered == sorted(sizes, reverse=True)
    assert all(a < b for a, b, x, y in zip(order.tolist(), order.tolist()[1:], ordered, ordered[1:]) if x == y)


def test_ragged_dot_grad_is_zero_for_empty_groups():
    lhs, rhs, gs, _ = _case(np.random.default_rng(2), 64, 32, 32, 4, [30, 0, 34, 0])
    tr = torch.tensor(rhs, requires_grad=True)
    tgm.ragged_dot(torch.from_numpy(lhs), tr, torch.from_numpy(gs)).sum().backward()
    assert float(tr.grad[1].abs().max()) == 0.0 and float(tr.grad[3].abs().max()) == 0.0
    assert float(tr.grad[0].abs().max()) > 0.0


def test_rows_past_the_groups_are_zero():
    lhs, rhs, _, _ = _case(np.random.default_rng(3), 40, 16, 24, 3, [5, 0, 20])
    out = tgm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.tensor([5, 0, 20], dtype=torch.int32))
    assert torch.equal(out[25:], torch.zeros(15, 24))
    assert bool((out[:25] != 0).any(dim=-1).all())


@pytest.mark.parametrize(
    "M,sizes",
    [(300, [0, 129, 0, 1, 100, 0]), (256, [256]), (64, [0, 0, 0]), (1000, [128, 128, 1, 127, 600]),
     (130, [1, 129]), (517, [7] * 60 + [0] * 4)],
)
def test_gmm_plan_covers_every_row_once_with_its_group(M, sizes):
    """The work units the gmm kernel walks: every row of [0, M) lies in
    exactly one unit's window, inside that unit's 128-row tile, with the
    group that owns it (G, the zero tail, for rows past the groups)."""
    gs = torch.tensor(sizes, dtype=torch.int32)
    plan = tgm.gmm_plan(gs, M)
    G, tm = len(sizes), tgm.GMM_TILE_M
    assert plan.dtype == torch.int32 and tuple(plan.shape) == (4, -(-M // tm) + G + 1)
    owner = np.repeat(np.arange(G + 1), list(sizes) + [max(M - sum(sizes), 0)])[:M]
    hits = np.zeros(M, np.int64)
    for g, tile, s, e in plan.t().tolist():
        if s >= e:
            continue
        assert tile * tm <= s < e <= min(tile * tm + tm, M)
        assert (owner[s:e] == g).all()
        hits[s:e] += 1
    assert (hits == 1).all()


def test_gmm_refuses_shapes_that_do_not_match():
    lhs = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="do not match"):
        tgm.gmm(lhs, torch.zeros(2, 24, 8), torch.tensor([4, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        tgm.tgmm(lhs, torch.zeros(7, 8), torch.tensor([4, 4], dtype=torch.int32))

"""The torch port's fused expert MLP (automodel_tpu_torch/ops/fused_expert_mlp)
against the JAX package's Pallas kernels run in interpret mode on the CPU:
the plain forward and the three plain backward functions against ``_fwd``,
``_bwd_gu``, ``_bwd_dwd`` and ``_bwd_dx``; the backward's elementwise pass
(``_bwd_act_plain``) against ``_act_core`` and ``jax.vjp`` of it, and the
composition the autograd function runs (the pass once, then ``bwd_dwd``
and ``bwd_dx`` given its outputs) against ``_bwd_dwd`` and ``_bwd_dx``;
the autograd function's seven
grads (dlhs, dWg | dWu as one [G, D, 2I], dWd, dgb | dub, ddb) against
``jax.vjp`` of ``fused_expert_mlp`` over the cases of
tests/test_fused_backward.py, a NaN tail past the groups, empty experts and
clamp ties. Inputs are made with numpy from a seed; fp32 throughout, atol
5e-4 as tests/test_fused_backward.py holds the JAX kernels to, or tighter
where stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import fused_expert_mlp as jfem
from automodel_tpu_torch.ops import fused_expert_mlp as tfem
import torch_port_parity  # noqa: F401  (caps torch at one thread)

ATOL = 5e-4
# tests/test_fused_backward.py:60-68: (act, limit, biased, sizes) over M=128
CASES = {
    "swiglu_empty_mid": ("swiglu", None, False, [40, 0, 30, 58]),
    "swiglu_limit_biased": ("swiglu", 2.0, True, [1, 63, 0, 64]),
    "oai_empty_first_biased": ("swiglu_oai", None, True, [0, 50, 50, 28]),
    "oai_balanced": ("swiglu_oai", None, False, [32, 32, 32, 32]),
}


def _case(seed, M, D, I, sizes, biased):
    """numpy fp32: lhs, gate, up, down, gb, ub, db, dy, group sizes (the
    weights at 0.3 as tests/test_fused_backward.py:_case)."""
    rng = np.random.default_rng(seed)
    G = len(sizes)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    lhs = mk(M, D)
    gate, up, down = mk(G, D, I) * 0.3, mk(G, D, I) * 0.3, mk(G, I, D) * 0.3
    gb, ub, db = (mk(G, I), mk(G, I), mk(G, D)) if biased else (None, None, None)
    return dict(lhs=lhs, gate=gate, up=up, down=down, gb=gb, ub=ub, db=db, dy=mk(M, D),
                gs=np.asarray(sizes, np.int32))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, grad=False):
    return None if x is None else torch.tensor(x, requires_grad=grad)


def _jax_vjp(c, act, limit):
    """JAX's forward and its seven grads through the Pallas kernels
    (interpreted)."""
    biased = c["gb"] is not None
    names = ("lhs", "gate", "up", "down") + (("gb", "ub", "db") if biased else ())

    def f(*a):
        b = a[4:] if biased else (None, None, None)
        return jfem.fused_expert_mlp(a[0], a[1], a[2], a[3], jnp.asarray(c["gs"]), *b, act, limit, None, True)

    y, vjp = jax.vjp(f, *(jnp.asarray(c[n]) for n in names))
    return np.asarray(y), dict(zip(names, (np.asarray(g) for g in vjp(jnp.asarray(c["dy"])))))


def _port_grads(c, act, limit):
    """The port's forward and grads through its autograd function (the
    plain versions on CPU tensors), the grads split as JAX's."""
    I = c["gate"].shape[2]
    lhs = _t(c["lhs"], True)
    gate_up = torch.tensor(np.concatenate([c["gate"], c["up"]], axis=-1), requires_grad=True)
    down = _t(c["down"], True)
    gub = None if c["gb"] is None else torch.tensor(np.concatenate([c["gb"], c["ub"]], -1), requires_grad=True)
    db = _t(c["db"], True)
    y = tfem.fused_expert_mlp(lhs, gate_up, down, torch.from_numpy(c["gs"]), gub, db, act, limit)
    y.backward(torch.from_numpy(c["dy"]))
    grads = dict(lhs=lhs.grad, gate=gate_up.grad[..., :I], up=gate_up.grad[..., I:], down=down.grad)
    if gub is not None:
        grads.update(gb=gub.grad[:, :I], ub=gub.grad[:, I:], db=db.grad)
    return y.detach().numpy(), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_the_pallas_kernels(case):
    """_fwd_plain, _bwd_gu_plain, _bwd_dwd_plain and _bwd_dx_plain against
    JAX's _fwd, _bwd_gu, _bwd_dwd and _bwd_dx in interpret mode, on the same
    lhs, weights, biases and (g, u, dmid) (fp32, 2e-4: the same products
    summed in another order)."""
    act, limit, biased, sizes = CASES[case]
    c = _case(0, 128, 96, 80, sizes, biased)
    I = 80
    rng = np.random.default_rng(1)
    g, u, dmid = (rng.normal(size=(128, I)).astype(np.float32) * 2 for _ in range(3))
    gs_j, gs_t = jnp.asarray(c["gs"]), torch.from_numpy(c["gs"])
    gate_up = torch.from_numpy(np.concatenate([c["gate"], c["up"]], -1))
    gub = None if not biased else torch.from_numpy(np.concatenate([c["gb"], c["ub"]], -1))
    gu = torch.from_numpy(np.concatenate([g, u], -1))

    want = jfem._fwd(_j(c["lhs"]), _j(c["gate"]), _j(c["up"]), _j(c["down"]), gs_j, _j(c["gb"]), _j(c["ub"]),
                     _j(c["db"]), act, limit, True)
    got = tfem._fwd_plain(_t(c["lhs"]), gate_up, _t(c["down"]), gs_t, gub, _t(c["db"]), act, limit)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, err_msg="fwd")

    dwg, dwu, dgb, dub = jfem._bwd_gu(_j(c["lhs"]), _j(g), _j(u), _j(dmid), gs_j, act, limit, True, biased)
    dw, dbias = tfem._bwd_gu_plain(_t(c["lhs"]), gu, _t(dmid), gs_t, act, limit, want_bias=biased)
    np.testing.assert_allclose(dw[..., :I].numpy(), np.asarray(dwg), atol=2e-4, err_msg="dWg")
    np.testing.assert_allclose(dw[..., I:].numpy(), np.asarray(dwu), atol=2e-4, err_msg="dWu")
    if biased:
        np.testing.assert_allclose(dbias[:, :I].numpy(), np.asarray(dgb), atol=2e-4, err_msg="dgb")
        np.testing.assert_allclose(dbias[:, I:].numpy(), np.asarray(dub), atol=2e-4, err_msg="dub")
    else:
        assert dbias is None and dgb is None

    dy = c["dy"]
    dwd, ddb = jfem._bwd_dwd(_j(g), _j(u), _j(dy), gs_j, act, limit, True, biased)
    t_dwd, t_ddb = tfem._bwd_dwd_plain(gu, _t(dy), gs_t, act, limit, want_bias=biased)
    np.testing.assert_allclose(t_dwd.numpy(), np.asarray(dwd), atol=2e-4, err_msg="dWd")
    if biased:
        np.testing.assert_allclose(t_ddb.numpy(), np.asarray(ddb), atol=2e-4, err_msg="ddb")

    dlhs = jfem._bwd_dx(_j(g), _j(u), _j(dmid), _j(c["gate"]), _j(c["up"]), gs_j, True, act, limit)
    t_dlhs = tfem._bwd_dx_plain(gu, _t(dmid), gate_up, gs_t, act, limit)
    np.testing.assert_allclose(t_dlhs.numpy(), np.asarray(dlhs), atol=2e-4, err_msg="dlhs")


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_grads_match_jax_vjp(case):
    """The forward and all seven grads against jax.vjp of the JAX
    fused_expert_mlp through its Pallas kernels (interpreted)."""
    act, limit, biased, sizes = CASES[case]
    c = _case(0, 128, 96, 80, sizes, biased)
    jy, jg = _jax_vjp(c, act, limit)
    ty, tg = _port_grads(c, act, limit)
    np.testing.assert_allclose(ty, jy, atol=2e-4)
    assert set(tg) == set(jg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], atol=ATOL, err_msg=f"d{name} ({case})")


def test_nan_tail_reaches_no_weight_or_bias_grad():
    """Rows past sum(group_sizes) hold NaN in lhs and dy (the sentinel tail
    of tests/test_fused_backward.py:84): every weight and bias grad stays
    finite and equals JAX's on a clean tail; dlhs and out agree on the real
    rows, and the port writes the tail rows as zeros."""
    M, n_real = 96, 70
    c = _case(7, M, 64, 48, [30, 0, 40], biased=True)
    c["lhs"][n_real:] = np.nan
    c["dy"][n_real:] = np.nan
    clean = dict(c, lhs=np.where(np.isfinite(c["lhs"]), c["lhs"], 0.0).astype(np.float32),
                 dy=np.where(np.isfinite(c["dy"]), c["dy"], 0.0).astype(np.float32))
    jy, jg = _jax_vjp(clean, "swiglu_oai", None)
    ty, tg = _port_grads(c, "swiglu_oai", None)
    np.testing.assert_allclose(ty[:n_real], jy[:n_real], atol=2e-4)
    assert (ty[n_real:] == 0).all() and (tg["lhs"][n_real:] == 0).all()
    for name in jg:
        got, want = tg[name], jg[name]
        if name == "lhs":
            got, want = got[:n_real], want[:n_real]
        assert np.isfinite(got).all(), f"d{name} poisoned by the NaN tail"
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"d{name}")
        assert np.abs(got).max() > 0.0


def test_empty_experts_get_zero_grads():
    """tests/test_fused_backward.py:127: experts that receive no rows get
    exactly zero weight and bias grads; the others match JAX."""
    c = _case(3, 64, 32, 32, [30, 0, 34, 0], biased=True)
    jy, jg = _jax_vjp(c, "swiglu", None)
    ty, tg = _port_grads(c, "swiglu", None)
    np.testing.assert_allclose(ty, jy, atol=2e-4)
    for name in ("gate", "up", "down", "gb", "ub", "db"):
        assert (tg[name][[1, 3]] == 0).all(), name
        assert np.abs(tg[name][[0, 2]]).max() > 0, name
        np.testing.assert_allclose(tg[name], jg[name], atol=ATOL, err_msg=name)


@pytest.mark.parametrize("act,limit", [("swiglu_oai", None), ("swiglu", 2.0)])
def test_clamp_ties_take_half_the_gradient_as_in_jax(act, limit):
    """g and u with entries exactly at a clamp's bound (+-7 for swiglu_oai,
    +-limit for u under swiglu's limit): JAX's minimum and maximum split the
    gradient there (0.5), which torch.clamp would not. The plain activation
    backward and the plain bwd_gu and bwd_dx (which the kernels mirror)
    against jax.vjp of JAX's _act_core and its interpreted _bwd_gu and
    _bwd_dx, exactly on the activation (1e-6) and 2e-4 on the products."""
    bound = 7.0 if act == "swiglu_oai" else limit
    M, D, I, sizes = 64, 32, 48, [20, 0, 44]
    rng = np.random.default_rng(5)
    g = rng.normal(size=(M, I)).astype(np.float32) * bound
    u = rng.normal(size=(M, I)).astype(np.float32) * bound
    pick = rng.random((M, I))
    if act == "swiglu_oai":
        g[pick < 0.2] = 7.0
    u[pick < 0.15] = bound
    u[(pick >= 0.15) & (pick < 0.3)] = -bound
    dmid = rng.normal(size=(M, I)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jfem._act_core(a, b, act, limit), jnp.asarray(g), jnp.asarray(u))
    jdg, jdu = (np.asarray(t) for t in vjp(jnp.asarray(dmid)))
    tdg, tdu = tfem._act_grads(torch.from_numpy(g), torch.from_numpy(u), torch.from_numpy(dmid), act, limit)
    at_u = np.abs(u) == bound
    assert at_u.sum() > 0.2 * M * I
    np.testing.assert_allclose(tdg.numpy(), jdg, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tdu.numpy(), jdu, atol=1e-6, rtol=1e-6)
    # torch.clamp's gradient at the bound would be the whole of it
    clamp_du = torch.where(torch.from_numpy(at_u), tdu * 2, tdu)
    assert not np.allclose(clamp_du.numpy(), jdu, atol=1e-3)

    lhs = rng.normal(size=(M, D)).astype(np.float32)
    gate = (rng.normal(size=(3, D, I)) * 0.3).astype(np.float32)
    up = (rng.normal(size=(3, D, I)) * 0.3).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    gu = torch.from_numpy(np.concatenate([g, u], -1))
    dwg, dwu, _, _ = jfem._bwd_gu(_j(lhs), _j(g), _j(u), _j(dmid), jnp.asarray(gs), act, limit, True, False)
    dw, _ = tfem._bwd_gu_plain(torch.from_numpy(lhs), gu, torch.from_numpy(dmid), torch.from_numpy(gs), act, limit)
    np.testing.assert_allclose(dw.numpy(), np.concatenate([np.asarray(dwg), np.asarray(dwu)], -1), atol=2e-4)
    dlhs = jfem._bwd_dx(_j(g), _j(u), _j(dmid), _j(gate), _j(up), jnp.asarray(gs), True, act, limit)
    t_dlhs = tfem._bwd_dx_plain(gu, torch.from_numpy(dmid), torch.from_numpy(np.concatenate([gate, up], -1)),
                                torch.from_numpy(gs), act, limit)
    np.testing.assert_allclose(t_dlhs.numpy(), np.asarray(dlhs), atol=2e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    lhs = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="act_kind='relu2'"):
        tfem.fwd(lhs, torch.zeros(2, 16, 16), torch.zeros(2, 8, 16), torch.tensor([4, 4], dtype=torch.int32),
                 act_kind="relu2")
    with pytest.raises(ValueError, match="limit"):
        tfem.fused_expert_mlp(lhs, torch.zeros(2, 16, 16), torch.zeros(2, 8, 16),
                              torch.tensor([4, 4], dtype=torch.int32), limit=-1.0)


def _act_inputs(act, limit, M=96, I=40, seed=11):
    """numpy fp32 g, u, dmid [M, I]: swiglu_oai and swiglu's limit with a
    share of entries exactly on the clamps' bounds, the rest spread past
    them."""
    rng = np.random.default_rng(seed)
    bound = 7.0 if act == "swiglu_oai" else (limit or 3.0)
    g, u, dmid = (rng.normal(size=(M, I)).astype(np.float32) * bound for _ in range(3))
    if act == "swiglu_oai" or limit is not None:
        pick = rng.random((M, I))
        u[pick < 0.1] = bound
        u[(pick >= 0.1) & (pick < 0.2)] = -bound
        if act == "swiglu_oai":
            g[pick > 0.9] = 7.0
    return g, u, dmid


ACTS = [("swiglu", None), ("swiglu", 2.0), ("swiglu_oai", None)]


@pytest.mark.parametrize("act,limit", ACTS)
def test_bwd_act_plain_matches_jax_act_core_and_its_vjp(act, limit):
    """The backward's elementwise pass against JAX's ``_act_core`` and
    ``jax.vjp`` of it on the same g, u, dmid (clamp ties included): in fp32
    within 1e-5; in bf16, mid, dg and du each rounded once from those fp32
    values, within one bf16 step of JAX's values rounded once (a few fp32
    ulps between the two frameworks' sigmoids can move a rounding by one
    step), and equal on at least 99% of the elements."""
    g, u, dmid = _act_inputs(act, limit)
    M, I = g.shape
    gs = torch.tensor([30, 0, 66], dtype=torch.int32)
    jmid = np.asarray(jfem._act_core(jnp.asarray(g), jnp.asarray(u), act, limit))
    _, vjp = jax.vjp(lambda a, b: jfem._act_core(a, b, act, limit), jnp.asarray(g), jnp.asarray(u))
    jdg, jdu = (np.asarray(t) for t in vjp(jnp.asarray(dmid)))
    gu = torch.from_numpy(np.concatenate([g, u], -1))
    mid, dgdu = tfem._bwd_act_plain(gu, torch.from_numpy(dmid), gs, act, limit)
    assert mid.dtype == dgdu.dtype == torch.float32
    np.testing.assert_allclose(mid.numpy(), jmid, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dgdu[:, :I].numpy(), jdg, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dgdu[:, I:].numpy(), jdu, atol=1e-5, rtol=1e-5)

    bf = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    gu16, dmid16 = bf(np.concatenate([g, u], -1)), bf(dmid)
    g32, u32, d32 = (jnp.asarray(t.float().numpy()) for t in (gu16[:, :I], gu16[:, I:], dmid16))
    want = [jfem._act_core(g32, u32, act, limit)]
    _, vjp = jax.vjp(lambda a, b: jfem._act_core(a, b, act, limit), g32, u32)
    want += list(vjp(d32))
    mid16, dgdu16 = tfem._bwd_act_plain(gu16, dmid16, gs, act, limit)
    assert mid16.dtype == dgdu16.dtype == torch.bfloat16
    for name, got, w in (("mid", mid16, want[0]), ("dg", dgdu16[:, :I], want[1]), ("du", dgdu16[:, I:], want[2])):
        w16 = torch.from_numpy(np.array(w, np.float32)).to(torch.bfloat16).float()
        step = w16.abs() * 2.0**-7 + 1e-30
        assert bool(((got.float() - w16).abs() <= step).all()), name
        assert float((got.float() == w16).float().mean()) >= 0.99, name


def test_bwd_act_plain_zeroes_rows_past_the_groups_whatever_they_hold():
    """Rows at or past sum(group_sizes) hold NaN in g | u and dmid: mid and
    dg | du come out 0 there, and the rows before are the clean run's."""
    g, u, dmid = _act_inputs("swiglu_oai", None, M=64)
    gs = torch.tensor([20, 0, 30], dtype=torch.int32)
    gu = torch.from_numpy(np.concatenate([g, u], -1))
    clean = tfem._bwd_act_plain(gu, torch.from_numpy(dmid), gs, "swiglu_oai", None)
    gu_nan, dmid_nan = gu.clone(), torch.from_numpy(dmid.copy())
    gu_nan[50:], dmid_nan[50:] = float("nan"), float("nan")
    dirty = tfem._bwd_act_plain(gu_nan, dmid_nan, gs, "swiglu_oai", None)
    for a, b in zip(dirty, clean):
        assert bool((a[50:] == 0).all()) and torch.equal(a, b)
    mid, dgdu = tfem.bwd_act(gu_nan, dmid_nan, gs, "swiglu_oai", want_mid=False)
    assert mid is None and torch.equal(dgdu, clean[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_composition_matches_the_pallas_kernels(case):
    """The new backward composition on the CPU, as the autograd function
    runs it (``bwd_act`` once, then ``bwd_dwd`` with mid and ``bwd_dx``
    with dg | du given), against JAX's ``_bwd_dwd`` and ``_bwd_dx`` in
    interpret mode on the same (g, u, dmid, dy) and weights (fp32, 2e-4 as
    ``test_plain_versions_match_the_pallas_kernels``)."""
    act, limit, biased, sizes = CASES[case]
    c = _case(0, 128, 96, 80, sizes, biased)
    I = 80
    rng = np.random.default_rng(1)
    g, u, dmid = (rng.normal(size=(128, I)).astype(np.float32) * 2 for _ in range(3))
    gs_j, gs_t = jnp.asarray(c["gs"]), torch.from_numpy(c["gs"])
    gate_up = torch.from_numpy(np.concatenate([c["gate"], c["up"]], -1))
    gu = torch.from_numpy(np.concatenate([g, u], -1))
    before = tfem.bwd_act.launches
    mid, dgdu = tfem.bwd_act(gu, _t(dmid), gs_t, act, limit)
    assert tfem.bwd_act.launches == before  # CPU tensors: the plain version, no launch

    dwd, ddb = jfem._bwd_dwd(_j(g), _j(u), _j(c["dy"]), gs_j, act, limit, True, biased)
    t_dwd, t_ddb = tfem.bwd_dwd(gu, _t(c["dy"]), gs_t, act, limit, want_bias=biased, mid=mid)
    np.testing.assert_allclose(t_dwd.numpy(), np.asarray(dwd), atol=2e-4, err_msg="dWd")
    if biased:
        np.testing.assert_allclose(t_ddb.numpy(), np.asarray(ddb), atol=2e-4, err_msg="ddb")
    else:
        assert t_ddb is None
    dlhs = jfem._bwd_dx(_j(g), _j(u), _j(dmid), _j(c["gate"]), _j(c["up"]), gs_j, True, act, limit)
    t_dlhs = tfem.bwd_dx(gu, _t(dmid), gate_up, gs_t, act, limit, dgdu=dgdu)
    np.testing.assert_allclose(t_dlhs.numpy(), np.asarray(dlhs), atol=2e-4, err_msg="dlhs")


def test_bwd_dwd_bf16_out_is_the_fp32_sum_rounded_once():
    """In bf16, as on the card: ``bwd_dwd(out_dtype=bf16)`` equals its fp32
    result rounded once, bit for bit, with mid computed inside and given;
    ddb stays fp32."""
    g, u, dy = (np.random.default_rng(s).normal(size=(96, 48)).astype(np.float32) for s in (1, 2, 3))
    gu = torch.from_numpy(np.concatenate([g, u], -1)).to(torch.bfloat16)
    dy = torch.from_numpy(dy).to(torch.bfloat16)
    gs = torch.tensor([40, 0, 50], dtype=torch.int32)
    fp32, ddb32 = tfem.bwd_dwd(gu, dy, gs, "swiglu_oai", None, True)
    mid, _ = tfem.bwd_act(gu, None, gs, "swiglu_oai", want_dgdu=False)
    for kw in (dict(), dict(mid=mid)):
        bf16, ddb = tfem.bwd_dwd(gu, dy, gs, "swiglu_oai", None, True, out_dtype=torch.bfloat16, **kw)
        assert fp32.dtype == torch.float32 and bf16.dtype == torch.bfloat16 and ddb.dtype == torch.float32
        assert torch.equal(bf16, fp32.to(torch.bfloat16)) and torch.equal(ddb, ddb32)
        assert bool((bf16[1] == 0).all()) and float(bf16.float().abs().max()) > 0


def _bwd_gu_inputs(dtype, M=160, D=64, I=48, sizes=(60, 0, 70), seed=21):
    """lhs [M, D], gu [M, 2I], dmid [M, I] from a seed (g and u spread past
    swiglu_oai's clamps) and the int32 group sizes; rows past the groups
    hold NaN in every operand, which no version may read."""
    rng = np.random.default_rng(seed)
    lhs = rng.normal(size=(M, D)).astype(np.float32)
    gu = rng.normal(size=(M, 2 * I)).astype(np.float32) * 3.0
    dmid = rng.normal(size=(M, I)).astype(np.float32)
    n = sum(sizes)
    for t in (lhs, gu, dmid):
        t[n:] = np.nan
    return (*(torch.from_numpy(t).to(dtype) for t in (lhs, gu, dmid)), torch.tensor(sizes, dtype=torch.int32))


@pytest.mark.parametrize("act,limit", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_gu_with_dgdu_given_equals_it_from_gu_and_dmid(act, limit, dtype):
    """``bwd_gu`` given the elementwise pass's dg | du (as the backward
    calls it) is bit for bit ``bwd_gu`` computing it from gu and dmid, the
    weight grad and the bias grads alike, through the wrapper and the plain
    version; a NaN tail past the groups reaches neither."""
    lhs, gu, dmid, gs = _bwd_gu_inputs(dtype)
    _, dgdu = tfem._bwd_act_plain(gu, dmid, gs, act, limit, want_mid=False)
    want = tfem._bwd_gu_plain(lhs, gu, dmid, gs, act, limit, want_bias=True)
    for got in (tfem._bwd_gu_plain(lhs, gu, dmid, gs, act, limit, want_bias=True, dgdu=dgdu),
                tfem.bwd_gu(lhs, gu, dmid, gs, act, limit, True, dgdu=dgdu)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[0].dtype == want[1].dtype == torch.float32
    assert bool(torch.isfinite(want[0]).all()) and bool(torch.isfinite(want[1]).all())
    assert bool((want[0][1] == 0).all()) and bool((want[1][1] == 0).all())  # the empty group


def test_bwd_gu_bf16_out_is_the_fp32_sum_rounded_once():
    """In bf16, as on the card: ``bwd_gu(out_dtype=bf16)`` (the weight grad
    the backward takes) equals its fp32 result rounded once, bit for bit,
    with dg | du computed inside and given; the bias grads stay fp32 and
    equal."""
    lhs, gu, dmid, gs = _bwd_gu_inputs(torch.bfloat16)
    fp32, db32 = tfem.bwd_gu(lhs, gu, dmid, gs, "swiglu_oai", None, True)
    _, dgdu = tfem.bwd_act(gu, dmid, gs, "swiglu_oai", want_mid=False)
    for kw in (dict(), dict(dgdu=dgdu)):
        bf16, db = tfem.bwd_gu(lhs, gu, dmid, gs, "swiglu_oai", None, True, out_dtype=torch.bfloat16, **kw)
        assert fp32.dtype == torch.float32 and bf16.dtype == torch.bfloat16 and db.dtype == torch.float32
        assert torch.equal(bf16, fp32.to(torch.bfloat16)) and torch.equal(db, db32)
        assert bool((bf16[1] == 0).all()) and float(bf16.float().abs().max()) > 0


@pytest.mark.parametrize("case", ["oai_empty_first_biased", "swiglu_limit_biased"])
def test_bwd_gu_bf16_out_matches_jax_bwd_gu_cast_to_bf16(case):
    """The backward's weight grad: the port's bf16 ``bwd_gu`` output against
    JAX's interpreted ``_bwd_gu`` cast with ``.astype(bf16)`` on the same
    fp32 (lhs, g, u, dmid): the two fp32 sums differ only in order (within
    the 2e-4 that ``test_plain_versions_match_the_pallas_kernels`` holds
    them to, which is all of an element that cancels to near 0), so each
    element is within one bf16 step of JAX's plus 2e-4 and at least 99%
    are equal; the bias grads, fp32 in both, within 2e-4."""
    act, limit, biased, sizes = CASES[case]
    c = _case(0, 128, 96, 80, sizes, biased)
    rng = np.random.default_rng(1)
    g, u, dmid = (rng.normal(size=(128, 80)).astype(np.float32) * 2 for _ in range(3))
    dwg, dwu, dgb, dub = jfem._bwd_gu(_j(c["lhs"]), _j(g), _j(u), _j(dmid), jnp.asarray(c["gs"]), act, limit, True,
                                      biased)
    want = torch.from_numpy(np.concatenate([np.asarray(dwg.astype(jnp.bfloat16).astype(jnp.float32)),
                                            np.asarray(dwu.astype(jnp.bfloat16).astype(jnp.float32))], -1))
    gu = torch.from_numpy(np.concatenate([g, u], -1))
    dw, dbias = tfem.bwd_gu(_t(c["lhs"]), gu, _t(dmid), torch.from_numpy(c["gs"]), act, limit, biased,
                            out_dtype=torch.bfloat16)
    assert dw.dtype == torch.bfloat16
    assert bool(((dw.float() - want).abs() <= want.abs() * 2.0**-7 + 2e-4).all())
    assert float((dw.float() == want).float().mean()) >= 0.99
    np.testing.assert_allclose(dbias.numpy(), np.concatenate([np.asarray(dgb), np.asarray(dub)], -1), atol=2e-4)


# the limits chip_smoke.py's phase 12 and tests/test_torch_cuda_kernels.py
# hold the fused expert-MLP kernels to: out per row, bias grads per expert row
FEM_ROW_TOL = 2.0**-7
FEM_BIAS_ROW_TOL = 2.0**-12


def _row_rel_err(out, ref) -> float:
    d = (out.float() - ref.float()).norm(dim=-1)
    return float((d / ref.float().norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("fault", ["gate_j_with_up_j_plus_8", "bias_sums_of_rounded_grads"])
def test_row_checks_see_the_epilogue_and_bias_sum_faults(fault):
    """On the CPU, in bf16 as on the card, at gpt-oss-20b's init scales and
    routing shape (8 experts, ~256 rows each, swiglu_oai with biases): the
    two mistakes the new kernels could make move the worst row past 4x the
    card's limits. The gate_up epilogue pairing gate column j with up
    column j + 8 (the next n8 chunk of the accumulator) moves ``out``; the
    bias grads summed from the bf16-rounded dg | du that ``bwd_act`` writes,
    instead of the unrounded fp32 values, move ``dbias``."""
    M, D, I, G = 2048, 128, 128, 8
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    bf = torch.bfloat16
    lhs, gate_up, down = r(M, D).to(bf), (r(G, D, 2 * I) / D**0.5).to(bf), (r(G, I, D) / I**0.5).to(bf)
    gub, db = (r(G, 2 * I) * 0.5).to(bf), (r(G, D) * 0.5).to(bf)
    cuts = torch.sort(torch.randint(1, M, (G - 1,), generator=g)).values
    gs = torch.diff(torch.cat([torch.tensor([0]), cuts, torch.tensor([M])])).to(torch.int32)
    if fault == "gate_j_with_up_j_plus_8":
        right = tfem._fwd_plain(lhs, gate_up, down, gs, gub, db, "swiglu_oai")
        shifted = gate_up.clone()
        shifted[..., I:] = torch.roll(gate_up[..., I:], -8, dims=-1)  # up column j + 8 beside gate column j
        wrong = tfem._fwd_plain(lhs, shifted, down, gs, gub, db, "swiglu_oai")
        assert _row_rel_err(wrong, right) > 4 * FEM_ROW_TOL
    else:
        dy = r(M, D).to(bf)
        gu = tfem.add_row_bias(tfem._gmm_plain(lhs, gate_up, gs), gub, gs)
        dmid = tfem._gmm_plain(dy, down, gs, transpose_rhs=True)
        _, right = tfem._bwd_gu_plain(lhs, gu, dmid, gs, "swiglu_oai", None, want_bias=True)
        _, dgdu = tfem._bwd_act_plain(gu, dmid, gs, "swiglu_oai", want_mid=False)
        wrong = torch.stack([dgdu[s:e].float().sum(dim=0) for s, e in tfem._bounds(gs, M)])
        assert _row_rel_err(wrong, right) > 4 * FEM_BIAS_ROW_TOL

"""The torch port's MoE layers (automodel_tpu_torch/moe) against the JAX
package on the CPU: the gate in its routing modes (the gpt-oss learned
router bias included), fake balanced routing, the aux-free bias update,
``make_act2``'s ``swiglu_oai``, the ragged, ragged_fused and dense experts
backends with and without the gpt-oss expert biases (forward and grads,
JAX's ragged and ragged_fused backends through their Pallas kernels in
interpret mode), ``gspmd`` against JAX's with picks dropped, ``gspmd``
and ``a2a`` / ``a2a_fused`` over ep = 2 and 4 virtual ranks in one process
against one process and JAX (its ragged, or its per-device a2a body where
a bounded chunk drops picks), and the whole MoE block with shared
experts. The same numpy-made fp32 inputs go to both; tolerances are
stated per test."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_parity  # noqa: F401  (caps torch at one thread)

# the JAX moe package exports functions under its modules' names
jcfg, jexp, jgate, jlayer = (importlib.import_module(f"automodel_tpu.moe.{m}")
                             for m in ("config", "experts", "gate", "layer"))
from automodel_tpu_torch.moe import config as tcfg
from automodel_tpu_torch.moe import experts as texp
from automodel_tpu_torch.moe import gate as tgate
from automodel_tpu_torch.moe import layer as tlayer


def _cfgs(**kw):
    return jcfg.MoEConfig(**kw), tcfg.MoEConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


GATE_CASES = {
    "softmax_norm_aux": dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=8,
                             norm_topk_prob=True, aux_loss_coeff=0.01),
    "sigmoid_bias_scale": dict(num_experts=16, num_experts_per_tok=4, moe_intermediate_size=8,
                               score_func="sigmoid", expert_bias=True, route_scale=2.5, norm_topk_prob=True),
    "grouped_routing": dict(num_experts=16, num_experts_per_tok=3, moe_intermediate_size=8,
                            score_func="sigmoid", n_group=4, topk_group=2, aux_loss_coeff=0.001),
    "softmax_after_topk": dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=8,
                               softmax_before_topk=False),
    # gpt-oss: a learned router bias, softmax over the picked logits, and the
    # aux loss, whose "probs" are then the raw logits (JAX :97-99)
    "linear_bias_softmax_after_topk_aux": dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=8,
                                               softmax_before_topk=False, router_linear_bias=True,
                                               aux_loss_coeff=0.01),
}


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_gate_matches_jax(name):
    """Expert ids and counts exactly; weights and the aux loss (with its
    router grad) to 1e-6 (fp32, same reductions)."""
    jc, tc = _cfgs(**GATE_CASES[name])
    rng = np.random.default_rng(0)
    T, D, E = 24, 16, jc.num_experts
    x = rng.normal(size=(T, D)).astype(np.float32)
    w = (rng.normal(size=(D, E)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(E,)) * 0.1).astype(np.float32) if jc.expert_bias else None
    lb = (rng.normal(size=(E,)) * 0.5).astype(np.float32) if jc.router_linear_bias else None
    opt = lambda a, f: None if a is None else f(a)
    jout = jgate.gate(jnp.asarray(x), jnp.asarray(w), jc, bias=opt(bias, jnp.asarray), seq_len=8,
                      linear_bias=opt(lb, jnp.asarray))
    tw = torch.tensor(w.T.copy(), requires_grad=True)
    tlb = opt(lb, lambda a: torch.tensor(a, requires_grad=True))
    tout = tgate.gate(_t(x), tw, tc, bias=opt(bias, _t), seq_len=8, linear_bias=tlb)
    np.testing.assert_array_equal(tout.topk_idx.numpy(), np.asarray(jout.topk_idx))
    np.testing.assert_array_equal(tout.expert_counts.numpy(), np.asarray(jout.expert_counts))
    assert tout.expert_counts.dtype == torch.int32
    np.testing.assert_allclose(tout.topk_weights.detach().numpy(), np.asarray(jout.topk_weights), atol=1e-6)
    np.testing.assert_allclose(float(tout.aux_loss.detach()), float(jout.aux_loss), rtol=1e-6, atol=1e-9)
    if jc.aux_loss_coeff > 0:
        jlb = opt(lb, jnp.asarray)
        jg = jax.grad(lambda ww: jgate.gate(jnp.asarray(x), ww, jc, seq_len=8, linear_bias=jlb).aux_loss)(
            jnp.asarray(w))
        tout.aux_loss.backward(retain_graph=True)
        np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jg), rtol=1e-5, atol=1e-9)
    if tlb is not None:
        # the learned bias feeds the combine weights as well: the router's
        # grads (weight and bias) through both (fp32, 1e-6)
        wsum = rng.normal(size=(T, jc.num_experts_per_tok)).astype(np.float32)

        def jloss(ww, lbb):
            out = jgate.gate(jnp.asarray(x), ww, jc, seq_len=8, linear_bias=lbb)
            return out.aux_loss + (out.topk_weights * jnp.asarray(wsum)).sum()

        jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(lb))
        tw.grad, tlb.grad = None, None
        (tout.aux_loss + (tout.topk_weights * _t(wsum)).sum()).backward()
        np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jg[0]), atol=1e-6)
        np.testing.assert_allclose(tlb.grad.numpy(), np.asarray(jg[1]), atol=1e-6)


def test_gate_breaks_ties_toward_the_lower_index():
    jc, tc = _cfgs(num_experts=8, num_experts_per_tok=3, moe_intermediate_size=4)
    x = np.ones((4, 2), np.float32)
    w = np.zeros((2, 8), np.float32)
    w[:, 5] = 1.0  # expert 5 wins, the rest tie
    jidx = np.asarray(jgate.gate(jnp.asarray(x), jnp.asarray(w), jc).topk_idx)
    tidx = tgate.gate(_t(x), _t(w.T.copy()), tc).topk_idx.numpy()
    np.testing.assert_array_equal(tidx, jidx)
    assert tidx[0].tolist() == [5, 0, 1]


def test_fake_balanced_gate_and_bias_update_match_jax():
    jc, tc = _cfgs(num_experts=8, num_experts_per_tok=3, moe_intermediate_size=4, route_scale=1.5)
    x = np.zeros((10, 4), np.float32)
    jout = jgate.fake_balanced_gate(jnp.asarray(x), jc, offset=2)
    tout = tgate.fake_balanced_gate(_t(x), tc, offset=2)
    np.testing.assert_array_equal(tout.topk_idx.numpy(), np.asarray(jout.topk_idx))
    np.testing.assert_array_equal(tout.expert_counts.numpy(), np.asarray(jout.expert_counts))
    np.testing.assert_allclose(tout.topk_weights.numpy(), np.asarray(jout.topk_weights))
    bias = np.linspace(-0.1, 0.1, 8).astype(np.float32)
    counts = np.array([3, 9, 4, 4, 0, 12, 4, 4], np.int32)
    want = jgate.update_gate_bias(jnp.asarray(bias), jnp.asarray(counts), 0.001)
    np.testing.assert_allclose(tgate.update_gate_bias(_t(bias), _t(counts), 0.001).numpy(), np.asarray(want))


def _expert_inputs(seed=3, T=48, D=32, E=8, I=24, biased=False):
    rng = np.random.default_rng(seed)
    a = dict(
        x=rng.normal(size=(T, D)).astype(np.float32),
        router=(rng.normal(size=(D, E)) * 0.1).astype(np.float32),
        gate_up=(rng.normal(size=(E, D, 2 * I)) * 0.1).astype(np.float32),
        down=(rng.normal(size=(E, I, D)) * 0.1).astype(np.float32),
        dout=rng.normal(size=(T, D)).astype(np.float32),
    )
    if biased:
        a.update(gate_up_bias=(rng.normal(size=(E, 2 * I)) * 0.5).astype(np.float32),
                 down_bias=(rng.normal(size=(E, D)) * 0.5).astype(np.float32))
    return a


def test_make_act2_swiglu_oai_matches_jax():
    """gpt-oss's clamped activation and its grads against JAX's make_act2,
    with entries beyond and exactly at the +-7 clamps (fp32, 1e-6; JAX's
    minimum and maximum give half the gradient at a tie)."""
    jc, tc = _cfgs(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=8, activation="swiglu_oai")
    rng = np.random.default_rng(2)
    g, u, d = (rng.normal(size=(16, 8)).astype(np.float32) * 6 for _ in range(3))
    g[0, :4], u[1, :4], u[2, :4] = 7.0, 7.0, -7.0
    ja = jlayer.make_act2(jc, jax.nn.silu)
    jy, vjp = jax.vjp(ja, jnp.asarray(g), jnp.asarray(u))
    jdg, jdu = vjp(jnp.asarray(d))
    tg, tu = (torch.tensor(a, requires_grad=True) for a in (g, u))
    ty = tlayer.make_act2(tc, torch.nn.functional.silu)(tg, tu)
    ty.backward(_t(d))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jdg), atol=1e-6)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jdu), atol=1e-6)


@pytest.mark.parametrize("backend", ["ragged_fused", "ragged", "dense"])
def test_biased_oai_experts_match_jax_ragged_fused_kernels(backend, monkeypatch):
    """gpt-oss experts (swiglu_oai, gate_up_bias and down_bias, a learned
    router bias, softmax after top-k) through the port's ragged_fused
    (the fused expert-MLP autograd over the plain versions), ragged and
    dense backends, against JAX's ragged_fused backend through its Pallas
    kernels (interpreted): the output and the grads of x, the router, its
    bias and the four expert tensors, to 5e-4 (tests/test_fused_backward.py
    holds JAX's fused kernels to its composition at the same)."""
    monkeypatch.setenv("AUTOMODEL_GMM_INTERPRET", "1")
    kw = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=24, softmax_before_topk=False,
              router_linear_bias=True, expert_mlp_bias=True, activation="swiglu_oai")
    jc, tc = _cfgs(**kw)
    a = _expert_inputs(biased=True)
    a["linear_bias"] = (np.random.default_rng(9).normal(size=(8,)) * 0.3).astype(np.float32)
    names = ("x", "router", "linear_bias", "gate_up", "down", "gate_up_bias", "down_bias")

    def jfn(x, router, lb, gu, dn, gub, db):
        gout = jgate.gate(x, router, jc, linear_bias=lb)
        w = {"gate_up": gu, "down": dn, "gate_up_bias": gub, "down_bias": db}
        out = jexp.ragged_fused_experts(x, gout, w, jc, jlayer.make_act2(jc, jax.nn.silu))
        return (out * a["dout"]).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=tuple(range(7)), has_aux=True)(
        *(jnp.asarray(a[k]) for k in names)
    )
    t = {k: torch.tensor(a[k] if k != "router" else a[k].T.copy(), requires_grad=True) for k in names}
    gout = tgate.gate(t["x"], t["router"], tc, linear_bias=t["linear_bias"])
    w = {k: t[k] for k in ("gate_up", "down", "gate_up_bias", "down_bias")}
    out = texp.expert_backend(backend)(t["x"], gout, w, tc, tlayer.make_act2(tc, torch.nn.functional.silu))
    (out * _t(a["dout"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-4)
    for name, want in zip(names, jgrads):
        got = t[name].grad.t() if name == "router" else t[name].grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, err_msg=name)


def test_ragged_fused_refuses_another_base_activation():
    _, tc = _cfgs(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=8)
    with pytest.raises(ValueError, match="ragged_fused.*'gelu'"):
        texp._fused_act_of(tc, "gelu")
    assert texp._fused_act_of(tc, "silu") == ("swiglu", None)


@pytest.mark.parametrize("backend", ["ragged", "dense", "ragged_fused"])
def test_experts_forward_and_grads_match_jax_ragged_kernels(backend, monkeypatch):
    """Port ragged (the plain gmm/tgmm), ragged_fused (the plain fused
    expert MLP) and dense against JAX's ragged backend through its Pallas
    kernels (interpreted): the output and the grads of x, the router and
    both expert weights, to 2e-4 (the test at
    tests/test_grouped_matmul.py:70 holds JAX's own two backends to the
    same)."""
    monkeypatch.setenv("AUTOMODEL_GMM_INTERPRET", "1")
    jc, tc = _cfgs(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=24, norm_topk_prob=True)
    a = _expert_inputs()

    def jfn(x, router, gu, dn):
        gout = jgate.gate(x, router, jc)
        out = jexp.ragged_experts(x, gout, {"gate_up": gu, "down": dn}, jc, lambda g, u: jax.nn.silu(g) * u)
        return (out * a["dout"]).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a[k]) for k in ("x", "router", "gate_up", "down"))
    )
    x, router, gu, dn = (torch.tensor(v, requires_grad=True) for v in (a["x"], a["router"].T.copy(), a["gate_up"], a["down"]))
    gout = tgate.gate(x, router, tc)
    act2 = lambda g, u: torch.nn.functional.silu(g) * u
    out = texp.expert_backend(backend)(x, gout, {"gate_up": gu, "down": dn}, tc, act2)
    (out * _t(a["dout"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-4)
    for got, want in zip((x.grad, router.grad.t(), gu.grad, dn.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_unported_expert_backends_raise_by_name():
    """Every experts backend of the JAX package runs in the port (gspmd,
    a2a and a2a_fused are held to JAX below); fp8 experts and an unknown
    backend still raise by name."""
    from automodel_tpu_torch.models.common.config import BackendConfig

    for name in ("gspmd", "a2a", "a2a_fused"):
        assert callable(texp.expert_backend(name))
        assert BackendConfig(experts=name).experts == name
    with pytest.raises(ValueError, match="fp8_experts"):
        BackendConfig.from_dict({"experts": "ragged", "fp8_experts": True})
    with pytest.raises(ValueError, match="experts='bogus'"):
        BackendConfig(experts="bogus")
    with pytest.raises(ValueError, match="experts='bogus'"):
        texp.expert_backend("bogus")
    # the backend config's names are the experts module's
    from automodel_tpu_torch.models.common.config import EXPERTS_NAMES

    assert set(EXPERTS_NAMES) == set(texp.EXPERT_BACKENDS) == set(jexp.EXPERT_BACKENDS)


def _silu2(g, u):
    return torch.nn.functional.silu(g) * u


def _jsilu2(g, u):
    return jax.nn.silu(g) * u


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_gspmd_experts_match_jax(capacity_factor):
    """gspmd against JAX's gspmd_experts on x [B, S, D] = [3, 16, 32], 8
    experts, top-2: at a capacity factor of 0.5 picks drop (the check says
    how many), at 1.25 (the default) some may, at 4.0 none. The output and
    the grads of x, the router and both expert slabs to 1e-5 (fp32, the
    same one-hot einsums; sums of K terms in another order)."""
    kw = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=24, norm_topk_prob=True,
              capacity_factor=capacity_factor)
    jc, tc = _cfgs(**kw)
    B, S = 3, 16
    a = _expert_inputs(T=B * S)
    x3 = a["x"].reshape(B, S, -1)

    def jfn(x, router, gu, dn):
        gout = jgate.gate(x.reshape(B * S, -1), router, jc)
        out = jexp.gspmd_experts(x, gout, {"gate_up": gu, "down": dn}, jc, _jsilu2)
        return (out * a["dout"].reshape(B, S, -1)).sum(), (out, gout.topk_idx)

    (_, (jout, jidx)), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x3), *(jnp.asarray(a[k]) for k in ("router", "gate_up", "down"))
    )
    x, router, gu, dn = (torch.tensor(v, requires_grad=True) for v in (x3, a["router"].T.copy(), a["gate_up"], a["down"]))
    gout = tgate.gate(x.reshape(B * S, -1), router, tc)
    out = texp.expert_backend("gspmd")(x, gout, {"gate_up": gu, "down": dn}, tc, _silu2)
    (out * _t(a["dout"]).reshape(B, S, -1)).sum().backward()
    # picks past capacity: per row and expert, the load over the capacity
    idx = np.asarray(jidx).reshape(B, S * 2)
    cap = max(2, int(np.ceil(S * 2 / 8 * capacity_factor)))
    dropped = sum(max(0, int((idx[b] == e).sum()) - cap) for b in range(B) for e in range(8))
    assert dropped > 0 if capacity_factor == 0.5 else dropped == 0 if capacity_factor == 4.0 else True, dropped
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    for got, want in zip((x.grad, router.grad.t(), gu.grad, dn.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ep", [2, 4])
def test_gspmd_ranks_match_one_process(ep):
    """gspmd over ep = 2 and 4 virtual ranks in one process (each rank's
    batch rows dispatched, its experts' slots gathered from every rank, run
    on its E / ep slabs and sent back) against gspmd on the whole batch in
    one process, at a capacity factor where picks drop (capacity is per
    row, so the split changes nothing): output and grads to 1e-6."""
    _, tc = _cfgs(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=24, norm_topk_prob=True,
                  capacity_factor=0.5)
    B, S = 4, 12
    a = _expert_inputs(T=B * S)

    def run(split: bool):
        t = {k: torch.tensor(a[k] if k != "router" else a[k].T.copy(), requires_grad=True)
             for k in ("x", "router", "gate_up", "down")}
        w = {"gate_up": t["gate_up"], "down": t["down"]}
        x = t["x"].reshape(B, S, -1)
        if split:
            xs = list(x.chunk(ep))
            gouts = [tgate.gate(xr.reshape(-1, xr.shape[-1]), t["router"], tc) for xr in xs]
            out = torch.cat(texp.gspmd_forward_ranks(xs, gouts, w, tc, _silu2))
        else:
            out = texp.expert_backend("gspmd")(x, tgate.gate(t["x"], t["router"], tc), w, tc, _silu2)
        (out * _t(a["dout"]).reshape(B, S, -1)).sum().backward()
        return [out.detach()] + [t[k].grad for k in ("x", "router", "gate_up", "down")]

    for got, want in zip(run(True), run(False)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def _rank_gates(tc, x, router, ep):
    """Each virtual rank's tokens [T / ep, D] and its gate output."""
    xs = list(x.chunk(ep))
    return xs, [tgate.gate(xr, router, tc) for xr in xs]


@pytest.mark.parametrize("a2a_capacity_factor", [None, 1.0])
@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("backend", ["a2a", "a2a_fused"])
def test_a2a_ranks_match_one_process_and_jax_ragged(backend, ep, a2a_capacity_factor, monkeypatch):
    """The token exchange over ep = 2 and 4 virtual ranks in one process
    (each rank's 48 / ep tokens packed, exchanged, run through its local
    experts with the plain grouped matmuls (a2a) or the plain fused expert
    MLP (a2a_fused), exchanged back and combined), against the same
    backend in one process (no group: the ragged path over all 48
    tokens) and against JAX's ragged backend through its Pallas kernels
    (interpreted): the output and the grads of x, the router and both
    expert slabs, to 1e-5 against one process and 2e-4 against JAX (the
    tolerance of the ragged test above). At the strict chunk size nothing
    drops; at an a2a_capacity_factor of 1.0 (chunks of the balanced load)
    the outputs of the picks past a chunk are zero in both packages, and
    JAX's a2a body is then the reference, driven by its own per-rank
    arithmetic on the same chunks."""
    monkeypatch.setenv("AUTOMODEL_GMM_INTERPRET", "1")
    kw = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=24, norm_topk_prob=True,
              a2a_capacity_factor=a2a_capacity_factor)
    jc, tc = _cfgs(**kw)
    a = _expert_inputs()
    fused = texp._fused_act_of(tc, "silu") if backend == "a2a_fused" else None

    def run(split: bool):
        t = {k: torch.tensor(a[k] if k != "router" else a[k].T.copy(), requires_grad=True)
             for k in ("x", "router", "gate_up", "down")}
        w = {"gate_up": t["gate_up"], "down": t["down"]}
        if split:
            xs, gouts = _rank_gates(tc, t["x"], t["router"], ep)
            out = torch.cat(texp.a2a_forward_ranks(xs, gouts, w, tc, _silu2, fused))
        else:
            gout = tgate.gate(t["x"], t["router"], tc)
            out = texp.expert_backend(backend)(t["x"][None], gout, w, tc, _silu2)[0]
        (out * _t(a["dout"])).sum().backward()
        return out.detach(), [t[k].grad for k in ("x", "router", "gate_up", "down")]

    out, grads = run(split=True)
    if a2a_capacity_factor is None:
        one, one_grads = run(split=False)
        np.testing.assert_allclose(out.numpy(), one.numpy(), atol=1e-5)
        for got, want in zip(grads, one_grads):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)

        def jfn(x, router, gu, dn):
            gout = jgate.gate(x, router, jc)
            o = jexp.ragged_experts(x, gout, {"gate_up": gu, "down": dn}, jc, _jsilu2)
            return (o * a["dout"]).sum(), o
    else:
        # JAX's per-device body over the same chunks, one rank after another
        # through a stand-in all_to_all that stacks the ranks' buffers (its
        # ragged_dot through XLA's: the kernels were held above)
        monkeypatch.delenv("AUTOMODEL_GMM_INTERPRET")

        def jfn(x, router, gu, dn):
            outs = jax_a2a_ranks(jc, x, router, gu, dn, ep)
            o = jnp.concatenate(outs)
            return (o * a["dout"]).sum(), o

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a[k]) for k in ("x", "router", "gate_up", "down"))
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-4)
    for got, want, name in zip(grads, jgrads, ("x", "router", "gate_up", "down")):
        got = got.t() if name == "router" else got
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, err_msg=name)


def jax_a2a_ranks(jc, x, router, gu, dn, ep):
    """JAX's ``_a2a_body`` for each of ``ep`` virtual ranks in turn, its
    ``all_to_all`` replaced by the exchange of the ranks' buffers it would
    make: each body runs twice, first to collect every rank's send buffers,
    then with the received chunks (``jax.lax.all_to_all`` patched)."""
    E, K = jc.num_experts, jc.num_experts_per_tok
    E_loc = E // ep
    xs = jnp.split(x, ep)
    T = xs[0].shape[0]
    cap = min(T * min(K, E_loc), int(np.ceil(jc.a2a_capacity_factor * T * K / ep)))
    C = -(-cap // 8) * 8
    gouts = [jgate.gate(xr, router, jc) for xr in xs]
    wd = jexp._a2a_weights({"gate_up": gu, "down": dn}, jc)
    act2 = _jsilu2
    real = jax.lax.all_to_all
    sent: dict = {}

    def exchange(bufs):
        return [jnp.concatenate([bufs[p][r * C:(r + 1) * C] for p in range(ep)]) for r in range(ep)]

    outs = []
    try:
        # pass 1: every rank's first two all_to_all operands (rows, ids);
        # pass 2: each rank's third (its expert rows, to be sent back)
        for phase in ("send", "back", "final"):
            for r in range(ep):
                calls = [0]

                def fake(arr, *args, r=r, **kw):
                    i = calls[0]
                    calls[0] += 1
                    sent.setdefault((phase, i), {})[r] = arr
                    if phase == "send":
                        return arr  # placeholder, not used
                    if i < 2:
                        return exchange([sent[("send", i)][p] for p in range(ep)])[r]
                    if phase == "back":
                        return arr
                    return exchange([sent[("back", 2)][p] for p in range(ep)])[r]

                jax.lax.all_to_all = fake
                wl = {k: v[r * E_loc:(r + 1) * E_loc] for k, v in wd.items()}
                o = jexp._a2a_body(
                    xs[r][None], gouts[r].topk_idx.reshape(1, T, K), gouts[r].topk_weights.reshape(1, T, K), wl,
                    ep=ep, ep_axis="ep", E=E, E_loc=E_loc, C=C, D=x.shape[-1], K=K, act2=act2,
                )
                if phase == "final":
                    outs.append(o[0])
    finally:
        jax.lax.all_to_all = real
    return outs


@pytest.mark.parametrize("backend", ["ragged", "dense"])
def test_moe_block_with_shared_experts_matches_jax(backend):
    """moe_block with a shared expert and the sigmoid shared-expert gate
    (qwen2-moe style) and the aux loss: output, counts and aux against
    JAX's moe_block, same weights (fp32, 1e-5)."""
    kw = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16, norm_topk_prob=True,
              num_shared_experts=1, shared_expert_intermediate_size=24, shared_expert_gate=True,
              aux_loss_coeff=0.01)
    jc, tc = _cfgs(**kw)
    D = 32
    mp = jlayer.init_moe_params(jax.random.key(4), jc, D, jnp.float32)
    # a non-zero shared gate, so its path is exercised
    mp["shared_gate"]["kernel"] = jax.random.normal(jax.random.key(5), (D, 1)) * 0.3
    x = np.random.default_rng(6).normal(size=(2, 12, D)).astype(np.float32)
    jout, jaux = jlayer.moe_block(jnp.asarray(x), mp, jc, jax.nn.silu, experts_backend="dense")
    block = tlayer.MoEBlock(tc, D, torch.float32, torch.device("cpu"))
    np_ = jax.tree.map(np.asarray, mp)
    sd = {
        "gate.weight": np_["router"]["weight"].T,
        "experts.gate_up": np_["experts"]["gate_up"],
        "experts.down": np_["experts"]["down"],
        "shared_experts.gate_proj.weight": np_["shared"]["gate_proj"]["kernel"].T,
        "shared_experts.up_proj.weight": np_["shared"]["up_proj"]["kernel"].T,
        "shared_experts.down_proj.weight": np_["shared"]["down_proj"]["kernel"].T,
        "shared_expert_gate.weight": np_["shared_gate"]["kernel"].T,
    }
    block.load_state_dict({k: _t(v) for k, v in sd.items()})
    out, aux = tlayer.moe_block(_t(x), block, torch.nn.functional.silu, backend)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_array_equal(aux.expert_counts.numpy(), np.asarray(jaux.expert_counts))
    np.testing.assert_allclose(float(aux.aux_loss.detach()), float(jaux.aux_loss), rtol=1e-6)


def test_moe_config_from_hf_matches_jax():
    hf = dict(num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768, norm_topk_prob=True,
              router_aux_loss_coef=0.001, n_group=1, first_k_dense_replace=0)
    want = dataclasses.asdict(jcfg.MoEConfig.from_hf(lambda k, d=None: hf.get(k, d)))
    got = dataclasses.asdict(tcfg.MoEConfig.from_hf(lambda k, d=None: hf.get(k, d)))
    # the gspmd / a2a dispatchers' capacity factors included
    assert got == want and got["capacity_factor"] == 1.25 and got["a2a_capacity_factor"] is None
    with pytest.raises(ValueError, match="n_group"):
        tcfg.MoEConfig(num_experts=6, num_experts_per_tok=2, moe_intermediate_size=4, n_group=4)


@pytest.mark.parametrize("field,value", [("interleaved_gate_up", True), ("activation", "relu2"),
                                         ("activation_limit", 7.0)])
def test_moe_config_refuses_the_unported_expert_variants_by_name(field, value):
    """Interleaved gate/up (which the JAX gpt-oss config keeps off), relu2
    experts (nemotron_v3) and the activation limit (step3p5) are not ported:
    each field that would turn them on raises naming itself (JAX's
    MoEConfig takes them). The gpt-oss fields are taken."""
    kw = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=4, **{field: value})
    jcfg.MoEConfig(**kw)
    with pytest.raises(ValueError, match=f"MoEConfig.{field}="):
        tcfg.MoEConfig(**kw)
    tcfg.MoEConfig(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=4, expert_mlp_bias=True,
                   activation="swiglu_oai", router_linear_bias=True)

"""Tensor parallelism of the port's MoE experts (``automodel_tpu_torch/moe/
experts.py``) against the JAX package at tiny sizes.

- ``a2a`` and ``a2a_fused`` over ep = 2 x tp = 2 virtual ranks in one
  process (``a2a_forward_ranks(..., tp=2)``: each tp rank's I-shard of the
  local experts, the down bias on tp rank 0, the fp32 partials summed)
  against JAX's ``moe_block`` on an ep = 2 x tp = 2 mesh of the suite's
  virtual CPU devices, the setups of ``tests/test_moe.py::
  test_a2a_matches_dense_on_ep_tp_mesh`` and ``test_a2a_fused_matches_a2a``
  (silu, and biased ``swiglu_oai``): the output and the grads of x, the
  router and every slab. JAX's fused kernel runs interpreted.
- The other backends (``dense``, ``ragged``, ``ragged_fused``, ``gspmd``)
  over tp = 2 virtual ranks (``_tp_forward_ranks``) against JAX's backend
  on the whole slabs (what GSPMD's I-split computes).
- The I-block exchange that turns a rank's canonical ``Shard(-1)`` shard
  of [gate | up] into its ``[g_r | u_r]`` (``_gate_up_routes``), simulated
  rank by rank at tp = 2, 3 and 4, forward and backward routes.

Tolerance: fp32; the same products summed in another order (over the tp
shards, the ranks' chunks): 2e-4 absolute on the outputs and grads, the
tolerance of JAX's own a2a tests.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_parity  # noqa: F401  (caps torch at one thread)

jcfg, jexp, jgate, jlayer = (importlib.import_module(f"automodel_tpu.moe.{m}")
                             for m in ("config", "experts", "gate", "layer"))
from automodel_tpu_torch.moe import config as tcfg
from automodel_tpu_torch.moe import experts as texp
from automodel_tpu_torch.moe import gate as tgate
from automodel_tpu_torch.moe import layer as tlayer

TOL = dict(atol=2e-4, rtol=0)
EP, TP = 2, 2


def _cfgs(**kw):
    return jcfg.MoEConfig(**kw), tcfg.MoEConfig(**kw)


def _weights(rng, E: int, D: int, I: int, biased: bool) -> dict:
    w = dict(gate_up=rng.normal(size=(E, D, 2 * I)) * 0.2, down=rng.normal(size=(E, I, D)) * 0.2)
    if biased:
        w.update(gate_up_bias=rng.normal(size=(E, 2 * I)) * 0.3, down_bias=rng.normal(size=(E, D)) * 0.3)
    return {k: v.astype(np.float32) for k, v in w.items()}


CASES = {
    "silu": dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, norm_topk_prob=True),
    "swiglu_oai_biased": dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                              activation="swiglu_oai", expert_mlp_bias=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["a2a", "a2a_fused"])
def test_a2a_ep2_tp2_matches_jax_on_an_ep_tp_mesh(devices8, backend, case, monkeypatch):
    from automodel_tpu.parallel.mesh import MeshConfig, build_mesh
    from automodel_tpu.parallel.plans import make_constrain, shard_params

    monkeypatch.setenv("AUTOMODEL_GMM_INTERPRET", "1")
    kw = CASES[case]
    jc, tc = _cfgs(**kw)
    T, D = 64, 16
    rng = np.random.default_rng(0)
    w = _weights(rng, jc.num_experts, D, jc.moe_intermediate_size, jc.expert_mlp_bias)
    router = (rng.normal(size=(D, jc.num_experts)) * 0.5).astype(np.float32)
    x = rng.normal(size=(EP, T // EP, D)).astype(np.float32)
    dout = rng.normal(size=(EP, T // EP, D)).astype(np.float32)

    ctx = build_mesh(MeshConfig(dp_shard=EP, ep=EP, tp=TP), devices=devices8[: EP * TP])
    constrain = make_constrain(ctx)
    jp = {"router": {"weight": jnp.asarray(router)}, "experts": {k: jnp.asarray(v) for k, v in w.items()}}
    ps = shard_params(ctx, jp, jlayer.MOE_SHARDING_RULES)
    xs = jax.device_put(jnp.asarray(x), ctx.sharding("batch", None, None))

    def jloss(p_, x_):
        out, _ = jlayer.moe_block(x_, p_, jc, jax.nn.silu, experts_backend=backend, constrain=constrain)
        return (out * dout).sum(), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(ps, xs)

    t = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    tr = torch.tensor(router.T.copy(), requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    act2 = tlayer.make_act2(tc, torch.nn.functional.silu)
    fused = texp._fused_act_of(tc, "silu") if backend == "a2a_fused" else None
    gouts = [tgate.gate(tx[r], tr, tc, seq_len=T // EP) for r in range(EP)]
    outs = texp.a2a_forward_ranks([tx[r] for r in range(EP)], gouts, t, tc, act2, fused, tp=TP)
    out = torch.stack(outs)
    (out * torch.from_numpy(dout)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(tr.grad.numpy().T, np.asarray(jgp["router"]["weight"]), **TOL)
    for k in w:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(jgp["experts"][k]), err_msg=k, **TOL)


def _tp_forward_ranks(fn, x, gate_out, weights: dict, tp: int, **kw):
    """A backend over every rank of a virtual tp group: each tp rank's fp32
    partial from its I-shard of the whole slabs (``tp_local_slabs``),
    summed, in x's dtype (``moe_block``'s sum over the tp group)."""
    out = sum(fn(x, gate_out, texp.tp_local_slabs(weights, t, tp), partial=True, **kw) for t in range(tp))
    return out.to(x.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["dense", "ragged", "ragged_fused", "gspmd"])
def test_backends_at_tp2_match_jax(backend, case, monkeypatch):
    monkeypatch.setenv("AUTOMODEL_GMM_INTERPRET", "1")
    kw = dict(CASES[case], capacity_factor=1.25)
    jc, tc = _cfgs(**kw)
    B, S, D = 2, 24, 16
    rng = np.random.default_rng(1)
    w = _weights(rng, jc.num_experts, D, jc.moe_intermediate_size, jc.expert_mlp_bias)
    router = (rng.normal(size=(D, jc.num_experts)) * 0.5).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, D)).astype(np.float32)
    jact2 = jlayer.make_act2(jc, jax.nn.silu)
    jfn = {"dense": jexp.dense_experts, "ragged": jexp.ragged_experts, "ragged_fused": jexp.ragged_fused_experts,
           "gspmd": jexp.gspmd_experts}[backend]

    def jloss(x_, r_, w_):
        gout = jgate.gate(x_.reshape(-1, D), r_, jc)
        xin = x_ if backend == "gspmd" else x_.reshape(-1, D)
        out = jfn(xin, gout, w_, jc, jact2).reshape(B, S, D)
        return (out * dout).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(router), {k: jnp.asarray(v) for k, v in w.items()})

    t = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    tr = torch.tensor(router.T.copy(), requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    gout = tgate.gate(tx.reshape(-1, D), tr, tc)
    act2 = tlayer.make_act2(tc, torch.nn.functional.silu)
    out = _tp_forward_ranks(texp.expert_backend(backend), tx, gout, t, TP, cfg=tc, act2=act2)
    (out * torch.from_numpy(dout)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(tr.grad.numpy().T, np.asarray(jg[1]), **TOL)
    for k in w:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(jg[2][k]), err_msg=k, **TOL)


def _all_to_all(bufs: list, in_splits: list) -> list:
    """``all_to_all_single`` of lists of blocks over ranks in one process:
    rank r gets, in source order, the blocks each source sends it."""
    tp = len(bufs)
    starts = [np.cumsum([0] + s[:-1]).tolist() for s in in_splits]
    return [[blk for src in range(tp) for blk in bufs[src][starts[src][r]:starts[src][r] + in_splits[src][r]]]
            for r in range(tp)]


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_gate_up_exchange_gives_each_rank_its_gate_and_up_blocks(tp):
    """``_TPGateUp``'s routes, simulated: each rank sends the I-blocks of
    its canonical ``Shard(-1)`` shard of [gate | up] where
    ``_gate_up_routes`` says, and every rank ends with ``tp_local_slabs``'
    ``[g_r | u_r]``; the backward's routes bring each block of a gradient
    back to the shard it came from, in its place."""
    I, rows = 4 * tp, 3
    w = torch.arange(rows * 2 * I, dtype=torch.float32).reshape(rows, 2 * I)
    shards = list(w.chunk(tp, dim=-1))
    b = I // tp
    routes = [texp._gate_up_routes(tp, r) for r in range(tp)]
    sent = [[shards[r][:, :b], shards[r][:, b:]][::-1 if routes[r][2] else 1] for r in range(tp)]
    got = _all_to_all(sent, [rt[0] for rt in routes])
    for r in range(tp):
        assert sum(routes[r][0]) == sum(routes[r][1]) == 2
        want = texp.tp_local_slabs({"gate_up": w[None]}, r, tp)["gate_up"][0]
        assert torch.equal(torch.cat(got[r], dim=-1), want), r
    back = _all_to_all(got, [rt[1] for rt in routes])
    for r in range(tp):
        blocks = back[r][::-1] if routes[r][2] else back[r]
        assert torch.equal(torch.cat(blocks, dim=-1), shards[r]), r

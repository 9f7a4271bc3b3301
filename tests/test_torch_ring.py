"""The port's context-parallel ring (automodel_tpu_torch/parallel/cp.py)
against the JAX package's on the CPU.

The zigzag layout functions must equal JAX's. The ring is driven in one
process (``ring_forward_ranks`` / ``ring_backward_ranks``: every rank's
steps in ring order through the same step and merge functions the real
ring runs) at cp = 2 and 4, and the stitched output and grads are held to
JAX's ``make_ring_attention`` on the suite's virtual CPU devices (its ring
on the CPU is its XLA formulation), with GQA, packed segments, a sliding
window, sinks, the soft cap and zigzag, after tests/test_ring_attention.py
and test_ring_flash.py. The inputs come from numpy with a seed. Tolerance:
fp32 on both sides, the sums taken in another order (blockwise online
softmax against one softmax per ring step): out 2e-5, grads 5e-5 absolute
with 1e-3 relative, as JAX's own ring tests hold its ring to sdpa.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_parity import to_np  # noqa: F401  (caps torch at one thread)

from automodel_tpu.ops import ring_flash as jrf
from automodel_tpu.parallel import cp as jcp
from automodel_tpu.parallel.mesh import MeshConfig, build_mesh
from automodel_tpu_torch.ops import attention as tattn
from automodel_tpu_torch.ops import ring_flash as trf
from automodel_tpu_torch.parallel import cp as tcp

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=5e-5)


@pytest.mark.parametrize("seq,cp", [(32, 2), (64, 4), (48, 3)])
def test_zigzag_functions_equal_jax(seq, cp):
    np.testing.assert_array_equal(tcp.zigzag_indices(seq, cp), jcp.zigzag_indices(seq, cp))
    x = np.random.default_rng(0).standard_normal((2, seq, 3)).astype(np.float32)
    z = tcp.apply_zigzag(x, cp)
    np.testing.assert_array_equal(z, np.asarray(jcp.apply_zigzag(x, cp)))
    np.testing.assert_array_equal(tcp.undo_zigzag(z, cp), x)
    np.testing.assert_array_equal(tcp.apply_zigzag(torch.from_numpy(x), cp).numpy(), z)
    for r in range(cp):
        got = tcp._zigzag_positions(r, seq // cp, cp).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcp._zigzag_positions(r, seq // cp, cp)))
        assert np.all(np.diff(got) >= 0)  # non-decreasing: K1's binary search holds
    with pytest.raises(ValueError, match="must divide"):
        tcp.zigzag_indices(seq + 1, cp)


def test_merge_partials_equals_jax():
    rng = np.random.default_rng(1)
    B, S, N, H = 2, 8, 3, 4
    oa, ot = (rng.standard_normal((B, S, N, H)).astype(np.float32) for _ in range(2))
    la, lt = (rng.standard_normal((B, N, S)).astype(np.float32) for _ in range(2))
    la[0, 0, :3] = lt[0, 0, :3] = trf.NEG_INF  # rows dead on both sides
    lt[1, 2, 4:] = trf.NEG_INF  # dead on one side
    out, lse = trf.merge_partials(*(torch.from_numpy(a) for a in (oa, la, ot, lt)))
    jout, jlse = jrf.merge_partials(*(jnp.asarray(a) for a in (oa, la, ot, lt)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-6)
    assert np.all(out.numpy()[0, :3, 0] == 0)


def _inputs(B, S, N, Nkv, H, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    k = rng.standard_normal((B, S, Nkv, H)).astype(np.float32)
    v = rng.standard_normal((B, S, Nkv, H)).astype(np.float32)
    ct = rng.standard_normal((B, S, N, H)).astype(np.float32)
    sinks = rng.standard_normal((N,)).astype(np.float32)
    return q, k, v, ct, sinks


RING_CASES = {
    "cp2_causal_gqa": dict(cp=2, N=4, Nkv=2),
    "cp4_causal_gqa_zigzag": dict(cp=4, N=4, Nkv=2, zigzag=True),
    "cp2_segments_zigzag": dict(cp=2, N=4, Nkv=4, segments=True, zigzag=True),
    "cp4_window": dict(cp=4, N=2, Nkv=1, window=20),
    "cp4_window_zigzag": dict(cp=4, N=2, Nkv=1, window=20, zigzag=True),
    "cp4_sinks_zigzag": dict(cp=4, N=4, Nkv=2, sinks=True, zigzag=True),
    "cp2_softcap_window": dict(cp=2, N=4, Nkv=2, soft_cap=5.0, window=24),
    "cp2_noncausal": dict(cp=2, N=2, Nkv=2, causal=False),
}


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_ranks_match_jax_ring(devices8, name):
    c = dict(dict(zigzag=False, window=None, segments=False, sinks=False, soft_cap=None, causal=True), **RING_CASES[name])
    cp, B, S, H = c["cp"], 2, 64, 16
    q, k, v, ct, sinks = _inputs(B, S, c["N"], c["Nkv"], H, seed=sum(map(ord, name)))
    seg = np.repeat(np.arange(4), S // 4)[None].repeat(B, 0).astype(np.int32) if c["segments"] else None
    if c["zigzag"]:  # the data in zigzag order, as the recipe permutes it
        q, k, v, ct = (tcp.apply_zigzag(a, cp) for a in (q, k, v, ct))
        seg = None if seg is None else tcp.apply_zigzag(seg, cp)
    kw = dict(causal=c["causal"], sliding_window=c["window"], logits_soft_cap=c["soft_cap"])

    ctx = build_mesh(MeshConfig(dp_shard=1, cp=cp), devices=devices8[:cp])
    ring = jcp.make_ring_attention(ctx, zigzag=c["zigzag"])
    jsinks = jnp.asarray(sinks) if c["sinks"] else None
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q_, k_, v_, s_):
        out = ring(q_, k_, v_, segment_ids=jseg, sinks=s_ if c["sinks"] else None, **kw)
        return (out * jnp.asarray(ct)).sum(), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jsinks if jsinks is not None else jnp.zeros((c["N"],)))

    s_loc = S // cp
    cut = lambda a: [torch.from_numpy(np.ascontiguousarray(a[:, r * s_loc:(r + 1) * s_loc])) for r in range(cp)]
    tkw = dict(zigzag=c["zigzag"], causal=c["causal"], window=c["window"], soft_cap=c["soft_cap"])
    tsinks = torch.from_numpy(sinks) if c["sinks"] else None
    segs = None if seg is None else cut(seg)
    qs, ks, vs = cut(q), cut(k), cut(v)
    outs, lses = tcp.ring_forward_ranks(qs, ks, vs, segs, tsinks, **tkw)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(jout), **OUT_TOL)
    dqs, dks, dvs, dsinks = tcp.ring_backward_ranks(qs, ks, vs, outs, lses, cut(ct), segs, tsinks, **tkw)
    for label, got, want in (("dq", dqs, jgrads[0]), ("dk", dks, jgrads[1]), ("dv", dvs, jgrads[2])):
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), np.asarray(want), err_msg=label, **GRAD_TOL)
    if c["sinks"]:
        np.testing.assert_allclose(dsinks.numpy(), np.asarray(jgrads[3]), err_msg="dsinks", **GRAD_TOL)


def test_ring_rank_balance_zigzag_against_contiguous():
    """Live (query, key) pairs each rank's K1 calls cover at cp = 4: the
    contiguous split's last rank has (3 + 1/2) / (1/2) = 7x the first's as
    the blocks grow (6.6x at 16-token blocks); zigzag evens them."""
    S, cp = 64, 4
    s_loc = S // cp

    def per_rank(zigzag):
        pos = [tcp.rank_positions(r, s_loc, cp, zigzag) for r in range(cp)]
        return [sum(tcp.live_pairs(pos[r], pos[(r - s) % cp], True, None) for s in range(cp)) for r in range(cp)]

    contiguous, zigzag = per_rank(False), per_rank(True)
    assert sum(contiguous) == sum(zigzag) == S * (S + 1) // 2
    assert contiguous[-1] / contiguous[0] == (3 * s_loc * s_loc + s_loc * (s_loc + 1) / 2) / (s_loc * (s_loc + 1) / 2)
    assert len(set(zigzag)) == 1


@pytest.mark.parametrize("sinks", [False, True])
def test_ring_at_cp1_is_flash_bit_for_bit(sinks):
    """``ring_attention`` with no group (cp = 1) runs one K1 step and its
    merge: the output and the grads equal ``flash_attention``'s exactly."""
    q, k, v, ct, s = _inputs(2, 40, 4, 2, 16, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, s)]
    outs = []
    for fn in (tattn.flash, tcp.ring_attention):
        for t in leaves:
            t.grad = None
        out = fn(*leaves[:3], causal=True, sinks=leaves[3] if sinks else None, sliding_window=16)
        (out * torch.from_numpy(ct)).sum().backward()
        outs.append([out.detach()] + [t.grad.clone() for t in leaves[: 4 if sinks else 3]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_ring_backend_install_and_refusals():
    """``ring`` raises naming the mesh until installed; installed without a
    mesh it is the cp = 1 ring; a cp of 2 without its group raises."""
    q, k, v, *_ = _inputs(1, 8, 2, 2, 16, seed=2)
    args = tuple(torch.from_numpy(a) for a in (q, k, v))
    saved = tattn.ATTENTION_BACKENDS["ring"]
    try:
        with pytest.raises(ValueError, match="needs a mesh"):
            tattn.attention(*args, backend="ring")
        tcp.install_ring_backend(None, zigzag=True)
        got = tattn.attention(*args, backend="ring", causal=True)
        assert torch.equal(got, tattn.flash(*args, causal=True))
        assert tattn.ATTENTION_BACKENDS["ring"].zigzag is False  # zigzag needs cp > 1
    finally:
        tattn.ATTENTION_BACKENDS["ring"] = saved
    with pytest.raises(ValueError, match="process group"):
        tcp.ring_attention(*args, cp=2, rank=0)

"""The port's flash attention (plain path on the CPU, fp32) against the JAX
package's blockwise flash kernels run in interpret mode: output, the
forward's logsumexp, and dq/dk/dv through autograd, over causal, sliding
window, packed segment ids, non-causal, GQA, head_dim 64 and 128, and an
unpadded length; with gpt-oss sinks folded around the kernels (out, dq,
dk, dv and d_sinks), with ``sdpa``'s sink column against JAX's; and with
Gemma 2's logits soft cap of 50 at head_dim 256 and 64 against the JAX
package's ``flash`` on the library splash kernel, run in interpret mode
(``AUTOMODEL_FLASH_INTERPRET=1``, as tests/test_flash_attention.py runs
it). Tolerances are the ones tests/test_block_flash.py holds the JAX
kernels to: out and lse atol 2e-4, grads atol 5e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import ring_flash as jrf
from automodel_tpu_torch.ops import attention as tattn
from automodel_tpu_torch.ops import ring_flash as trf
import torch_port_parity  # noqa: F401  (caps torch at one thread)

CASES = {
    "causal": dict(S=256, H=64),
    "window": dict(S=256, H=128, window=64),
    "segments": dict(S=256, H=64, segments=True),
    "noncausal": dict(S=256, H=64, causal=False),
    "noncausal_window": dict(S=128, H=64, causal=False, window=32),
    "unpadded": dict(S=200, H=64, B=1),
}


def _inputs(S, H, B=2, N=4, NKV=2, segments=False, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, n, H)).astype(np.float32) for n in (N, NKV, NKV, N))
    seg = None
    if segments:  # three packed documents of ragged lengths per row
        cuts = np.sort(rng.choice(np.arange(1, S), size=(B, 2), replace=False), axis=1)
        seg = (np.arange(S)[None, :] >= cuts[:, :1]).astype(np.int32) + (np.arange(S)[None, :] >= cuts[:, 1:])
    return q, k, v, do, seg


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax_blockwise_kernels(case):
    c = dict(CASES[case])
    causal, window = c.pop("causal", True), c.pop("window", None)
    q, k, v, do, seg = _inputs(**c)
    S, H = q.shape[1], q.shape[3]
    scale = 1.0 / H**0.5

    def jax_loss(q_, k_, v_):
        out = jrf.flash_attention(
            q_, k_, v_, causal=causal, sliding_window=window,
            segment_ids=None if seg is None else jnp.asarray(seg), interpret=True,
        )
        return (out * jnp.asarray(do)).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    pos = np.arange(S, dtype=np.int32)
    segj = jnp.asarray(seg if seg is not None else np.zeros((q.shape[0], S), np.int32))
    _, j_lse = jrf.flash_block_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pos), segj, segj,
        causal=causal, window=window, scale=scale, interpret=True,
    )

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tseg = None if seg is None else torch.tensor(seg)
    out = trf.flash_attention(tq, tk, tv, causal=causal, sliding_window=window, segment_ids=tseg)
    (out * torch.tensor(do)).sum().backward()
    tpos = torch.tensor(pos)
    _, t_lse = trf.flash_block_fwd(
        tq.detach(), tk.detach(), tv.detach(), tpos, tpos, tseg, tseg,
        causal=causal, window=window, scale=scale,
    )

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-4)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=2e-4, rtol=1e-6)
    for name, t, j in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-3, err_msg=name)


def test_fully_masked_rows_give_zero_out_and_neg_inf_lse():
    """A query whose segment holds no visible key (a window of 1 over a
    position before every key) outputs 0 and lse NEG_INF, as the JAX
    kernel's all-masked guard does."""
    q, k, v, _, _ = _inputs(S=16, H=64, B=1, N=2, NKV=1)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    q_pos = torch.arange(16, dtype=torch.int32)
    kv_pos = q_pos + 8  # keys start after the first 8 queries
    out, lse = trf.flash_block_fwd(tq, tk, tv, q_pos, kv_pos, None, None, causal=True, window=None, scale=0.125)
    assert bool((out[:, :8] == 0).all()) and bool((lse[:, :, :8] == trf.NEG_INF).all())
    assert bool(torch.isfinite(lse[:, :, 8:]).all())


@pytest.mark.parametrize("window,segments", [(None, False), (48, False), (None, True)])
def test_sdpa_matches_jax_sdpa_and_plain_flash(window, segments):
    """The port's ``sdpa`` (the reference the plain flash version is held
    to) against JAX ``sdpa``, and ``attention(backend='flash')`` on the CPU
    against it."""
    from automodel_tpu.ops.attention import sdpa as jax_sdpa

    q, k, v, _, seg = _inputs(S=96, H=64, segments=segments, seed=3)
    kw = dict(causal=True, sliding_window=window)
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   segment_ids=None if seg is None else jnp.asarray(seg), **kw)
    tseg = None if seg is None else torch.tensor(seg)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v))
    out = tattn.sdpa(*args, segment_ids=tseg, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    flash = tattn.attention(*args, backend="flash", segment_ids=tseg, **kw)
    np.testing.assert_allclose(flash.numpy(), out.numpy(), atol=2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_with_sinks_matches_jax(window):
    """gpt-oss sinks (one learned logit per q head) folded around the
    blockwise kernels: out, dq, dk, dv and d_sinks against JAX's
    ring_flash.flash_attention(..., sinks=) in interpret mode, causal, full
    and with a window, at head_dim 64 (d_sinks fp32 sums over B x S rows:
    5e-3 as the other grads)."""
    q, k, v, do, _ = _inputs(S=128, H=64, seed=4)
    sinks = np.random.default_rng(8).normal(size=(4,)).astype(np.float32) * 2

    def jax_loss(q_, k_, v_, s_):
        out = jrf.flash_attention(q_, k_, v_, causal=True, sliding_window=window, sinks=s_, interpret=True)
        return (out * jnp.asarray(do)).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, sinks))
    )
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, sinks)]
    out = trf.flash_attention(*leaves[:3], causal=True, sliding_window=window, sinks=leaves[3])
    (out * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-4)
    for name, t, j in zip(("dq", "dk", "dv", "d_sinks"), leaves, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=5e-3, err_msg=name)
    assert float(leaves[3].grad.abs().min()) > 0  # every head's sink takes mass


@pytest.mark.parametrize("window", [None, 40])
def test_sdpa_sinks_match_jax_and_the_flash_fold(window):
    """``sdpa``'s sink column against JAX's sdpa (1e-5), and the flash fold
    on the CPU against it (2e-5), out and the sinks' grad."""
    from automodel_tpu.ops.attention import sdpa as jax_sdpa

    q, k, v, do, _ = _inputs(S=96, H=64, seed=6)
    sinks = np.random.default_rng(2).normal(size=(4,)).astype(np.float32)
    kw = dict(causal=True, sliding_window=window)
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sinks=jnp.asarray(sinks), **kw)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v))
    grads = []
    for backend in ("sdpa", "flash"):
        ts = torch.tensor(sinks, requires_grad=True)
        out = tattn.attention(*args, backend=backend, sinks=ts, **kw)
        (out * torch.tensor(do)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5 if backend == "sdpa" else 2e-5)
        grads.append(ts.grad)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), atol=2e-5, rtol=1e-5)


def test_flash_refuses_sinks_soft_cap_and_unknown_backends():
    """Sinks must be one logit per q head and a soft cap must be positive;
    a soft cap of 30 is carried (the plain flash equals ``sdpa`` with the
    cap); the kernels' checks refuse head_dim 96 by name; ring is not a
    flash backend."""
    q, k, v, _, _ = _inputs(S=32, H=64, seed=9)
    args = (torch.tensor(q) * 8, torch.tensor(k), torch.tensor(v))  # x8: the cap of 30 bites
    with pytest.raises(ValueError, match="sinks"):
        tattn.attention(*args, backend="flash", sinks=torch.zeros(3))
    with pytest.raises(ValueError, match="soft cap"):
        tattn.attention(*args, backend="flash", logits_soft_cap=0.0)
    capped = tattn.attention(*args, backend="flash", logits_soft_cap=30.0)
    np.testing.assert_allclose(capped.numpy(), tattn.sdpa(*args, logits_soft_cap=30.0).numpy(), atol=2e-5)
    assert float((capped - tattn.attention(*args, backend="flash")).abs().max()) > 1e-2
    h96 = torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 96"):
        trf._check_cuda("flash_block_fwd", h96, h96, h96, pos, pos, None, None, None, 50.0)
    with pytest.raises(ValueError, match="ring"):
        tattn.attention(*args, backend="ring")


# -- the logits soft cap (Gemma 2), against the JAX package's splash kernel ------

CAP_CASES = {
    "h256_causal": dict(S=128, H=256),
    "h256_window": dict(S=128, H=256, window=32),
    "h256_segments": dict(S=128, H=256, segments=True),
    "h256_unaligned": dict(S=200, H=256),
    "h64_causal": dict(S=128, H=64),
    "h64_window": dict(S=128, H=64, window=32),
    "h64_segments": dict(S=128, H=64, segments=True),
    "h64_unaligned": dict(S=200, H=64, window=48),
    # q x 64: scale * q.k ~ N(0, 64^2), far past the cap of 50, so the tanh
    # saturates and 1 - t^2 is small (0 in fp32 for most pairs)
    "h256_sharp": dict(S=128, H=256, sharp=64.0),
}
SOFT_CAP = 50.0


def _splash_capped(q, k, v, do, seg, window, monkeypatch):
    """JAX ``ops.attention.flash`` with the cap (the splash kernel in
    interpret mode; a fall back to sdpa fails the test): out, and dq/dk/dv
    through ``jax.vjp``."""
    from automodel_tpu.ops import attention as jattn

    monkeypatch.setenv("AUTOMODEL_FLASH_INTERPRET", "1")

    def no_fallback(*a, **kw):
        raise AssertionError("JAX flash fell back to sdpa: the splash kernel was not taken")

    monkeypatch.setattr(jattn, "sdpa", no_fallback)
    fn = lambda q_, k_, v_: jattn.flash(
        q_, k_, v_, causal=True, segment_ids=None if seg is None else jnp.asarray(seg),
        logits_soft_cap=SOFT_CAP, sliding_window=window,
    )
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", sorted(CAP_CASES))
def test_soft_capped_flash_matches_jax_splash(case, monkeypatch):
    """Gemma 2's attention (cap 50): the port's flash (plain versions on the
    CPU) against splash's ``attn_logits_soft_cap``, out atol 2e-4 and
    dq/dk/dv atol 5e-3, causal, windowed, with packed segments and at an S
    that is no multiple of the kernels' tiles (splash pads it to 256)."""
    c = dict(CAP_CASES[case])
    window, sharp = c.pop("window", None), c.pop("sharp", 1.0)
    q, k, v, do, seg = _inputs(B=1, **c)
    q = q * sharp
    j_out, j_grads = _splash_capped(q, k, v, do, seg, window, monkeypatch)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tseg = None if seg is None else torch.tensor(seg)
    out = trf.flash_attention(*leaves, causal=True, sliding_window=window, segment_ids=tseg, soft_cap=SOFT_CAP)
    (out * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=2e-4)
    for name, t, j in zip(("dq", "dk", "dv"), leaves, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), j, atol=5e-3, err_msg=name)
    if sharp > 1:
        # the cap decides here: without it, or without its factor 1 - t^2 in
        # the backward, the port would be far off splash
        tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
        uncapped = trf.flash_attention(tq, tk, tv, causal=True)
        assert float(np.abs(uncapped.numpy() - j_out).max()) > 100 * 2e-4
        scores = trf._scores
        monkeypatch.setattr(trf, "_scores", lambda *a: (scores(*a)[0], None))  # drop 1 - t^2
        faulty = trf.flash_attention(tq.requires_grad_(True), tk, tv, causal=True, soft_cap=SOFT_CAP)
        (faulty * tdo).sum().backward()
        assert float(np.abs(tq.grad.numpy() - j_grads[0]).max()) > 100 * 5e-3



# -- the blocks at the edges of the CUDA kernels' tiles, against JAX ----------
# The card tests hold the kernels to the plain versions at these layouts
# (tests/test_torch_cuda_kernels.py); here the plain versions, what the
# wrappers run on the CPU, are held to the JAX blocks at the same layouts.

EDGE_CASES = {
    # lengths at and around the kernels' 64- and 128-row tiles
    **{f"S={S}": dict(Sq=S, Sk=S) for S in (1, 63, 64, 65, 127, 129)},
    # the q rows at the end of the key range (the chunked prefill layout)
    **{f"prefill Sq={Sq} Sk={Sk}": dict(Sq=Sq, Sk=Sk) for Sq, Sk in ((1, 129), (63, 200), (65, 127), (129, 300))},
    # GQA: rep q heads per kv head
    **{f"rep {r}": dict(Sq=129, Sk=129, N=8, NKV=8 // r) for r in (1, 2, 4, 8)},
    # a window whose edge falls on a tile boundary, causal and not
    "window 64 on a tile edge": dict(Sq=256, Sk=256, window=64),
    "window 128 on a tile edge": dict(Sq=256, Sk=256, window=128),
    "non-causal window 64": dict(Sq=192, Sk=192, window=64, causal=False),
    # a document boundary inside a tile
    "document boundary at 100": dict(Sq=200, Sk=200, cut=100),
    # the wider head dims
    "H=128 S=65": dict(Sq=65, Sk=65, H=128),
    "H=256 S=65": dict(Sq=65, Sk=65, H=256),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_flash_blocks_match_jax_at_tile_edges(case):
    """``flash_block_fwd`` / ``_dq`` / ``_dkv`` on the CPU against JAX's
    ``flash_block_fwd`` / ``flash_block_bwd`` in interpret mode with the
    same positions, segment ids, lse and delta: out and lse atol 2e-4,
    dq/dk/dv atol 5e-3, as tests/test_block_flash.py holds the JAX kernels."""
    c = dict(dict(H=64, N=4, NKV=2, window=None, causal=True, cut=None), **EDGE_CASES[case])
    Sq, Sk, H = c["Sq"], c["Sk"], c["H"]
    rng = np.random.default_rng(11)
    q, do = (rng.normal(size=(1, Sq, c["N"], H)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(1, Sk, c["NKV"], H)).astype(np.float32) for _ in range(2))
    kv_pos = np.arange(Sk, dtype=np.int32)
    q_pos = kv_pos[Sk - Sq:] if Sq <= Sk else np.arange(Sq, dtype=np.int32)
    cut = c["cut"] if c["cut"] is not None else Sk + 1
    seg_q, seg_kv = ((p >= cut).astype(np.int32)[None] for p in (q_pos, kv_pos))
    kw = dict(causal=c["causal"], window=c["window"], scale=H**-0.5)

    j_args = [jnp.asarray(x) for x in (q, k, v, q_pos, kv_pos, seg_q, seg_kv)]
    j_out, j_lse = jrf.flash_block_fwd(*j_args, interpret=True, **kw)
    delta = (np.asarray(j_out) * do).sum(-1).transpose(0, 2, 1)  # [B, N, Sq]
    j_grads = jrf.flash_block_bwd(*j_args[:3], jnp.asarray(do), j_lse, jnp.asarray(delta), *j_args[3:],
                                  interpret=True, **kw)

    tq, tk, tv, tdo, tqp, tkp, tsq, tsk = map(torch.tensor, (q, k, v, do, q_pos, kv_pos, seg_q, seg_kv))
    out, lse = trf.flash_block_fwd(tq, tk, tv, tqp, tkp, tsq, tsk, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=2e-4, rtol=1e-6)
    bargs = (tq, tk, tv, tdo, torch.tensor(np.asarray(j_lse)), torch.tensor(delta), tqp, tkp, tsq, tsk)
    dq = trf.flash_block_dq(*bargs, **kw)
    dk, dv = trf.flash_block_dkv(*bargs, **kw)
    for name, t, j in zip(("dq", "dk", "dv"), (dq, dk, dv), j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-3, err_msg=name)

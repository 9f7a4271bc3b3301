"""The torch port's plain ops against the JAX package's, on the same
numpy-made inputs: RMSNorm, RoPE (default, llama3 and yarn scaling),
``repeat_kv``, ``sdpa_decode`` under the chunk mask, sampling filters, and
the paged write targets and chunk mask. fp32, atol 1e-5 unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.generation import kv_cache as jkv
from automodel_tpu.generation import sampling as jsm
from automodel_tpu.ops import attention as jatt
from automodel_tpu.ops import norms as jnorms
from automodel_tpu.ops import rope as jrope
from automodel_tpu_torch.generation import kv_cache as tkv
from automodel_tpu_torch.generation import sampling as tsm
from automodel_tpu_torch.ops import attention as tatt
from automodel_tpu_torch.ops import norms as tnorms
from automodel_tpu_torch.ops import rope as trope
from torch_port_parity import HF_TINY, to_np

RNG = np.random.default_rng(0)


def _rand(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def test_rms_norm():
    x, s = _rand(2, 5, 64, scale=3.0), _rand(64)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)
    out = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gemma(dtype):
    """Gemma's zero-centered norm, x̂ · (1 + w) in fp32, cast back: fp32 to
    1e-5, and bf16 to one rounding of the same fp32 value."""
    x, s = _rand(2, 5, 64, scale=3.0), _rand(64)
    ref = jnorms.rms_norm_gemma(jnp.asarray(x).astype(dtype), jnp.asarray(s), 1e-6)
    out = tnorms.rms_norm_gemma(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(s), 1e-6)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_np(out), np.asarray(ref, np.float32), atol=1e-5 if dtype == "float32" else 2**-7 * 8)


# gpt-oss's published rope (yarn, factor 32 over 4096 positions, theta 150000)
HF_YARN = dict(rope_theta=150000.0, rope_scaling=dict(rope_type="yarn", factor=32.0, beta_fast=32.0, beta_slow=1.0,
                                                      original_max_position_embeddings=4096, truncate=False))


@pytest.mark.parametrize("hf", [{"rope_theta": 10000.0}, HF_TINY, HF_YARN], ids=["default", "llama3", "yarn"])
def test_rope_table_and_apply(hf):
    jcfg, tcfg = jrope.RopeConfig.from_hf(hf), trope.RopeConfig.from_hf(hf)
    assert (tcfg.theta, tcfg.scaling, tcfg.factor, tcfg.original_max_position) == (
        jcfg.theta, jcfg.scaling, jcfg.factor, jcfg.original_max_position
    )
    pos = RNG.integers(0, 200, size=(2, 9)).astype(np.int32)
    jcos, jsin = jrope.rope_table(jnp.asarray(pos), 16, jcfg)
    tcos, tsin = trope.rope_table(torch.from_numpy(pos), 16, tcfg)
    np.testing.assert_allclose(to_np(tcos), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(to_np(tsin), np.asarray(jsin), atol=1e-5)
    q, k = _rand(2, 9, 4, 16), _rand(2, 9, 2, 16)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tcos, tsin)
    np.testing.assert_allclose(to_np(tq), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(to_np(tk), np.asarray(jk), atol=1e-5)


def test_yarn_copies_jax_which_floors_the_ramp_whatever_truncate_says():
    """The port's yarn frequencies and attention factor equal JAX's at
    gpt-oss's head_dim 64 (1e-7 relative); both floor and ceil the ramp's
    ends, which is HF's ``truncate: true``. HF with gpt-oss's published
    ``truncate: false`` gives other frequencies (ROADMAP queue 3)."""
    from transformers.modeling_rope_utils import _compute_yarn_parameters
    from transformers import PretrainedConfig

    tcfg = trope.RopeConfig.from_hf(HF_YARN)
    inv = trope.inv_freq(64, tcfg)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jrope._inv_freq(64, jrope.RopeConfig.from_hf(HF_YARN))),
                               rtol=1e-7)
    assert trope.attention_factor(tcfg) == jrope._attention_factor(jrope.RopeConfig.from_hf(HF_YARN))
    assert abs(trope.attention_factor(tcfg) - (0.1 * np.log(32.0) + 1.0)) < 1e-12

    def hf_inv(truncate):
        rs = dict(HF_YARN["rope_scaling"], truncate=truncate)
        cfg = PretrainedConfig(rope_theta=150000.0, rope_scaling=rs, head_dim=64, hidden_size=2880,
                               num_attention_heads=64, max_position_embeddings=131072)
        return _compute_yarn_parameters(cfg, "cpu")[0].float().numpy()

    np.testing.assert_allclose(inv.numpy(), hf_inv(True), rtol=1e-6)
    assert np.abs(inv.numpy() / hf_inv(False) - 1).max() > 0.1


def test_llama3_scaling_changes_low_frequencies():
    inv = trope.inv_freq(16, trope.RopeConfig.from_hf(HF_TINY))
    plain = trope.inv_freq(16, trope.RopeConfig(theta=HF_TINY["rope_theta"]))
    assert torch.equal(inv[:1], plain[:1]) and bool((inv[-1] < plain[-1]).item())


def test_repeat_kv():
    x = _rand(2, 3, 2, 8)
    np.testing.assert_array_equal(
        to_np(tatt.repeat_kv(torch.from_numpy(x), 3)), np.asarray(jatt.repeat_kv(jnp.asarray(x), 3))
    )


@pytest.mark.parametrize("window,cap", [(None, None), (5, None), (None, 20.0)])
def test_sdpa_decode_under_the_chunk_mask(window, cap):
    B, S, C = 2, 4, 16
    start = np.asarray([3, 9], np.int32)
    real = np.asarray([4, 2], np.int32)
    jctx = jkv.chunk_ctx(
        jkv.init_cache(1, B, C, 2, 8, jnp.float32), S, jnp.asarray(start), jnp.asarray(real)
    )[1]
    tctx = tkv.chunk_ctx(C, S, torch.from_numpy(start), torch.from_numpy(real))
    jmask = jctx.attend_mask(window)
    tmask = tctx.attend_mask(window)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    q, k, v = _rand(B, S, 4, 8), _rand(B, C, 2, 8), _rand(B, C, 2, 8)
    ref = jatt.sdpa_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jmask, logits_soft_cap=cap
    )
    out = tatt.sdpa_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=tmask, logits_soft_cap=cap,
    )
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)
    # the [B, C] decode-mask form
    m2 = np.asarray(RNG.random((B, C)) < 0.7)
    ref2 = jatt.sdpa_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(m2))
    out2 = tatt.sdpa_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_mask=torch.from_numpy(m2)
    )
    np.testing.assert_allclose(to_np(out2), np.asarray(ref2), atol=1e-5)


def test_paged_write_targets():
    tables = RNG.integers(1, 30, size=(3, 6)).astype(np.int32)
    lengths = np.asarray([0, 7, 21], np.int32)
    active = np.asarray([True, False, True])
    jb, jo = jkv.paged_write_targets(
        jnp.asarray(tables), jnp.asarray(lengths), 3, jnp.asarray(active), 4
    )
    tb, to = tkv.paged_write_targets(
        torch.from_numpy(tables), torch.from_numpy(lengths), 3, torch.from_numpy(active), 4
    )
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize(
    "cfg", [dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8), dict(temperature=1.3, top_k=9, top_p=0.9)]
)
def test_sampling_filters(cfg):
    logits = _rand(3, 50, scale=2.0)
    jf = np.asarray(jsm._filter_logits(jnp.asarray(logits), jsm.SamplingConfig(**cfg)))
    tf = to_np(tsm._filter_logits(torch.from_numpy(logits), tsm.SamplingConfig(**cfg)))
    np.testing.assert_array_equal(tf <= -1e29, jf <= -1e29)
    np.testing.assert_allclose(tf, jf, atol=1e-5)


def test_greedy_sample_with_logprobs():
    logits = _rand(4, 50, scale=2.0)
    jid, jlp = jsm.sample_with_logprobs(jnp.asarray(logits), None, jsm.SamplingConfig(temperature=0.0))
    tid, tlp = tsm.sample_with_logprobs(torch.from_numpy(logits), None, tsm.SamplingConfig(temperature=0.0))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)


def test_sampled_tokens_respect_the_filters():
    logits = torch.from_numpy(_rand(2, 50, scale=2.0))
    cfg = tsm.SamplingConfig(temperature=1.0, top_k=3)
    allowed = torch.topk(logits, 3).indices
    for step in range(20):
        ids = tsm.sample(logits, tsm.step_generator(0, step, logits.device), cfg)
        assert all(int(ids[b]) in allowed[b].tolist() for b in range(2))

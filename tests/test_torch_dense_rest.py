"""The rest of the torch port's dense ops and the dense-family aliases
against the JAX package on the CPU: ``layer_norm``, ``yarn_mscale``,
``mrope_table``, partial-rotary ``apply_rope``, ``sdpa`` with
``bidir_groups``, ``windowed_attention``'s OR-mask and
``nemotron_parse_cross_entropy`` on numpy inputs from a seed; then tiny
``Qwen2ForCausalLM``, ``Qwen3ForCausalLM``, ``MistralForCausalLM`` and
``Phi3ForCausalLM`` (partial rotary 0.75) models made by HF
``transformers``, written as HF directories (Phi-3's with its fused
``qkv_proj`` / ``gate_up_proj`` keys) and loaded through both packages'
``from_pretrained``: the port's logits against JAX's (fp32 atol 1e-5) and
HF's (the tolerance of tests/test_llama_parity.py), and the port's HF save
against JAX's, key for key and bit for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu import auto_model as jauto_model
from automodel_tpu.checkpoint import hf_io as jhf
from automodel_tpu.ops import attention as jattn
from automodel_tpu.ops import losses as jl
from automodel_tpu.ops import norms as jnorms
from automodel_tpu.ops import rope as jrope
from automodel_tpu_torch.auto_model import from_pretrained
from automodel_tpu_torch.checkpoint import hf_io
from automodel_tpu_torch.checkpoint.addons import write_hf_addons
from automodel_tpu_torch.ops import attention as tattn
from automodel_tpu_torch.ops import losses as tl
from automodel_tpu_torch.ops import norms as tnorms
from automodel_tpu_torch.ops import rope as trope
from torch_port_parity import to_np

FP32 = dict(attn="sdpa", param_dtype="float32", compute_dtype="float32")


def _rng(seed: int = 0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(affine):
    rng = _rng(1)
    x = (rng.normal(size=(3, 5, 32)) * 2 + 0.5).astype(np.float32)
    scale = rng.normal(size=32).astype(np.float32) if affine else np.ones(32, np.float32)
    bias = rng.normal(size=32).astype(np.float32) if affine else np.zeros(32, np.float32)
    want = np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5))
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tnorms.layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias)).dtype == torch.bfloat16


@pytest.mark.parametrize(
    "rope_scaling",
    [
        None,
        dict(rope_type="yarn", factor=40.0, mscale=1.0, mscale_all_dim=1.0, original_max_position_embeddings=4096),
        dict(rope_type="yarn", factor=40.0, mscale=0.707, mscale_all_dim=0.0, original_max_position_embeddings=4096),
        dict(rope_type="yarn", factor=4.0, mscale=1.0, mscale_all_dim=0.5, original_max_position_embeddings=4096),
        dict(rope_type="llama3", factor=8.0, original_max_position_embeddings=8192),
    ],
)
def test_yarn_mscale_matches_jax(rope_scaling):
    hf = dict(rope_theta=10000.0, max_position_embeddings=8192, rope_scaling=rope_scaling)
    jcfg, tcfg = jrope.RopeConfig.from_hf(hf), trope.RopeConfig.from_hf(hf)
    assert (tcfg.mscale, tcfg.mscale_all_dim) == (jcfg.mscale, jcfg.mscale_all_dim)
    assert trope.yarn_mscale(tcfg) == pytest.approx(jrope.yarn_mscale(jcfg), rel=1e-12)


@pytest.mark.parametrize("section", [(8, 12, 12), (16, 8, 8), (24, 4, 4)])
def test_mrope_table_matches_jax(section):
    rng = _rng(2)
    pos = rng.integers(0, 500, size=(3, 2, 11)).astype(np.int32)
    cfg = dict(rope_theta=1000000.0, max_position_embeddings=4096)
    jc, js = jrope.mrope_table(jnp.asarray(pos), 64, jrope.RopeConfig.from_hf(cfg), section)
    tc, ts = trope.mrope_table(torch.from_numpy(pos), 64, trope.RopeConfig.from_hf(cfg), section)
    assert tuple(tc.shape) == (2, 11, 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("rotary_dim", [12, 16])
def test_partial_rotary_apply_rope_matches_jax(rotary_dim):
    """Head 16: a table of 12 channels rotates 12 and passes 4 through
    (Phi-3's factor 0.75); 16 is the whole head."""
    rng = _rng(3)
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    cfg = dict(rope_theta=10000.0)
    jc, js = jrope.rope_table(jnp.asarray(pos), rotary_dim, jrope.RopeConfig.from_hf(cfg))
    tc, ts = trope.rope_table(torch.from_numpy(pos), rotary_dim, trope.RopeConfig.from_hf(cfg))
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    if rotary_dim < 16:
        np.testing.assert_array_equal(tq[..., rotary_dim:].numpy(), q[..., rotary_dim:])


def _qkv(seed: int, S: int = 12):
    rng = _rng(seed)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    groups = np.full((2, S), -1, np.int32)
    groups[0, 3:7] = 0  # an image block in the middle
    groups[1, 1:4] = 0
    groups[1, 8:11] = 1
    return q, k, v, groups


@pytest.mark.parametrize("window,segments", [(None, False), (3, False), (None, True)])
def test_sdpa_bidir_groups_match_jax(window, segments):
    """The group mask ORed onto the causal (and window) mask, the segment
    mask ANDed after it; a group's first token sees its last."""
    q, k, v, groups = _qkv(4)
    seg = (np.arange(12)[None, :] >= np.array([[12], [6]])).astype(np.int32) if segments else None
    kw = dict(causal=True, sliding_window=window)
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bidir_groups=jnp.asarray(groups),
                      segment_ids=None if seg is None else jnp.asarray(seg), **kw)
    got = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     bidir_groups=torch.from_numpy(groups),
                     segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    causal_only = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert not torch.allclose(got[0, 3], causal_only[0, 3], atol=1e-3)


@pytest.mark.parametrize("is_sliding", [True, False])
def test_windowed_attention_or_mask_matches_jax(is_sliding):
    """With ``bidir_groups`` the layer runs on sdpa in both packages; the
    window applies on a sliding layer only."""
    backend = "sdpa"
    q, k, v, groups = _qkv(5)
    window = 4
    S = q.shape[1]
    want = jattn.windowed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend=backend, is_sliding=jnp.asarray(is_sliding),
        window=window, dynamic_window=jnp.asarray(window if is_sliding else S), bidir_groups=jnp.asarray(groups),
        logits_soft_cap=20.0,
    )
    got = tattn.windowed_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), backend=backend, is_sliding=is_sliding,
        window=window, bidir_groups=torch.from_numpy(groups), logits_soft_cap=20.0,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="ring"):
        tattn.windowed_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), backend="ring",
                                 is_sliding=True, window=window, bidir_groups=torch.from_numpy(groups))


@pytest.mark.parametrize("is_sliding", [True, False])
def test_windowed_attention_flash_refuses_bidir_groups(is_sliding):
    """The flash kernels mask by position only: a ``bidir_groups`` call
    under ``flash`` raises rather than run elsewhere."""
    q, k, v, groups = _qkv(5)
    with pytest.raises(ValueError, match="bidir_groups.*'flash'"):
        tattn.windowed_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), backend="flash",
                                 is_sliding=is_sliding, window=4, bidir_groups=torch.from_numpy(groups))


def test_windowed_attention_without_groups_runs_the_backend(monkeypatch):
    """Without ``bidir_groups`` a flash layer runs the flash path (its
    plain version here) with the layer's window, as JAX's static-flag
    branch does."""
    from automodel_tpu_torch.ops import ring_flash as rf

    seen = []
    orig = rf.flash_attention
    monkeypatch.setattr(rf, "flash_attention", lambda *a, **kw: seen.append(kw["sliding_window"]) or orig(*a, **kw))
    q, k, v, _ = _qkv(6)
    for sliding in (True, False):
        got = tattn.windowed_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                       backend="flash", is_sliding=sliding, window=4)
        want = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          sliding_window=4 if sliding else None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert seen == [4, None]


@pytest.mark.parametrize("weight,start", [(10.0, 30), (3.0, 0), (1.0, 1000)])
def test_nemotron_parse_cross_entropy_matches_jax(weight, start):
    rng = _rng(7)
    logits = (rng.normal(size=(2, 9, 40)) * 2).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 9)).astype(np.int32)
    labels[1, :3] = -100
    kw = dict(coordinate_weight=weight, class_token_start_idx=start)
    (j_sum, j_n), j_grad = jax.value_and_grad(
        lambda x: jl.nemotron_parse_cross_entropy(x, jnp.asarray(labels), **kw), has_aux=True)(jnp.asarray(logits))
    tx = torch.tensor(logits, requires_grad=True)
    t_sum, t_n = tl.build_loss("nemotron_parse", **kw)(tx, torch.tensor(labels))
    t_sum.backward()
    assert int(t_n) == int(j_n) == int((labels != -100).sum())
    np.testing.assert_allclose(float(t_sum.detach()), float(j_sum), rtol=1e-6)
    # the grads reach the coordinate weight in size: fp32 rounding relative to them
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(j_grad), rtol=1e-6, atol=1e-6)


# -- the dense-family aliases --------------------------------------------------


def _hf_model(arch: str):
    """A tiny random HF model of ``arch`` (seeded) and its config dict."""
    import transformers

    torch.manual_seed(0)
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                  pad_token_id=0, bos_token_id=1, eos_token_id=2, tie_word_embeddings=False)
    extra = dict(
        Qwen2ForCausalLM=dict(tie_word_embeddings=True),
        Qwen3ForCausalLM=dict(head_dim=16),
        MistralForCausalLM=dict(sliding_window=6, head_dim=16),
        Phi3ForCausalLM=dict(partial_rotary_factor=0.75, sliding_window=None),
    )[arch]
    cfg_cls = getattr(transformers, arch.replace("ForCausalLM", "Config"))
    cfg = cfg_cls(**dict(common, **extra), attn_implementation="eager")
    cfg.architectures = [arch]
    model = getattr(transformers, arch)(cfg).eval()
    with torch.no_grad():  # biases and norm scales init to 0 / 1: draw them
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.copy_(torch.randn(p.shape) * 0.3 + (1.0 if "norm" in name else 0.0))
    hf = {k: v for k, v in cfg.to_dict().items() if k not in ("torch_dtype", "dtype")}
    return model, hf


ALIASES = ["Qwen2ForCausalLM", "Qwen3ForCausalLM", "MistralForCausalLM", "Phi3ForCausalLM"]


@pytest.mark.parametrize("arch", ALIASES)
def test_alias_logits_match_jax_and_hf(arch, tmp_path):
    """The HF model's weights as an HF directory (its own keys: Phi-3's
    fused) into both packages; logits on 17 random tokens."""
    hf_model, hf = _hf_model(arch)
    src = tmp_path / "src"
    sd = hf_model.state_dict()
    if hf.get("tie_word_embeddings"):
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    hf_io.save_hf_checkpoint(src, sd.items())
    write_hf_addons(src, hf_config=hf)
    keys = hf_io.HFCheckpointReader(src).keys()
    fused = arch == "Phi3ForCausalLM"
    assert any(k.endswith("qkv_proj.weight") for k in keys) == fused
    assert any(k.endswith("gate_up_proj.weight") for k in keys) == fused

    auto = from_pretrained(src, FP32, device="cpu")
    assert type(auto.model).__name__ == "LlamaForCausalLM"
    if fused:
        assert auto.model.config.rope_dim == 12
    jauto = jauto_model.from_pretrained(str(src), None, FP32)
    ids = _rng(8).integers(0, 128, size=(2, 17))
    with torch.no_grad():
        got = auto.model(torch.from_numpy(ids)).numpy()
        ref = hf_model(torch.from_numpy(ids)).logits.numpy()
    want = np.asarray(jauto.model(jauto.params, jnp.asarray(ids.astype(np.int32))))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)

    # the HF save: the canonical split keys, as JAX writes them, bit for bit
    hf_io.save_hf_checkpoint(tmp_path / "port", auto.adapter.to_hf(auto.model.state_dict()))
    jhf.save_hf_checkpoint(tmp_path / "jax", jauto.adapter.to_hf(jax.device_get(jauto.params)))
    port, jax_out = hf_io.HFCheckpointReader(tmp_path / "port"), hf_io.HFCheckpointReader(tmp_path / "jax")
    assert sorted(port.keys()) == sorted(jax_out.keys())
    assert not any("qkv_proj" in k or "gate_up_proj" in k for k in port.keys())
    for k in port.keys():
        assert torch.equal(port.get_tensor(k), jax_out.get_tensor(k)), k
    write_hf_addons(tmp_path / "port", hf_config=hf)
    again = from_pretrained(tmp_path / "port", FP32, device="cpu")
    with torch.no_grad():
        assert torch.equal(again.model(torch.from_numpy(ids)), torch.from_numpy(got))
    assert json.loads((tmp_path / "port" / "config.json").read_text())["architectures"] == [arch]


def test_partial_rotary_changes_the_logits():
    """The match above is not vacuous: the same Phi-3 weights with the
    whole head rotating give other logits."""
    import dataclasses

    from automodel_tpu_torch.auto_model import from_config

    _, hf = _hf_model("Phi3ForCausalLM")
    auto = from_config(hf, FP32, device="cpu", seed=1)
    ids = torch.from_numpy(_rng(9).integers(0, 128, size=(1, 12)))
    with torch.no_grad():
        partial = auto.model(ids)
        auto.model.config = dataclasses.replace(auto.model.config, partial_rotary_factor=1.0)
        full = auto.model(ids)
    assert (partial - full).abs().max() > 1e-3

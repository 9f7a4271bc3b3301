"""The port's quantized-checkpoint ingest (``automodel_tpu_torch/checkpoint/quant_io.py``
and the reader in ``checkpoint/hf_io.py``) against the JAX package's
``checkpoint/quant_io.py``, case for case with ``tests/test_quant_io.py``.

Tolerance: none. The same numpy-made inputs dequantize to the same bits in
both packages (fp8 blockwise, MXFP4), the port's quantizers write the same
fp8 bytes, scales, MXFP4 codes and exponents as JAX's, and a checkpoint
either package writes reads back equal through the other's reader. The
round-trip bounds of the JAX tests are kept as they are.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import torch

from automodel_tpu.checkpoint import quant_io as jq
from automodel_tpu.checkpoint.hf_io import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_io import save_hf_checkpoint as jsave
from automodel_tpu_torch.checkpoint import quant_io as tq
from automodel_tpu_torch.checkpoint.hf_io import HFCheckpointReader, save_hf_checkpoint


def _bits(x) -> np.ndarray:
    """A tensor's or array's bytes, as a flat uint8 array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).copy()).view(torch.bfloat16)


def _fp8(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(torch.float8_e4m3fn)


def test_fp8_blockwise_roundtrip_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((200, 300)).astype(np.float32)  # edge blocks in both dims
    jqw, jscale = jq.quantize_fp8_blockwise(w)
    q, scale_inv = tq.quantize_fp8_blockwise(torch.from_numpy(w))
    assert q.dtype == torch.float8_e4m3fn and tuple(scale_inv.shape) == (2, 3)
    assert np.array_equal(_bits(q), _bits(jqw)) and np.array_equal(scale_inv.numpy(), jscale)
    deq = tq.dequantize_fp8_blockwise(q, scale_inv, dtype=torch.float32)
    assert np.array_equal(deq.numpy(), jq.dequantize_fp8_blockwise(jqw, jscale, dtype=np.float32))
    assert np.max(np.abs(deq.numpy() - w)) / np.max(np.abs(w)) < 0.07
    bf = tq.dequantize_fp8_blockwise(q, scale_inv)
    assert bf.dtype == torch.bfloat16 and np.array_equal(_bits(bf), _bits(jq.dequantize_fp8_blockwise(jqw, jscale)))


def test_fp8_exact_for_representable_values():
    w = np.array([[0.5, 1.0, -2.0], [4.0, 0.25, -0.125]], np.float32)
    deq = tq.dequantize_fp8_blockwise(torch.from_numpy(w).to(torch.float8_e4m3fn), torch.ones(1, 1),
                                      dtype=torch.float32)
    np.testing.assert_array_equal(deq.numpy(), w)


def test_mxfp4_roundtrip_exact_equals_jax():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, size=(3, 8, 64))
    exp = rng.integers(-3, 4, size=(3, 8, 2))
    w_rt = jq.FP4_VALUES[codes].reshape(3, 8, 2, 32) * np.exp2(exp)[..., None]
    w = np.swapaxes(w_rt.reshape(3, 8, 64), -1, -2).astype(ml_dtypes.bfloat16)
    jb, js = jq.pack_mxfp4(w)
    blocks, scales = tq.pack_mxfp4(_bf16(w))
    assert tuple(blocks.shape) == (3, 8, 2, 16) and tuple(scales.shape) == (3, 8, 2)
    assert np.array_equal(blocks.numpy(), jb) and np.array_equal(scales.numpy(), js)
    deq = tq.dequantize_mxfp4(blocks, scales)
    assert np.array_equal(_bits(deq), _bits(jq.dequantize_mxfp4(jb, js)))
    np.testing.assert_array_equal(deq.float().numpy(), np.asarray(w, np.float32))


def test_mxfp4_quantization_error_bounded_and_codes_equal_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 96, 16)).astype(np.float32)
    jb, js = jq.pack_mxfp4(w)
    # a chunk of 5 groups: the chunked code search gives the same codes
    blocks, scales = tq.pack_mxfp4(torch.from_numpy(w), rows_per_chunk=5)
    assert np.array_equal(blocks.numpy(), jb) and np.array_equal(scales.numpy(), js)
    deq = tq.dequantize_mxfp4(blocks, scales, rows_per_chunk=7).float().numpy()
    assert np.array_equal(deq, np.asarray(jq.dequantize_mxfp4(jb, js), np.float32))
    grp = np.swapaxes(w, -1, -2).reshape(4, 16, 3, 32)
    dq = np.swapaxes(deq, -1, -2).reshape(4, 16, 3, 32)
    absmax = np.abs(grp).max(-1, keepdims=True)
    assert np.max(np.abs(dq - grp) / np.maximum(absmax, 1e-6)) < 0.34
    # every exponent, 0 and 255 included: the dequantization stays bit for bit
    b = rng.integers(0, 256, size=(2, 256, 1, 16), dtype=np.uint8)
    s = np.arange(512, dtype=np.int64).reshape(2, 256, 1).astype(np.uint8)
    got = tq.dequantize_mxfp4(torch.from_numpy(b), torch.from_numpy(s), dtype=torch.float32)
    assert np.array_equal(_bits(got), _bits(jq.dequantize_mxfp4(b, s, dtype=np.float32)))


def test_reader_transparent_fp8_across_packages(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((160, 130)).astype(np.float32)
    q, scale_inv = jq.quantize_fp8_blockwise(w)
    plain = rng.standard_normal((8, 8)).astype(ml_dtypes.bfloat16)
    jsave(tmp_path / "jax", [("blk.weight", q), ("blk.weight_scale_inv", scale_inv), ("norm.weight", plain)])
    save_hf_checkpoint(tmp_path / "port", [("blk.weight", _fp8(q)), ("blk.weight_scale_inv", torch.from_numpy(scale_inv)),
                                           ("norm.weight", _bf16(plain))])
    for d in ("jax", "port"):
        r, jr = HFCheckpointReader(tmp_path / d), JReader(tmp_path / d)
        assert sorted(r.keys()) == sorted(jr.keys()) == ["blk.weight", "norm.weight"]
        assert r.info("blk.weight") == jr.info("blk.weight") == ("BF16", (160, 130))
        deq = r.get_tensor("blk.weight")
        assert deq.dtype == torch.bfloat16 and np.array_equal(_bits(deq), _bits(jr.get_tensor("blk.weight")))
        assert np.array_equal(_bits(r.get_tensor("norm.weight")), _bits(plain))
        # the stored payloads stay fp8 with their scales beside them
        assert sorted(r.weight_map) == ["blk.weight", "blk.weight_scale_inv", "norm.weight"]
        assert r._raw_tensor("blk.weight").dtype == torch.float8_e4m3fn
        for x in (r, jr):
            x.close()


def test_reader_transparent_mxfp4_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 16, size=(2, 6, 64))
    w_rt = jq.FP4_VALUES[codes].reshape(2, 6, 2, 32) * np.exp2(rng.integers(-2, 3, size=(2, 6, 2)))[..., None]
    w = np.swapaxes(w_rt.reshape(2, 6, 64), -1, -2).astype(ml_dtypes.bfloat16)
    blocks, scales = tq.pack_mxfp4(_bf16(w))
    save_hf_checkpoint(tmp_path, [("mlp.experts.gate_up_proj_blocks", blocks),
                                  ("mlp.experts.gate_up_proj_scales", scales)])
    r, jr = HFCheckpointReader(tmp_path), JReader(tmp_path)
    assert r.keys() == jr.keys() == ["mlp.experts.gate_up_proj"]
    assert r.info("mlp.experts.gate_up_proj") == jr.info("mlp.experts.gate_up_proj") == ("BF16", (2, 64, 6))
    deq = r.get_tensor("mlp.experts.gate_up_proj")
    assert np.array_equal(_bits(deq), _bits(jr.get_tensor("mlp.experts.gate_up_proj")))
    np.testing.assert_array_equal(deq.float().numpy(), np.asarray(w, np.float32))
    r.close()
    jr.close()


def test_gpt_oss_adapter_loads_mxfp4_checkpoint(tmp_path):
    """A GPT-OSS checkpoint whose expert slabs the port's ``pack_mxfp4``
    wrote loads through ``from_pretrained`` to the same weights as JAX's
    adapter reads from it, and as a bf16 checkpoint of the dequantized
    slabs gives: the model's state dict bit for bit."""
    import jax

    from automodel_tpu.models.gpt_oss.model import GptOssConfig, GptOssForCausalLM
    from automodel_tpu.models.gpt_oss.state_dict_adapter import GptOssStateDictAdapter
    from automodel_tpu_torch.auto_model import from_pretrained
    from automodel_tpu_torch.checkpoint.addons import write_hf_addons
    from automodel_tpu_torch.models.gpt_oss.state_dict_adapter import params_from_jax

    hf = {"model_type": "gpt_oss", "architectures": ["GptOssForCausalLM"], "vocab_size": 64, "hidden_size": 32,
          "intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
          "head_dim": 16, "num_local_experts": 2, "num_experts_per_tok": 1, "sliding_window": 8,
          "torch_dtype": "bfloat16"}
    cfg = GptOssConfig.from_hf(hf)
    jadapter = GptOssStateDictAdapter(cfg)
    params = GptOssForCausalLM(cfg).init(jax.random.key(0))
    tensors = {k: np.asarray(v) for k, v in jadapter.to_hf(params)}
    quant, dense = {}, {}
    for k, v in tensors.items():
        if k.endswith(("experts.gate_up_proj", "experts.down_proj")):
            blocks, scales = tq.pack_mxfp4(_bf16(v))
            quant[f"{k}_blocks"], quant[f"{k}_scales"] = blocks, scales
            dense[k] = tq.dequantize_mxfp4(blocks, scales)
        else:
            quant[k] = dense[k] = _bf16(v)
    for name, tree in (("mxfp4", quant), ("bf16", dense)):
        save_hf_checkpoint(tmp_path / name, list(tree.items()))
        write_hf_addons(tmp_path / name, hf_config=hf)
    backend = dict(param_dtype="bfloat16", compute_dtype="bfloat16", attn="sdpa", experts="ragged")
    got = from_pretrained(tmp_path / "mxfp4", backend, device="cpu").model.state_dict()
    want = from_pretrained(tmp_path / "bf16", backend, device="cpu").model.state_dict()
    jr = JReader(tmp_path / "mxfp4")
    jax_loaded = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jadapter.from_hf(jr.get_tensor)))
    jr.close()
    assert sorted(got) == sorted(want) == sorted(jax_loaded)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k].float(), jax_loaded[k]), k


def test_deepseek_v3_adapter_loads_fp8_blockwise_checkpoint(tmp_path):
    """A tiny DeepSeek-V3 whose projection and expert weights the port's
    ``quantize_fp8_blockwise`` wrote (DeepSeek-V3's published format)
    loads through ``from_pretrained`` to what JAX's adapter reads from the
    same directory, bit for bit."""
    import jax

    from automodel_tpu.models.deepseek_v3.model import DeepseekV3Config as JConfig
    from automodel_tpu.models.deepseek_v3.model import DeepseekV3ForCausalLM as JModel
    from automodel_tpu.models.deepseek_v3.state_dict_adapter import DeepseekV3StateDictAdapter as JAdapter
    from automodel_tpu_torch.auto_model import from_pretrained
    from automodel_tpu_torch.checkpoint.addons import write_hf_addons
    from automodel_tpu_torch.models.deepseek_v3.state_dict_adapter import params_from_jax
    from tests.test_torch_deepseek_v3 import HF_DSV3_TINY

    hf = dict(HF_DSV3_TINY, torch_dtype="bfloat16")
    jcfg = JConfig.from_hf(hf)
    jadapter = JAdapter(jcfg)
    tensors = {k: np.asarray(v) for k, v in jadapter.to_hf(JModel(jcfg).init(jax.random.key(3)))}
    out, n_fp8 = {}, 0
    for k, v in tensors.items():
        if k.endswith("proj.weight") and v.ndim == 2:
            q, s = tq.quantize_fp8_blockwise(torch.from_numpy(np.asarray(v, np.float32)))
            out[k], out[f"{k}_scale_inv"] = q, s
            n_fp8 += 1
        else:
            out[k] = _bf16(v)
    assert n_fp8 > 20  # attention, dense MLP, shared and per-expert projections
    save_hf_checkpoint(tmp_path, list(out.items()))
    write_hf_addons(tmp_path, hf_config=hf)
    backend = dict(param_dtype="bfloat16", compute_dtype="bfloat16", attn="sdpa", experts="ragged")
    got = from_pretrained(tmp_path, backend, device="cpu").model.state_dict()
    jr = JReader(tmp_path)
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jadapter.from_hf(jr.get_tensor)))
    jr.close()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k

"""The torch port's HF weights in and out (automodel_tpu_torch/checkpoint/
hf_io.py, conversion_mapping.py, addons.py, the state-dict adapters and
auto_model.from_pretrained) against the JAX package on the CPU.

For each family (llama, qwen3_moe with and without the aux-free router
bias, gpt_oss, gemma2, gemma3), at tiny widths: a checkpoint the JAX
package writes (``save_hf_checkpoint(adapter.to_hf(params))``) loads into
the port bit for bit equal to ``params_from_jax`` of the same tree, with
logits within the fp32 1e-5 of the parity tests; and the port's save loads
into JAX's ``load_params_from_hf`` bit for bit equal to the port's weights.
Leaves the JAX init zeroes or sets to one (biases, sinks, norm scales) are
filled with seeded random values first, so a map that drops or swaps one
shows. The tests of the reader's pieces follow tests/test_checkpoint_polish.py
and tests/test_streaming_load.py by name."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint import hf_io as jhf
from automodel_tpu.models.common.config import BackendConfig as JaxBackend
from automodel_tpu.models.registry import resolve_architecture as jax_resolve
from automodel_tpu_torch.auto_model import from_config, from_pretrained
from automodel_tpu_torch.checkpoint import hf_io
from automodel_tpu_torch.checkpoint.addons import write_hf_addons
from automodel_tpu_torch.checkpoint.conversion_mapping import detect_remaps
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.gpt_oss.state_dict_adapter import deinterleave, interleave
from automodel_tpu_torch.models.llama.state_dict_adapter import LlamaStateDictAdapter
from automodel_tpu_torch.models.registry import resolve_architecture
from torch_port_parity import HF_TINY
from test_torch_gemma import HF_TINY as HF_GEMMA
from test_torch_gpt_oss import HF_GPT_OSS_TINY
from test_torch_moe_model import HF_MOE_TINY

FP32 = dict(attn="sdpa", param_dtype="float32", compute_dtype="float32")
FAMILIES = {
    "llama": (HF_TINY, {}),
    "qwen3_moe": (HF_MOE_TINY, dict(experts="dense")),
    "qwen3_moe_aux_free": (dict(HF_MOE_TINY, topk_method="noaux_tc", scoring_func="sigmoid"), dict(experts="dense")),
    "gpt_oss": (HF_GPT_OSS_TINY, dict(experts="dense")),
    "gemma2": (dict(HF_GEMMA["gemma2"], num_hidden_layers=2), {}),
    "gemma3": (dict(HF_GEMMA["gemma3"], num_hidden_layers=2), {}),
}
_FILL = ("bias", "linear_bias", "sinks", "gate_up_bias", "down_bias", "scale")


def _carry(hf: dict):
    """The family's ``params_from_jax``."""
    arch = hf["architectures"][0]
    if arch == "Qwen3MoeForCausalLM":
        from automodel_tpu_torch.models.qwen3_moe import params_from_jax
    elif arch == "GptOssForCausalLM":
        from automodel_tpu_torch.models.gpt_oss import params_from_jax
    elif arch.startswith("Gemma"):
        from automodel_tpu_torch.models.gemma import params_from_jax
    else:
        from automodel_tpu_torch.models.llama import params_from_jax
    return params_from_jax


def _jax_pair(family: str, seed: int = 0):
    """(hf config, backend kwargs, JAX model, JAX adapter, params with the
    init's constant leaves filled from the seed)."""
    hf, extra = FAMILIES[family]
    kw = dict(FP32, **extra)
    jmodel, jadapter = jax_resolve(hf)(hf, JaxBackend(**kw))
    params = jmodel.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)

    def fill(path, x):
        if getattr(path[-1], "key", None) in _FILL:
            return jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
        return x

    return hf, kw, jmodel, jadapter, jax.tree_util.tree_map_with_path(fill, params)


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_hf_save_loads_into_the_port_bit_for_bit(family, tmp_path):
    hf, kw, jmodel, jadapter, params = _jax_pair(family)
    np_params = jax.device_get(params)
    jhf.save_hf_checkpoint(tmp_path, jadapter.to_hf(np_params))
    write_hf_addons(tmp_path, hf_config=hf)
    auto = from_pretrained(tmp_path, kw, device="cpu")
    want = _carry(hf)(np_params)
    got = auto.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert auto.source_dir == str(tmp_path) and auto.hf_config == json.loads((tmp_path / "config.json").read_text())
    ids = np.random.default_rng(1).integers(0, hf["vocab_size"], size=(2, 16)).astype(np.int32)
    jl = np.asarray(_logits(jmodel(params, jnp.asarray(ids))))
    with torch.no_grad():
        tl = _logits(auto.model(torch.from_numpy(ids))).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_hf_save_loads_into_jax_bit_for_bit(family, tmp_path):
    hf, kw, _, jadapter, jparams0 = _jax_pair(family)
    auto = from_config(hf, kw, device="cpu", seed=3)
    with torch.no_grad():  # the constant-init leaves, as the JAX side fills them
        g = torch.Generator().manual_seed(4)
        for name, t in auto.model.state_dict().items():
            if name.split(".")[-1] in ("bias", "linear_bias", "sinks", "gate_up_bias", "down_bias") or "norm" in name:
                t.copy_(torch.randn(t.shape, generator=g) * 0.3)
    sd = auto.model.state_dict()
    n = hf_io.save_hf_checkpoint(tmp_path, auto.adapter.to_hf(sd))
    assert n == sum(v.numel() * v.element_size() for v in sd.values())
    write_hf_addons(tmp_path, hf_config=hf)
    jkeys = sorted(k for k, _ in jadapter.to_hf(jax.device_get(jparams0)))
    assert sorted(hf_io.HFCheckpointReader(tmp_path).keys()) == jkeys == sorted(auto.adapter.hf_keys())
    jparams = jhf.load_params_from_hf(jadapter, tmp_path)
    back = _carry(hf)(jax.device_get(jparams))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k


def test_bf16_checkpoints_round_trip_both_ways(tmp_path):
    """bf16 tensors cross in both directions bit for bit (the writer and
    reader use torch's own bfloat16, JAX's ml_dtypes)."""
    bf16 = dict(FP32, param_dtype="bfloat16", compute_dtype="bfloat16")
    jmodel, jadapter = jax_resolve(HF_TINY)(HF_TINY, JaxBackend(**bf16))
    params = jax.device_get(jmodel.init(jax.random.key(0)))
    jhf.save_hf_checkpoint(tmp_path / "jax", jadapter.to_hf(params))
    write_hf_addons(tmp_path / "jax", hf_config=HF_TINY)
    auto = from_pretrained(tmp_path / "jax", bf16, device="cpu")
    want = _carry(HF_TINY)(params)
    for k, v in auto.model.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, want[k]), k
    hf_io.save_hf_checkpoint(tmp_path / "port", auto.adapter.to_hf(auto.model.state_dict()))
    # the same tensors in the same order: the two writers' files are equal byte for byte
    jreader = jhf.HFCheckpointReader(tmp_path / "jax")
    jhf.save_hf_checkpoint(tmp_path / "jax2", [(k, jreader.get_tensor(k)) for k in auto.adapter.hf_keys()])
    assert (tmp_path / "port" / "model.safetensors").read_bytes() == (tmp_path / "jax2" / "model.safetensors").read_bytes()


def test_sharded_save_writes_an_index_both_packages_read(tmp_path):
    auto = from_config(HF_TINY, FP32, device="cpu", seed=0)
    sd = auto.model.state_dict()
    hf_io.save_hf_checkpoint(tmp_path, auto.adapter.to_hf(sd), max_shard_bytes=40_000)
    index = json.loads((tmp_path / hf_io.SAFETENSORS_INDEX).read_text())
    files = sorted(set(index["weight_map"].values()))
    assert len(files) > 2 and files[0] == f"model-00001-of-{len(files):05d}.safetensors"
    assert not list(tmp_path.glob("*.tmp"))
    reader, jreader = hf_io.HFCheckpointReader(tmp_path), jhf.HFCheckpointReader(tmp_path)
    for k in auto.adapter.hf_keys():
        assert torch.equal(reader.get_tensor(k), sd[k])
        np.testing.assert_array_equal(np.asarray(jreader.get_tensor(k)), sd[k].numpy())
    reader.close()
    jreader.close()


@pytest.mark.parametrize("inter", [3, 4])
def test_gpt_oss_gate_up_interleave_round_trips(inter):
    """HF's interleaved gate_up [E, D, 2I] → the port's contiguous halves
    and back, I odd and even, as the JAX adapter's _deint / _reint."""
    from automodel_tpu.models.gpt_oss import state_dict_adapter as jsda

    x = np.random.default_rng(inter).normal(size=(2, 5, 2 * inter)).astype(np.float32)
    d = deinterleave(torch.from_numpy(x))
    np.testing.assert_array_equal(d.numpy(), jsda._deint(x))
    np.testing.assert_array_equal(d[..., :inter].numpy(), x[..., 0::2])
    np.testing.assert_array_equal(interleave(d).numpy(), x)
    np.testing.assert_array_equal(interleave(d).numpy(), jsda._reint(jsda._deint(x)))


def test_write_hf_addons(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "tokenizer.json").write_text("{}")
    (src / "tokenizer_config.json").write_text("{}")
    (src / "generation_config.json").write_text("{}")
    out = tmp_path / "hf"
    written = write_hf_addons(out, hf_config=HF_TINY, source_dir=src)
    assert "config.json" in written and "tokenizer.json" in written
    assert json.loads((out / "config.json").read_text())["model_type"] == "llama"
    assert (out / "generation_config.json").exists()


def test_fused_qkv_remap(tmp_path):
    """A phi-style fused checkpoint (qkv_proj, gate_up_proj) loads through
    the conversion mapping into the same weights as the split one."""
    auto = from_config(HF_TINY, FP32, device="cpu", seed=5)
    sd = auto.model.state_dict()
    fused = {}
    for k, v in sd.items():
        if ".self_attn.k_proj." in k or ".self_attn.v_proj." in k or ".mlp.up_proj." in k:
            continue
        if ".self_attn.q_proj." in k:
            p = k.replace("q_proj.weight", "")
            fused[f"{p}qkv_proj.weight"] = torch.cat([sd[f"{p}{n}_proj.weight"] for n in "qkv"])
        elif ".mlp.gate_proj." in k:
            p = k.replace("gate_proj.weight", "")
            fused[f"{p}gate_up_proj.weight"] = torch.cat([v, sd[f"{p}up_proj.weight"]])
        else:
            fused[k] = v
    hf_io.save_hf_checkpoint(tmp_path, fused.items())
    write_hf_addons(tmp_path, hf_config=HF_TINY)
    remapped = detect_remaps(hf_io.HFCheckpointReader(tmp_path), HF_TINY)
    keys = remapped.keys()
    assert "model.layers.0.self_attn.k_proj.weight" in keys and "model.layers.0.mlp.up_proj.weight" in keys
    assert "model.layers.0.self_attn.qkv_proj.weight" not in keys
    assert remapped.info("model.layers.0.self_attn.v_proj.weight") == ("F32", (32, 64))
    remapped.close()
    loaded = from_pretrained(tmp_path, FP32, device="cpu").model.state_dict()
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k


def test_iter_from_hf_matches_from_hf(tmp_path):
    hf, kw, _, jadapter, params = _jax_pair("qwen3_moe")
    jhf.save_hf_checkpoint(tmp_path, jadapter.to_hf(jax.device_get(params)))
    reader = hf_io.HFCheckpointReader(tmp_path)
    model = resolve_architecture(hf)(hf, BackendConfig(**kw), device="cpu")
    adapter = model.state_dict_adapter(model)
    whole = adapter.from_hf(reader.get_tensor)
    streamed = hf_io.assemble(adapter.iter_from_hf(reader.get_tensor))
    assert set(whole) == set(streamed) == set(model.state_dict())
    for k in whole:
        assert torch.equal(whole[k], streamed[k]), k
    lazy = dict(adapter.iter_from_hf(reader.get_tensor))["model.layers.0.mlp.experts.gate_up"]
    assert isinstance(lazy, hf_io.LazyStacked) and lazy.shape == (8, 64, 64)
    reader.close()


def test_lazy_stacked_rows_and_materialize():
    calls = []

    def row(i):
        def fn():
            calls.append(i)
            return torch.full((2, 3), float(i))
        return fn

    ls = hf_io.LazyStacked([row(i) for i in range(4)])
    assert ls.shape == (4, 2, 3) and ls.dtype == torch.float32 and len(ls) == 4
    assert torch.equal(ls.row(2), torch.full((2, 3), 2.0))
    ls.row(2)  # cached
    assert calls.count(2) == 1
    full = ls.materialize()
    assert full.shape == (4, 2, 3) and torch.equal(full[3], torch.full((2, 3), 3.0))


def test_quantized_checkpoints_and_hub_ids_are_refused(tmp_path):
    """FP8-blockwise and MXFP4 tensors dequantize as JAX's reader does
    (the same keys, the same bf16 bits; a lone fp8 tensor without its
    scales stays fp8), and a path that is no local directory raises naming
    what is not ported."""
    from automodel_tpu.checkpoint.hf_io import HFCheckpointReader as JReader

    fp8 = tmp_path / "fp8"
    hf_io.save_hf_checkpoint(fp8, [
        ("w", torch.randn(4, 4).to(torch.float8_e4m3fn)), ("w_scale_inv", torch.full((1, 1), 0.5)),
        ("plain_fp8", torch.randn(2).to(torch.float8_e4m3fn)),
    ])
    reader, jreader = hf_io.HFCheckpointReader(fp8), JReader(fp8)
    assert sorted(reader.keys()) == sorted(jreader.keys()) == ["plain_fp8", "w"]
    w = reader.get_tensor("w")
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.view(torch.uint16).numpy(), np.asarray(jreader.get_tensor("w")).view(np.uint16))
    assert reader.get_tensor("plain_fp8").dtype == torch.float8_e4m3fn
    mx = tmp_path / "mxfp4"
    hf_io.save_hf_checkpoint(mx, [("e_blocks", torch.randint(0, 256, (2, 3, 4, 16), dtype=torch.uint8)),
                                  ("e_scales", torch.randint(120, 130, (2, 3, 4), dtype=torch.uint8))])
    reader, jreader = hf_io.HFCheckpointReader(mx), JReader(mx)
    assert reader.keys() == jreader.keys() == ["e"]
    e = reader.get_tensor("e")
    assert tuple(e.shape) == (2, 128, 3) and reader.info("e") == jreader.info("e")
    assert np.array_equal(e.view(torch.uint16).numpy(), np.asarray(jreader.get_tensor("e")).view(np.uint16))
    with pytest.raises(ValueError, match="pretrained_model_name_or_path.*hub"):
        from_pretrained("meta-llama/Meta-Llama-3-8B", FP32, device="cpu")


def test_adapter_key_plans_cover_the_model_once():
    for family in FAMILIES:
        hf, kw, _, jadapter, params = _jax_pair(family)
        model = from_config(hf, kw, device="cpu").model
        adapter = model.state_dict_adapter(model)
        assert isinstance(adapter, LlamaStateDictAdapter)
        keys = adapter.hf_keys()
        jkeys = [k for k, _ in jadapter.to_hf(jax.device_get(params))]
        assert len(keys) == len(set(keys)) and sorted(keys) == sorted(jkeys), family

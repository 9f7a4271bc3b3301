"""Activation recompute in the torch port (automodel_tpu_torch/models/
common/stacking.py ``remat_wrap``, the ``remat`` backend key) on the CPU:
for each of the four families (llama, gemma, qwen3_moe, gpt_oss) under
``attn: flash`` (the kernels' plain versions), the parameter grads of one
microbatch with ``remat`` full, selective (and ``full_save_dispatch`` on
the MoE families) equal to those without it, fp32 atol 1e-6; the forward
running again in the backward, once per layer, and never under
``torch.no_grad``; ``full_save_dispatch`` keeping the experts' sort out of
the recompute; one case against JAX with ``remat: selective`` on both
sides; ``scan_layers`` changing nothing, and ``attn_block_*`` taking only
JAX's default 512, which changes nothing. Weights
come from the port's seeded init, inputs from numpy."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from automodel_tpu_torch.auto_model import from_config
from automodel_tpu_torch.models.common.config import BackendConfig
from automodel_tpu_torch.models.common.stacking import remat_wrap
from automodel_tpu_torch.ops import ring_flash as rf
from automodel_tpu_torch.training.train_step import make_causal_lm_loss
from test_torch_gemma import HF_TINY as HF_GEMMA
from test_torch_gpt_oss import HF_GPT_OSS_TINY
from test_torch_moe_model import HF_MOE_TINY
from torch_port_parity import HF_TINY, to_np

FP32 = dict(attn="flash", param_dtype="float32", compute_dtype="float32")
FAMILIES = {
    "llama": (HF_TINY, {}),
    "gemma2": (HF_GEMMA["gemma2"], {}),
    "qwen3_moe": (HF_MOE_TINY, dict(experts="ragged")),
    "gpt_oss": (HF_GPT_OSS_TINY, dict(experts="ragged_fused")),
}
POLICIES = {
    "llama": ("full", "selective"),
    "gemma2": ("full", "selective"),
    "qwen3_moe": ("full", "selective", "full_save_dispatch"),
    "gpt_oss": ("full", "selective", "full_save_dispatch"),
}


def _microbatch(vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mb = dict(input_ids=rng.integers(0, vocab, size=(2, 24)).astype(np.int64),
              labels=rng.integers(0, vocab, size=(2, 24)).astype(np.int64))
    mb["labels"][:, -2:] = -100
    return {k: torch.from_numpy(v) for k, v in mb.items()}


def _grads(family: str, **backend) -> tuple[float, list]:
    hf, extra = FAMILIES[family]
    model = from_config(hf, dict(FP32, **extra, **backend), device="cpu", seed=5, trainable=True).model
    loss_sum, n, *_ = make_causal_lm_loss(model, loss="masked_ce")(_microbatch(hf["vocab_size"]))
    grads = torch.autograd.grad(loss_sum, list(model.parameters()))
    return float(loss_sum.detach()), [g.detach() for g in grads]


def _case_ids():
    return [(f, p) for f in FAMILIES for p in POLICIES[f]]


@pytest.mark.parametrize("family,policy", _case_ids())
def test_remat_grads_equal_no_remat(family, policy):
    loss0, g0 = _grads(family)
    loss1, g1 = _grads(family, remat=policy)
    assert loss1 == loss0
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


@pytest.mark.parametrize("policy,calls", [("none", 1), ("full", 2), ("selective", 2)])
def test_flash_forward_runs_again_in_the_recompute(monkeypatch, policy, calls):
    """The flash forward (its plain version on CPU tensors) runs once per
    layer in the forward and, under ``full`` and ``selective``, once more
    per layer in the backward; the backward kernels once per layer; under
    ``torch.no_grad`` the forward runs once per layer whatever the policy."""
    counts = {"fwd": 0, "dq": 0}
    for name, key in (("_flash_fwd_plain", "fwd"), ("_flash_dq_plain", "dq")):
        orig = getattr(rf, name)

        def counted(*a, _orig=orig, _key=key, **k):
            counts[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(rf, name, counted)
    layers = HF_TINY["num_hidden_layers"]
    _grads("llama", remat=policy)
    assert counts == {"fwd": calls * layers, "dq": layers}
    model = from_config(HF_TINY, dict(FP32, remat=policy), device="cpu", seed=5, trainable=True).model
    counts["fwd"] = 0
    with torch.no_grad():
        model(_microbatch(HF_TINY["vocab_size"])["input_ids"])
    assert counts["fwd"] == layers


class _CountSorts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.sorts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.sort, torch.ops.aten.argsort):
            self.sorts += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", ["qwen3_moe", "gpt_oss"])
def test_full_save_dispatch_keeps_the_sort_out_of_the_recompute(family):
    """Under ``full`` the backward sorts the picks again in each layer's
    recompute; under ``full_save_dispatch`` it sorts nothing."""
    hf, extra = FAMILIES[family]
    sorts = {}
    for policy in ("full", "full_save_dispatch"):
        model = from_config(hf, dict(FP32, **extra, remat=policy), device="cpu", seed=5, trainable=True).model
        loss_sum, *_ = make_causal_lm_loss(model, loss="masked_ce")(_microbatch(hf["vocab_size"]))
        with _CountSorts() as mode:
            torch.autograd.grad(loss_sum, list(model.parameters()))
        sorts[policy] = mode.sorts
    assert sorts["full"] > 0 and sorts["full_save_dispatch"] == 0, sorts


def test_selective_remat_grads_match_jax():
    """The tiny Llama with ``remat: selective`` on both sides (JAX's layer
    scan under ``dots_with_no_batch_dims_saveable``): the mean-token loss's
    grads key by key, fp32 atol 1e-6 on the loss and 1e-5 on the grads."""
    import jax
    import jax.numpy as jnp

    from automodel_tpu.models.common.config import BackendConfig as JaxBackend
    from automodel_tpu.models.common.config import TransformerConfig as JaxTC
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.models.llama import LlamaForCausalLM, params_from_jax
    from automodel_tpu_torch.models.common.config import TransformerConfig

    kw = dict(attn="sdpa", param_dtype="float32", compute_dtype="float32", remat="selective")
    jmodel = JaxLlama(JaxTC.from_hf(HF_TINY), JaxBackend(**kw))
    params = jmodel.init(jax.random.key(1))
    mb = {k: v.numpy().astype(np.int32) for k, v in _microbatch(HF_TINY["vocab_size"], seed=4).items()}
    jfn = jax_loss(jmodel, loss="masked_ce")

    def jax_mean(p):
        loss_sum, n = jfn(p, {k: jnp.asarray(v) for k, v in mb.items()})
        return loss_sum / n

    j_loss, j_grads = jax.value_and_grad(jax_mean)(params)
    tmodel = LlamaForCausalLM(TransformerConfig.from_hf(HF_TINY), BackendConfig(**kw), device="cpu", trainable=True)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    loss_sum, n = make_causal_lm_loss(tmodel, loss="masked_ce")({k: torch.from_numpy(v) for k, v in mb.items()})
    t_loss = loss_sum / n
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), atol=1e-6)
    want = params_from_jax(jax.device_get(j_grads))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(to_np(p.grad), want[name].numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("key,value", [("scan_layers", False), ("attn_block_q", 512), ("attn_block_kv", 512)])
def test_scan_layers_and_attn_blocks_change_nothing(key, value):
    loss0, g0 = _grads("llama")
    loss1, g1 = _grads("llama", **{key: value})
    assert loss1 == loss0 and all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_backend_keys_refused_or_checked():
    for key, value in (("fp8", True), ("fp8_experts", True), ("cp_zigzag", True), ("pp_microbatches", 8)):
        with pytest.raises(ValueError, match=key):
            BackendConfig.from_dict({key: value})
    with pytest.raises(ValueError, match="remat policy 'partial'"):
        BackendConfig(remat="partial")
    for key in ("attn_block_q", "attn_block_kv"):
        for bad in (0, -512, 1.5, True, 128, 1024):
            with pytest.raises(ValueError, match=f"{key}.*only JAX's default 512"):
                BackendConfig(**{key: bad})
    with pytest.raises(ValueError, match="remat policy 'everything'"):
        remat_wrap(lambda x: x, "everything")

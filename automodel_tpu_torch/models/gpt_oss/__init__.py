from automodel_tpu_torch.models.gpt_oss.model import GptOssConfig, GptOssForCausalLM
from automodel_tpu_torch.models.gpt_oss.state_dict_adapter import params_from_jax

__all__ = ["GptOssConfig", "GptOssForCausalLM", "params_from_jax"]

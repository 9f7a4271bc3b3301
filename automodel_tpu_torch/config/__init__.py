from automodel_tpu_torch.config.arg_parser import parse_args_and_load_config, parse_cli_argv
from automodel_tpu_torch.config.loader import ConfigNode, load_yaml_config, translate_value

__all__ = [
    "ConfigNode",
    "load_yaml_config",
    "parse_args_and_load_config",
    "parse_cli_argv",
    "translate_value",
]

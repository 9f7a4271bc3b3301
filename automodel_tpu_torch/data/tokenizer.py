"""Tokenizer layer, port of ``automodel_tpu/data/tokenizer.py`` (reference
``NeMoAutoTokenizer``, _transformers/auto_tokenizer.py:151): an
AutoTokenizer builder that keeps the invariants the data pipeline relies on
(a pad token exists; padding is on the right for training). Mistral-family
checkpoints shipping tekken.json / tokenizer.model.v3 route to the
mistral-common adapter (tokenization_mistral_common.py). ``transformers``
and ``mistral_common`` are imported only inside ``build_tokenizer``, so the
module imports on a host that has neither.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

logger = logging.getLogger(__name__)

_MISTRAL_FILES = ("tekken.json", "tokenizer.model.v3")


def _looks_mistral_common(path: str) -> bool:
    if os.path.basename(path) in _MISTRAL_FILES:
        return True
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f)) for f in _MISTRAL_FILES
    )


def build_tokenizer(
    pretrained_model_name_or_path: str,
    use_fast: bool = True,
    trust_remote_code: bool = False,
    padding_side: str = "right",
    use_mistral_common: Optional[bool] = None,
    **kwargs: Any,
):
    """AutoTokenizer with training-safe defaults (pad token guaranteed).

    ``use_mistral_common``: force (True) or suppress (False) the mistral-
    common adapter; None auto-detects tekken.json / tokenizer.model.v3 in a
    local checkout (reference AutoTokenizer picks the backend the same way,
    _transformers/auto_tokenizer.py)."""
    route_mistral = use_mistral_common
    if route_mistral is None and _looks_mistral_common(
        pretrained_model_name_or_path
    ):
        # auto-detect must not regress checkpoints that also ship a normal
        # tokenizer.json: only route when mistral-common is importable
        # (explicit use_mistral_common=True stays loud if it is missing)
        try:
            import mistral_common  # noqa: F401

            route_mistral = True
        except ImportError:
            logger.info(
                "checkpoint ships a mistral-common tokenizer file but the "
                "package is not installed; falling back to AutoTokenizer"
            )
            route_mistral = False
    if route_mistral:
        from automodel_tpu_torch.data.tokenization_mistral_common import (
            MistralCommonTokenizer,
        )

        return MistralCommonTokenizer.from_pretrained(
            pretrained_model_name_or_path, padding_side=padding_side,
            **kwargs,  # model_max_length/truncation_side; unknown → loud
        )
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(
        pretrained_model_name_or_path,
        use_fast=use_fast,
        trust_remote_code=trust_remote_code,
        **kwargs,
    )
    tok.padding_side = padding_side
    if tok.pad_token is None:
        if tok.eos_token is not None:
            tok.pad_token = tok.eos_token
            logger.info("tokenizer had no pad token; using eos (%r)", tok.eos_token)
        else:
            tok.add_special_tokens({"pad_token": "<|pad|>"})
            logger.info("tokenizer had no pad/eos token; added <|pad|>")
    return tok

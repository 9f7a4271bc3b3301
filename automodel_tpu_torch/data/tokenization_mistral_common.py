"""Mistral-common tokenizer adapter (transformers-shaped surface), port of
``automodel_tpu/data/tokenization_mistral_common.py`` (reference
_transformers/tokenization/tokenization_mistral_common.py). Mistral-family
models ship tekken / sentencepiece tokenizers whose only correct chat
template lives in the ``mistral-common`` package; the adapter wraps its
``MistralTokenizer`` behind the surface the data pipeline touches:
special-token properties, vocab, encode / decode / batch_decode, tokenize
and id ⇄ token conversion, ``__call__`` with padding, truncation and
attention masks, ``pad`` (collators), ``apply_chat_template`` (delegated to
``encode_chat_completion``) and save / from_pretrained. The
``mistral_common`` import is gated inside :func:`load_mistral_tokenizer`;
any object with the same small backend interface works, which is how the
tests drive the adapter without the package.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional, Sequence, Union

import numpy as np

logger = logging.getLogger(__name__)

TRUNC_KEEP = ("longest_first", True, "only_first")


def load_mistral_tokenizer(path: str):
    """Import-gated mistral-common loader: `path` is a tokenizer file
    (tekken.json / *.model) or a directory/repo containing one (reference
    from_pretrained resolution order, tokenization_mistral_common.py:1819)."""
    try:
        from mistral_common.tokens.tokenizers.mistral import MistralTokenizer
    except ImportError as e:  # mistral-common is an optional extra
        raise ImportError(
            "MistralCommonTokenizer needs the `mistral-common` package "
            "(pip install mistral-common); it is not installed"
        ) from e
    if os.path.isdir(path):
        for name in ("tekken.json", "tokenizer.model.v3", "tokenizer.model"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    return MistralTokenizer.from_file(path)


def _build_chat_request(messages, tools=None, continue_final_message=False):
    """OpenAI-style messages → mistral-common ChatCompletionRequest via
    ``from_openai`` (the reference does the same,
    tokenization_mistral_common.py:1640 — it converts tool_calls /
    tool-role / content-part messages into the typed mistral-common
    messages; the raw pydantic constructor rejects those)."""
    from mistral_common.protocol.instruct.request import ChatCompletionRequest

    kw = {"continue_final_message": continue_final_message}
    if tools:
        kw["tools"] = tools
    return ChatCompletionRequest.from_openai(messages=list(messages), **kw)


class MistralCommonTokenizer:
    """Transformers-shaped tokenizer over a mistral-common backend.

    ``backend`` must expose ``instruct_tokenizer.tokenizer`` (the base
    tokenizer: encode(s, bos, eos), decode(ids), bos_id/eos_id/pad_id/unk_id,
    n_words, id_to_piece, vocab) and ``encode_chat_completion(request)``
    returning an object with ``.tokens`` and ``.text``.
    """

    model_input_names = ["input_ids", "attention_mask"]

    def __init__(
        self,
        backend: Any,
        *,
        model_max_length: int = int(1e30),
        padding_side: str = "right",
        truncation_side: str = "right",
        tokenizer_path: Optional[str] = None,
    ):
        self.backend = backend
        self.model_max_length = model_max_length
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self._tokenizer_path = tokenizer_path
        self._pad_id_override: Optional[int] = None

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "MistralCommonTokenizer":
        return cls(load_mistral_tokenizer(path), tokenizer_path=path, **kwargs)

    # -- base tokenizer + special tokens ------------------------------------
    @property
    def _base(self):
        return self.backend.instruct_tokenizer.tokenizer

    @property
    def bos_token_id(self) -> int:
        return self._base.bos_id

    @property
    def eos_token_id(self) -> int:
        return self._base.eos_id

    @property
    def unk_token_id(self) -> Optional[int]:
        return getattr(self._base, "unk_id", None)

    @property
    def pad_token_id(self) -> Optional[int]:
        if self._pad_id_override is not None:
            return self._pad_id_override
        pad = getattr(self._base, "pad_id", None)
        if pad is None or pad < 0:
            # training-safe default, same policy as build_tokenizer: pad
            # with eos (loss masks padding anyway)
            return self.eos_token_id
        return pad

    @pad_token_id.setter
    def pad_token_id(self, value: Optional[int]) -> None:
        self._pad_id_override = value

    def _id_to_piece(self, i: int) -> str:
        return self._base.id_to_piece(i)

    @property
    def bos_token(self) -> str:
        return self._id_to_piece(self.bos_token_id)

    @property
    def eos_token(self) -> str:
        return self._id_to_piece(self.eos_token_id)

    @property
    def pad_token(self) -> Optional[str]:
        pid = self.pad_token_id
        return None if pid is None else self._id_to_piece(pid)

    @property
    def vocab_size(self) -> int:
        return self._base.n_words

    def __len__(self) -> int:
        return self.vocab_size

    def get_vocab(self) -> dict:
        vocab = self._base.vocab()
        if isinstance(vocab, dict):
            return dict(vocab)
        return {piece: i for i, piece in enumerate(vocab)}

    # -- encode / decode -----------------------------------------------------
    def encode(
        self,
        text: Union[str, Sequence[int]],
        add_special_tokens: bool = True,
        truncation: Union[bool, str] = False,
        max_length: Optional[int] = None,
        **kwargs,
    ) -> list:
        if isinstance(text, str):
            ids = list(
                self._base.encode(text, bos=add_special_tokens, eos=False)
            )
        else:
            ids = list(text)
        if truncation in TRUNC_KEEP:
            # HF fallback: truncation=True without max_length truncates to
            # model_max_length (silently never truncating lost batches to
            # shape overflows)
            limit = max_length if max_length is not None else self.model_max_length
            if limit < int(1e30):
                ids = self._truncate(ids, int(limit))
        return ids

    def tokenize(self, text: str, **kwargs) -> list:
        return [
            self._id_to_piece(i)
            for i in self._base.encode(text, bos=False, eos=False)
        ]

    def convert_tokens_to_ids(self, tokens):
        if not hasattr(self, "_vocab_cache"):  # backend vocab is immutable
            self._vocab_cache = self.get_vocab()
        vocab = self._vocab_cache
        if isinstance(tokens, str):
            return vocab.get(tokens, self.unk_token_id)
        return [vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids, skip_special_tokens: bool = False):
        special = set(self._all_special_ids())  # same set decode() strips
        if isinstance(ids, int):
            return self._id_to_piece(ids)
        out = []
        for i in ids:
            if skip_special_tokens and int(i) in special:
                continue
            out.append(self._id_to_piece(int(i)))
        return out

    def decode(
        self, token_ids, skip_special_tokens: bool = False, **kwargs
    ) -> str:
        if hasattr(token_ids, "tolist"):
            token_ids = token_ids.tolist()
        if isinstance(token_ids, int):
            token_ids = [token_ids]
        ids = [int(i) for i in token_ids]
        if skip_special_tokens:
            special = set(self._all_special_ids())
            ids = [i for i in ids if i not in special]
        return self._base.decode(ids)

    def batch_decode(self, sequences, **kwargs) -> list:
        return [self.decode(s, **kwargs) for s in sequences]

    def _all_special_ids(self) -> list:
        ids = {self.bos_token_id, self.eos_token_id}
        if self.pad_token_id is not None:
            ids.add(self.pad_token_id)
        if self.unk_token_id is not None:
            ids.add(self.unk_token_id)
        # tekken control tokens sit below the first regular piece
        n_ctrl = getattr(self._base, "num_special_tokens", None)
        if n_ctrl:
            ids.update(range(n_ctrl))
        return sorted(ids)

    @property
    def all_special_ids(self) -> list:
        return self._all_special_ids()

    # -- padding / truncation ------------------------------------------------
    def _truncate(self, ids: list, max_length: int) -> list:
        if len(ids) <= max_length:
            return ids
        if self.truncation_side == "left":
            return ids[-max_length:]
        return ids[:max_length]

    def _pad_one(self, ids: list, target: int, padding_side: Optional[str],
                 mask: Optional[list] = None):
        n = target - len(ids)
        mask = [1] * len(ids) if mask is None else list(mask)
        if n <= 0:
            return ids, mask
        pad = [self.pad_token_id] * n
        side = padding_side or self.padding_side
        if side == "left":
            return pad + ids, [0] * n + mask
        return ids + pad, mask + [0] * n

    def pad(
        self,
        encoded_inputs,
        padding: Union[bool, str] = True,
        max_length: Optional[int] = None,
        pad_to_multiple_of: Optional[int] = None,
        padding_side: Optional[str] = None,
        return_tensors: Optional[str] = None,
        **kwargs,
    ) -> dict:
        """Collator-style batch padding over {'input_ids': [[...], ...]}."""
        if isinstance(encoded_inputs, (list, tuple)):
            encoded_inputs = {
                k: [d[k] for d in encoded_inputs] for k in encoded_inputs[0]
            }
        seqs = [list(s) for s in encoded_inputs["input_ids"]]
        # a caller-provided attention_mask (pre-padded features) EXTENDS
        # with zeros rather than being rebuilt as all-ones (HF semantics)
        given_masks = encoded_inputs.get("attention_mask")
        if padding == "max_length" and max_length is not None:
            target = max_length
        else:
            target = max(len(s) for s in seqs)
        if pad_to_multiple_of:
            target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
        ids, masks = zip(*(
            self._pad_one(
                s, target, padding_side,
                mask=None if given_masks is None else given_masks[i],
            )
            for i, s in enumerate(seqs)
        ))
        out = {"input_ids": list(ids), "attention_mask": list(masks)}
        # unknown feature keys pass through (HF tokenizer.pad semantics —
        # collators pad labels themselves) BEFORE tensorization so every
        # key converts uniformly (ragged extras raise, exactly like HF)
        for k, v in encoded_inputs.items():
            if k not in out and k != "attention_mask":
                out[k] = v
        if return_tensors == "np":
            out = {k: np.asarray(v) for k, v in out.items()}
        return out

    # -- __call__ ------------------------------------------------------------
    def __call__(
        self,
        text: Union[str, Sequence[str]],
        add_special_tokens: bool = True,
        padding: Union[bool, str] = False,
        truncation: Union[bool, str] = False,
        max_length: Optional[int] = None,
        return_tensors: Optional[str] = None,
        return_attention_mask: bool = True,
        **kwargs,
    ) -> dict:
        batched = not isinstance(text, str)
        texts = list(text) if batched else [text]
        seqs = [
            self.encode(
                t, add_special_tokens=add_special_tokens,
                truncation=truncation, max_length=max_length,
            )
            for t in texts
        ]
        if padding:
            out = self.pad(
                {"input_ids": seqs}, padding=padding, max_length=max_length
            )
        else:
            out = {
                "input_ids": seqs,
                "attention_mask": [[1] * len(s) for s in seqs],
            }
        if not return_attention_mask:
            out.pop("attention_mask", None)
        if not batched:
            out = {k: v[0] for k, v in out.items()}
        if return_tensors == "np":
            out = {k: np.asarray(v, np.int64) for k, v in out.items()}
        return out

    # -- chat template -------------------------------------------------------
    def apply_chat_template(
        self,
        conversation,
        tools=None,
        add_generation_prompt: bool = False,
        continue_final_message: bool = False,
        tokenize: bool = True,
        padding: Union[bool, str] = False,
        truncation: bool = False,
        max_length: Optional[int] = None,
        return_tensors: Optional[str] = None,
        return_dict: bool = False,
        **kwargs,
    ):
        """The template IS mistral-common's encode_chat_completion — never a
        Jinja reimplementation (the reference takes the same stance)."""
        if add_generation_prompt and continue_final_message:
            raise ValueError(
                "cannot use both add_generation_prompt and continue_final_message"
            )
        batched = bool(conversation) and isinstance(conversation[0], (list, tuple))
        convs = conversation if batched else [conversation]
        if add_generation_prompt:
            for c in convs:
                if c and c[-1].get("role") == "assistant":
                    raise ValueError(
                        "conversation already ends with an assistant message; "
                        "use continue_final_message"
                    )

        def _one(c):
            # SFT conversations (chat.py label building) END with assistant
            # turns, which mistral-common only encodes as an open prefix
            # (continue_final_message). The mistral templates close every
            # assistant turn with EOS, so prefix-encode + append EOS
            # reproduces the closed-turn token stream exactly; an EXPLICIT
            # continue_final_message keeps the turn open (prefill).
            close_eos = False
            cfm = continue_final_message
            if not cfm and c and c[-1].get("role") == "assistant":
                cfm, close_eos = True, True
            enc = self.backend.encode_chat_completion(
                _build_chat_request(c, tools=tools, continue_final_message=cfm)
            )
            return enc, close_eos

        enc_pairs = [_one(c) for c in convs]
        if not tokenize:
            texts = [e.text for e, _ in enc_pairs]
            return texts if batched else texts[0]
        seqs = [
            list(e.tokens) + ([self.eos_token_id] if close else [])
            for e, close in enc_pairs
        ]
        if truncation and max_length is not None:
            seqs = [self._truncate(s, max_length) for s in seqs]
        if not return_dict:
            return seqs if batched else seqs[0]
        out = self.pad(
            {"input_ids": seqs},
            padding=padding or "longest",
            max_length=max_length,
            return_tensors=return_tensors,
        )
        return out

    # -- persistence ---------------------------------------------------------
    def save_pretrained(self, save_directory: str, **kwargs) -> tuple:
        """Copy the underlying tokenizer file (reference save_pretrained
        writes the mistral-common file, not an HF tokenizer.json)."""
        import shutil

        if self._tokenizer_path is None or not os.path.exists(self._tokenizer_path):
            raise ValueError(
                "this tokenizer was built from an in-memory backend; nothing "
                "to save (construct via from_pretrained to keep the file path)"
            )
        os.makedirs(save_directory, exist_ok=True)
        src = self._tokenizer_path
        if os.path.isdir(src):
            for name in ("tekken.json", "tokenizer.model.v3", "tokenizer.model"):
                cand = os.path.join(src, name)
                if os.path.exists(cand):
                    src = cand
                    break
        dst = os.path.join(save_directory, os.path.basename(src))
        shutil.copyfile(src, dst)
        return (dst,)

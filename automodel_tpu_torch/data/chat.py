"""Chat-template and tool-calling SFT datasets, port of
``automodel_tpu/data/chat.py`` (reference datasets/llm/chat_dataset.py:189,
formatting_utils.py and xlam.py:199): conversation → chat-template tokens
with assistant-only labels, preference pairs with a shared prompt mask,
xLAM function-calling rows, sequence classification rows.

Label masking applies the template one turn at a time: it tokenizes
``messages[:i]`` for every prefix and marks only the token spans that
assistant turns add, which holds for any chat template (no substring
search against retokenized answers). The tokenizer is duck-typed: anything
with ``apply_chat_template`` (and ``__call__`` for ``SeqClsDataset``).
"""

from __future__ import annotations

import json
from typing import Any, Iterator, Optional, Sequence

import numpy as np

from automodel_tpu_torch.data.collators import IGNORE_INDEX


def _template_len(tokenizer: Any, messages: Sequence[dict], **kw: Any) -> int:
    if not messages:
        return 0
    ids = tokenizer.apply_chat_template(list(messages), tokenize=True, **kw)
    if isinstance(ids, dict):
        ids = ids["input_ids"]
    return len(np.asarray(ids).reshape(-1))


def tokenize_conversation(
    tokenizer: Any, messages: Sequence[dict], chat_template_kwargs: Optional[dict] = None
) -> dict:
    """messages (OpenAI-style role/content dicts) → input_ids + labels with
    IGNORE_INDEX on everything except assistant-turn tokens."""
    kw = dict(chat_template_kwargs or {})
    ids = tokenizer.apply_chat_template(list(messages), tokenize=True, **kw)
    if isinstance(ids, dict):
        ids = ids["input_ids"]
    ids = np.asarray(ids).reshape(-1)
    labels = np.full_like(ids, IGNORE_INDEX)
    for i, msg in enumerate(messages):
        if msg.get("role") != "assistant":
            continue
        start = _template_len(tokenizer, messages[:i], **kw)
        end = _template_len(tokenizer, messages[: i + 1], **kw)
        # the turn may include generation markers before the content; the
        # whole span added by this assistant turn trains (reference
        # formatting_utils answer-only masking semantics)
        labels[start:end] = ids[start:end]
    return {"input_ids": ids.tolist(), "labels": labels.tolist()}


class ChatDataset:
    """Column-mapped conversation dataset: each row carries an OpenAI-style
    ``messages`` list (or ``conversations`` with from/value keys, converted)."""

    def __init__(
        self,
        dataset: Any,
        tokenizer: Any,
        messages_column: str = "messages",
        system_prompt: Optional[str] = None,
        chat_template_kwargs: Optional[dict] = None,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.messages_column = messages_column
        self.system_prompt = system_prompt
        self.chat_template_kwargs = chat_template_kwargs

    def __len__(self) -> int:
        return len(self.dataset)

    @staticmethod
    def _normalize(messages: Sequence[dict]) -> list[dict]:
        out = []
        for m in messages:
            if "from" in m:  # sharegpt style
                role = {"human": "user", "gpt": "assistant"}.get(m["from"], m["from"])
                out.append({"role": role, "content": m.get("value", "")})
            else:
                out.append({"role": m["role"], "content": m.get("content", "")})
        return out

    def __getitem__(self, idx: int) -> dict:
        messages = self._normalize(self.dataset[idx][self.messages_column])
        if self.system_prompt and (not messages or messages[0]["role"] != "system"):
            messages = [{"role": "system", "content": self.system_prompt}] + messages
        return tokenize_conversation(self.tokenizer, messages, self.chat_template_kwargs)

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]


def tokenize_preference_pair(
    tokenizer: Any,
    prompt: Any,
    chosen: Any,
    rejected: Any,
    chat_template_kwargs: Optional[dict] = None,
) -> dict:
    """One preference pair → per-side token arrays with a SHARED prompt mask.

    Both sides tokenize the identical prompt prefix through the same chat
    template; labels carry IGNORE_INDEX over that prefix on BOTH sides, so
    neither policy's per-sequence logprob sum counts prompt tokens — the
    DPO/ORPO margin compares response likelihoods only. Keys are prefixed
    (``chosen_input_ids``/``chosen_labels``/``rejected_...``) so the pair
    rides one example dict through ``preference_collater``.
    """
    kw = dict(chat_template_kwargs or {})
    if isinstance(prompt, str):
        prompt_msgs = [{"role": "user", "content": prompt}]
    else:
        prompt_msgs = ChatDataset._normalize(prompt)
    prompt_len = _template_len(tokenizer, prompt_msgs, **kw)
    out: dict[str, Any] = {}
    for side, response in (("chosen", chosen), ("rejected", rejected)):
        if isinstance(response, list):  # full-conversation column (HH style)
            response = response[-1]
        if isinstance(response, dict):
            msg = ChatDataset._normalize([response])[0]
        else:
            msg = {"role": "assistant", "content": str(response)}
        ids = tokenizer.apply_chat_template(prompt_msgs + [msg], tokenize=True, **kw)
        if isinstance(ids, dict):
            ids = ids["input_ids"]
        ids = np.asarray(ids).reshape(-1)
        labels = np.full_like(ids, IGNORE_INDEX)
        labels[prompt_len:] = ids[prompt_len:]
        out[f"{side}_input_ids"] = ids.tolist()
        out[f"{side}_labels"] = labels.tolist()
    return out


class PreferenceDataset:
    """Column-mapped preference-pair dataset (the UltraFeedback/HH shape):
    each row carries a prompt plus a chosen and a rejected response."""

    def __init__(
        self,
        dataset: Any,
        tokenizer: Any,
        prompt_column: str = "prompt",
        chosen_column: str = "chosen",
        rejected_column: str = "rejected",
        chat_template_kwargs: Optional[dict] = None,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.prompt_column = prompt_column
        self.chosen_column = chosen_column
        self.rejected_column = rejected_column
        self.chat_template_kwargs = chat_template_kwargs

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        row = self.dataset[idx]
        return tokenize_preference_pair(
            self.tokenizer,
            row[self.prompt_column],
            row[self.chosen_column],
            row[self.rejected_column],
            self.chat_template_kwargs,
        )

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]


class XLamDataset:
    """Salesforce xLAM function-calling rows → tool-call SFT conversations
    (reference datasets/llm/xlam.py:199). Rows: ``query`` (str), ``tools``
    (JSON list of tool specs), ``answers`` (JSON list of calls)."""

    def __init__(
        self,
        dataset: Any,
        tokenizer: Any,
        system_prompt: str = (
            "You are a helpful assistant with access to the following tools. "
            "Use them when needed to answer the user."
        ),
        chat_template_kwargs: Optional[dict] = None,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.system_prompt = system_prompt
        self.chat_template_kwargs = chat_template_kwargs

    def __len__(self) -> int:
        return len(self.dataset)

    @staticmethod
    def _loads(v: Any) -> Any:
        return json.loads(v) if isinstance(v, str) else v

    def __getitem__(self, idx: int) -> dict:
        row = self.dataset[idx]
        tools = self._loads(row.get("tools", []))
        answers = self._loads(row.get("answers", []))
        messages = [
            {
                "role": "system",
                "content": f"{self.system_prompt}\n\nTools:\n{json.dumps(tools)}",
            },
            {"role": "user", "content": str(row["query"])},
            {"role": "assistant", "content": json.dumps(answers)},
        ]
        return tokenize_conversation(self.tokenizer, messages, self.chat_template_kwargs)

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]


class SeqClsDataset:
    """Column-mapped sequence-classification dataset (reference
    datasets/llm/seq_cls.py:74): text (+optional pair) → input_ids + label."""

    def __init__(
        self,
        dataset: Any,
        tokenizer: Any,
        text_column: str = "text",
        pair_column: Optional[str] = None,
        label_column: str = "label",
        max_len: int = 512,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.text_column = text_column
        self.pair_column = pair_column
        self.label_column = label_column
        self.max_len = max_len

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        row = self.dataset[idx]
        text = str(row[self.text_column])
        if self.pair_column:
            text = text + "\n" + str(row[self.pair_column])
        ids = self.tokenizer(text, add_special_tokens=True)
        if isinstance(ids, dict):
            ids = ids["input_ids"]
        return {
            "input_ids": list(ids)[: self.max_len],
            "label": int(row[self.label_column]),
        }

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]

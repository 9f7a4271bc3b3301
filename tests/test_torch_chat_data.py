"""The port's chat datasets and tokenizer adapters (automodel_tpu_torch/data/
chat.py, tokenizer.py, tokenization_mistral_common.py, delta_lake.py)
against the JAX package on the CPU, with the duck-typed tokenizer of
tests/test_chat_data.py and the fake mistral-common backend of
tests/test_mistral_tokenizer.py: the same rows give the same input ids
and labels (held exactly); ``build_tokenizer``'s pad fallback and Mistral
routing; the adapter's encode, decode, padding, truncation and chat
template; the import gates and their messages."""

import os
import subprocess
import sys

import numpy as np
import pytest

from automodel_tpu.data import chat as jchat
from automodel_tpu.data import tokenization_mistral_common as JM
from automodel_tpu.data import tokenizer as jtok
from automodel_tpu_torch.data import chat as tchat
from automodel_tpu_torch.data import tokenization_mistral_common as TM
from automodel_tpu_torch.data import tokenizer as ttok
from automodel_tpu_torch.data.collators import IGNORE_INDEX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeTokenizer:
    """tests/test_chat_data.py's whitespace tokenizer with a llama-ish chat
    template: a role-header token, content tokens, an end token per turn.
    Word ids come from a fixed table (not ``hash``), so they are the same
    in every process."""

    ROLE = {"system": 1, "user": 2, "assistant": 3}
    END = 4
    pad_token = "<pad>"
    eos_token = "<eos>"

    def _word(self, w):
        return 10 + sum(w.encode()) % 1000

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [self._word(w) for w in str(text).split()]}

    def apply_chat_template(self, messages, tokenize=True, **kw):
        ids = []
        for m in messages:
            ids.append(self.ROLE[m["role"]])
            ids.extend(self._word(w) for w in str(m["content"]).split())
            ids.append(self.END)
        return ids


CONVERSATION = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": "hi there"},
    {"role": "assistant", "content": "hello world foo"},
    {"role": "user", "content": "more"},
    {"role": "assistant", "content": "bye"},
]


def test_tokenize_conversation_matches_jax_and_masks_non_assistant():
    tok = FakeTokenizer()
    out = tchat.tokenize_conversation(tok, CONVERSATION)
    assert out == jchat.tokenize_conversation(tok, CONVERSATION)
    ids, labels = np.asarray(out["input_ids"]), np.asarray(out["labels"])
    pre2, end2 = (len(tok.apply_chat_template(CONVERSATION[:n])) for n in (2, 3))
    pre4 = len(tok.apply_chat_template(CONVERSATION[:4]))
    want = np.full(len(ids), IGNORE_INDEX)
    want[pre2:end2], want[pre4:] = ids[pre2:end2], ids[pre4:]
    np.testing.assert_array_equal(labels, want)


def test_datasets_match_jax_row_for_row():
    tok = FakeTokenizer()
    chat_rows = [{"messages": [{"from": "human", "value": "q"}, {"from": "gpt", "value": "a b"}]},
                 {"messages": CONVERSATION}, {"conversations": CONVERSATION[1:3]}]
    xlam_rows = [{"query": "what time is it", "tools": '[{"name": "clock", "parameters": {}}]',
                  "answers": '[{"name": "clock", "arguments": {}}]'}]
    cls_rows = [{"text": "good movie", "pair": "yes", "label": 1}, {"text": "bad", "pair": "no", "label": 0}]
    pref_rows = [{"prompt": "why", "chosen": "because so", "rejected": "no"},
                 {"prompt": CONVERSATION[:2], "chosen": [CONVERSATION[2]], "rejected": {"role": "assistant",
                                                                                          "content": "meh"}}]
    cases = [
        (tchat.ChatDataset(chat_rows[:2], tok, system_prompt="sys"), jchat.ChatDataset(chat_rows[:2], tok,
                                                                                      system_prompt="sys")),
        (tchat.ChatDataset(chat_rows[2:], tok, messages_column="conversations"),
         jchat.ChatDataset(chat_rows[2:], tok, messages_column="conversations")),
        (tchat.XLamDataset(xlam_rows, tok), jchat.XLamDataset(xlam_rows, tok)),
        (tchat.SeqClsDataset(cls_rows, tok, pair_column="pair", max_len=3),
         jchat.SeqClsDataset(cls_rows, tok, pair_column="pair", max_len=3)),
        (tchat.PreferenceDataset(pref_rows, tok), jchat.PreferenceDataset(pref_rows, tok)),
    ]
    for t, j in cases:
        assert len(t) == len(j) and list(t) == list(j)
    ex = cases[0][0][0]
    assert (np.asarray(ex["labels"]) != IGNORE_INDEX).sum() == 4  # role + 'a' + 'b' + end
    pair = cases[-1][0][0]
    n_prompt = len(tok.apply_chat_template([{"role": "user", "content": "why"}]))
    for side in ("chosen", "rejected"):
        assert pair[f"{side}_labels"][:n_prompt] == [IGNORE_INDEX] * n_prompt
    assert cases[3][0][0] == {"input_ids": tok("good movie\nyes")["input_ids"][:3], "label": 1}


def test_build_tokenizer_pad_fallback_matches_jax(monkeypatch):
    import transformers

    class Tok:
        pad_token = None
        eos_token = "</s>"
        padding_side = "left"

    class NoEos(Tok):
        eos_token = None
        added = None

        def add_special_tokens(self, d):
            self.pad_token = d["pad_token"]

    for cls in (Tok, NoEos):
        monkeypatch.setattr(transformers, "AutoTokenizer", type("A", (), {
            "from_pretrained": staticmethod(lambda name, **kw: cls())}))
        t, j = ttok.build_tokenizer("any"), jtok.build_tokenizer("any")
        assert (t.pad_token, t.padding_side) == (j.pad_token, j.padding_side)
        assert t.padding_side == "right" and t.pad_token == ("</s>" if cls is Tok else "<|pad|>")


def test_modules_import_without_transformers_or_mistral_common():
    code = ("import sys\n"
            "import automodel_tpu_torch.data.tokenizer, automodel_tpu_torch.data.tokenization_mistral_common\n"
            "import automodel_tpu_torch.data.chat, automodel_tpu_torch.data.delta_lake\n"
            "print(sorted(k for k in ('transformers', 'mistral_common', 'deltalake') if k in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


class _FakeBase:
    """tests/test_mistral_tokenizer.py's byte-level base: ids 0..3 are
    control (<unk>/<s>/</s>/<pad>), bytes map to 4 + b."""

    bos_id, eos_id, unk_id, pad_id = 1, 2, 0, -1
    num_special_tokens = 4
    n_words = 4 + 256

    def encode(self, s, bos=False, eos=False):
        ids = [4 + b for b in s.encode("utf-8")]
        return ([self.bos_id] if bos else []) + ids + ([self.eos_id] if eos else [])

    def decode(self, ids):
        return bytes(i - 4 for i in ids if i >= 4).decode("utf-8", "ignore")

    def id_to_piece(self, i):
        return ["<unk>", "<s>", "</s>", "<pad>"][i] if i < 4 else chr(i - 4)

    def vocab(self):
        return [self.id_to_piece(i) for i in range(self.n_words)]


class _Enc:
    def __init__(self, tokens, text):
        self.tokens, self.text = tokens, text


class _FakeBackend:
    class instruct_tokenizer:  # noqa: N801 (mistral-common's attribute name)
        tokenizer = _FakeBase()

    def encode_chat_completion(self, request):
        base = self.instruct_tokenizer.tokenizer
        text = "".join(f"[{m['role'].upper()}]{m['content']}" for m in request.messages)
        return _Enc([base.bos_id] + base.encode(text), text)


class _FakeRequest:
    def __init__(self, **kw):
        self.messages = kw["messages"]


@pytest.fixture()
def toks(monkeypatch):
    """(port adapter, JAX adapter) over the same fake backend."""
    for mod in (TM, JM):
        monkeypatch.setattr(mod, "_build_chat_request", lambda messages, tools=None, continue_final_message=False:
                            _FakeRequest(messages=list(messages)))
    return TM.MistralCommonTokenizer(_FakeBackend()), JM.MistralCommonTokenizer(_FakeBackend())


def _np_eq(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _np_eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _np_eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mistral_adapter_matches_jax(toks):
    t, j = toks
    conv = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "yo"}]
    calls = [
        lambda k: k.encode("hello", add_special_tokens=True),
        lambda k: k.encode("hello world", truncation=True, max_length=4),
        lambda k: k.decode(k.encode("héllo"), skip_special_tokens=True),
        lambda k: k.batch_decode([[1, 108], [109]]),
        lambda k: k.tokenize("ab"),
        lambda k: (k.pad_token_id, k.pad_token, k.bos_token, k.eos_token, k.vocab_size, k.all_special_ids),
        lambda k: (k.convert_tokens_to_ids(["a", "zz"]), k.convert_ids_to_tokens([1, 101], skip_special_tokens=True)),
        lambda k: k(["ab", "abcdef"], padding=True, return_tensors="np"),
        lambda k: k("abcdef", truncation=True, max_length=3),
        lambda k: k.pad([{"input_ids": [5, 6]}, {"input_ids": [5, 6, 7]}], pad_to_multiple_of=4, return_tensors="np"),
        lambda k: k.pad({"input_ids": [[5], [5, 6]], "attention_mask": [[1], [1, 1]], "labels": [[1], [1, 2]]},
                        padding="max_length", max_length=4),
        lambda k: k.apply_chat_template(conv, tokenize=False),
        lambda k: k.apply_chat_template(conv),
        lambda k: k.apply_chat_template(conv, continue_final_message=True),
        lambda k: k.apply_chat_template([conv, conv[:1]], return_dict=True, return_tensors="np"),
        lambda k: tchat.tokenize_conversation(k, conv + [{"role": "user", "content": "more?"},
                                                        {"role": "assistant", "content": "sure"}]),
    ]
    for call in calls:
        _np_eq(call(t), call(j))
    t.padding_side = j.padding_side = "left"
    _np_eq(t(["ab", "abcdef"], padding=True), j(["ab", "abcdef"], padding=True))
    t.pad_token_id = j.pad_token_id = 3
    assert t.pad_token == j.pad_token == "<pad>"
    for k in (t, j):
        with pytest.raises(ValueError, match="already ends with an assistant"):
            k.apply_chat_template(conv, add_generation_prompt=True)


def test_build_tokenizer_routes_mistral_files_as_jax_does(tmp_path, monkeypatch):
    (tmp_path / "tekken.json").write_text("{}")
    monkeypatch.setattr(TM, "load_mistral_tokenizer", lambda p: _FakeBackend())
    tok = ttok.build_tokenizer(str(tmp_path), use_mistral_common=True)
    assert isinstance(tok, TM.MistralCommonTokenizer)
    monkeypatch.setitem(sys.modules, "mistral_common", object())
    tok = ttok.build_tokenizer(str(tmp_path))
    assert isinstance(tok, TM.MistralCommonTokenizer)
    (saved,) = tok.save_pretrained(str(tmp_path / "out"))
    assert saved.endswith("tekken.json") and open(saved).read() == "{}"
    monkeypatch.delitem(sys.modules, "mistral_common")
    assert ttok._looks_mistral_common(str(tmp_path)) == jtok._looks_mistral_common(str(tmp_path)) is True
    with pytest.raises(Exception) as err:  # auto-detect falls back to AutoTokenizer
        ttok.build_tokenizer(str(tmp_path))
    assert "mistral-common" not in str(err.value)
    with pytest.raises(ValueError, match="in-memory backend"):
        TM.MistralCommonTokenizer(_FakeBackend()).save_pretrained(str(tmp_path / "x"))


def test_import_gates_name_the_missing_packages():
    with pytest.raises(ImportError, match="mistral-common"):
        TM.load_mistral_tokenizer("/nonexistent/tekken.json")
    from automodel_tpu.data.delta_lake import DeltaLakeDataset as JDelta
    from automodel_tpu_torch.data.delta_lake import DeltaLakeDataset

    with pytest.raises(ImportError, match="deltalake") as t_err:
        DeltaLakeDataset("s3://nope", tokenizer=lambda t: [1])
    with pytest.raises(ImportError, match="deltalake") as j_err:
        JDelta("s3://nope", tokenizer=lambda t: [1])
    assert str(t_err.value) == str(j_err.value)

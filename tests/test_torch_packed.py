"""Sequence packing in the port (automodel_tpu_torch/data/packed.py,
``collators.packed_collater``) against the JAX package on the CPU: greedy
fill, segment 0 for padding, position ids that restart in each document,
labels that shift within a segment and stop at its end; then a tiny
Llama's logits on a packed row against each document's own forward (sdpa
and flash's plain versions, fp32, atol 1e-5), and the packed row's loss in
the port against JAX's on the same weights. Inputs are made with numpy
from a seed; integer outputs are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.data.collators import packed_collater as jax_packed_collater
from automodel_tpu.data.packed import pack_sequences as jax_pack
from automodel_tpu_torch.data.collators import IGNORE_INDEX, packed_collater, stack_microbatches
from automodel_tpu_torch.data.packed import pack_sequences
from torch_port_parity import HF_TINY, jax_tiny, to_np, torch_twin


def _examples(seed: int, n: int, lo: int, hi: int, masked: bool = False) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(3, HF_TINY["vocab_size"], size=int(rng.integers(lo, hi))).tolist()
        ex = {"input_ids": ids}
        if masked:
            k = len(ids) // 3
            ex["labels"] = [IGNORE_INDEX] * k + ids[k:]
        out.append(ex)
    return out


@pytest.mark.parametrize("drop_overlong", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_pack_sequences_matches_jax(drop_overlong, masked):
    examples = _examples(0, 40, 1, 90, masked)
    got = list(pack_sequences(examples, 64, pad_token_id=2, drop_overlong=drop_overlong))
    want = list(jax_pack(examples, 64, pad_token_id=2, drop_overlong=drop_overlong))
    assert got == want and len(got) > 5
    for row in got:
        seg = np.asarray(row["segment_ids"])
        assert all(len(v) == 64 for v in row.values())
        assert (np.diff(seg[seg > 0]) >= 0).all() and (seg[np.asarray(row["input_ids"]) == 2] == 0).all()
        for s in range(1, seg.max() + 1):
            np.testing.assert_array_equal(np.asarray(row["position_ids"])[seg == s], np.arange((seg == s).sum()))


def test_packed_collater_matches_jax():
    rows = list(pack_sequences(_examples(1, 30, 5, 40, masked=True), 64))
    got, want = packed_collater(rows[:4]), jax_packed_collater(rows[:4])
    assert set(got) == set(want)
    for k in ("input_ids", "labels", "position_ids", "segment_ids"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["num_label_tokens"] == want["num_label_tokens"]
    seg, labels, ids = got["segment_ids"], got["labels"], got["input_ids"]
    ends = np.concatenate([seg[:, :-1] != seg[:, 1:], np.ones((4, 1), bool)], axis=1)
    assert (labels[ends] == IGNORE_INDEX).all()
    inside = ~ends & (labels != IGNORE_INDEX)
    np.testing.assert_array_equal(labels[inside], ids[:, 1:][inside[:, :-1]])


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
def test_packed_row_logits_equal_each_documents_own_forward(attn):
    """A packed row of 4 documents and padding through the tiny Llama with
    segment ids and restarting positions: each document's logits equal
    its forward alone (fp32, atol 1e-5), and equal JAX's packed forward."""
    model, params, _ = jax_tiny(seed=0)
    twin = torch_twin(params, attn=attn).model
    docs = _examples(2, 4, 6, 20)
    row = next(pack_sequences(docs, 80))
    batch = packed_collater([row])
    ids = torch.from_numpy(batch["input_ids"])
    kw = dict(position_ids=torch.from_numpy(batch["position_ids"]), segment_ids=torch.from_numpy(batch["segment_ids"]))
    with torch.no_grad():
        packed = twin(ids, **kw)
        start = 0
        for d in docs:
            n = len(d["input_ids"])
            alone = twin(torch.tensor([d["input_ids"]]))
            np.testing.assert_allclose(to_np(packed[0, start:start + n]), to_np(alone[0]), atol=1e-5)
            start += n
    assert start < 80
    want = model(params, jnp.asarray(batch["input_ids"]), position_ids=jnp.asarray(batch["position_ids"]),
                 segment_ids=jnp.asarray(batch["segment_ids"]))
    live = batch["segment_ids"][0] > 0
    np.testing.assert_allclose(to_np(packed)[0][live], np.asarray(want)[0][live], atol=1e-5)


def test_packed_batch_loss_matches_jax():
    """The train step's loss on a stacked packed batch (fused_linear_ce,
    two microbatches) against JAX's loss on the same weights and batch:
    fp32, atol 1e-5, and the same label count."""
    from automodel_tpu.training.train_step import make_causal_lm_loss as jax_loss
    from automodel_tpu_torch.training.train_step import make_causal_lm_loss

    model, params, _ = jax_tiny(seed=1)
    twin = torch_twin(params, attn="flash").model
    rows = list(pack_sequences(_examples(3, 24, 4, 30, masked=True), 48))
    stacked = stack_microbatches([packed_collater(rows[0:2]), packed_collater(rows[2:4])])
    for i in range(2):
        mb = {k: v[i] for k, v in stacked.items() if isinstance(v, np.ndarray)}
        t_sum, t_n = make_causal_lm_loss(twin, loss="fused_linear_ce")({k: torch.from_numpy(v) for k, v in mb.items()})
        j_out = jax_loss(model, loss="fused_linear_ce")(params, {k: jnp.asarray(v) for k, v in mb.items()})
        j_sum, j_n = jax.device_get(j_out[0]), jax.device_get(j_out[1])
        assert int(t_n) == int(j_n) == int((mb["labels"] != IGNORE_INDEX).sum())
        np.testing.assert_allclose(float(t_sum) / int(t_n), float(j_sum) / int(j_n), atol=1e-5)

"""Kernel K4 (paged attention) of the torch port against the JAX package.

On the CPU the port's ``paged_attend`` runs its plain version; the JAX
``paged_attend`` runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it. Both get the same numpy-made inputs. fp32
queries: atol 1e-5 (fp32 accumulation order differs). The CUDA kernel
itself is held to the plain version in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import paged_attention as jpa
from automodel_tpu_torch.ops import paged_attention as tpa
from torch_port_parity import to_np

B, N, NKV, H, NB, BS, NBSEQ = 3, 4, 2, 16, 12, 4, 5
LENGTHS = [7, 13, 0]


def _case(seed: int, sq: int, q_dtype=np.float32):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(NB, BS, NKV, H)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, NKV, H)).astype(np.float32)
    tables = rng.integers(1, NB, size=(B, NBSEQ)).astype(np.int32)
    # entries past each sequence's live range may point anywhere
    tables[2, 1:] = 0
    q = rng.normal(size=(B, sq, N, H)).astype(q_dtype)
    return q, kp, vp, tables, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("sq", [1, 5])
def test_paged_attend_matches_jax_kernel(sq, cap, window, pool):
    q, kp, vp, tables, lengths = _case(seed=sq * 7 + (window or 0), sq=sq)
    if pool == "int8":
        kq, ks = jpa.quantize_kv_rows(jnp.asarray(kp))
        vq, vs = jpa.quantize_kv_rows(jnp.asarray(vp))
        j_args = (kq, vq, jnp.asarray(tables), jnp.asarray(lengths), ks, vs)
        t_args = (
            torch.from_numpy(np.array(kq)), torch.from_numpy(np.array(vq)),
            torch.from_numpy(tables), torch.from_numpy(lengths),
            torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)),
        )
    else:
        j_args = (
            jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
            jnp.asarray(tables), jnp.asarray(lengths),
        )
        t_args = (
            torch.from_numpy(kp).to(torch.bfloat16), torch.from_numpy(vp).to(torch.bfloat16),
            torch.from_numpy(tables), torch.from_numpy(lengths),
        )
    ref = jpa.paged_attend(
        jnp.asarray(q), *j_args,
        sliding_window=window, logits_soft_cap=cap, interpret=True,
    )
    before = tpa.paged_attend.launches
    out = tpa.paged_attend(
        torch.from_numpy(q), *t_args, sliding_window=window, logits_soft_cap=cap,
    )
    assert tpa.paged_attend.launches == before  # CPU tensors never launch
    assert out.dtype == torch.float32 and out.shape == (B, sq, N, H)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)


def test_paged_attend_bf16_queries_match_jax_kernel():
    """bf16 queries and pool, bf16 output: both sides accumulate in fp32
    and round once, so they may differ by one bf16 ulp (2^-8 relative);
    |out| < 4 here, so atol 2e-2."""
    q, kp, vp, tables, lengths = _case(seed=3, sq=5)
    ref = jpa.paged_attend(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(lengths),
        interpret=True,
    )
    out = tpa.paged_attend(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(kp).to(torch.bfloat16),
        torch.from_numpy(vp).to(torch.bfloat16), torch.from_numpy(tables),
        torch.from_numpy(lengths),
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_matches_jax_exactly_and_is_idempotent(dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 4, 3, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jpa.quantize_kv_rows(jx)
    tq, ts = tpa.quantize_kv_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tpa.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jpa.dequantize_kv(jq, js, jnp.float32))
    )
    # quantize∘dequantize leaves the values bit-identical: a chunk prefill
    # that rewrites shared int8 prefix blocks does not change them
    tq2, ts2 = tpa.quantize_kv_rows(deq)
    np.testing.assert_array_equal(tq2.numpy(), tq.numpy())
    np.testing.assert_allclose(ts2.numpy(), ts.numpy(), rtol=1e-6)


def test_paged_attend_refuses_half_a_scale_pair():
    q, kp, vp, tables, lengths = _case(seed=1, sq=1)
    kq, ks = tpa.quantize_kv_rows(torch.from_numpy(kp))
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        tpa.paged_attend(
            torch.from_numpy(q), kq, kq, torch.from_numpy(tables), torch.from_numpy(lengths), ks
        )


# -- the CUDA kernel's split rule (ops/paged_attention.py chunk_blocks) --


@pytest.mark.parametrize(
    "batch,nkv,nbseq,sms,want",
    [
        (16, 8, 257, 132, 32),  # the serving shape: 1152 CTAs of 512 tokens
        (16, 8, 256, 132, 32),  # the decode step's tables (4096 / 16 blocks)
        (1, 8, 257, 132, 16),  # one long sequence: 136 CTAs of 256 tokens
        (1, 4, 257, 132, 8),  # 132 CTAs of 128 tokens
        (1, 1, 8, 132, 4),  # tiny: the smallest chunk
    ],
)
def test_chunk_blocks_spreads_a_long_sequence_over_the_sms(batch, nkv, nbseq, sms, want):
    cb = tpa.chunk_blocks(batch, nkv, nbseq, sms)
    assert cb == want
    if cb != tpa.CUDA_CHUNK_BLOCKS[-1]:  # a larger chunk only while the grid gives every SM a CTA
        assert batch * nkv * -(-nbseq // cb) >= sms
    if cb != tpa.CUDA_CHUNK_BLOCKS[0]:  # and the next larger one would not
        assert batch * nkv * -(-nbseq // (2 * cb)) < sms


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("fill", [-1, 10**6])
def test_plain_version_never_follows_a_dead_table_entry(fill, pool):
    """The plain version, the kernel's reference on the card, gives the same
    output whatever the dead entries hold: ids past the pool included."""
    q, kp, vp, tables, lengths = _case(seed=5, sq=2)
    if pool == "int8":
        kq, ks = tpa.quantize_kv_rows(torch.from_numpy(kp))
        vq, vs = tpa.quantize_kv_rows(torch.from_numpy(vp))
        args = (kq, vq, ks, vs)
    else:
        args = (torch.from_numpy(kp), torch.from_numpy(vp), None, None)
    t = torch.from_numpy(tables)
    dead = t.clone()
    j = torch.arange(NBSEQ)
    for b, length in enumerate(LENGTHS):
        live = (j <= (length + 1) // BS) & ((j + 1) * BS - 1 > length - 6)
        dead[b, ~live] = fill
    kw = dict(sliding_window=6)
    ref = tpa.paged_attend_plain(torch.from_numpy(q), args[0], args[1], t, torch.from_numpy(lengths),
                                 args[2], args[3], **kw)
    out = tpa.paged_attend_plain(torch.from_numpy(q), args[0], args[1], dead, torch.from_numpy(lengths),
                                 args[2], args[3], **kw)
    assert torch.equal(out, ref)

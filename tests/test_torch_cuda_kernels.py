"""The torch port's hand-written CUDA kernels against their plain torch
versions, on the card. Marked ``cuda``: without a CUDA device or nvcc each
test skips and names what is missing. This file imports no JAX, so it runs
on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The unmarked test runs on the CPU: it shows that the limit the kernel is
held to would catch a masking fault of a single row.
"""

import pytest
import torch

from automodel_tpu_torch.ops import _cuda_build
from automodel_tpu_torch.ops import paged_attention as tpa

# per output row, |out - ref| / |ref|: both versions round an fp32 result to
# bf16, and one bf16 ulp is at most 2^-7 of an element (chip_smoke.py holds
# the kernel to the same limit)
ROW_REL_TOL = 2.0**-7


def row_rel_err(out, ref) -> float:
    d = (out.float() - ref.float()).norm(dim=-1)
    r = ref.float().norm(dim=-1)
    return float((d / r.clamp_min(1e-30)).max())


def make_case(dev, sq, h, pool, sharp=1.0, b=4, n=32, nkv=8, bs=16, context=384, lengths=None):
    g = torch.Generator(device=dev).manual_seed(0)
    nbseq = -(-(context + sq) // bs)
    nb = b * nbseq + 1
    kp = torch.randn((nb, bs, nkv, h), generator=g, device=dev)
    vp = torch.randn((nb, bs, nkv, h), generator=g, device=dev)
    tables = (torch.randperm(nb - 1, generator=g, device=dev)[: b * nbseq] + 1)
    tables = tables.reshape(b, nbseq).to(torch.int32)
    if lengths is None:
        lengths = [0, 17, 200, context - sq]
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = (torch.randn((b, sq, n, h), generator=g, device=dev) * sharp).to(torch.bfloat16)
    if pool == "int8":
        kq, ks = tpa.quantize_kv_rows(kp)
        vq, vs = tpa.quantize_kv_rows(vp)
        return q, (kq, vq, tables, lengths, ks, vs)
    return q, (kp.to(torch.bfloat16), vp.to(torch.bfloat16), tables, lengths)


@pytest.mark.parametrize("sharp", [1.0, 4.0])
@pytest.mark.parametrize("sq", [1, 5])
def test_row_check_catches_one_masked_row(sq, sharp):
    """At the serving shapes (H=128, BS=16, 4 query heads per kv head,
    contexts up to 4000), dropping the one oldest row of a sliding window
    moves the worst output row by more than 4x ROW_REL_TOL, whether the
    attention is near uniform (q ~ N(0, 1)) or sharp (q x 4)."""
    dev = torch.device("cpu")
    q, args = make_case(dev, sq, 128, "bf16", sharp=sharp, n=8, nkv=2, context=4096,
                        lengths=[300, 1000, 2500, 4000])
    right = tpa.paged_attend(q, *args, sliding_window=256)
    wrong = tpa.paged_attend(q, *args, sliding_window=255)
    assert row_rel_err(wrong, right) > 4 * ROW_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize(
    "sq,window,cap,h,sharp",
    [
        (1, None, None, 128, 1.0),
        (5, None, None, 128, 1.0),
        (1, 100, None, 128, 1.0),
        (1, None, 30.0, 128, 1.0),
        (2, 40, None, 64, 1.0),
        (1, None, None, 256, 1.0),
        (1, None, None, 128, 4.0),
        (5, 100, None, 128, 4.0),
    ],
)
def test_cuda_kernel_matches_plain(sq, window, cap, h, sharp, pool):
    """The hand-written Hopper kernel against its plain version on the card:
    every output row within ROW_REL_TOL of the plain row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    try:
        _cuda_build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build csrc/paged_attention.cu: {e}")
    q, args = make_case(torch.device("cuda"), sq, h, pool, sharp=sharp)
    before = tpa.paged_attend.launches
    out = tpa.paged_attend(q, *args, sliding_window=window, logits_soft_cap=cap)
    torch.cuda.synchronize()
    assert tpa.paged_attend.launches == before + 1
    ref = tpa.paged_attend_plain(q, *args, sliding_window=window, logits_soft_cap=cap)
    assert bool(torch.isfinite(out.float()).all())
    assert row_rel_err(out, ref) <= ROW_REL_TOL

"""The torch port's hand-written CUDA kernels against their plain torch
versions, on the card. Marked ``cuda``: without a CUDA device or nvcc each
test skips and names what is missing. This file imports no JAX, so it runs
on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The unmarked tests run on the CPU: they show that the limits the kernels
are held to would catch a masking fault of a single row or key.
"""

import threading

import pytest
import torch

from automodel_tpu_torch.ops import _cuda_build
from automodel_tpu_torch.ops import paged_attention as tpa
from automodel_tpu_torch.ops import ring_flash as trf
import torch_port_parity  # noqa: F401  (caps torch at one thread)

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


# -- paged attention: split-KV and the in-kernel merge --------------------------


def _paged_chunk_tokens(b, nkv, nbseq) -> int:
    """Tokens a chunk of the kernel's split-KV grid at this shape."""
    return 16 * tpa.chunk_blocks(b, nkv, nbseq, tpa._sm_count(torch.cuda.current_device()))


def _paged_matches_plain(q, args, **kw) -> torch.Tensor:
    """The kernel's output, each row held to the plain version's."""
    before = tpa.paged_attend.launches
    out = tpa.paged_attend(q, *args, **kw)
    torch.cuda.synchronize()
    assert tpa.paged_attend.launches == before + 1
    ref = tpa.paged_attend_plain(q, *args, **kw)
    assert bool(torch.isfinite(out.float()).all())
    assert row_rel_err(out, ref) <= ROW_REL_TOL
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("sq", [1, 5])
def test_paged_kernel_chunk_edges_match_plain(sq, pool):
    """Sequences whose last query position is the last token of the first
    or second chunk, or one token past it (a chunk holding one live token),
    and lengths 0 and 1."""
    _need_cuda("paged_attention")
    b, nkv, context = 6, 8, 4096
    C = _paged_chunk_tokens(b, nkv, -(-(context + sq) // 16))
    lengths = [0, 1, C - sq, C - sq + 1, 2 * C - sq, 2 * C - sq + 1]
    q, args = make_case(torch.device("cuda"), sq, 128, pool, b=b, nkv=nkv, context=context, lengths=lengths)
    _paged_matches_plain(q, args)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("sq", [1, 5])
def test_paged_kernel_one_long_sequence_matches_plain(sq, pool):
    """B = 1 at a 4096 context, where the split matters most: one
    (sequence, kv head) spread over every chunk, merged in one CTA."""
    _need_cuda("paged_attention")
    q, args = make_case(torch.device("cuda"), sq, 128, pool, b=1, context=4096, lengths=[4096 - sq])
    _paged_matches_plain(q, args)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("window", ["chunk", 1000, 37])
def test_paged_kernel_windows_across_chunks_match_plain(window, pool):
    """A window whose first position starts a chunk (the chunks before it
    dead), one that cuts a chunk mid-block, and one inside two blocks."""
    _need_cuda("paged_attention")
    b, nkv, context, lengths = 2, 8, 4096, [4000, 2500]
    if window == "chunk":  # row 0 of the first sequence sees from a chunk's first token
        C = _paged_chunk_tokens(b, nkv, -(-(context + 1) // 16))
        window = lengths[0] + 1 - (lengths[0] // C - 2) * C
    q, args = make_case(torch.device("cuda"), 1, 128, pool, b=b, nkv=nkv, context=context, lengths=lengths)
    _paged_matches_plain(q, args, sliding_window=window)


@pytest.mark.cuda
def test_paged_kernel_int8_verify_chunk_with_soft_cap_matches_plain():
    """int8 at Sq = 5 (20 query rows a kv head: two warps a worker) with the
    soft cap, over several chunks."""
    _need_cuda("paged_attention")
    q, args = make_case(torch.device("cuda"), 5, 128, "int8", sharp=4.0, context=2048,
                        lengths=[0, 300, 1500, 2040])
    _paged_matches_plain(q, args, logits_soft_cap=30.0)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 3, 8])
@pytest.mark.parametrize("h", [64, 256])
def test_paged_kernel_head_dims_over_several_chunks_match_plain(h, sq):
    """H = 64 and 256 at 4, 12 and 32 query rows a kv head (one warp of 8
    rows, one of 16, two warps of 16 a worker), over several chunks."""
    _need_cuda("paged_attention")
    for pool in ("bf16", "int8"):
        q, args = make_case(torch.device("cuda"), sq, h, pool, b=2, context=2048, lengths=[2000, 700])
        _paged_matches_plain(q, args)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("fill", [-1, 2**30])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_paged_kernel_never_reads_dead_blocks(pool, fill, window):
    """Table entries outside each sequence's live blocks (past its last
    query position, before its window) hold -1 or an id far past the pool:
    a kernel that followed one would fault or read garbage."""
    _need_cuda("paged_attention")
    sq, bs, lengths = 1, 16, [5, 300, 1500, 2000]
    q, args = make_case(torch.device("cuda"), sq, 128, pool, context=2048, lengths=lengths)
    tables = args[2]
    j = torch.arange(tables.shape[1], device=tables.device)
    for b, length in enumerate(lengths):
        live = j <= (length + sq - 1) // bs
        if window is not None:
            live &= (j + 1) * bs - 1 > length - window
        tables[b, ~live] = fill
    _paged_matches_plain(q, args, sliding_window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_paged_kernel_repeats_bit_for_bit(pool):
    """The merge takes the partials in split order whichever CTA does it,
    so two runs over many chunks give the same bits."""
    _need_cuda("paged_attention")
    q, args = make_case(torch.device("cuda"), 5, 128, pool, context=4096, lengths=[4091, 3000, 2, 1700])
    first = tpa.paged_attend(q, *args, logits_soft_cap=30.0)
    second = tpa.paged_attend(q, *args, logits_soft_cap=30.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_paged_kernel_folded_scale_equals_prescaled_q(pool, scale):
    """The kernel scales q as it loads it, bf16(float(q) * float(bf16(scale))):
    bit for bit the output it gives for q scaled beforehand in eager bf16
    (``_scaled_q``, the plain version's) with the scale 1."""
    _need_cuda("paged_attention")
    q, args = make_case(torch.device("cuda"), 5, 128, pool, context=2048, lengths=[0, 300, 1500, 2040])
    folded = tpa.paged_attend(q, *args, scale=scale)
    prescaled = tpa.paged_attend(tpa._scaled_q(q, scale), *args, scale=1.0)
    torch.cuda.synchronize()
    assert torch.equal(folded, prescaled)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("window,cap", [(None, None), (100, None), (None, 30.0)])
@pytest.mark.parametrize(
    "sq,n,nkv",
    [
        (11, 12, 4),  # 33 rows a kv head: a full row tile and one row
        (5, 32, 4),  # 40: Qwen3-30B-A3B's verify at k = 4
        (8, 32, 4),  # 64: two full tiles
        (13, 40, 8),  # 65: two full tiles and one row
        (20, 32, 4),  # 160: five tiles
    ],
)
def test_paged_kernel_wide_rows_match_plain(sq, n, nkv, window, cap, pool):
    """More than 32 query rows a kv head (a verify chunk at a GQA ratio
    of 3 to 8): the kernel's row tiles, each over the same live blocks and
    split-KV chunks, merged per tile."""
    _need_cuda("paged_attention")
    q, args = make_case(torch.device("cuda"), sq, 128, pool, sharp=4.0 if cap else 1.0, n=n, nkv=nkv,
                        context=2048, lengths=[0, 300, 1500, 2048 - sq])
    _paged_matches_plain(q, args, sliding_window=window, logits_soft_cap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_paged_kernel_wide_rows_repeat_bit_for_bit(pool):
    """Each row tile's merge counter is its own: two runs at 40 rows a kv
    head over many chunks give the same bits."""
    _need_cuda("paged_attention")
    q, args = make_case(torch.device("cuda"), 5, 128, pool, n=32, nkv=4, context=4096,
                        lengths=[4091, 3000, 2, 1700])
    first = tpa.paged_attend(q, *args)
    second = tpa.paged_attend(q, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_paged_refuses_what_the_kernel_does_not_take():
    _need_cuda("paged_attention")
    q, args = make_case(torch.device("cuda"), 1, 96, "bf16")
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attend(q, *args)
    q, args = make_case(torch.device("cuda"), 1, 128, "bf16")
    with pytest.raises(ValueError, match="sliding_window"):
        tpa.paged_attend(q, *args, sliding_window=0)


# -- flash attention (csrc/flash_attention.cu) ----------------------------------

# The flash kernels against their plain versions, per output row (one query
# head at one position, or one kv head at one key for dk/dv). out: the same
# 2^-7 as above (both round an fp32 result to bf16), and the kernel also
# rounds P to bf16 before P.V, which alone reads ~2^-8 on the CPU
# (emulated). dq/dk/dv come out in fp32, but the kernels round P and dS to
# bf16 before their second products: ~2^-8 emulated, so the limit is 2^-6.
# A gradient row whose exact value cancels to ~0 (dq of the first token of a
# document: P = 1 there, so dS = dP - delta = 0) holds only rounding noise,
# so rows are judged against at least 1/8 of the tensor's RMS row norm. lse
# is fp32 in both, ~1e-6 apart; 1e-3 is far under what a dropped key moves.
FLASH_OUT_TOL = 2.0**-7
FLASH_GRAD_TOL = 2.0**-6
FLASH_GRAD_FLOOR = 0.125
FLASH_LSE_TOL = 1e-3


def grad_row_err(out, ref, floor=FLASH_GRAD_FLOOR) -> float:
    d = (out.float() - ref.float()).norm(dim=-1)
    r = ref.float().norm(dim=-1)
    return float((d / torch.maximum(r, floor * r.pow(2).mean().sqrt()).clamp_min(1e-30)).max())


def flash_case(dev, S=1000, H=128, B=2, N=8, Nkv=2, sharp=1.0, segments=False, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, S, N, H), generator=g, device=dev) * sharp).to(torch.bfloat16)
    k, v = (torch.randn((B, S, Nkv, H), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    do = torch.randn((B, S, N, H), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    seg = None
    if segments:  # 4 packed documents of ragged lengths per row
        cuts = torch.stack([torch.randperm(S - 1, generator=g, device=dev)[:3] + 1 for _ in range(B)])
        seg = (pos[None, :, None] >= cuts.sort(dim=1).values[:, None, :]).sum(-1).to(torch.int32)
    return q, k, v, do, pos, seg


def flash_all(q, k, v, do, pos, seg, *, causal, window, plain: bool, soft_cap=None):
    """(out, lse, dq, dk, dv) from the wrappers or the plain versions; the
    backward of both reads the plain forward's out and lse."""
    kw = dict(causal=causal, window=window, scale=q.shape[-1] ** -0.5, soft_cap=soft_cap)
    fwd = trf._flash_fwd_plain if plain else trf.flash_block_fwd
    dq_fn = trf._flash_dq_plain if plain else trf.flash_block_dq
    dkv_fn = trf._flash_dkv_plain if plain else trf.flash_block_dkv
    out, lse = fwd(q, k, v, pos, pos, seg, seg, **kw)
    ref_out, ref_lse = trf._flash_fwd_plain(q, k, v, pos, pos, seg, seg, **kw)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, pos, pos, seg, seg)
    return (out, lse, dq_fn(*args, **kw), *dkv_fn(*args, **kw))


def flash_errors(got, want) -> dict:
    out, lse, dq, dk, dv = got
    r_out, r_lse, r_dq, r_dk, r_dv = want
    return dict(
        out=row_rel_err(out, r_out), lse=float((lse - r_lse).abs().max()),
        dq=grad_row_err(dq, r_dq), dk=grad_row_err(dk, r_dk), dv=grad_row_err(dv, r_dv),
    )


def flash_ok(err: dict) -> bool:
    return (err["out"] <= FLASH_OUT_TOL and err["lse"] <= FLASH_LSE_TOL
            and max(err["dq"], err["dk"], err["dv"]) <= FLASH_GRAD_TOL)


@pytest.mark.parametrize("sharp", [1.0, 4.0])
@pytest.mark.parametrize("fault", ["diagonal", "window_edge"])
def test_flash_row_check_catches_an_off_by_one_mask(fault, sharp):
    """On the CPU: the plain versions with the causal diagonal excluded (or
    a 1024 window cut to 1023) move the worst row of out and of each
    gradient past 4x its limit, in near-uniform and in sharp attention."""
    q, k, v, do, pos, _ = flash_case(torch.device("cpu"), S=2048, B=1, N=4, Nkv=1, sharp=sharp)
    window = 1024 if fault == "window_edge" else None
    right = flash_all(q, k, v, do, pos, None, causal=True, window=window, plain=True)
    kw = dict(causal=True, scale=q.shape[-1] ** -0.5, window=1023 if window else None)
    kv_pos = pos + 1 if fault == "diagonal" else pos
    out, _ = trf._flash_fwd_plain(q, k, v, pos, kv_pos, None, None, **kw)
    delta = (do.float() * right[0].float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, right[1], delta, pos, kv_pos, None, None)
    err = flash_errors((out, right[1], trf._flash_dq_plain(*args, **kw), *trf._flash_dkv_plain(*args, **kw)), right)
    assert err["out"] > 4 * FLASH_OUT_TOL
    assert min(err["dq"], err["dk"], err["dv"]) > 4 * FLASH_GRAD_TOL


def test_flash_row_check_catches_a_dropped_cap_factor(monkeypatch):
    """On the CPU, at Gemma 2's head_dim 256 and cap 50 with q x 64 (the
    scores far past the cap, most tanh saturated): the plain backward with
    the cap's factor 1 - t^2 dropped moves the worst dq row past 4x its
    limit, and the plain forward without the cap moves the worst out row
    past 4x its limit."""
    q, k, v, do, pos, _ = flash_case(torch.device("cpu"), S=1024, H=256, B=1, N=4, Nkv=1, sharp=64.0)
    right = flash_all(q, k, v, do, pos, None, causal=True, window=None, plain=True, soft_cap=50.0)
    uncapped, _ = trf._flash_fwd_plain(q, k, v, pos, pos, None, None, causal=True, window=None, scale=1 / 16)
    assert row_rel_err(uncapped, right[0]) > 4 * FLASH_OUT_TOL
    scores = trf._scores
    monkeypatch.setattr(trf, "_scores", lambda *a: (scores(*a)[0], None))  # no 1 - t^2
    wrong = flash_all(q, k, v, do, pos, None, causal=True, window=None, plain=True, soft_cap=50.0)
    assert grad_row_err(wrong[2], right[2]) > 4 * FLASH_GRAD_TOL


def _need_cuda(source: str) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    try:
        _cuda_build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build csrc/{source}.cu: {e}")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,H,causal,window,segments,sharp",
    [
        (1024, 128, True, None, False, 1.0),
        (1000, 128, True, 200, False, 1.0),
        (1000, 128, True, None, True, 1.0),
        (1000, 128, False, None, False, 1.0),
        (777, 64, True, None, False, 1.0),
        (1000, 64, False, 128, True, 1.0),
        (1024, 128, True, None, False, 4.0),
        (100, 128, True, 16, True, 4.0),
    ],
)
def test_flash_kernels_match_plain(S, H, causal, window, segments, sharp):
    """fwd (out, lse), dq and dk/dv kernels against their plain versions on
    the card, each launched once."""
    _need_cuda("flash_attention")
    case = flash_case(torch.device("cuda"), S=S, H=H, sharp=sharp, segments=segments)
    counts = [f.launches for f in (trf.flash_block_fwd, trf.flash_block_dq, trf.flash_block_dkv)]
    got = flash_all(*case, causal=causal, window=window, plain=False)
    torch.cuda.synchronize()
    assert [f.launches for f in (trf.flash_block_fwd, trf.flash_block_dq, trf.flash_block_dkv)] == [c + 1 for c in counts]
    want = flash_all(*case, causal=causal, window=window, plain=True)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    err = flash_errors(got, want)
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,H,causal,window,segments,sharp,cap",
    [
        (1024, 256, True, None, False, 1.0, None),
        (1000, 256, False, 128, True, 1.0, None),
        (1024, 256, True, None, False, 1.0, 50.0),
        (1000, 256, True, 200, False, 1.0, 50.0),
        (1000, 256, True, None, True, 1.0, 50.0),
        (777, 256, True, None, False, 64.0, 50.0),
        (1000, 128, True, None, False, 4.0, 50.0),
        (777, 64, True, 100, True, 1.0, 50.0),
    ],
)
def test_flash_kernels_soft_cap_and_head_dim_256_match_plain(S, H, causal, window, segments, sharp, cap):
    """Head_dim 256 (its own dkv tiling: two warps per kv strip) with and
    without the logits soft cap, and the cap at head_dim 128 and 64: each
    kernel against its plain version, launched once."""
    _need_cuda("flash_attention")
    case = flash_case(torch.device("cuda"), S=S, H=H, sharp=sharp, segments=segments)
    kernels = (trf.flash_block_fwd, trf.flash_block_dq, trf.flash_block_dkv)
    counts = [f.launches for f in kernels]
    got = flash_all(*case, causal=causal, window=window, plain=False, soft_cap=cap)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [c + 1 for c in counts]
    want = flash_all(*case, causal=causal, window=window, plain=True, soft_cap=cap)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    err = flash_errors(got, want)
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize(
    "Sq,Sk,window",
    [(1, 300, None), (130, 700, None), (65, 129, 2), (200, 1000, 64)],
)
def test_flash_kernels_edge_shapes_match_plain(Sq, Sk, window):
    """Queries at the end of a longer key range (q_pos = Sk - Sq + i, the
    chunked-prefill layout), a single query row, and a window of 2: every
    kernel against its plain version. (A row that sees one key alone has
    P = 1 and dS = dP - delta = 0 exactly, so its dq holds only rounding
    noise; such shapes check nothing in the gradients.)"""
    _need_cuda("flash_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    B, N, Nkv, H = 2, 8, 2, 128
    q = torch.randn((B, Sq, N, H), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, Sk, Nkv, H), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    do = torch.randn((B, Sq, N, H), generator=g, device=dev).to(torch.bfloat16)
    kv_pos = torch.arange(Sk, dtype=torch.int32, device=dev)
    q_pos = kv_pos[Sk - Sq:].contiguous()
    kw = dict(causal=True, window=window, scale=H**-0.5)
    out, lse = trf.flash_block_fwd(q, k, v, q_pos, kv_pos, None, None, **kw)
    r_out, r_lse = trf._flash_fwd_plain(q, k, v, q_pos, kv_pos, None, None, **kw)
    delta = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, r_lse, delta, q_pos, kv_pos, None, None)
    got = (out, lse, trf.flash_block_dq(*args, **kw), *trf.flash_block_dkv(*args, **kw))
    torch.cuda.synchronize()
    want = (r_out, r_lse, trf._flash_dq_plain(*args, **kw), *trf._flash_dkv_plain(*args, **kw))
    err = flash_errors(got, want)
    assert flash_ok(err), err


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card():
    """flash_attention's backward on the card is the dq and dkv kernels fed
    with the forward kernel's out and lse: bit-identical to calling the
    three wrappers by hand (the kernels use no atomics, so they repeat
    exactly), each launched once more."""
    _need_cuda("flash_attention")
    q, k, v, do, pos, _ = flash_case(torch.device("cuda"), S=512, H=128)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels = (trf.flash_block_fwd, trf.flash_block_dq, trf.flash_block_dkv)
    before = [f.launches for f in kernels]
    out = trf.flash_attention(*leaves, causal=True)
    out.backward(do)
    assert [f.launches for f in kernels] == [c + 1 for c in before]
    kw = dict(causal=True, window=None, scale=128**-0.5)
    ref_out, lse = trf.flash_block_fwd(q, k, v, pos, pos, None, None, **kw)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = trf.flash_block_bwd(q, k, v, do, lse, delta, pos, pos, None, None, **kw)
    assert torch.equal(out.detach(), ref_out)
    for name, leaf, g in zip(("dq", "dk", "dv"), leaves, ref):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, g.to(torch.bfloat16)), name


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1024, 1000])
def test_flash_kernels_at_llama3_2_1b_heads_match_plain(S):
    """The KD student's attention (Llama-3.2-1B: N=32, Nkv=8, H=64, causal,
    no sinks), a case of ``flash_fwd_kernel<64, false>`` that the GPT-OSS
    path (sinks folded around it) does not run alone: each kernel against
    its plain version, launched once."""
    _need_cuda("flash_attention")
    case = flash_case(torch.device("cuda"), S=S, H=64, B=1, N=32, Nkv=8)
    kernels = (trf.flash_block_fwd, trf.flash_block_dq, trf.flash_block_dkv)
    counts = [f.launches for f in kernels]
    got = flash_all(*case, causal=True, window=None, plain=False)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [c + 1 for c in counts]
    want = flash_all(*case, causal=True, window=None, plain=True)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    err = flash_errors(got, want)
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "selective"])
def test_flash_recomputed_under_remat_gives_the_same_grads(policy):
    """Attention through the kernels inside a checkpointed layer: the
    backward runs the forward kernel again (on autograd's device thread,
    which must bind the context before encoding its tensor maps) and the
    grads equal those without recompute bit for bit; fwd launches twice,
    dq and dkv once."""
    from automodel_tpu_torch.models.common.stacking import remat_wrap

    _need_cuda("flash_attention")
    q, k, v, do, _, _ = flash_case(torch.device("cuda"), S=512, H=64, B=1, N=32, Nkv=8)
    w = torch.randn((64, 64), device="cuda").to(torch.bfloat16)

    def layer(q, k, v):
        return trf.flash_attention(q @ w, k, v, causal=True) @ w

    grads = {}
    kernels = (trf.flash_block_fwd, trf.flash_block_dq, trf.flash_block_dkv)
    for name, fn in (("none", layer), (policy, remat_wrap(layer, policy))):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = [f.launches for f in kernels]
        fn(*leaves).backward(do)
        torch.cuda.synchronize()
        calls = [f.launches - b for f, b in zip(kernels, before)]
        assert calls == ([1, 1, 1] if name == "none" else [2, 1, 1]), (name, calls)
        grads[name] = [t.grad for t in leaves]
    for a, b in zip(grads["none"], grads[policy]):
        assert torch.equal(a, b)

def tiled_case(dev, Sq, Sk, H, N=8, Nkv=2, B=2, cuts=None, sharp=1.0, seed=5):
    """bf16 q [B, Sq, N, H] whose rows sit at the end of the key range
    (q_pos = Sk - Sq + i, the chunked-prefill layout; Sq = Sk is plain
    self-attention), k/v [B, Sk, Nkv, H], dO; with ``cuts`` the documents'
    first positions (the same in every row). → (q, k, v, do, q_pos, kv_pos,
    seg_q, seg_kv)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, Sq, N, H), generator=g, device=dev) * sharp).to(torch.bfloat16)
    k, v = (torch.randn((B, Sk, Nkv, H), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    do = torch.randn((B, Sq, N, H), generator=g, device=dev).to(torch.bfloat16)
    kv_pos = torch.arange(Sk, dtype=torch.int32, device=dev)
    q_pos = kv_pos[Sk - Sq:].contiguous()
    seg_q = seg_kv = None
    if cuts:
        edges = torch.tensor(cuts, dtype=torch.int32, device=dev)
        seg_kv = (kv_pos[:, None] >= edges[None, :]).sum(-1).to(torch.int32).expand(B, Sk).contiguous()
        seg_q = seg_kv[:, Sk - Sq:].contiguous()
    return q, k, v, do, q_pos, kv_pos, seg_q, seg_kv


def tiled_errors(case, causal=True, window=None, soft_cap=None):
    """Each kernel, launched once, against its plain version (the backward of
    both fed the plain forward's lse and delta). A gradient that is exactly
    zero in the plain version (every row sees one key alone: P = 1, dS = 0)
    holds only rounding noise, so there it is held to 1e-4 absolute."""
    q, k, v, do, q_pos, kv_pos, seg_q, seg_kv = case
    kw = dict(causal=causal, window=window, scale=q.shape[-1] ** -0.5, soft_cap=soft_cap)
    pos = (q_pos, kv_pos, seg_q, seg_kv)
    out, lse = trf.flash_block_fwd(q, k, v, *pos, **kw)
    r_out, r_lse = trf._flash_fwd_plain(q, k, v, *pos, **kw)
    delta = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, r_lse, delta, *pos)
    got = (out, lse, trf.flash_block_dq(*args, **kw), *trf.flash_block_dkv(*args, **kw))
    torch.cuda.synchronize()
    want = (r_out, r_lse, trf._flash_dq_plain(*args, **kw), *trf._flash_dkv_plain(*args, **kw))
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    err = flash_errors(got, want)
    for name, g_, w_ in (("dq", got[2], want[2]), ("dk", got[3], want[3])):
        if not bool(w_.abs().gt(1e-4).any()):
            err[name] = 0.0 if float(g_.abs().max()) <= 1e-4 else float("inf")
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 4000])
def test_flash_kernels_at_tile_edges_match_plain(S, H):
    """Self-attention lengths around the kernels' tiles (64-row warpgroup
    slices, 128-row CTAs, 32-128-row streamed tiles, a ring of two stages):
    one row, one short of a tile, a tile, one past, and a length that is no
    multiple of any tile."""
    _need_cuda("flash_attention")
    case = tiled_case(torch.device("cuda"), S, S, H, B=1 if S == 4000 else 2)
    err = tiled_errors(case)
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128, 256])
@pytest.mark.parametrize("Sq,Sk", [(1, 129), (63, 4000), (64, 65), (65, 127), (127, 129), (129, 4000)])
def test_flash_kernels_chunked_prefill_match_plain(Sq, Sk, H):
    """Fewer queries than keys, the queries at the end of the key range (the
    chunked-prefill layout): the live kv tiles start at the first key and
    end on a diagonal that crosses the kernels' tiles off their edges."""
    _need_cuda("flash_attention")
    err = tiled_errors(tiled_case(torch.device("cuda"), Sq, Sk, H))
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_flash_kernels_gqa_reps_match_plain(rep, H):
    """1, 2, 4 and 8 query heads per kv head: dkv sums dk and dv over the
    rep heads' q tiles inside one CTA."""
    _need_cuda("flash_attention")
    err = tiled_errors(tiled_case(torch.device("cuda"), 1000, 1000, H, N=8, Nkv=8 // rep))
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("H", [64, 128, 256])
@pytest.mark.parametrize("window", [64, 128, 129])
def test_flash_kernels_window_edge_on_a_tile_boundary(window, H, cap):
    """A causal window of 64 or 128 keys (the streamed tiles' rows: its
    edge falls on a tile boundary) and of 129 (one past), with and without
    the soft cap."""
    _need_cuda("flash_attention")
    err = tiled_errors(tiled_case(torch.device("cuda"), 1024, 1024, H), window=window, soft_cap=cap)
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("H", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_document_boundary_inside_a_tile(causal, H, cap):
    """Packed documents whose boundaries fall inside tiles (positions 40,
    100 and 333), on a 64-row edge (192) and on a 128-row edge (512): the
    segment mask inside a tile, with and without the soft cap."""
    _need_cuda("flash_attention")
    case = tiled_case(torch.device("cuda"), 700, 700, H, cuts=[40, 100, 192, 333, 512])
    err = tiled_errors(case, causal=causal, soft_cap=cap)
    assert flash_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("H,cap", [(128, None), (256, 50.0), (64, None)])
def test_flash_backward_repeats_bit_for_bit(H, cap):
    """No atomics: two launches of dq and of dkv on the same inputs give the
    same bits (dk and dv summed over 8 q heads a kv head, and at H=256 over
    the two consumers' halves of the head dim)."""
    _need_cuda("flash_attention")
    q, k, v, do, q_pos, kv_pos, _, _ = tiled_case(torch.device("cuda"), 1000, 1000, H, N=16, Nkv=2)
    kw = dict(causal=True, window=None, scale=H**-0.5, soft_cap=cap)
    out, lse = trf.flash_block_fwd(q, k, v, q_pos, kv_pos, None, None, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, q_pos, kv_pos, None, None)
    first = (trf.flash_block_dq(*args, **kw), *trf.flash_block_dkv(*args, **kw))
    second = (trf.flash_block_dq(*args, **kw), *trf.flash_block_dkv(*args, **kw))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_refuses_what_the_kernels_do_not_take():
    _need_cuda("flash_attention")
    q, k, v, _, pos, _ = flash_case(torch.device("cuda"), S=64, H=128)
    kw = dict(causal=True, window=None, scale=0.1)
    with pytest.raises(ValueError, match="head_dim"):
        trf.flash_block_fwd(q[..., :96].contiguous(), k[..., :96].contiguous(), v[..., :96].contiguous(),
                            pos, pos, None, None, **kw)
    with pytest.raises(ValueError, match="float16|bfloat16"):
        trf.flash_block_fwd(q.float(), k.float(), v.float(), pos, pos, None, None, **kw)
    with pytest.raises(ValueError, match="soft cap"):
        trf.flash_block_fwd(q, k, v, pos, pos, None, None, soft_cap=-1.0, **kw)


def test_ptxas_report_is_parsed_per_kernel():
    """The build keeps ptxas's -v report beside each library;
    ``parse_ptxas`` reads registers and spills per kernel, with the
    template arguments spelled out (PERF.md records them per head_dim)."""
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_dkv_kernelILi256ELb1EEEvNS_4ArgsE' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_dkv_kernelILi256ELb1EEEvNS_4ArgsE\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 1024 bytes smem, 544 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN40_INTERNAL_e3b5d1a2_18_flash_attention_cu_c138979115flash_dq_kernelILi64ELb0EEEvNS_4ArgsE' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 158 registers, used 1 barriers, 1024 bytes smem, 544 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function 'paged_attention_fwd' for 'sm_90a'\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
    )
    assert _cuda_build.parse_ptxas(log) == [
        dict(kernel="flash_dkv_kernel<256, 1>", spill_stores=4, spill_loads=12, registers=255),
        dict(kernel="flash_dq_kernel<64, 0>", spill_stores=0, spill_loads=0, registers=158),
        dict(kernel="paged_attention_fwd", registers=96),
    ]


def test_ptxas_names_a_kernel_without_template_arguments():
    """A kernel that is no template (the fused expert MLP's forward products
    and its elementwise kernels) is named by its own name, not its mangled
    one; a name that does not end in ``_kernel`` stays as it is."""
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114gmm_act_kernelENS_7GmmArgsE14CUtensorMap_stS2_S2_' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115bwd_dgub_kernelENS_11BwdDgubArgsE' for 'sm_90a'\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 16384 bytes smem\n"
        "ptxas info    : Compiling entry function 'fused_expert_mlp_bwd_act' for 'sm_90a'\n"
        "ptxas info    : Used 12 registers\n"
    )
    assert _cuda_build.parse_ptxas(log) == [
        dict(kernel="gmm_act_kernel", spill_stores=0, spill_loads=0, registers=168),
        dict(kernel="bwd_dgub_kernel", registers=64),
        dict(kernel="fused_expert_mlp_bwd_act", registers=12),
    ]


def test_sass_registers_are_read_per_kernel():
    """``parse_sass_registers`` reads the highest register a kernel's code
    names (the consumers' count after setmaxnreg, which ptxas's report at
    entry does not show) and the counts its setmaxnreg instructions set,
    the template arguments spelled out."""
    sass = (
        "\n\tcode for sm_90a\n"
        "\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelILi128ELb0EEEvNS_4ArgsE14CUtensorMap_stS2_S2_\n"
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
        "        /*0010*/                   USETMAXREG.TRY_ALLOC.CTAPOOL UP0, 0xf0 ;\n"
        "        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT, gsb0 ;\n"
        "        /*0030*/                   FMUL R174, R24, R3 ;\n"
        "        /*0040*/                   USETMAXREG.DEALLOC.CTAPOOL 0x18 ;\n"
        "\t\tFunction : paged_attention_fwd\n"
        "        /*0000*/                   IADD3 R7, R2, 0x1, RZ ;\n"
    )
    assert _cuda_build.parse_sass_registers(sass) == {
        "flash_fwd_kernel<128, 0>": dict(registers=175, setmaxnreg_dec=[24], setmaxnreg_inc=[240]),
        "paged_attention_fwd": dict(registers=8, setmaxnreg_dec=[], setmaxnreg_inc=[]),
    }


def test_an_edited_header_changes_the_library_path(tmp_path, monkeypatch):
    """The library's name hashes the source and every csrc header it
    includes (through another header too), so an edited header is built
    anew and never loads a stale library."""
    monkeypatch.setattr(_cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\nint g() { return h(); }\n')
    (tmp_path / "b.cuh").write_text("int h() { return 1; }\n")
    assert [p.name for p in _cuda_build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _cuda_build._lib_path("k")
    assert first == _cuda_build._lib_path("k") and first.parent == tmp_path / "_build"
    (tmp_path / "b.cuh").write_text("int h() { return 2; }\n")
    second = _cuda_build._lib_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint g() { return -h(); }\n')
    assert _cuda_build._lib_path("k") not in (first, second)


# -- grouped matmul (csrc/grouped_matmul.cu) ------------------------------------

from automodel_tpu_torch.ops import grouped_matmul as tgm  # noqa: E402

# gmm and gmm with a transposed rhs, per output row: both versions round an
# fp32 sum to bf16 (the kernel's tensor-core sum over K in another order),
# so a row moves by at most one bf16 ulp per element, 2^-7 of its norm (as
# ROW_REL_TOL). A row past the groups must be exactly zero. tgmm, per row of
# each [K, N] slab: both are fp32 sums of exact bf16 x bf16 products, apart
# only by the order of the sum, so 2^-13; the first readings on an H100 were
# at most 0.00087 (gmm) and 9.6e-6 (tgmm, an 8192-row group). A group that
# gains or loses one row moves the worst row of each past 4x its limit
# (test_grouped_row_check_catches_a_one_row_boundary_shift).
GMM_ROW_TOL = 2.0**-7
TGMM_ROW_TOL = 2.0**-13


def grouped_case(dev, M, K, N, sizes, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    G = len(sizes)
    lhs = torch.randn((M, K), generator=g).to(torch.bfloat16)
    rhs = (torch.randn((G, K, N), generator=g) / K**0.5).to(torch.bfloat16)
    dout = torch.randn((M, N), generator=g).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32)
    return tuple(t.to(dev) for t in (lhs, rhs, dout, gs))


def ragged_sizes(M, G, seed=0, empty=(), big=None):
    """G group sizes summing to M: random cuts, the groups in ``empty``
    forced to 0 and group ``big`` taking a quarter of the rows."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(G, generator=g) + 0.05
    for e in empty:
        w[e] = 0.0
    if big is not None:
        w[big] = 0.0
    rest = M - (M // 4 if big is not None else 0)
    sizes = torch.floor(w / w.sum() * rest).long()
    sizes[int(torch.nonzero(w).max())] += rest - int(sizes.sum())
    if big is not None:
        sizes[big] = M // 4
    return sizes.tolist()


def grouped_errors(lhs, rhs, dout, gs, plain: bool, shift=None):
    """(gmm, gmm_t, tgmm) row errors of the kernels (or, on the CPU, of the
    plain versions with group_sizes ``shift``ed) against the plain ones."""
    gmm_fn = tgm._gmm_plain if plain else tgm.gmm
    tgmm_fn = tgm._tgmm_plain if plain else tgm.tgmm
    gs_got = gs if shift is None else shift
    got = (gmm_fn(lhs, rhs, gs_got), gmm_fn(dout, rhs, gs_got, True), tgmm_fn(lhs, dout, gs_got))
    if lhs.is_cuda:
        torch.cuda.synchronize()
    want = (tgm._gmm_plain(lhs, rhs, gs), tgm._gmm_plain(dout, rhs, gs, True), tgm._tgmm_plain(lhs, dout, gs))
    return dict(gmm=row_rel_err(got[0], want[0]), gmm_t=row_rel_err(got[1], want[1]),
                tgmm=row_rel_err(got[2], want[2]))


@pytest.mark.parametrize("case", ["random", "skewed"])
def test_grouped_row_check_catches_a_one_row_boundary_shift(case):
    """On the CPU: one row handed from a group to its neighbour moves the
    worst gmm / gmm_t row and the worst tgmm slab row past 4x their limits,
    with ~256-row groups and with one group holding a quarter of the rows
    (the card's skewed case, where one row is the smallest share)."""
    M = 4096
    sizes = ragged_sizes(M, 16, seed=1, big=3 if case == "skewed" else None)
    lhs, rhs, dout, gs = grouped_case(torch.device("cpu"), M, 256, 256, sizes)
    b = 3  # the big group in the skewed case; it gives its last row away
    shifted = gs.clone()
    shifted[b] -= 1
    shifted[b + 1] += 1
    err = grouped_errors(lhs, rhs, dout, gs, plain=True, shift=shifted)
    assert err["gmm"] > 4 * GMM_ROW_TOL and err["gmm_t"] > 4 * GMM_ROW_TOL, err
    assert err["tgmm"] > 4 * TGMM_ROW_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,K,N,sizes",
    [
        (4096, 512, 768, ragged_sizes(4096, 16)),
        (4096, 768, 512, ragged_sizes(4096, 16, seed=2, empty=(0, 15), big=7)),
        (1000, 1000, 1000, ragged_sizes(1000, 5, seed=3)),  # K and N off the 128/32 tiles
        (130, 128, 128, [1, 129]),  # a tile across a group boundary
        (96, 32, 40, [96, 0, 0]),  # one group takes every row
        (300, 64, 64, [0, 50, 0, 78, 0]),  # empty groups at both ends, rows past the groups
        (512, 128, 192, [100, 1, 300, 111]),  # a 1-row group inside a tile
        (1024, 256, 256, [50, 400, 574]),  # a group over four 128-row tiles
        (40, 64, 72, [10, 0, 25]),  # M < 64, rows past the groups
        (300, 40, 40, [100, 120, 80]),  # K and N cut inside the 64-wide boxes
        (32768, 768, 2048, ragged_sizes(32768, 128, seed=6)),  # Qwen3-30B-A3B: 128 experts, the down shape
        (32768, 768, 2048, ragged_sizes(32768, 128, seed=7, empty=(0, 127, 17, 64, 90), big=5)),  # skewed
        (2048, 2880, 5760, [0, 700, 1, 1200]),  # gpt-oss-20b's widths: 33 MB slabs, gmm n tile by n tile
    ],
)
def test_grouped_kernels_match_plain(M, K, N, sizes):
    """gmm, gmm with a transposed rhs and tgmm against their plain versions
    on the card, each launched once."""
    _need_cuda("grouped_matmul")
    lhs, rhs, dout, gs = grouped_case(torch.device("cuda"), M, K, N, sizes)
    before = (tgm.gmm.launches, tgm.gmm.launches_t, tgm.tgmm.launches)
    err = grouped_errors(lhs, rhs, dout, gs, plain=False)
    assert (tgm.gmm.launches, tgm.gmm.launches_t, tgm.tgmm.launches) == tuple(c + 1 for c in before)
    assert err["gmm"] <= GMM_ROW_TOL and err["gmm_t"] <= GMM_ROW_TOL and err["tgmm"] <= TGMM_ROW_TOL, err


def _gmm_tiles_case(dev, transpose_rhs):
    lhs, rhs, dout, gs = grouped_case(dev, 4096, 512, 640, ragged_sizes(4096, 16, seed=8, empty=(3,), big=9))
    a = dout if transpose_rhs else lhs
    return a, rhs, gs, tgm.gmm_plan(gs, a.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_major", [False, True])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_gmm_n_tiles_and_orders_match_plain(transpose_rhs, n_major):
    """The gmm kernel's two orders of a group's items (unit by unit, n tile
    by n tile; gmm picks one from the shape), each against the plain
    version, over N = 640: two n tiles of 256 and a half tile."""
    _need_cuda("grouped_matmul")
    a, rhs, gs, plan = _gmm_tiles_case(torch.device("cuda"), transpose_rhs)
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    got = tgm._gmm_launch(a, rhs, gs, plan, N, transpose_rhs, n_major)
    torch.cuda.synchronize()
    assert row_rel_err(got, tgm._gmm_plain(a, rhs, gs, transpose_rhs)) <= GMM_ROW_TOL
    assert bool((got[int(gs.sum()):] == 0).all())


@pytest.mark.cuda
def test_grouped_kernels_repeat_bit_for_bit():
    """Two launches of gmm, gmm_t and tgmm (both output types) give the
    same bits: no atomics, every element one CTA's sum in a fixed order."""
    _need_cuda("grouped_matmul")
    lhs, rhs, dout, gs = grouped_case(torch.device("cuda"), 8192, 512, 768,
                                      ragged_sizes(8192, 32, seed=9, empty=(0, 31), big=4))
    runs = [lambda: tgm.gmm(lhs, rhs, gs), lambda: tgm.gmm(dout, rhs, gs, transpose_rhs=True),
            lambda: tgm.tgmm(lhs, dout, gs), lambda: tgm.tgmm(lhs, dout, gs, torch.bfloat16)]
    for run in runs:
        first = run()
        assert torch.equal(first, run())


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,sizes", [(2048, 256, 384, ragged_sizes(2048, 8, seed=4)),
                                         (1000, 1000, 1000, [0, 333, 1, 500, 100]),
                                         (4096, 768, 512, ragged_sizes(4096, 16, seed=2, empty=(0, 15), big=7))])
def test_tgmm_bf16_output_is_its_fp32_output_rounded(M, K, N, sizes):
    """tgmm written in bf16 (the backward's drhs) equals tgmm written in
    fp32 and cast to bf16, bit for bit: the same sum, rounded once."""
    _need_cuda("grouped_matmul")
    lhs, _, dout, gs = grouped_case(torch.device("cuda"), M, K, N, sizes)
    got = tgm.tgmm(lhs, dout, gs, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, tgm.tgmm(lhs, dout, gs).to(torch.bfloat16))


@pytest.mark.cuda
def test_grouped_kernels_nan_tail_on_the_card():
    """NaN in the lhs and dout rows past sum(group_sizes): every in-group
    gmm and gmm_t row and every tgmm slab (both output types) is
    bit-identical to a clean run's, and finite; the tail's gmm rows are
    zeros. tgmm's last chunk of a group reads those rows and must zero
    them before its products."""
    _need_cuda("grouped_matmul")
    sizes = [300, 0, 129, 1, 200]  # 630 rows of 1024: the last group ends inside a chunk and a tile
    lhs, rhs, dout, gs = grouped_case(torch.device("cuda"), 1024, 256, 192, sizes)
    n = sum(sizes)
    dirty_l, dirty_d = lhs.clone(), dout.clone()
    dirty_l[n:] = float("nan")
    dirty_d[n:] = float("nan")

    def run(l, d):
        return (tgm.gmm(l, rhs, gs), tgm.gmm(d, rhs, gs, transpose_rhs=True), tgm.tgmm(l, d, gs),
                tgm.tgmm(l, d, gs, torch.bfloat16))

    clean, dirty = run(lhs, dout), run(dirty_l, dirty_d)
    for i, (a, b) in enumerate(zip(dirty, clean)):
        assert bool(torch.isfinite(a.float()).all()) and torch.equal(a, b), i
    assert bool((dirty[0][n:] == 0).all()) and bool((dirty[1][n:] == 0).all())


@pytest.mark.cuda
def test_ragged_dot_autograd_on_the_card():
    """ragged_dot's backward on the card is gmm_t and tgmm: bit-identical to
    calling the wrappers by hand (no atomics: the kernels repeat exactly)."""
    _need_cuda("grouped_matmul")
    lhs, rhs, dout, gs = grouped_case(torch.device("cuda"), 2048, 256, 384, ragged_sizes(2048, 8, seed=4))
    leaves = [t.clone().requires_grad_(True) for t in (lhs, rhs)]
    out = tgm.ragged_dot(*leaves, gs)
    out.backward(dout)
    assert torch.equal(out.detach(), tgm.gmm(lhs, rhs, gs))
    assert torch.equal(leaves[0].grad, tgm.gmm(dout, rhs, gs, transpose_rhs=True))
    assert torch.equal(leaves[1].grad, tgm.tgmm(lhs, dout, gs).to(torch.bfloat16))


@pytest.mark.cuda
def test_tma_kernels_launch_from_a_fresh_host_thread():
    """gmm, gmm_t, tgmm and the flash forward from a host thread that has
    made no CUDA call yet, as an autograd worker may be (its outputs come
    from torch's cache): the tensor maps' driver calls need the device's
    context, which the launchers bind first. The results equal the main
    thread's bit for bit."""
    _need_cuda("grouped_matmul")
    _need_cuda("flash_attention")
    lhs, rhs, dout, gs = grouped_case(torch.device("cuda"), 2048, 256, 384, ragged_sizes(2048, 8, seed=4))
    q, k, v, _, pos, _ = flash_case(torch.device("cuda"), S=512, H=128)
    plan = tgm.gmm_plan(gs, lhs.shape[0])
    kw = dict(causal=True, window=None, scale=128**-0.5)
    calls = [lambda: tgm.gmm(lhs, rhs, gs, plan=plan), lambda: tgm.gmm(dout, rhs, gs, transpose_rhs=True, plan=plan),
             lambda: trf.flash_block_fwd(q, k, v, pos, pos, None, None, **kw)[0],
             lambda: tgm.tgmm(lhs, dout, gs, torch.bfloat16)]
    [c() for c in calls]  # outputs freed: the thread's allocations reuse their blocks
    torch.cuda.synchronize()
    want = [c() for c in calls]
    torch.cuda.synchronize()
    got, errors = [], []

    def worker():
        try:
            got.extend(c() for c in calls)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert not errors, errors
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_grouped_kernels_refuse_what_they_do_not_take():
    _need_cuda("grouped_matmul")
    lhs, rhs, dout, gs = grouped_case(torch.device("cuda"), 64, 32, 40, [30, 34])
    with pytest.raises(ValueError, match="bfloat16"):
        tgm.gmm(lhs.float(), rhs.float(), gs)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgm.gmm(lhs[:, :30].contiguous(), rhs[:, :30].contiguous(), gs)
    # transposed rhs [G, N, K]: N=36 is its middle dim, which no last-dim check sees
    with pytest.raises(ValueError, match="N=36 must be multiples of 8"):
        tgm.gmm(lhs, rhs.transpose(1, 2)[:, :36].contiguous(), gs, transpose_rhs=True)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.tgmm(lhs.t().contiguous().t(), dout, gs)
    with pytest.raises(ValueError, match="group_sizes"):
        tgm.tgmm(lhs, dout, gs.long())
    with pytest.raises(ValueError, match="writes"):
        tgm.tgmm(lhs, dout, gs, torch.float16)


# -- fused expert MLP (csrc/fused_expert_mlp.cu) --------------------------------

from automodel_tpu_torch.ops import fused_expert_mlp as tfem  # noqa: E402

# The fused expert-MLP kernels against their plain versions (chip_smoke.py
# holds them to the same limits): out and dlhs per row within 2^-7, as gmm
# (both round an fp32 sum to bf16; mid, dg and du are rounded to bf16 in
# both before the second product, and an element whose fp32 value the two
# compute a few fp32 ulps apart flips one bf16 ulp only rarely); rows past
# the groups exactly zero. The weight grads dW (gate | up) and dWd per row of
# each slab within 2^-10: fp32 sums of bf16 products, which tgmm holds to
# 2^-13, but one operand (dg, du or mid) is the bf16 rounding of an fp32 the
# kernel computes with expf where the plain version uses torch.sigmoid, and
# a rare one-ulp flip among few rows moves a slab row by ~2^-14. The bias
# grads per expert row within 2^-12: fp32 sums of fp32 values in another
# order. A group that gains or loses one row moves the worst row of each
# past 4x its limit (test_fused_row_check_catches_a_one_row_boundary_shift).
# The backward's elementwise pass (mid, dg | du, each an fp32 value rounded
# once to bf16) per row within FEM_ROW_TOL, as out: the one-ulp flips above.
FEM_ROW_TOL = 2.0**-7
FEM_DW_ROW_TOL = 2.0**-10
FEM_BIAS_ROW_TOL = 2.0**-12


def fem_case(dev, M, D, I, sizes, biased=True, scale=1.0, seed=0, dtype=torch.bfloat16):
    """lhs (times ``scale``), gate_up, down, biases, dy and group sizes from a
    seeded CPU generator, at the JAX init scales."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    G = len(sizes)
    r = lambda *s: torch.randn(s, generator=g)
    c = dict(
        lhs=r(M, D) * scale, gate_up=r(G, D, 2 * I) / D**0.5, down=r(G, I, D) / I**0.5, dy=r(M, D),
        gate_up_bias=r(G, 2 * I) * 0.5 if biased else None, down_bias=r(G, D) * 0.5 if biased else None,
    )
    c = {k: None if v is None else v.to(dtype).to(dev) for k, v in c.items()}
    c["gs"] = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return c


def fem_all(c, act, limit, gs=None, plain=False):
    """(out, dW, dbias, dWd, ddb, dlhs, mid, dgdu) through the wrappers (or
    the plain versions), each called alone (bwd_dwd and bwd_dx run the
    elementwise pass themselves), the backward's gu and dmid recomputed as
    the autograd function does (through gmm, bias added in the compute
    dtype)."""
    from automodel_tpu_torch.ops import grouped_matmul as gm

    gs = c["gs"] if gs is None else gs
    want_b = c["gate_up_bias"] is not None
    gu = gm._gmm_plain(c["lhs"], c["gate_up"], gs)
    if want_b:
        gu = tfem.add_row_bias(gu, c["gate_up_bias"], gs)
    dmid = gm._gmm_plain(c["dy"], c["down"], gs, True)
    f = (tfem._fwd_plain, tfem._bwd_gu_plain, tfem._bwd_dwd_plain, tfem._bwd_dx_plain, tfem._bwd_act_plain) if (
        plain) else (tfem.fwd, tfem.bwd_gu, tfem.bwd_dwd, tfem.bwd_dx, tfem.bwd_act)
    out = f[0](c["lhs"], c["gate_up"], c["down"], gs, c["gate_up_bias"], c["down_bias"], act, limit)
    dw, dbias = f[1](c["lhs"], gu, dmid, gs, act, limit, want_b)
    dwd, ddb = f[2](gu, c["dy"], gs, act, limit, want_b)
    dlhs = f[3](gu, dmid, c["gate_up"], gs, act, limit)
    mid, dgdu = f[4](gu, dmid, gs, act, limit)
    return out, dw, dbias, dwd, ddb, dlhs, mid, dgdu


def fem_errors(got, want) -> dict:
    names = ("out", "dw", "dbias", "dwd", "ddb", "dlhs", "mid", "dgdu")
    return {n: row_rel_err(a, b) for n, a, b in zip(names, got, want) if b is not None}


def fem_ok(err: dict) -> bool:
    tol = dict(out=FEM_ROW_TOL, dlhs=FEM_ROW_TOL, dw=FEM_DW_ROW_TOL, dwd=FEM_DW_ROW_TOL,
               dbias=FEM_BIAS_ROW_TOL, ddb=FEM_BIAS_ROW_TOL, mid=FEM_ROW_TOL, dgdu=FEM_ROW_TOL)
    return all(v <= tol[k] for k, v in err.items())


@pytest.mark.parametrize("case", ["random", "skewed"])
def test_fused_row_check_catches_a_one_row_boundary_shift(case):
    """On the CPU, in bf16 as on the card: one row handed from a group to
    its neighbour moves the worst row of out, dlhs, dW, dWd and the bias
    grads past 4x their limits, with ~256-row groups and with one group
    holding a quarter of the rows (where one row is the smallest share)."""
    M = 2048
    sizes = ragged_sizes(M, 8, seed=1, big=3 if case == "skewed" else None)
    c = fem_case(torch.device("cpu"), M, 128, 128, sizes)
    shifted = c["gs"].clone()
    shifted[3] -= 1
    shifted[4] += 1
    right = fem_all(c, "swiglu_oai", None, plain=True)
    err = fem_errors(fem_all(c, "swiglu_oai", None, gs=shifted, plain=True), right)
    assert err["out"] > 4 * FEM_ROW_TOL and err["dlhs"] > 4 * FEM_ROW_TOL, err
    assert err["dw"] > 4 * FEM_DW_ROW_TOL and err["dwd"] > 4 * FEM_DW_ROW_TOL, err
    assert err["dbias"] > 4 * FEM_BIAS_ROW_TOL and err["ddb"] > 4 * FEM_BIAS_ROW_TOL, err


FEM_CASES = [
    (2048, 256, 384, ragged_sizes(2048, 8), "swiglu_oai", None, True, 1.0),
    (2048, 384, 256, ragged_sizes(2048, 8, seed=2, empty=(0, 7), big=3), "swiglu", None, False, 1.0),
    (1000, 1000, 1000, ragged_sizes(1000, 5, seed=3), "swiglu_oai", None, True, 1.0),  # off the tiles
    (130, 128, 128, [1, 129], "swiglu_oai", None, True, 1.0),  # a tile across a group boundary
    (300, 64, 64, [0, 50, 0, 78, 0], "swiglu", None, True, 1.0),  # empty ends, rows past the groups
    (2048, 256, 256, ragged_sizes(2048, 8, seed=4), "swiglu_oai", None, True, 4.26),  # ~10% clamped
    (2048, 256, 256, ragged_sizes(2048, 8, seed=5), "swiglu", 2.0, True, 1.5),  # swiglu's limit
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,I,sizes,act,limit,biased,scale", FEM_CASES)
def test_fused_expert_mlp_kernels_match_plain(M, D, I, sizes, act, limit, biased, scale):
    """fwd (both launches), bwd_gu, bwd_dwd, bwd_dx and bwd_act against
    their plain versions on the card, each wrapper counted once a call
    (bwd_act four times: once alone, once inside bwd_gu, bwd_dwd and bwd_dx
    each); rows past the groups zero. I = 1000 ends the gate_up product's
    last gate boxes past I, I = 64 reads no second gate box at all."""
    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), M, D, I, sizes, biased=biased, scale=scale)
    kernels = (tfem.fwd, tfem.bwd_gu, tfem.bwd_dwd, tfem.bwd_dx, tfem.bwd_act)
    before = [f.launches for f in kernels]
    got = fem_all(c, act, limit)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(kernels, before)] == [1, 1, 1, 1, 4]
    want = fem_all(c, act, limit, plain=True)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got if t is not None)
    n = sum(sizes)
    assert all(bool((got[i][n:] == 0).all()) for i in (0, 5, 6, 7))
    err = fem_errors(got, want)
    assert fem_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,I,sizes,act,limit,biased,scale", FEM_CASES)
def test_bwd_act_kernel_matches_plain(M, D, I, sizes, act, limit, biased, scale):
    """The backward's elementwise pass alone on g | u and dmid drawn at the
    K3 cases' widths and scales (g and u ~ N(0, scale^2), so the 4.26 case
    puts ~10% past +-7), with entries set exactly on the clamps' bounds:
    mid and dg | du per row within FEM_ROW_TOL of the plain version, each
    output alone (mid without dmid, dg | du alone) equal to the pair's, and
    a second launch bit for bit the first."""
    _need_cuda("fused_expert_mlp")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(M + I)
    gu = torch.randn((M, 2 * I), generator=g) * scale
    dmid = torch.randn((M, I), generator=g)
    bound = 7.0 if act == "swiglu_oai" else limit
    if bound is not None:
        pick = torch.rand((M, 2 * I), generator=g)
        gu[pick < 0.05] = bound
        gu[:, I:][pick[:, I:] > 0.95] = -bound
    gu, dmid = gu.to(torch.bfloat16).to(dev), dmid.to(torch.bfloat16).to(dev)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = tfem.bwd_act.launches
    mid, dgdu = tfem.bwd_act(gu, dmid, gs, act, limit)
    mid_alone, none = tfem.bwd_act(gu, None, gs, act, limit, want_dgdu=False)
    none2, dgdu_alone = tfem.bwd_act(gu, dmid, gs, act, limit, want_mid=False)
    again = tfem.bwd_act(gu, dmid, gs, act, limit)
    torch.cuda.synchronize()
    assert tfem.bwd_act.launches == before + 4 and none is None and none2 is None
    r_mid, r_dgdu = tfem._bwd_act_plain(gu, dmid, gs, act, limit)
    n = sum(sizes)
    assert bool((mid[n:] == 0).all()) and bool((dgdu[n:] == 0).all())
    assert row_rel_err(mid, r_mid) <= FEM_ROW_TOL and row_rel_err(dgdu, r_dgdu) <= FEM_ROW_TOL
    assert torch.equal(mid_alone, mid) and torch.equal(dgdu_alone, dgdu)
    assert torch.equal(again[0], mid) and torch.equal(again[1], dgdu)


@pytest.mark.cuda
def test_bwd_act_nan_tail_on_the_card():
    """NaN in g | u and dmid past sum(group_sizes): mid and dg | du are
    bit-identical to the clean run's, zeros there."""
    _need_cuda("fused_expert_mlp")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    gu = torch.randn((1024, 512), generator=g).to(torch.bfloat16).to(dev)
    dmid = torch.randn((1024, 256), generator=g).to(torch.bfloat16).to(dev)
    gs = torch.tensor([300, 0, 400, 200], dtype=torch.int32, device=dev)
    clean = tfem.bwd_act(gu, dmid, gs, "swiglu_oai")
    gu_nan, dmid_nan = gu.clone(), dmid.clone()
    gu_nan[900:], dmid_nan[900:] = float("nan"), float("nan")
    for a, b in zip(tfem.bwd_act(gu_nan, dmid_nan, gs, "swiglu_oai"), clean):
        assert torch.equal(a, b) and bool((a[900:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [True, False])
def test_fused_expert_mlp_backward_repeats_bit_for_bit(biased):
    """No atomics anywhere: every output of two runs (the backward's grads,
    ddb included, and the elementwise pass's) is the same bits; dWd written
    in bf16 equals the fp32 dWd rounded once, with mid given or computed
    inside."""
    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), 2048, 256, 384, ragged_sizes(2048, 8, seed=7), biased=biased)
    first = fem_all(c, "swiglu_oai", None)
    second = fem_all(c, "swiglu_oai", None)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)
    from automodel_tpu_torch.ops import grouped_matmul as gm

    gu = gm.gmm(c["lhs"], c["gate_up"], c["gs"])
    mid, _ = tfem.bwd_act(gu, None, c["gs"], "swiglu_oai", want_dgdu=False)
    fp32, _ = tfem.bwd_dwd(gu, c["dy"], c["gs"], "swiglu_oai", None, biased)
    for kw in (dict(), dict(mid=mid)):
        bf16, ddb = tfem.bwd_dwd(gu, c["dy"], c["gs"], "swiglu_oai", None, biased, out_dtype=torch.bfloat16, **kw)
        assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, fp32.to(torch.bfloat16))
        assert (ddb is None) == (not biased)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,I,sizes", [(1000, 1000, 1000, [0, 333, 1, 500, 100]), (300, 64, 64, [0, 50, 0, 78, 0]),
                                         (2048, 2880, 2880, [0, 700, 1, 1200])])
def test_fused_expert_mlp_forward_repeats_bit_for_bit(M, D, I, sizes):
    """Two launches of the forward (the gate_up product with the activation
    in its epilogue, then the down product with the row bias) give the same
    bits, with and without biases; the mid of the first launch equals the
    plain activation of the plain product within FEM_ROW_TOL a row."""
    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), M, D, I, sizes)
    args = [c[k] for k in ("lhs", "gate_up", "down", "gs")]
    for gub, db in ((c["gate_up_bias"], c["down_bias"]), (None, None)):
        first = tfem.fwd(*args, gub, db, "swiglu_oai")
        assert torch.equal(first, tfem.fwd(*args, gub, db, "swiglu_oai"))
    plan = tgm.gmm_plan(c["gs"], M)
    mid = tfem._launch_fwd_gu_act(c["lhs"], c["gate_up"], c["gate_up_bias"], plan, tfem._ends(c["gs"]), "swiglu_oai",
                                  None)
    gu = tfem.add_row_bias(tgm._gmm_plain(c["lhs"], c["gate_up"], c["gs"]).float(), c["gate_up_bias"].float(),
                           c["gs"])
    want = tfem._act_core(gu[:, :I], gu[:, I:], "swiglu_oai", None)
    n = sum(sizes)
    assert bool((mid[n:] == 0).all()) and row_rel_err(mid[:n], want[:n]) <= FEM_ROW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,I,sizes", [(2048, 256, 384, ragged_sizes(2048, 8, seed=7)),
                                         (1000, 1000, 1000, [0, 333, 1, 500, 100])])
def test_bwd_gu_bf16_out_is_its_fp32_out_rounded(M, D, I, sizes):
    """bwd_gu written in bf16 (the backward's weight grad, dg | du given as
    the backward gives it, and computed inside) equals its fp32 output cast
    to bf16, bit for bit: one sum, rounded once; the bias grads are the
    same fp32 bits either way and repeat exactly."""
    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), M, D, I, sizes)
    gs = c["gs"]
    gu = tfem.add_row_bias(tgm.gmm(c["lhs"], c["gate_up"], gs), c["gate_up_bias"], gs)
    dmid = tgm.gmm(c["dy"], c["down"], gs, transpose_rhs=True)
    fp32, db32 = tfem.bwd_gu(c["lhs"], gu, dmid, gs, "swiglu_oai", None, True)
    _, dgdu = tfem.bwd_act(gu, dmid, gs, "swiglu_oai", want_mid=False)
    for kw in (dict(), dict(dgdu=dgdu)):
        bf16, db = tfem.bwd_gu(c["lhs"], gu, dmid, gs, "swiglu_oai", None, True, out_dtype=torch.bfloat16, **kw)
        assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, fp32.to(torch.bfloat16)) and torch.equal(db, db32)


@pytest.mark.cuda
def test_fused_expert_mlp_entry_points_refuse_what_they_do_not_take():
    """K3a's and K3b's C entry points return the unsupported-shape code for
    D or I not a multiple of 8 and an unknown act_kind, before any launch;
    the wrappers refuse a dtype the kernels do not take."""
    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), 64, 32, 40, [30, 34])
    plan, ends = tgm.gmm_plan(c["gs"], 64), tfem._ends(c["gs"])
    out = torch.empty(64, 40, dtype=torch.bfloat16, device="cuda")
    lib, flib, s = tgm._lib(), tfem._lib(), tfem._stream(c["lhs"])
    W = plan.shape[1]
    p = lambda t: t.data_ptr()  # noqa: E731
    act = lambda D, I, kind: lib.grouped_matmul_gmm_act(  # noqa: E731
        p(c["lhs"]), p(c["gate_up"]), None, p(plan), p(ends), p(out), 64, D, I, 2, W, 1, kind, 0.0, s)
    bias = lambda K, N: lib.grouped_matmul_gmm_bias(  # noqa: E731
        p(c["lhs"]), p(c["down"]), None, p(plan), p(ends), p(out), 64, K, N, 2, W, 1, s)
    dgub = lambda I, kind: flib.fused_expert_mlp_bwd_dgub(  # noqa: E731
        p(out), p(out), p(ends), p(out), 64, I, 2, kind, 0.0, s)
    for rc in (act(30, 40, 1), act(32, 36, 1), act(32, 40, 2), bias(36, 32), bias(40, 30), dgub(36, 1), dgub(40, 2)):
        assert rc == 100001
    torch.cuda.synchronize()
    gu = torch.zeros(64, 80, dtype=torch.bfloat16, device="cuda")
    dmid = torch.zeros(64, 40, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        tfem.bwd_gu(c["lhs"], gu, dmid, c["gs"], dgdu=gu.float())
    with pytest.raises(ValueError, match="writes"):
        tfem.bwd_gu(c["lhs"], gu, dmid, c["gs"], out_dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        tfem.fwd(c["lhs"], c["gate_up"], c["down"], c["gs"], c["gate_up_bias"].float())


@pytest.mark.cuda
def test_fused_expert_mlp_nan_tail_on_the_card():
    """NaN in lhs and dy past sum(group_sizes): every kernel output is
    bit-identical to the clean-tail run (no CTA reads those rows), and
    finite."""
    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), 1024, 256, 256, [300, 0, 400, 200])
    clean = fem_all(c, "swiglu_oai", None)
    dirty = dict(c, lhs=c["lhs"].clone(), dy=c["dy"].clone())
    dirty["lhs"][900:] = float("nan")
    dirty["dy"][900:] = float("nan")
    for a, b in zip(fem_all(dirty, "swiglu_oai", None), clean):
        assert bool(torch.isfinite(a.float()).all()) and torch.equal(a, b)


@pytest.mark.cuda
def test_fused_expert_mlp_autograd_on_the_card():
    """fused_expert_mlp's backward on the card is gmm, gmm_t, the
    elementwise pass once and the three backward wrappers given its
    outputs, bit-identical to calling each wrapper alone (no atomics: they
    repeat exactly; dWd's bf16 out is its fp32 sum rounded once); the
    tgmm and gmm counts are K2's own calls, which dWd and dlhs do not
    add to."""
    from automodel_tpu_torch.ops import grouped_matmul as gm

    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), 2048, 256, 384, ragged_sizes(2048, 8, seed=6))
    names = ("lhs", "gate_up", "down", "gate_up_bias", "down_bias")
    leaves = {k: c[k].clone().requires_grad_(True) for k in names}
    counts = lambda: (gm.gmm.launches, gm.gmm.launches_t, gm.tgmm.launches, tfem.fwd.launches, tfem.bwd_gu.launches,
                      tfem.bwd_dwd.launches, tfem.bwd_dx.launches, tfem.bwd_act.launches)
    before = counts()
    out = tfem.fused_expert_mlp(leaves["lhs"], leaves["gate_up"], leaves["down"], c["gs"], leaves["gate_up_bias"],
                                leaves["down_bias"], "swiglu_oai")
    out.backward(c["dy"])
    assert [b - a for a, b in zip(before, counts())] == [1, 1, 0, 1, 1, 1, 1, 1]
    gu = tfem.add_row_bias(gm.gmm(c["lhs"], c["gate_up"], c["gs"]), c["gate_up_bias"], c["gs"])
    dmid = gm.gmm(c["dy"], c["down"], c["gs"], transpose_rhs=True)
    dw, dbias = tfem.bwd_gu(c["lhs"], gu, dmid, c["gs"], "swiglu_oai", None, True)
    dwd, ddb = tfem.bwd_dwd(gu, c["dy"], c["gs"], "swiglu_oai", None, True)
    assert torch.equal(out.detach(), tfem.fwd(*(c[k] for k in ("lhs", "gate_up", "down", "gs", "gate_up_bias",
                                                                 "down_bias")), "swiglu_oai"))
    assert torch.equal(leaves["lhs"].grad, tfem.bwd_dx(gu, dmid, c["gate_up"], c["gs"], "swiglu_oai"))
    assert torch.equal(leaves["gate_up"].grad, dw.to(torch.bfloat16))
    assert torch.equal(leaves["down"].grad, dwd.to(torch.bfloat16))
    assert torch.equal(leaves["gate_up_bias"].grad, dbias.to(torch.bfloat16))
    assert torch.equal(leaves["down_bias"].grad, ddb.to(torch.bfloat16))


@pytest.mark.cuda
def test_fused_expert_mlp_refuses_what_the_kernels_do_not_take():
    _need_cuda("fused_expert_mlp")
    c = fem_case(torch.device("cuda"), 64, 32, 40, [30, 34])
    args = lambda **kw: {**{k: c[k] for k in ("lhs", "gate_up", "down")}, "group_sizes": c["gs"], **kw}
    with pytest.raises(ValueError, match="bfloat16"):
        tfem.fwd(**args(lhs=c["lhs"].float()))
    with pytest.raises(ValueError, match="multiple of 8|multiples of 8"):
        tfem.fwd(c["lhs"][:, :30].contiguous(), c["gate_up"][:, :30].contiguous(), c["down"][..., :30].contiguous(),
                 c["gs"])
    with pytest.raises(ValueError, match="contiguous"):
        tfem.bwd_dwd(torch.zeros(80, 64, dtype=torch.bfloat16, device="cuda").t(), c["dy"], c["gs"])
    with pytest.raises(ValueError, match="group_sizes"):
        tfem.fwd(**args(group_sizes=c["gs"].long()))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 128])
def test_flash_with_sinks_on_the_card_matches_plain(window):
    """The sink fold around the kernels against the same fold around the
    plain versions: the folded out per row within 2^-7 and the extended lse
    within 1e-3; dq/dk/dv per row within 2^-6 (the flash kernels' limits),
    both backward versions fed the plain fold's extended lse and delta, as
    the flash checks above feed them the plain forward's; d_sinks end to
    end, each side from its own out and lse, per head within SINKS_GRAD_TOL
    of its terms' magnitudes (``sinks_grad_err``)."""
    _need_cuda("flash_attention")
    q, k, v, do, pos, _ = flash_case(torch.device("cuda"), S=1000, H=64, N=16, Nkv=2)
    sinks = torch.randn(16, generator=torch.Generator().manual_seed(2)).cuda() * 2
    kw = dict(causal=True, window=window, scale=64**-0.5)
    out, lse = trf.fold_sinks(*trf.flash_block_fwd(q, k, v, pos, pos, None, None, **kw), sinks)
    r_out, r_lse = trf.fold_sinks(*trf._flash_fwd_plain(q, k, v, pos, pos, None, None, **kw), sinks)
    delta = lambda o: (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, r_lse, delta(r_out), pos, pos, None, None)
    got = (trf.flash_block_dq(*args, **kw), *trf.flash_block_dkv(*args, **kw))
    ds = trf.sinks_grad(lse, delta(out), sinks)
    torch.cuda.synchronize()
    want = (trf._flash_dq_plain(*args, **kw), *trf._flash_dkv_plain(*args, **kw))
    r_ds = trf.sinks_grad(r_lse, delta(r_out), sinks)
    assert row_rel_err(out, r_out) <= FLASH_OUT_TOL and float((lse - r_lse).abs().max()) <= FLASH_LSE_TOL
    assert max(grad_row_err(a, b) for a, b in zip(got, want)) <= FLASH_GRAD_TOL
    assert sinks_grad_err(ds, r_ds, sinks, r_out, r_lse, do) <= SINKS_GRAD_TOL


# d_sinks = -sum over rows of p_sink x delta, delta = dO . out per row: a
# signed sum that cancels, so each head's error is judged against the sum of
# its terms' magnitudes, sum p_sink |dO| |out|. The two versions' out rows
# are within 2^-7 of each other, so |delta - delta'| <= 2^-7 |dO| |out| and
# the error is within 2^-7 of that sum whatever the cancellation (first
# reading on an H100: 2.6e-3 of the largest element, S=1000, N=16).
SINKS_GRAD_TOL = 2.0**-7


def sinks_grad_err(ds, r_ds, sinks, out, lse, do) -> float:
    """max over heads of |ds - r_ds| / sum_{b,s} p_sink |dO| |out| (the plain
    fold's out and extended lse)."""
    p_sink = torch.exp(sinks.float()[None, :, None] - lse)  # [B, N, S]
    mag = (do.float().norm(dim=-1) * out.float().norm(dim=-1)).transpose(1, 2)  # [B, N, S]
    return float(((ds - r_ds).abs() / (p_sink * mag).sum(dim=(0, 2)).clamp_min(1e-30)).max())


def test_sinks_grad_check_catches_an_unfolded_delta():
    """On the CPU: d_sinks taken with delta from the output before the sink
    fold (out not rescaled by exp(lse - lse')) moves the worst head's error
    past 4x SINKS_GRAD_TOL, in bf16 at N=16 over 8 kv heads."""
    q, k, v, do, pos, _ = flash_case(torch.device("cpu"), S=512, H=64, N=16, Nkv=2, B=1)
    sinks = torch.randn(16, generator=torch.Generator().manual_seed(1)) * 2
    kw = dict(causal=True, window=None, scale=64**-0.5)
    raw, lse0 = trf._flash_fwd_plain(q, k, v, pos, pos, None, None, **kw)
    out, lse = trf.fold_sinks(raw, lse0, sinks)
    delta = lambda o: (do.float() * o.float()).sum(-1).transpose(1, 2)
    right = trf.sinks_grad(lse, delta(out), sinks)
    wrong = trf.sinks_grad(lse, delta(raw), sinks)
    assert sinks_grad_err(wrong, right, sinks, out, lse, do) > 4 * SINKS_GRAD_TOL

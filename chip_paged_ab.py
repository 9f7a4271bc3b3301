"""Times the paged-attention kernel (K4) of two checkouts of the torch port
on one CUDA card, each checkout in a process of its own, in the order A, B,
B, A.

The cases are chip_smoke.py's phase 3 cases, made from its seeds: B = 16
sequences, N = 32, Nkv = 8, H = 128, BS = 16, Sq = 1,

- ``bf16 ragged`` and ``int8 ragged``: the main cases, lengths 1..4096;
- ``bf16 all 256``, ``bf16 all 1024``, ``bf16 all 4096``: every sequence
  at one length;
- ``bf16 B=1 4096`` and ``int8 B=1 4096``: one 4096-token sequence.

    python3 chip_paged_ab.py A_DIR B_DIR   # one JSON line a run, then the means and A / B
    python3 chip_paged_ab.py --one DIR     # one checkout's times as one JSON line
    python3 chip_paged_ab.py --sweep DIR   # what sets the checkout's times, one JSON line each

``--sweep`` times each case at every chunk size the split rule may pick
(``CUDA_CHUNK_BLOCKS``) beside the one it picks; the same bytes (128
sequences x kv heads at 4096 tokens) with Nkv = 8, 4, 2 and 1, whose token
rows of one head lie 2 KB down to 256 B apart; and the rate at which the
card reads 268 MB in plain torch (a sum, and a copy that also writes).

Each time is the card's, with the host kept ahead of it
(``chip_smoke.cuda_ms_queued``): one call of the wrapper costs the host
about as long as the new kernel takes. Each DIR is the root of a checkout
that holds ``automodel_tpu_torch/``. The script needs one card and imports
nothing of JAX; its A/B harness is chip_grouped_ab.py's.
"""

from __future__ import annotations

import json
import os
import sys

from chip_grouped_ab import ab_main, checkout

# (name, chip_smoke.phase_kernels' case index = its seed, paged_case arguments)
CASES = (
    ("bf16 ragged", 0, dict(sq=1, quantized=False)),
    ("int8 ragged", 1, dict(sq=1, quantized=True)),
    ("bf16 all 256", 9, dict(sq=1, quantized=False, uniform=256)),
    ("bf16 all 1024", 10, dict(sq=1, quantized=False, uniform=1024)),
    ("bf16 all 4096", 11, dict(sq=1, quantized=False, uniform=4096)),
    ("bf16 B=1 4096", 14, dict(sq=1, quantized=False, batch=1, uniform=4096)),
    ("int8 B=1 4096", 15, dict(sq=1, quantized=True, batch=1, uniform=4096)),
)


def one(root: str) -> dict:
    torch, cs, pa = checkout(root, "paged_attention", "chip_paged_ab")
    root = os.path.abspath(root)
    dev = torch.device("cuda")
    ms = {}
    for name, seed, kw in CASES:
        q, pool = cs.paged_case(torch, dev, seed=seed, **kw)
        ms[name] = cs.cuda_ms_queued(lambda: pa.paged_attend(q, *pool), iters=50)[0]
        del q, pool
        torch.cuda.empty_cache()
    return dict(root=root, torch=torch.__version__, card=torch.cuda.get_device_name(0), ms=ms)


def layout_case(torch, pa, dev, batch: int, nkv: int, quantized: bool, length: int = 4096):
    """``batch`` sequences of ``length`` tokens over ``nkv`` kv heads (4 query
    heads each), H = 128, a random block table, from seed 0."""
    H, BS = 128, 16
    g = torch.Generator(device=dev).manual_seed(0)
    nbseq = -(-(length + 1) // BS)
    nb = batch * nbseq + 1
    tables = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(batch, nbseq).to(torch.int32)
    lengths = torch.full((batch,), length, dtype=torch.int32, device=dev)
    q = torch.randn((batch, 1, 4 * nkv, H), generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn((nb, BS, nkv, H), generator=g, device=dev) for _ in range(2))
    if quantized:
        (kq, ks), (vq, vs) = pa.quantize_kv_rows(kp), pa.quantize_kv_rows(vp)
        return q, (kq, vq, tables, lengths, ks, vs)
    return q, (kp.to(torch.bfloat16), vp.to(torch.bfloat16), tables, lengths)


def sweep(root: str) -> None:
    torch, cs, pa = checkout(root, "paged_attention", "chip_paged_ab")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, seed, kw in CASES:
        q, pool = cs.paged_case(torch, dev, seed=seed, **kw)
        row = dict(case=name, rule_tokens=16 * pa.chunk_blocks(q.shape[0], pool[0].shape[2], pool[2].shape[1], sms))
        scales = pool[4:] if len(pool) == 6 else (None, None)
        for cb in pa.CUDA_CHUNK_BLOCKS:
            call = lambda cb=cb: pa._launch_cuda(q, *pool[:4], *scales, None, None, None, cb)  # noqa: E731
            row[f"ms_at_{16 * cb}_tokens"] = cs.cuda_ms_queued(call, iters=50)[0]
        print(json.dumps(row), flush=True)
        del q, pool
        torch.cuda.empty_cache()
    for quantized in (False, True):
        for batch, nkv in ((16, 8), (32, 4), (64, 2), (128, 1)):
            q, pool = layout_case(torch, pa, dev, batch, nkv, quantized)
            ms = cs.cuda_ms_queued(lambda: pa.paged_attend(q, *pool), iters=30)[0]
            bound_ms, _, nbytes = cs.paged_bound(q, pool, None)
            print(json.dumps(dict(layout=f"{'int8' if quantized else 'bf16'} B={batch} Nkv={nkv}", ms=ms,
                                  bound_ms=bound_ms, tb_per_s=nbytes / ms / 1e9)), flush=True)
            del q, pool
            torch.cuda.empty_cache()
    x = torch.randn(134_217_728, device=dev).to(torch.bfloat16)  # 268 MB
    y = torch.empty_like(x)
    ms_sum = cs.cuda_ms(lambda: x.sum(dtype=torch.float32), iters=20)
    ms_copy = cs.cuda_ms(lambda: y.copy_(x), iters=20)
    print(json.dumps(dict(read_268_mb=dict(sum_ms=ms_sum, sum_tb_per_s=x.numel() * 2 / ms_sum / 1e9,
                                           copy_ms=ms_copy, copy_tb_per_s=4 * x.numel() / ms_copy / 1e9))),
          flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--sweep":
        sweep(argv[1])
        return 0
    return ab_main(argv, __file__, one, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Times the grouped-matmul kernels (K2) and the fused expert MLP's
backward (K3) of two checkouts of the torch port on one CUDA card, each
checkout in a process of its own, in the order A, B, B, A.

At Qwen3-30B-A3B's MoE launches (M = 32768 gate-routed rows over 128
experts, the gate case of chip_smoke.py's phase 8, from its seeds):

- gmm and gmm_t at the gate_up and the down launch, with the plan given
  (as the MoE layer runs them) and with the plan built in each call;
- tgmm with an fp32 output, and the bf16 weight grad the backward takes:
  tgmm's bf16 output where the checkout has one, else its fp32 output
  cast in eager torch.

At gpt-oss-20b's (M = 16384 gate-routed rows over 32 experts, D = I =
2880, swiglu_oai with expert biases, the gate case of chip_smoke.py's
phase 12, from its seeds):

- ``k3c_bf16_grad``: bwd_dwd with the bf16 weight grad and the bias grad
  the backward takes, called alone from gu (a checkout whose bwd_dwd
  writes fp32 only: that, then the cast in eager torch);
- ``k3d``: bwd_dx called alone from gu and dmid;
- where the checkout has the elementwise pass, ``bwd_act`` and the
  products given its outputs (``k3c_mid_given``, ``k3d_dgdu_given``);
- ``k3_backward``: one whole backward of ``fused_expert_mlp`` (the
  autograd function, from the same forward's saved tensors).

    python3 chip_grouped_ab.py A_DIR B_DIR   # one JSON line a run, then the means and A / B
    python3 chip_grouped_ab.py --one DIR     # one checkout's times as one JSON line

Each DIR is the root of a checkout that holds ``automodel_tpu_torch/``. The
script needs one card and imports nothing of JAX. ``checkout`` and
``ab_main`` are the A/B harness, which chip_paged_ab.py shares.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys


def checkout(root: str, module: str, script: str):
    """torch, chip_smoke.py (beside this script) as a module of helpers, and
    ``automodel_tpu_torch.ops.<module>`` imported from the checkout at
    ``root``; exits unless there is a CUDA card. → (torch, chip_smoke, module)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{script}: needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    mod = importlib.import_module(f"automodel_tpu_torch.ops.{module}")
    if not mod.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {mod.__file__}, not the checkout at {root}")
    return torch, cs, mod


def one(root: str) -> dict:
    torch, cs, gm = checkout(root, "grouped_matmul", "chip_grouped_ab")
    root = os.path.abspath(root)
    dev = torch.device("cuda")
    hf = cs.QWEN3_MOE_A3B
    D, I, E = hf["hidden_size"], hf["moe_intermediate_size"], hf["num_experts"]
    g = torch.Generator(device=dev).manual_seed(100)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    # the tensors of phase 8's gate case, made in its order
    w_gu = randn(E, D, 2 * I, scale=D**-0.5)
    w_dn = randn(E, I, D, scale=I**-0.5)
    xs, gs = cs.moe_rows(torch, dev, "gate", seed=0)
    M = xs.shape[0]
    dgu = randn(M, 2 * I)
    h, dy = randn(M, I), randn(M, D)
    plan = gm.gmm_plan(gs, M)
    ms = {}
    for name, a, b, t in (("gmm", xs, w_gu, False), ("gmm_t", dgu, w_gu, True),
                          ("gmm_down", h, w_dn, False), ("gmm_t_down", dy, w_dn, True)):
        ms[f"{name}_plan_given"] = cs.cuda_ms(lambda: gm.gmm(a, b, gs, transpose_rhs=t, plan=plan), iters=20)
        ms[f"{name}_plan_in_call"] = cs.cuda_ms(lambda: gm.gmm(a, b, gs, transpose_rhs=t), iters=20)
    for name, a, b in (("tgmm", xs, dgu), ("tgmm_down", h, dy)):
        ms[f"{name}_fp32"] = cs.cuda_ms(lambda: gm.tgmm(a, b, gs), iters=20)
        try:
            gm.tgmm(a, b, gs, bf16)
            grad = lambda: gm.tgmm(a, b, gs, bf16)  # noqa: E731
        except TypeError:  # a tgmm with an fp32 output only: the backward cast it
            grad = lambda: gm.tgmm(a, b, gs).to(bf16)  # noqa: E731
        ms[f"{name}_bf16_grad"] = cs.cuda_ms(grad, iters=20)
    del w_gu, w_dn, xs, dgu, h, dy, plan
    torch.cuda.empty_cache()
    ms.update(k3_backward_ms(torch, cs, dev))
    return dict(root=root, torch=torch.__version__, card=torch.cuda.get_device_name(0), ms=ms)


def k3_backward_ms(torch, cs, dev) -> dict:
    """K3's backward at phase 12's gate case (its seeds and scales)."""
    from automodel_tpu_torch.ops import fused_expert_mlp as fem
    from automodel_tpu_torch.ops import grouped_matmul as gm

    hf = cs.GPT_OSS_20B
    D, I = hf["hidden_size"], hf["intermediate_size"]
    act, bf16 = "swiglu_oai", torch.bfloat16
    xs, gs = cs.gpt_oss_rows(torch, dev, "gate", seed=40)
    M, G = xs.shape[0], gs.shape[0]
    g = torch.Generator(device=dev).manual_seed(50)
    rnd = lambda *shape, s=1.0: (torch.randn(shape, generator=g, device=dev) * s).to(bf16)  # noqa: E731
    w_gu, w_dn = rnd(G, D, 2 * I, s=D**-0.5), rnd(G, I, D, s=I**-0.5)
    gub, db = rnd(G, 2 * I, s=0.5), rnd(G, D, s=0.5)
    dy = torch.randn((M, D), generator=torch.Generator(device=dev).manual_seed(60), device=dev).to(bf16)
    plan = gm.gmm_plan(gs, M)
    gu = fem.add_row_bias(gm.gmm(xs, w_gu, gs, plan=plan), gub, gs)
    dmid = gm.gmm(dy, w_dn, gs, transpose_rhs=True, plan=plan)
    ms = {}
    try:
        fem.bwd_dwd(gu, dy, gs, act, None, True, bf16)
        k3c = lambda: fem.bwd_dwd(gu, dy, gs, act, None, True, bf16)  # noqa: E731
    except TypeError:  # a bwd_dwd with an fp32 output only: the backward cast it
        k3c = lambda: fem.bwd_dwd(gu, dy, gs, act, None, True)[0].to(bf16)  # noqa: E731
    ms["k3c_bf16_grad"] = cs.cuda_ms(k3c, iters=10)
    ms["k3d"] = cs.cuda_ms(lambda: fem.bwd_dx(gu, dmid, w_gu, gs, act, None, plan=plan), iters=10)
    if hasattr(fem, "bwd_act"):
        mid, dgdu = fem.bwd_act(gu, dmid, gs, act, None)
        ms["bwd_act"] = cs.cuda_ms(lambda: fem.bwd_act(gu, dmid, gs, act, None), iters=10)
        ms["k3c_mid_given"] = cs.cuda_ms(lambda: fem.bwd_dwd(gu, dy, gs, act, None, True, bf16, mid=mid), iters=10)
        ms["k3d_dgdu_given"] = cs.cuda_ms(lambda: fem.bwd_dx(gu, dmid, w_gu, gs, act, None, plan=plan, dgdu=dgdu),
                                          iters=10)
        del mid, dgdu
    del gu, dmid
    torch.cuda.empty_cache()
    leaves = [t.clone().requires_grad_(True) for t in (xs, w_gu, w_dn, gub, db)]
    out = fem.fused_expert_mlp(leaves[0], leaves[1], leaves[2], gs, leaves[3], leaves[4], act, plan=plan)
    ms["k3_backward"] = cs.cuda_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), iters=5, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.autograd.grad(out, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()
    ms["k3_backward_peak_extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    return ms


def ab_main(argv: list[str], script: str, one, doc: str) -> int:
    """``--one DIR``: ``one(DIR)`` as one JSON line. ``A_DIR B_DIR``: ``script
    --one`` for A, B, B and A, each in a process of its own, their lines,
    the card's name and power limit, then the mean of each time and A / B
    over the times both report."""
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(doc, file=sys.stderr)
        return 2
    a, b = argv
    runs = {a: [], b: []}
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(script), "--one", root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[root].append(line["ms"])
    mean = {root: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]} for root, rs in runs.items()}
    common = [k for k in mean[a] if k in mean[b]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"A": a, "B": b, "mean_ms": mean, "A_over_B": {k: mean[a][k] / mean[b][k] for k in common}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(ab_main(sys.argv[1:], __file__, one, __doc__))

"""Times the grouped-matmul kernels (K2) of two checkouts of the torch port
on one CUDA card, each checkout in a process of its own, in the order A, B,
B, A, at Qwen3-30B-A3B's MoE launches (M = 32768 gate-routed rows over 128
experts, the gate case of chip_smoke.py's phase 8, from its seeds):

- gmm and gmm_t at the gate_up and the down launch, with the plan given
  (as the MoE layer runs them) and with the plan built in each call;
- tgmm with an fp32 output, and the bf16 weight grad the backward takes:
  tgmm's bf16 output where the checkout has one, else its fp32 output
  cast in eager torch.

    python3 chip_grouped_ab.py A_DIR B_DIR   # one JSON line a run, then the means and A / B
    python3 chip_grouped_ab.py --one DIR     # one checkout's times as one JSON line

Each DIR is the root of a checkout that holds ``automodel_tpu_torch/``. The
script needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_grouped_ab: needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from automodel_tpu_torch.ops import grouped_matmul as gm

    if not gm.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {gm.__file__}, not the checkout at {root}")
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
    return dict(root=root, torch=torch.__version__, card=torch.cuda.get_device_name(0), ms=ms)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv
    runs = {a: [], b: []}
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], capture_output=True,
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
    sys.exit(main(sys.argv[1:]))

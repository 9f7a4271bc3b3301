"""chip_smoke.py phase 4's serving (16 greedy requests at Llama-3-8B width
and 32 layers, 8 sharing a 512-token prefix, through the paged-attention
kernel) and its decode-step profile, in two checkouts, each in its own
process, in turns A, B, B, A; one JSON line a run, the card's name and
power limit last.

    python3 chip_serving_ab.py OTHER_CHECKOUT .    # on one CUDA card

Each checkout builds its own kernel. Compare the two only within one call.
It imports nothing of JAX."""

import json
import subprocess
import sys

ONE = r'''
import importlib.util, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
from automodel_tpu_torch.ops import _cuda_build
from automodel_tpu_torch.config import ConfigNode
from automodel_tpu_torch.serving.server import build_engine
_cuda_build.build(["paged_attention"])
torch.backends.cuda.matmul.allow_tf32 = False
engine = build_engine(ConfigNode(cs.serve_config("bf16")))
s = cs.phase_serving(torch, engine, n=16, shared=8)
p = cs.phase_profile(torch, engine)
print("AB " + json.dumps(dict(tokens_per_s=s["tokens_per_s"], ttft_p50_s=s["ttft_p50_s"], step_ms=p["step_ms"],
      device_busy_ms_per_step=p.get("device_busy_ms_per_step"))), flush=True)
'''

a, b = sys.argv[1], sys.argv[2]
out = []
for tag, d in (("A", a), ("B", b), ("B", b), ("A", a)):
    r = subprocess.run([sys.executable, "-c", ONE], cwd=d, capture_output=True, text=True, timeout=600)
    line = next((x for x in r.stdout.splitlines() if x.startswith("AB ")), None)
    if line is None:
        print(r.stdout[-3000:], r.stderr[-3000:])
        sys.exit(1)
    out.append(dict(side=tag, dir=d, **json.loads(line[3:])))
    print(tag, d, line[3:], flush=True)
print(json.dumps(out))
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())

"""One ``torchrun`` rank of ``tests/test_torch_parallel_mp.py``'s MoE run:
every case of a plan in one gloo group of two processes.

``python -m torch.distributed.run --standalone --nproc_per_node 2
tests/torch_mp_moe_child.py PLAN.json OUT_DIR`` reads the plan the test
wrote (each case: a family's HF config and the state dict of its carried
JAX weights, the mesh degrees, the experts backend, and what to run) and,
case by case on a device mesh of those degrees over the same group:

- ``grads``: one microbatch's loss over the global batch (the ranks' loss
  sums and label counts summed over ``loss_dp``) and every parameter's
  whole gradient of it (``full_tensor`` of a sharded one), the moe aux
  loss (each rank's share, summed); under ``cp > 1`` the rows zigzag-
  permuted with their global positions, and attention the ``ring``;
- ``steps``: two steps of the train step with the plan's optimizer
  (``adafactor`` or ``muon``, built over the local shards with their
  placements), then every parameter whole, and the optimizer's state
  saved through DCP to the case's ``optim_dir`` as the recipe's
  checkpoint tree holds it;
- ``gate``: the token-level aux loss over the ranks' rows (``seq_len``
  unset, the expert counts and probability sums all-reduced) and its
  router-weight grad.

Rank 0 writes each case's result to ``OUT_DIR/<case>.pt``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)


def _build(case: dict, ctx):
    from automodel_tpu_torch.auto_model import from_config

    backend = dict(attn="sdpa", experts=case["experts"], param_dtype="float32", compute_dtype="float32")
    if ctx.cp_size > 1:
        from automodel_tpu_torch.parallel.cp import install_ring_backend

        install_ring_backend(ctx, zigzag=True)
        backend.update(attn="ring", cp_zigzag=True)
    model = from_config(case["hf"], backend, device="cpu", trainable=True).model
    model.load_state_dict(torch.load(case["weights"]))
    return model


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _grads(case: dict, ctx) -> dict:
    import torch.distributed as dist

    from automodel_tpu_torch.data.loader import local_batch
    from automodel_tpu_torch.parallel.plans import parallelize
    from automodel_tpu_torch.training.train_step import make_causal_lm_loss

    model = _build(case, ctx)
    parallelize(model, ctx)
    batch = {k: np.asarray(v) for k, v in np.load(case["batch"]).items()}
    if ctx.cp_size > 1:
        from automodel_tpu_torch.parallel.cp import apply_zigzag

        ids = batch["input_ids"]
        batch["position_ids"] = np.broadcast_to(np.arange(ids.shape[-1], dtype=np.int32), ids.shape).copy()
        batch = {k: apply_zigzag(v, ctx.cp_size, axis=1) for k, v in batch.items()}
    mb = {k: torch.from_numpy(v) for k, v in local_batch(ctx, batch, microbatched=False).items()}
    loss_sum, n, extras = make_causal_lm_loss(model, "fused_linear_ce", mesh_ctx=ctx)(mb)
    loss_sum.backward()
    sums = torch.stack([loss_sum.detach(), n.float(), extras["moe_aux_loss"]])
    if ctx.group_size("loss_dp") > 1:
        dist.all_reduce(sums, group=ctx.group("loss_dp"))
    grads = {name: _whole(p.grad) / sums[1] for name, p in model.named_parameters()}
    return dict(loss=float(sums[0] / sums[1]), aux=float(sums[2]), grads=grads)


def _steps(case: dict, ctx) -> dict:
    from automodel_tpu_torch.data.loader import local_batch
    from automodel_tpu_torch.optim.builders import build_optimizer
    import torch.distributed.checkpoint as dcp

    from automodel_tpu_torch.parallel.plans import local, parallelize, shard_like
    from automodel_tpu_torch.training.train_state import TrainState
    from automodel_tpu_torch.training.train_step import build_train_step, make_causal_lm_loss

    model = _build(case, ctx)
    parallelize(model, ctx)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    opt = build_optimizer([local(p) for p in params], names=[n for n, _ in named], leaf_of=model.jax_leaf_of,
                          like=params, **case["optimizer"])
    state = TrainState(params=params, optimizer=opt)
    step = build_train_step(make_causal_lm_loss(model, "fused_linear_ce", mesh_ctx=ctx), mesh_ctx=ctx)
    batch = {k: np.asarray(v) for k, v in np.load(case["batch"]).items()}
    mb = {k: torch.from_numpy(v)[None] for k, v in local_batch(ctx, batch, microbatched=False).items()}
    losses = [float(step(state, mb)["loss"]) for _ in range(2)]
    dcp.save({"optim": shard_like(opt.state_tree([n for n, _ in named]), dict(named))},
             checkpoint_id=case["optim_dir"])
    return dict(losses=losses, params={n: _whole(p).detach().clone() for n, p in named})


def _gate(case: dict, ctx) -> dict:
    import torch.distributed as dist

    from automodel_tpu_torch.moe.config import MoEConfig
    from automodel_tpu_torch.moe.gate import AuxScope, gate

    g = case["gate"]
    x, w = torch.tensor(np.load(case["batch"])["x"]), torch.tensor(np.load(case["batch"])["router"])
    w.requires_grad_(True)
    cfg = MoEConfig(**g["cfg"])
    group = ctx.group("loss_dp")
    rows = x.shape[0] // dist.get_world_size()
    mine = x[dist.get_rank() * rows:(dist.get_rank() + 1) * rows]
    share = gate(mine, w, cfg, scope=AuxScope(torch.tensor(0.0), group)).aux_loss
    share.backward()
    total = share.detach().clone()
    dist.all_reduce(total, group=group)
    grad = w.grad.clone()
    dist.all_reduce(grad, group=group)
    return dict(aux=float(total), grad=grad)


def main(plan_path: str, out_dir: str) -> int:
    import torch.distributed as dist

    from automodel_tpu_torch.parallel.mesh import MeshConfig, build_mesh, initialize_distributed

    initialize_distributed("cpu")
    out = Path(out_dir)
    for case in json.loads(Path(plan_path).read_text()):
        ctx = build_mesh(MeshConfig(**case["mesh"]), device_type="cpu")
        result = {"grads": _grads, "steps": _steps, "gate": _gate}[case["kind"]](case, ctx)
        if dist.get_rank() == 0:
            torch.save(result, out / f"{case['name']}.pt")
        dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

"""The port's data loader and input pipeline (automodel_tpu_torch/data/
loader.py, data/prefetch.py, the grouped path of training/step_scheduler.py
and the recipe's wiring) against the JAX package on the CPU, following
tests/test_prefetch.py: the loader's sample stream, batches and resume
cursors equal JAX's (``shuffle``, ``drop_last``, ``infinite``); the
pipeline's stream parity and tail discard, consumption cursor, seek, seed
change and producer error; the overlap under a slow dataset (no fault
injection); the strict ``data.prefetch`` keys; and the recipe with prefetch
on against off bit for bit, through a resume and a rollback across a
prefetched window. Every batch is held exactly; the placement on the card
is tests/test_torch_cuda_kernels.py's (marked ``cuda``)."""

import json
import os
import time

import numpy as np
import pytest

from automodel_tpu.data.collators import packed_collater as jax_packed_collater
from automodel_tpu.data.loader import DataLoader as JDataLoader
from automodel_tpu.data.prefetch import PrefetchConfig as JConfig
from automodel_tpu.data.prefetch import PrefetchingLoader as JPrefetch
from automodel_tpu.data.sft import MockSFTDataset as JMock
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.data.collators import packed_collater, stack_microbatches
from automodel_tpu_torch.data.loader import DataLoader
from automodel_tpu_torch.data.packed import pack_sequences
from automodel_tpu_torch.data.prefetch import PrefetchConfig, PrefetchingLoader, PreparedBatch
from automodel_tpu_torch.data.sft import MockSFTDataset
from automodel_tpu_torch.training.step_scheduler import StepScheduler
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFT_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "sft_tiny_cpu.yaml")


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _sync_groups(ds, gbs, group_size, seed=0, epochs=1):
    """The sync stream: stacked grad-acc groups, tails dropped, as the
    scheduler's grouping feeds the loop."""
    out, loader = [], DataLoader(ds, global_batch_size=gbs, shuffle=True, seed=seed)
    for _ in range(epochs):
        group = []
        for b in loader:
            group.append(b)
            if len(group) == group_size:
                out.append(stack_microbatches(group))
                group = []
    return out


def _facade(ds, gbs, group_size, depth=3, workers=2, seed=0):
    return PrefetchingLoader(DataLoader(ds, global_batch_size=gbs, shuffle=True, seed=seed),
                             PrefetchConfig(depth=depth, collate_workers=workers), group_size=group_size)


@pytest.mark.parametrize("shuffle,drop_last,infinite", [(True, True, False), (False, True, False),
                                                         (True, False, False), (False, False, True)])
def test_loader_stream_and_cursor_match_jax(shuffle, drop_last, infinite):
    kw = dict(global_batch_size=4, shuffle=shuffle, seed=3, drop_last=drop_last, infinite=infinite)
    t = DataLoader(MockSFTDataset(vocab_size=64, seq_length=8, num_samples=22, seed=0), **kw)
    j = JDataLoader(JMock(vocab_size=64, seq_length=8, num_samples=22, seed=0), **kw)
    assert len(t) == len(j) == (5 if drop_last else 6)
    ti, ji = iter(t), iter(j)
    n = 3 * len(t) if infinite else len(t)
    for _ in range(n):
        _same(next(ti), next(ji))
        assert t.state_dict() == j.state_dict()
    if not infinite:
        assert next(ti, None) is None and next(ji, None) is None
        assert t.state_dict() == j.state_dict() == {"epoch": 1, "batch_in_epoch": 0, "seed": 3}
    t.load_state_dict({"epoch": 2, "batch_in_epoch": 1, "seed": 5})
    j.load_state_dict({"epoch": 2, "batch_in_epoch": 1, "seed": 5})
    _same(next(iter(t)), next(iter(j)))


def test_loader_collate_fn_and_kwargs_match_jax():
    """``collate_fn`` (the packed collater over pre-packed rows) and
    ``**collate_kwargs`` reach the collator."""
    rows = list(pack_sequences(({"input_ids": list(range(3, 3 + n))} for n in (5, 9, 20, 4, 30, 11, 7, 16)), 32))
    got = list(DataLoader(rows, global_batch_size=2, collate_fn=packed_collater, shuffle=False))
    want = list(JDataLoader(rows, global_batch_size=2, collate_fn=jax_packed_collater, shuffle=False))
    assert len(got) == len(want) == len(rows) // 2 and got[0]["segment_ids"].shape == (2, 32)
    for a, b in zip(got, want):
        _same(a, b)
    kw = dict(global_batch_size=4, shuffle=True, seed=1, pad_seq_len_divisible=16)
    t = DataLoader(MockSFTDataset(vocab_size=64, seq_length=9, num_samples=16), **kw)
    j = JDataLoader(JMock(vocab_size=64, seq_length=9, num_samples=16), **kw)
    got, want = list(t), list(j)
    assert len(got) == 4 and got[0]["input_ids"].shape == (4, 16)
    for a, b in zip(got, want):
        _same(a, b)


def test_prefetch_stream_parity_and_tail_discard_match_jax():
    """40 samples / gbs 4 / grad_acc 3: 10 batches, 3 full groups an epoch
    (the tail dropped), equal to the sync grouping and to JAX's pipeline
    across an epoch boundary."""
    ds = MockSFTDataset(vocab_size=64, seq_length=8, num_samples=40, seed=0)
    ref = _sync_groups(ds, 4, 3, epochs=2)
    assert len(ref) == 6
    pf = _facade(ds, 4, 3)
    jpf = JPrefetch(JDataLoader(JMock(vocab_size=64, seq_length=8, num_samples=40, seed=0), global_batch_size=4,
                                shuffle=True, seed=0), JConfig(depth=3, collate_workers=2), group_size=3)
    got = [item.host for _ in range(2) for item in pf]
    want = [item.host for _ in range(2) for item in jpf]
    pf.close(), jpf.close()
    assert len(got) == len(want) == len(ref)
    for a, b, c in zip(got, want, ref):
        _same(a, b)
        _same(a, c)


def test_consumption_cursor_not_fetch_cursor():
    ds = MockSFTDataset(vocab_size=64, seq_length=8, num_samples=48, seed=1)
    ref = _sync_groups(ds, 4, 2, seed=1)
    pf = _facade(ds, 4, 2, depth=3, seed=1)
    it = iter(pf)
    consumed = [next(it).host, next(it).host]
    deadline = time.monotonic() + 5
    while pf.queue_depth < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf.queue_depth >= 1
    snap = pf.state_dict()
    assert snap == {"epoch": 0, "batch_in_epoch": 4, "seed": 1}  # 2 groups x 2 batches consumed
    pf.close()
    pf2 = _facade(ds, 4, 2, depth=3, seed=999)  # the seed comes back with the snapshot
    pf2.load_state_dict(snap)
    replayed = [item.host for item in pf2]
    pf2.close()
    seen = consumed + replayed
    assert len(seen) == len(ref)
    for a, b in zip(seen, ref):
        _same(a, b)


def test_seek_flushes_run_ahead_and_replays_exactly():
    ds = MockSFTDataset(vocab_size=64, seq_length=8, num_samples=40, seed=2)
    ref = _sync_groups(ds, 4, 1, seed=2, epochs=2)
    pf = _facade(ds, 4, 1, depth=4, seed=2)
    it = iter(pf)
    for _ in range(6):
        next(it)
    pf.seek(0, 3)
    assert pf.state_dict()["batch_in_epoch"] == 3
    tail = [item.host for item in pf] + [item.host for item in pf]
    pf.close()
    assert len(tail) == len(ref) - 3
    for a, b in zip(tail, ref[3:]):
        _same(a, b)
    with pytest.raises(RuntimeError, match="closed"):
        next(iter(pf))
    pf.seek(1, 0)  # a seek reopens
    assert len([item for item in pf]) == 10


def test_seed_change_invalidates_cached_epoch_order():
    ds = MockSFTDataset(vocab_size=64, seq_length=8, num_samples=24, seed=0)
    warm = DataLoader(ds, global_batch_size=4, shuffle=True, seed=1)
    next(iter(warm))
    warm.load_state_dict({"epoch": 0, "batch_in_epoch": 0, "seed": 2})
    _same(warm.batch_for(0, 0), DataLoader(ds, global_batch_size=4, shuffle=True, seed=2).batch_for(0, 0))


def test_producer_exception_surfaces_at_pop():
    class Boom:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            if i >= 6:
                raise RuntimeError("shard went away")
            return {"input_ids": [1, 2, 3]}

    pf = _facade(Boom(), 2, 1, depth=2, workers=1)
    it = iter(pf)
    with pytest.raises(RuntimeError, match="shard went away"):
        for _ in range(10):
            next(it)
    assert pf._thread is None
    pf.close()


class SlowDataset(MockSFTDataset):
    """A dataset whose every read sleeps (a slow disk or tokenizer), in
    place of JAX's injected collate delay."""

    def __getitem__(self, idx):
        time.sleep(0.01)
        return super().__getitem__(idx)


def test_overlap_hides_a_slow_dataset():
    """4 reads of 10 ms a batch and ~25 ms of consumer work a step: the
    pipeline (4 collate workers) must run >= 1.5x the sync loop (about
    2.6x in theory: 65 ms serial against max(25, 40 / 4) ms)."""
    ds = SlowDataset(vocab_size=64, seq_length=8, num_samples=160, seed=3)
    steps, work_s = 12, 0.025
    it = iter(DataLoader(ds, global_batch_size=4, shuffle=True, seed=3))
    t0 = time.perf_counter()
    for _ in range(steps):
        next(it)
        time.sleep(work_s)
    t_sync = time.perf_counter() - t0
    pf = _facade(ds, 4, 1, depth=4, workers=4, seed=3)
    it = iter(pf)
    next(it)
    time.sleep(0.3)
    t0 = time.perf_counter()
    for _ in range(steps):
        next(it)
        time.sleep(work_s)
    t_pf = time.perf_counter() - t0
    pf.close()
    assert t_sync / t_pf >= 1.5, f"sync {t_sync:.3f}s, prefetched {t_pf:.3f}s for {steps} steps"


def test_prefetch_config_keys_are_strict_as_in_jax():
    assert PrefetchConfig.from_data_section(None) == PrefetchConfig(enabled=False)
    assert PrefetchConfig.from_data_section({"prefetch": None}).enabled is False
    assert PrefetchConfig.from_data_section({"prefetch": {"depth": 3}}) == PrefetchConfig(depth=3)
    for bad, err in (({"dept": 2}, TypeError), ({"depth": 0}, ValueError), ({"collate_workers": 0}, ValueError)):
        with pytest.raises(err) as t_err:
            PrefetchConfig.from_dict(bad)
        with pytest.raises(err) as j_err:
            JConfig.from_dict(bad)
        assert str(t_err.value) == str(j_err.value)


def test_scheduler_yields_prepared_groups_and_stops_at_max_steps():
    ds = MockSFTDataset(vocab_size=64, seq_length=8, num_samples=40, seed=0)
    sched = StepScheduler(grad_acc_steps=3, num_epochs=2, max_steps=5, dataloader=_facade(ds, 4, 3))
    got = list(sched)
    sched.dataloader.close()
    assert len(got) == 5 and all(isinstance(g, PreparedBatch) for g in got) and sched.step == 5
    ref = _sync_groups(ds, 4, 3, epochs=2)
    for a, b in zip(got, ref):
        _same(a.host, b)
    # the scheduler's look-ahead pops one group past max_steps, as the sync path collates one
    assert sched.dataloader.state_dict() == {"epoch": 1, "batch_in_epoch": 9, "seed": 0}


def _rows(path) -> list:
    return [json.loads(s) for s in open(path).read().splitlines() if '"loss"' in s]


def _cli(tmp_path, tag: str, *extra) -> list:
    path = tmp_path / f"{tag}.jsonl"
    assert app.main(["finetune", "llm", "-c", SFT_CFG, "--device=cpu", f"--logging.metrics_path={path}", *extra]) == 0
    return [json.loads(s) for s in path.read_text().splitlines()]


PREFETCH = ("--data.prefetch.depth=3", "--data.prefetch.collate_workers=2")


def test_recipe_prefetch_equals_sync_through_a_resume(tmp_path):
    """The tiny SFT config (grad_acc 2, 2 epochs): prefetch on equals off
    bit for bit over 8 steps; a prefetched run stopped at step 3 with a
    checkpoint and resumed by a fresh recipe equals them too, and both the
    sync and the prefetched checkpoints hold the same cursor."""
    sync = _rows_of(_cli(tmp_path, "sync"))
    pf = _rows_of(_cli(tmp_path, "pf", *PREFETCH))
    assert [r["step"] for r in pf] == list(range(1, 9))
    assert [(r["loss"], r["grad_norm"]) for r in pf] == [(r["loss"], r["grad_norm"]) for r in sync]
    assert all(r["host_input_wait_s"] >= 0 and 0 <= r["prefetch_depth"] <= 3 for r in pf[1:])
    ck = ("--checkpoint.enabled=true", f"--checkpoint.checkpoint_dir={tmp_path / 'ck'}",
          "--step_scheduler.ckpt_every_steps=3")
    _cli(tmp_path, "resumed", *PREFETCH, *ck, "--step_scheduler.max_steps=3")
    rows = _cli(tmp_path, "resumed", *PREFETCH, *ck)
    assert [r.get("resumed_from_step") for r in rows if r.get("event") == "resume"] == [3]
    by_step = {r["step"]: r for r in rows if "loss" in r}
    assert [(by_step[s]["loss"], by_step[s]["grad_norm"]) for s in range(1, 9)] == [
        (r["loss"], r["grad_norm"]) for r in sync]
    extra = json.loads(next((tmp_path / "ck").glob("epoch_*_step_3")).joinpath("extra_state.json").read_text())
    assert extra["dataloader"] == {"epoch": 0, "batch_in_epoch": 6, "seed": 0}


def _rows_of(records: list) -> list:
    return [r for r in records if "loss" in r]


def test_recipe_rollback_across_a_prefetched_window(tmp_path):
    """``on_nonfinite: rollback`` with the pipeline running ahead: the
    rollback's seek flushes it, and the sync and prefetched runs of the
    same planted divergence log the same losses and end at the same
    cursor (tests/test_torch_rollback.py holds the rollback's cursor
    arithmetic to JAX's ``_rollback``)."""
    import torch

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    def run(tag, prefetch):
        cfg = load_yaml_config(SFT_CFG).to_dict()
        cfg.update(device="cpu", fault_tolerance={"on_nonfinite": "rollback"},
                   checkpoint={"enabled": True, "checkpoint_dir": str(tmp_path / f"ck_{tag}")})
        cfg["step_scheduler"].update(ckpt_every_steps=2, num_epochs=3)
        cfg["logging"]["metrics_path"] = str(tmp_path / f"{tag}.jsonl")
        if prefetch:
            cfg["data"] = {"prefetch": {"depth": 3, "collate_workers": 2}}
        from automodel_tpu_torch.config import ConfigNode

        r = TrainFinetuneRecipeForNextTokenPrediction(ConfigNode(cfg))
        r.setup()
        step, fired = r.train_step, []

        def flaky(state, batch):
            m = step(state, batch)
            if m["step"] == 3 and not fired:
                fired.append(1)
                m = dict(m, nonfinite=torch.tensor(True))
            return m

        r.train_step = flaky
        last = r.run_train_validation_loop()
        assert last["step"] == 8 and last["rollbacks_total"] == 1
        return r, [(x["step"], x["loss"]) for x in _rows(tmp_path / f"{tag}.jsonl")]

    r_sync, sync = run("sync", False)
    r_pf, pf = run("pf", True)
    assert pf == sync
    # 8 batches an epoch, 4 steps an epoch: restore at step 2 (batch 4), skip
    # step 3's group (batch 6), train steps 3-8 (12 batches, into epoch 2 at
    # batch 2) and the scheduler's look-ahead group (batch 4)
    assert r_sync.dataloader.state_dict() == r_pf.dataloader.state_dict() == {
        "epoch": 2, "batch_in_epoch": 4, "seed": 0}

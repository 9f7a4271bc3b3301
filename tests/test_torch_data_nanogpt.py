"""The port's nanoGPT datasets (automodel_tpu_torch/data/nanogpt.py) against
the JAX package on the CPU, following tests/test_megatron_data.py:96-224:
windows and strides, the blend's schedule fixed in advance from the seed,
windows reshuffled on each pass over a short source, an empty source
refused at init, ``source_counts``, and JAX's resume mid-stream across a
shard boundary (:165) through the port's prefetch pipeline and rollback
fast-forward, against JAX's stream. Shards are written with numpy;
every output is held exactly."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from automodel_tpu.data import nanogpt as jn
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.data import nanogpt as tn
from automodel_tpu_torch.data import synthetic
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "automodel_tpu_torch", "configs", "pretrain_tiny_cpu_nanogpt.yaml")


def _sources(tmp_path):
    """tests/test_megatron_data.py's two sources: the first split over two
    .bin shards, disjoint token ranges so every window names its origin."""
    a, b = tmp_path / "src_a", tmp_path / "src_b"
    a.mkdir(), b.mkdir()
    (a / "s0.bin").write_bytes(np.arange(0, 200, dtype=np.uint16).tobytes())
    (a / "s1.bin").write_bytes(np.arange(200, 400, dtype=np.uint16).tobytes())
    (b / "s0.bin").write_bytes(np.arange(5000, 5600, dtype=np.uint16).tobytes())
    return a, b


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("stride", [None, 24])
def test_nanogpt_windows_match_jax(tmp_path, stride):
    (tmp_path / "shard0.bin").write_bytes(np.arange(1000, dtype=np.uint16).tobytes())
    (tmp_path / "shard1.bin").write_bytes(np.arange(1000, 1500, dtype=np.uint16).tobytes())
    t = tn.NanogptDataset(tmp_path, seq_length=64, stride=stride)
    j = jn.NanogptDataset(tmp_path, seq_length=64, stride=stride)
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        _same(t[i], j[i])
    np.testing.assert_array_equal(t[1]["input_ids"][1:], t[1]["labels"][:-1])
    assert t[1]["input_ids"][0] == (stride or 64)


def test_uint32_shards_hold_ids_past_uint16(tmp_path):
    synthetic.write_nanogpt_shards(tmp_path, 2, 5000, 128256, seed=1)
    t = tn.NanogptDataset(tmp_path, seq_length=128, dtype="uint32")
    j = jn.NanogptDataset(tmp_path, seq_length=128, dtype=np.uint32)
    assert len(t) == len(j) == 2 * ((5000 - 129) // 128 + 1)
    assert max(int(t[i]["input_ids"].max()) for i in range(len(t))) > 65535
    for i in (0, len(t) // 2, len(t) - 1):
        _same(t[i], j[i])


def test_blended_nanogpt_matches_jax(tmp_path):
    a, b = _sources(tmp_path)
    sources = [{"paths": str(a), "weight": 1.0}, {"paths": str(b), "weight": 3.0}]
    for seed, n, shuffle in ((5, 80, True), (1, None, True), (2, 50, False)):
        t = tn.BlendedNanogptDataset(sources, seq_length=16, seed=seed, num_samples=n, shuffle_windows=shuffle)
        j = jn.BlendedNanogptDataset(sources, seq_length=16, seed=seed, num_samples=n, shuffle_windows=shuffle)
        assert len(t) == len(j) and t.source_counts() == j.source_counts()
        np.testing.assert_array_equal(t._assignment, j._assignment)
        for i in range(len(t)):
            _same(t[i], j[i])
    counts = tn.BlendedNanogptDataset(sources, seq_length=16, seed=5, num_samples=80).source_counts()
    assert sum(counts) == 80 and counts[1] > counts[0]


def test_blend_refuses_an_empty_source_at_init_and_reshuffles_each_pass(tmp_path):
    a, _ = _sources(tmp_path)
    (tmp_path / "tiny").mkdir()
    (tmp_path / "tiny" / "s.bin").write_bytes(np.arange(4, dtype=np.uint16).tobytes())
    bad = [{"paths": str(a)}, {"paths": str(tmp_path / "tiny")}]
    with pytest.raises(ValueError, match="zero windows") as t_err:
        tn.BlendedNanogptDataset(bad, seq_length=16, seed=5, num_samples=10)
    with pytest.raises(ValueError, match="zero windows") as j_err:
        jn.BlendedNanogptDataset(bad, seq_length=16, seed=5, num_samples=10)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="weights must be > 0"):
        tn.BlendedNanogptDataset([{"paths": str(a), "weight": 0}], seq_length=16)
    long = tn.BlendedNanogptDataset([{"paths": str(a)}], seq_length=16, seed=5, num_samples=60)
    n = len(long.datasets[0])
    pass0 = [int(long[i]["input_ids"][0]) for i in range(n)]
    pass1 = [int(long[i]["input_ids"][0]) for i in range(n, 2 * n)]
    assert sorted(pass0) == sorted(pass1) and pass0 != pass1


def test_blended_nanogpt_resume_mid_stream_across_shard_boundary(tmp_path):
    """JAX's test (:165) on the port: consume 3 groups through the prefetch
    pipeline, roll back to the checkpointed cursor and fast-forward past
    the failed window (steps 4-7, across src_a's shard boundary and the
    source boundary) with the recipe's own ``_rollback``; the continuation
    equals the uninterrupted stream's suffix, and that stream equals the
    JAX pipeline's batch for batch."""
    from automodel_tpu.data.loader import DataLoader as JDataLoader
    from automodel_tpu.data.prefetch import PrefetchConfig as JConfig
    from automodel_tpu.data.prefetch import PrefetchingLoader as JPrefetch
    from automodel_tpu_torch.data.loader import DataLoader
    from automodel_tpu_torch.data.prefetch import PrefetchConfig, PrefetchingLoader
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction as R

    a, b = _sources(tmp_path)
    sources = [{"paths": str(a), "weight": 1.0}, {"paths": str(b), "weight": 1.0}]

    def make(ds_mod, dl_cls, pf_cls, cfg_cls):
        ds = ds_mod.BlendedNanogptDataset(sources, seq_length=16, seed=9, num_samples=40)
        return pf_cls(dl_cls(ds, global_batch_size=4, shuffle=True, seed=9), cfg_cls(depth=3, collate_workers=2),
                      group_size=1)

    streams = {}
    for name, args in (("port", (tn, DataLoader, PrefetchingLoader, PrefetchConfig)),
                       ("jax", (jn, JDataLoader, JPrefetch, JConfig))):
        loader = make(*args)
        streams[name] = [item.host for _ in range(2) for item in loader]
        loader.close()
    ref = streams["port"]
    assert len(ref) == len(streams["jax"]) == 20
    for got, want in zip(ref, streams["jax"]):
        _same(got, want)
    firsts = {int(h["input_ids"][0, i, 0]) for h in ref for i in range(4)}
    assert any(200 <= t < 400 for t in firsts), "no window from src_a's second shard"
    assert any(t < 200 for t in firsts) and any(t >= 5000 for t in firsts)

    live = make(tn, DataLoader, PrefetchingLoader, PrefetchConfig)
    it = iter(live)
    for _ in range(3):
        next(it)
    r = object.__new__(R)
    r.dataloader = live
    r.step_scheduler = SimpleNamespace(step=3, epoch=0, grad_acc_steps=1)
    r.checkpointer = SimpleNamespace(has_checkpoint=lambda: True, wait=lambda: None)
    r.metric_logger = SimpleNamespace(log=lambda rec, step=None: None)
    r.rollbacks = 1
    r._restore = lambda before_step: None
    r._rollback(fail_step=7)
    assert (live.epoch, live.batch_in_epoch) == (0, 7)
    cont = [item.host for item in live] + [item.host for item in live]
    live.close()
    assert len(cont) == len(ref) - 7
    for got, want in zip(cont, ref[7:]):
        _same(got, want)


def test_tiny_nanogpt_cli_trains_on_a_blend(tmp_path):
    """``pretrain llm`` on the tiny nanoGPT config: three sources of two
    shards each, weights 1, 2, 1, prefetch on; 8 finite steps."""
    for s in "abc":
        synthetic.write_nanogpt_shards(tmp_path / s, 2, 16384, 256, seed=ord(s))
    sources = ",".join(f"{{paths: {tmp_path / s}, weight: {w}}}" for s, w in zip("abc", (1.0, 2.0, 1.0)))
    path = tmp_path / "m.jsonl"
    rc = app.main(["pretrain", "llm", "-c", TINY_CFG, "--device=cpu", f"--dataset.sources=[{sources}]",
                   f"--logging.metrics_path={path}"])
    assert rc == 0
    rows = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert all(np.isfinite(r["loss"]) and r["num_label_tokens"] == 2 * 4 * 63 for r in rows)
    assert all(r["prefetch_depth"] >= 0 for r in rows[1:])

"""The port's Megatron data path (automodel_tpu_torch/data/megatron/,
data/synthetic.py) against the JAX package on the CPU, following
tests/test_megatron_data.py: ``.bin``/``.idx`` corpora written by either
package read by the other, byte for byte; the native index builders (the
port's own ``helpers.cpp``, built into ``_build/``) and their numpy
versions against JAX's; GPT samples, blends and samplers; the double label
shift both packages share; and ``pretrain llm`` on a tiny corpus against
JAX's recipe, prefetch on and off. Corpora are written with numpy from a
seed. Integer and byte outputs are held exactly; losses and grad norms to
rtol 1e-4 (fp32; the tolerance of the port's other recipe trajectories:
4 Adam steps apart by summation order)."""

import importlib.util
import json
import os

import numpy as np
import pytest

from automodel_tpu.data import collators as jcoll
from automodel_tpu.data.megatron import gpt_dataset as jgpt
from automodel_tpu.data.megatron import helpers as jh
from automodel_tpu.data.megatron import indexed_dataset as jidx
from automodel_tpu.data.megatron import sampler as jsamp
from automodel_tpu_torch.cli import app
from automodel_tpu_torch.data import collators as tcoll
from automodel_tpu_torch.data import synthetic
from automodel_tpu_torch.data.megatron import gpt_dataset as tgpt
from automodel_tpu_torch.data.megatron import helpers as th
from automodel_tpu_torch.data.megatron import indexed_dataset as tidx
from automodel_tpu_torch.data.megatron import sampler as tsamp
import torch_port_parity  # noqa: F401  (caps torch at one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "automodel_tpu_torch", "configs")
TINY_CFG = os.path.join(CONFIGS, "pretrain_tiny_cpu_megatron.yaml")


def _docs(seed: int, n: int, vocab: int, lo: int = 5, hi: int = 120) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))) for _ in range(n)]


def _write(mod, prefix, docs, dtype):
    with mod.IndexedDatasetWriter(prefix, dtype=dtype) as w:
        for d in docs:
            w.add_document(d)


@pytest.fixture()
def corpus(tmp_path):
    """tests/test_megatron_data.py's corpus, written by the JAX package."""
    _write(jidx, tmp_path / "corpus", _docs(0, 50, 1000), np.uint16)
    return tmp_path / "corpus"


@pytest.mark.parametrize("dtype,vocab", [(np.uint16, 1000), (np.uint32, 128256)])
def test_indexed_corpora_cross_between_the_packages_byte_for_byte(tmp_path, dtype, vocab):
    docs = _docs(1, 40, vocab)
    _write(jidx, tmp_path / "jax", docs, dtype)
    _write(tidx, tmp_path / "port", docs, dtype)
    for suffix in (".bin", ".idx"):
        assert (tmp_path / f"jax{suffix}").read_bytes() == (tmp_path / f"port{suffix}").read_bytes()
    for reader, prefix in ((tidx.IndexedDataset, "jax"), (jidx.IndexedDataset, "port")):
        ds = reader(tmp_path / prefix)
        assert len(ds) == len(docs) and ds.dtype == np.dtype(dtype) and ds.num_tokens == sum(map(len, docs))
        for i, d in enumerate(docs):
            np.testing.assert_array_equal(ds[i], d)
        np.testing.assert_array_equal(ds.get_slice(3, 2, 3), docs[3][2:5])


def test_writer_default_uint16_wraps_ids_like_jax(tmp_path):
    """The JAX package's default dtype is uint16, which wraps an id past
    65,535 without an error; the port copies it (a Llama-3 corpus says
    uint32, as data/synthetic.py does)."""
    doc = np.asarray([5, 65535, 65536, 128255])
    _write(jidx, tmp_path / "jax", [doc], np.uint16)
    with tidx.IndexedDatasetWriter(tmp_path / "port") as w:
        w.add_document(doc)
    got = tidx.IndexedDataset(tmp_path / "port")[0]
    np.testing.assert_array_equal(got, jidx.IndexedDataset(tmp_path / "jax")[0])
    np.testing.assert_array_equal(got, [5, 65535, 0, 62719])
    assert synthetic.token_dtype(128256) == np.uint32 and synthetic.token_dtype(1000) == np.uint16


def test_synthetic_megatron_corpus_lengths_and_dtype(tmp_path):
    out = synthetic.write_megatron_corpus(tmp_path / "c", 100_000, 128256, seed=3, median=300)
    ds = tidx.IndexedDataset(tmp_path / "c")
    assert out["dtype"] == "uint32" and ds.dtype == np.uint32 and ds.num_tokens == 100_000
    assert out["documents"] == len(ds) and int(ds.sizes[:-1].min()) >= 16 and int(ds.sizes.max()) <= 16384
    assert 150 < float(np.median(ds.sizes)) < 600 and int(ds._data.max()) < 128256
    again = synthetic.write_megatron_corpus(tmp_path / "d", 100_000, 128256, seed=3, median=300)
    assert again["documents"] == out["documents"]
    assert (tmp_path / "c.bin").read_bytes() == (tmp_path / "d.bin").read_bytes()


def test_native_helpers_build_into_the_build_dir_and_match_numpy_and_jax():
    assert th.native_available(), "g++ failed to build the port's helpers"
    lib = th.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "automodel_tpu_torch" and lib.exists()
    assert not list((th._SRC.parent).glob("*.so")), "a library was built beside the source"
    assert th._SRC.read_bytes().split(b"#include", 1)[1] == open(
        os.path.join(REPO, "automodel_tpu", "data", "megatron", "helpers.cpp"), "rb").read().split(b"#include", 1)[1]
    rng = np.random.default_rng(1)
    sizes = rng.integers(3, 50, size=40).astype(np.int32)
    doc_idx = np.tile(np.arange(40, dtype=np.int64), 4)
    rng.shuffle(doc_idx)
    before = th.native_calls.get("build_sample_idx", 0)
    native = th.build_sample_idx(sizes, doc_idx, 64, 20)
    assert th.native_calls["build_sample_idx"] == before + 1
    np.testing.assert_array_equal(native, th._build_sample_idx_py(sizes, doc_idx, 64, 20))
    np.testing.assert_array_equal(native, jh.build_sample_idx(sizes, doc_idx, 64, 20))
    np.testing.assert_array_equal(native, jh._build_sample_idx_py(sizes, doc_idx, 64, 20))


def test_sample_idx_exhaustion_raises():
    with pytest.raises(ValueError, match="exhaust"):
        th.build_sample_idx(np.asarray([10], np.int32), np.zeros(1, np.int64), 64, 5)
    with pytest.raises(ValueError, match="exhaust"):
        th._build_sample_idx_py(np.asarray([10], np.int32), np.zeros(1, np.int64), 64, 5)


@pytest.mark.parametrize("weights,size", [([0.7, 0.2, 0.1], 1000), ([1.0, 3.0], 77), ([0.25] * 4, 64)])
def test_blending_indices_match_jax(weights, size):
    native = th.build_blending_indices(np.asarray(weights), size)
    w = np.asarray(weights, np.float64) / np.sum(weights)
    for other in (th._build_blending_indices_py(w, size), jh.build_blending_indices(np.asarray(weights), size)):
        for a, b in zip(native, other):
            np.testing.assert_array_equal(a, b)
    counts = np.bincount(native[0], minlength=len(weights))
    np.testing.assert_allclose(counts / size, w, atol=0.02)
    for d in range(len(weights)):
        np.testing.assert_array_equal(native[1][native[0] == d], np.arange(counts[d]))


@pytest.mark.parametrize("sizes", [[5, 2, 9], [1, 1], [30, 7, 0, 4]])
def test_exhaustive_blending_indices_match_jax(sizes):
    sizes = np.asarray(sizes, np.int64)
    native = th.build_exhaustive_blending_indices(sizes)
    for other in (th._build_exhaustive_blending_indices_py(sizes), jh.build_exhaustive_blending_indices(sizes)):
        for a, b in zip(native, other):
            np.testing.assert_array_equal(a, b)
    for d, n in enumerate(sizes):
        np.testing.assert_array_equal(np.sort(native[1][native[0] == d]), np.arange(n))


def _sentences(seed: int, n_docs: int, lo: int, hi: int, long_at=None):
    rng = np.random.default_rng(seed)
    docs = np.concatenate([[0], np.cumsum(rng.integers(lo, hi, n_docs))]).astype(np.int64)
    sizes = rng.integers(5, 60, int(docs[-1])).astype(np.int32)
    if long_at is not None:
        sizes[long_at] = 600
    return docs, sizes


def _rows(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("short_seq_prob", [0.0, 0.2])
def test_build_mapping_matches_jax(short_seq_prob):
    """The native builder equals JAX's native one row for row, the numpy
    version JAX's numpy version; without short samples (no random target)
    the native and numpy rows are the same set (their shuffles differ, as
    in the JAX package)."""
    docs, sizes = _sentences(0, 12, 1, 9, long_at=3)
    kw = dict(num_epochs=2, max_num_samples=10_000, max_seq_length=64, short_seq_prob=short_seq_prob, seed=7,
              min_num_sent=2)
    native = th.build_mapping(docs, sizes, **kw)
    np.testing.assert_array_equal(native, jh.build_mapping(docs, sizes, **kw))
    py = th._build_mapping_py(docs, sizes, *kw.values())
    np.testing.assert_array_equal(py, jh._build_mapping_py(docs, sizes, *kw.values()))
    assert native.shape[1] == 3 and (native[:, 0] < native[:, 1]).all()
    assert (native[:, 2] >= 2).all() and (native[:, 2] <= 64).all()
    if short_seq_prob == 0.0:
        np.testing.assert_array_equal(_rows(native), _rows(py))


def test_build_blocks_mapping_matches_jax():
    docs, sizes = _sentences(1, 8, 2, 7)
    titles = np.random.default_rng(2).integers(2, 10, 8).astype(np.int32)
    kw = dict(num_epochs=1, max_num_samples=10_000, max_seq_length=48, seed=3, use_one_sent_blocks=False)
    native = th.build_blocks_mapping(docs, sizes, titles, **kw)
    np.testing.assert_array_equal(native, jh.build_blocks_mapping(docs, sizes, titles, **kw))
    py = th._build_blocks_mapping_py(docs, sizes, titles, *kw.values())
    np.testing.assert_array_equal(_rows(native), _rows(py))
    for s0, s1, d, _ in native:
        assert docs[d] <= s0 < s1 <= docs[d + 1]
    assert len(set(native[:, 3].tolist())) == len(native)


def test_gpt_datasets_and_blend_match_jax(corpus, tmp_path):
    for seed, shuffle in ((0, True), (5, False)):
        t = tgpt.GPTDataset(str(corpus), seq_length=32, num_samples=40, seed=seed, shuffle=shuffle)
        j = jgpt.GPTDataset(str(corpus), seq_length=32, num_samples=40, seed=seed, shuffle=shuffle)
        np.testing.assert_array_equal(t.doc_idx, j.doc_idx)
        np.testing.assert_array_equal(t.sample_idx, j.sample_idx)
        np.testing.assert_array_equal(t.shuffle_idx, j.shuffle_idx)
        for i in range(len(t)):
            got, want = _sample_or_fault(t, i), _sample_or_fault(j, i)
            if want is None:  # a window that ends on a document's end (below)
                assert got is None, i
                continue
            for k in ("input_ids", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
    _write(jidx, tmp_path / "c2", _docs(2, 20, 1000, 60, 61), np.uint16)
    kw = dict(seq_length=16, num_samples=30, weights=[0.3, 0.7])
    t = tgpt.MegatronPretraining([str(corpus), str(tmp_path / "c2")], **kw)
    j = jgpt.MegatronPretraining([str(corpus), str(tmp_path / "c2")], **kw)
    assert len(t) == len(j) == 30 and isinstance(t._ds, tgpt.BlendedDataset)
    for i in range(30):
        np.testing.assert_array_equal(t[i]["input_ids"], j[i]["input_ids"])


def _sample_or_fault(ds, i: int):
    try:
        return ds[i]
    except AssertionError:
        return None


def test_gpt_sample_ending_on_a_document_end_fails_in_both_packages(corpus):
    """Where a sample's last token is a document's last token,
    ``build_sample_idx`` starts the next sample at the next document
    without the shared token, and ``GPTDataset.__getitem__`` then reads one
    token too many and fails its length assertion. The JAX package does
    this, and the port copies it: the same samples fail in both."""
    t = tgpt.GPTDataset(str(corpus), seq_length=32, num_samples=40, seed=0)
    j = jgpt.GPTDataset(str(corpus), seq_length=32, num_samples=40, seed=0)
    t_bad = [i for i in range(40) if _sample_or_fault(t, i) is None]
    j_bad = [i for i in range(40) if _sample_or_fault(j, i) is None]
    assert t_bad == j_bad and t_bad
    for i in t_bad:
        d1, o1 = t.sample_idx[int(t.shuffle_idx[i]) + 1]
        assert o1 == 0 and d1 > t.sample_idx[int(t.shuffle_idx[i])][0]


def test_pretraining_labels_copy_jax_which_shifts_twice(corpus):
    """``GPTDataset`` returns labels already shifted and the collator
    shifts them again, so position t trains on token t + 2: the JAX
    package does this, and the port copies it."""
    t = tgpt.MegatronPretraining(str(corpus), seq_length=32, num_samples=8)
    j = jgpt.MegatronPretraining(str(corpus), seq_length=32, num_samples=8)
    tb = tcoll.default_collater([t[i] for i in range(4)])
    jb = jcoll.default_collater([j[i] for i in range(4)])
    for k in ("input_ids", "labels", "position_ids"):
        np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(tb["labels"][:, :-2], tb["input_ids"][:, 2:])
    np.testing.assert_array_equal(tb["labels"][:, -2], [t[i]["labels"][-1] for i in range(4)])
    assert (tb["labels"][:, -1] == -100).all()


@pytest.mark.parametrize("drop_last", [True, False])
def test_sequential_sampler_matches_jax_and_resumes(drop_last):
    t = tsamp.MegatronPretrainingSampler(23, 4, drop_last=drop_last)
    j = jsamp.MegatronPretrainingSampler(23, 4, drop_last=drop_last)
    assert len(t) == len(j)
    assert list(t) == list(j) and t.state_dict() == j.state_dict()
    t2 = tsamp.MegatronPretrainingSampler(23, 4, consumed_samples=8, drop_last=drop_last)
    assert next(iter(t2)) == [8, 9, 10, 11]
    t2.load_state_dict({"consumed_samples": 12})
    assert next(iter(t2)) == [12, 13, 14, 15]


def test_random_sampler_matches_jax_across_epochs_and_resume():
    t = tsamp.MegatronPretrainingRandomSampler(30, 4, seed=3)
    j = jsamp.MegatronPretrainingRandomSampler(30, 4, seed=3)
    for _ in range(3):
        assert list(t) == list(j) and t.state_dict() == j.state_dict()
    assert t.epoch == 3
    resumed = tsamp.MegatronPretrainingRandomSampler(30, 4, seed=0)
    full = jsamp.MegatronPretrainingRandomSampler(30, 4, seed=3)
    it = iter(full)
    [next(it) for _ in range(2)]
    resumed.load_state_dict(full.state_dict())
    assert list(resumed) == list(it)


def _loss_rows(path) -> list:
    return [json.loads(s) for s in open(path).read().splitlines() if '"loss"' in s]


def test_tiny_megatron_config_matches_jax_recipe(tmp_path):
    """``pretrain_tiny_cpu_megatron.yaml`` as it is (flash, remat full,
    fused_linear_ce, grad_acc 2, prefetch on) through JAX's recipe on the
    suite's 8 CPU devices and the port's on the CPU, the port holding JAX's
    weights, on one corpus: the same 4-step loss and grad norm (rtol 1e-4,
    fp32). The global batch is 8 on both, as JAX's 8-way data axis needs
    (JAX's flash falls back to its sdpa off a TPU; the port's runs the
    kernels' plain versions)."""
    import jax

    from automodel_tpu.config.loader import load_yaml_config as jax_load
    from automodel_tpu.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe
    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.models.llama import params_from_jax
    from automodel_tpu_torch.recipes.train_ft import TrainFinetuneRecipeForNextTokenPrediction

    synthetic.write_megatron_corpus(tmp_path / "corpus", 65536, 256, seed=0)
    recipes = {}
    for name, load, cls in (("jax", jax_load, JaxRecipe), ("port", load_yaml_config,
                                                           TrainFinetuneRecipeForNextTokenPrediction)):
        cfg = load(TINY_CFG)
        for key, value in (("dataset.paths", str(tmp_path / "corpus")), ("dataloader.global_batch_size", 8),
                           ("step_scheduler.max_steps", 4), ("logging.metrics_path", str(tmp_path / f"{name}.jsonl"))):
            cfg.set_by_path(key, value)
        if name == "port":
            cfg.set_by_path("device", "cpu")
        recipes[name] = cls(cfg)
        recipes[name].setup()
    recipes["port"].model.load_state_dict(params_from_jax(jax.device_get(recipes["jax"].state.params)))
    for r in recipes.values():
        r.run_train_validation_loop()
    jrows, trows = _loss_rows(tmp_path / "jax.jsonl"), _loss_rows(tmp_path / "port.jsonl")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [1, 2, 3, 4]
    for j, t in zip(jrows, trows):
        assert t["num_label_tokens"] == j["num_label_tokens"] == 2 * 8 * 63
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4, err_msg=f"step {t['step']}")
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4, err_msg=f"step {t['step']}")
    assert all(t["prefetch_depth"] >= 0 and t["host_input_wait_s"] >= 0 for t in trows[1:])
    # 4 steps of 2 microbatches and the scheduler's look-ahead group, in both
    assert recipes["port"].dataloader.state_dict() == recipes["jax"].dataloader.state_dict() == {
        "epoch": 0, "batch_in_epoch": 10, "seed": 0}


def test_tiny_megatron_cli_prefetch_equals_sync_bit_for_bit(tmp_path):
    """``pretrain llm`` on the tiny CPU config (its own 8 steps, grad_acc
    2, remat full, flash's plain versions), prefetch on as the config says
    and off: the same losses and grad norms bit for bit."""
    synthetic.write_megatron_corpus(tmp_path / "corpus", 65536, 256, seed=0)
    rows = {}
    for tag, extra in (("on", []), ("off", ["--data.prefetch.enabled=false"])):
        path = tmp_path / f"{tag}.jsonl"
        rc = app.main(["pretrain", "llm", "-c", TINY_CFG, "--device=cpu", f"--dataset.paths={tmp_path / 'corpus'}",
                       f"--logging.metrics_path={path}", *extra])
        assert rc == 0
        rows[tag] = _loss_rows(path)
    assert [r["step"] for r in rows["on"]] == list(range(1, 9))
    assert [(r["loss"], r["grad_norm"]) for r in rows["on"]] == [(r["loss"], r["grad_norm"]) for r in rows["off"]]
    assert all("prefetch_depth" in r for r in rows["on"][1:]) and not any("prefetch_depth" in r for r in rows["off"])
    assert all(r["num_label_tokens"] == 2 * 4 * 63 for r in rows["on"])


def test_chip_smoke_pretrains_the_committed_megatron_config():
    """chip_smoke.py carries pretrain_llama3_8b_megatron.yaml as a dict (the
    card has no YAML reader); the two must not drift apart, and the config
    is the full-depth SFT one with the Megatron dataset and prefetch."""
    from automodel_tpu_torch.config.loader import load_yaml_config

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = load_yaml_config(os.path.join(CONFIGS, "pretrain_llama3_8b_megatron.yaml")).to_dict()
    assert chip_smoke.PRETRAIN_LLAMA3_8B_MEGATRON == cfg
    full = load_yaml_config(os.path.join(CONFIGS, "sft_llama3_8b_full.yaml")).to_dict()
    assert cfg["model"] == full["model"] and cfg["optimizer"] == full["optimizer"]
    assert cfg["dataset"]["_target_"].endswith("MegatronPretraining") and cfg["dataset"]["seq_length"] == 4096
    assert cfg["data"] == {"prefetch": {"depth": 2, "collate_workers": 2}}
    tiny = load_yaml_config(TINY_CFG).to_dict()
    assert set(tiny) == set(cfg) and tiny["dataset"]["_target_"] == cfg["dataset"]["_target_"]

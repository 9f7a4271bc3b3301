"""The single-wave ``GenerationEngine``, the ``generation:`` config section,
the model constructors and the ``generate`` CLI.

Port of ``automodel_tpu/generation/engine.py``: ``GenerationConfig``
(:44), ``_ring_window`` (:91), ``GenerationEngine`` (:103-283),
``resolve_tokenizer`` (:293), ``build_auto_from_model_section`` (:315),
``build_auto_from_cfg`` (:342) and ``main`` (:361).

Each prompt owns a slot (a batch row) with its own length, position offset
and stop state; slots are right-padded to a common prompt length (a
multiple of ``pad_to_multiple``), prefilled together, then decoded one
token per slot a step over the contiguous KV cache
(generation/kv_cache.py, generation/loop.py). Attention in decode is the
plain ``sdpa_decode`` over the cache, as in JAX; prefill attends through
the model's configured backend.

There is no tokenizer in the port: prompts and completions are token ids
(``resolve_tokenizer`` returns None when no tokenizer is configured, and
refuses one that is). Only a model whose ``supports_kv_cache`` is true
decodes; any other raises ``GenerationUnsupported``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np
import torch

from automodel_tpu_torch.generation import kv_cache
from automodel_tpu_torch.generation.loop import build_decode_fn, build_prefill_fn
from automodel_tpu_torch.generation.sampling import SamplingConfig, sample, step_generator

logger = logging.getLogger(__name__)


class GenerationUnsupported(ValueError):
    """The model family has no KV-cache decode path (the benchmark's
    decode leg and the recipe's eval sampling record the reason instead of
    running)."""


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """The `generation:` YAML section."""

    max_new_tokens: int = 64
    max_length: Optional[int] = None  # hard context cap (prompt + new)
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False
    eos_token_id: Any = None  # int | [int] | None
    pad_token_id: int = 0
    seed: int = 0
    # pad prompts up to a multiple, so prompts of nearby lengths share one
    # prefill shape
    pad_to_multiple: int = 16

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "GenerationConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        if d.get("tokenizer") is not None:
            raise ValueError(
                "generation.tokenizer is not ported to the torch backend: "
                "prompts are token ids"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def eos_ids(self) -> tuple:
        e = self.eos_token_id
        if e is None:
            return ()
        return tuple(int(x) for x in e) if isinstance(e, (list, tuple)) else (int(e),)

    @property
    def sampling(self) -> SamplingConfig:
        return SamplingConfig(
            temperature=0.0 if self.greedy else self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
        )


def model_max_positions(mcfg: Any) -> Optional[int]:
    v = getattr(mcfg, "max_position_embeddings", None)
    return int(v) if v else None


def _ring_window(mcfg: Any) -> Optional[int]:
    """The ring layout is sound only when EVERY layer has the same window
    (mistral-style). Mixed stacks (qwen2's ``max_window_layers``, per-layer
    ``layer_types``) keep the full layout; their masks come from the tags."""
    window = getattr(mcfg, "sliding_window", None)
    if window is None:
        return None
    if getattr(mcfg, "max_window_layers", 0) or getattr(mcfg, "layer_types", ()):
        return None
    return int(window)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GenerationEngine:
    """Facade over (AutoModel, GenerationConfig).

    ``generate_ids`` takes and returns token ids. It decodes with the
    model's live weights: the training recipe's eval sampling and the
    benchmark's decode leg share the trained module."""

    def __init__(self, auto: Any, config: Optional[GenerationConfig] = None):
        model = auto.model
        if not getattr(model, "supports_kv_cache", False):
            raise GenerationUnsupported(
                f"{type(model).__name__} has no KV-cache decode path; cache-capable "
                "families in the torch backend: llama-generic (llama/qwen2/qwen3/mistral/phi3), qwen3_moe"
            )
        self.auto = auto
        self.model = model
        self.device = auto.device
        self.config = config or GenerationConfig()
        mcfg = model.config
        self._num_layers = int(mcfg.num_layers)
        self._num_kv_heads = int(mcfg.num_kv_heads)
        self._head_dim = int(mcfg.head_dim)
        self._window = _ring_window(mcfg)
        self._max_positions = model_max_positions(mcfg)
        self._cache_dtype = model.compute_dtype
        self._prefill = build_prefill_fn(model)
        self._decode = build_decode_fn(
            model, self.config.sampling, self.config.max_new_tokens,
            eos_ids=self.config.eos_ids, pad_id=self.config.pad_token_id,
        )

    def _make_cache(self, batch: int, prompt_len: int, lengths: np.ndarray) -> kv_cache.KVCache:
        total = prompt_len + self.config.max_new_tokens
        hard_cap = self.config.max_length or self._max_positions
        if hard_cap and total > hard_cap and self._window is None:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({self.config.max_new_tokens}) = "
                f"{total} exceeds the context limit {hard_cap}"
            )
        capacity = total if self._window is None else min(total, self._window)
        if self._window is not None and prompt_len > capacity and int(lengths.min()) < prompt_len:
            # ring prefill writes only the padded tail [S-C, S): a short
            # slot's pad positions would evict real in-window history
            raise ValueError(
                f"ragged prompt batch (lengths {int(lengths.min())}...{int(lengths.max())}, "
                f"padded {prompt_len}) wraps the ring cache (window {capacity}): short slots "
                "would lose in-window history. Use equal-length prompts or prompts that fit the window"
            )
        cache = kv_cache.init_cache(
            self._num_layers, batch, capacity, self._num_kv_heads, self._head_dim,
            dtype=self._cache_dtype, window=self._window, device=self.device,
        )
        return kv_cache.place_cache(cache, getattr(self.auto, "mesh_ctx", None))

    def generate_ids(self, prompts: Sequence[Sequence[int]]) -> dict:
        """Per-slot token-id prompts → per-slot completions (``tokens``)
        and timings. ``ttft_s`` runs from the prefill's start to the first
        token on the host (it ends in a synchronise); ``decode_tps``
        counts the tokens the decode loop made (the first came from
        prefill)."""
        if not prompts:
            raise ValueError("generate_ids needs at least one prompt")
        if any(len(p) == 0 for p in prompts):
            raise ValueError("empty prompt (every slot needs >= 1 token)")
        B = len(prompts)
        lengths = np.array([len(p) for p in prompts], np.int32)
        m = max(int(self.config.pad_to_multiple), 1)
        S = int(-(-int(lengths.max()) // m) * m)
        ids = np.full((B, S), self.config.pad_token_id, np.int64)
        for b, p in enumerate(prompts):
            ids[b, : len(p)] = np.asarray(p, np.int64)

        cache = self._make_cache(B, S, lengths)
        cache_bytes = cache.nbytes
        ids_t = torch.from_numpy(ids).to(self.device)
        lengths_t = torch.from_numpy(lengths).to(self.device)
        _synchronize(self.device)
        t0 = time.perf_counter()
        last_logits, cache = self._prefill(ids_t, lengths_t, cache)
        sampling = self.config.sampling
        gen = None if sampling.greedy else step_generator(self.config.seed, 0, self.device)
        first = sample(last_logits, gen, sampling)
        _synchronize(self.device)
        ttft_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        result, cache = self._decode(cache, first, self.config.seed)
        tokens = result["tokens"].cpu().numpy()
        n_gen = result["n_generated"].cpu().numpy()
        decode_s = time.perf_counter() - t1
        steps = int(result["steps"])
        decode_tokens = int(n_gen.sum()) - B
        return {
            "tokens": [tokens[b, : int(n_gen[b])].tolist() for b in range(B)],
            "n_generated": n_gen.tolist(),
            "gen_tokens": int(n_gen.sum()),
            "prefill_tokens": int(lengths.sum()),
            "decode_steps": steps,
            "ttft_s": ttft_s,
            "decode_s": decode_s,
            "decode_tps": decode_tokens / decode_s if decode_s > 0 else 0.0,
            "cache_bytes": cache_bytes,
        }


# files a Hugging Face checkpoint directory keeps its tokenizer in
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json", "vocab.json")


def resolve_tokenizer(tok_cfg: Any, fallback_path: Optional[str] = None) -> None:
    """The ``generation.tokenizer`` ladder of the ``generate`` CLI and the
    recipe's eval sampling. No tokenizer is ported: with none configured
    this returns None (prompts are token ids); a configured one raises,
    naming the section; tokenizer files in ``fallback_path`` (the model's
    own directory) are left unread with a warning, as JAX does when it
    cannot build one."""
    if tok_cfg is not None:
        raise ValueError(
            f"generation.tokenizer={tok_cfg!r}: a tokenizer is not ported to the torch "
            "backend; prompts are token ids (generation.prompt_ids)"
        )
    if fallback_path and any((Path(fallback_path) / f).exists() for f in _TOKENIZER_FILES):
        logger.warning("tokenizer files in %s are not read by the torch backend; token-id mode", fallback_path)
    return None


def build_auto_from_model_section(mcfg: Any, device: Any, seed: int = 0, trainable: bool = False) -> Any:
    """AutoModel from a ``model:``-shaped section on ``device``:
    ``pretrained_model_name_or_path`` (a local HF checkpoint directory) or
    ``hf_config`` (random weights from ``seed``), with ``backend``;
    ``trainable`` for the finetune recipe."""
    from automodel_tpu_torch import auto_model

    get = mcfg.get if hasattr(mcfg, "get") else dict(mcfg).get
    backend = get("backend", {}) or {}
    backend = backend.to_dict() if hasattr(backend, "to_dict") else dict(backend)
    if get("pretrained_model_name_or_path"):
        return auto_model.from_pretrained(
            get("pretrained_model_name_or_path"), backend, device=device, trainable=trainable
        )
    hf = get("hf_config")
    if hf is None:
        raise ValueError("model section needs pretrained_model_name_or_path or hf_config")
    return auto_model.from_config(
        hf.to_dict() if hasattr(hf, "to_dict") else dict(hf), backend,
        device=device, seed=seed, trainable=trainable,
    )


def build_auto_from_cfg(cfg: Any, parallel: bool = False) -> Any:
    """Model from the YAML's ``model:`` section on the top-level ``device``
    (``cuda`` unless the config says ``cpu``). With ``parallel`` (the
    ``generate`` command) a ``distributed:`` section shards the model by
    its tensor-parallel plan over the mesh's ``tp`` group (each rank keeps
    its kv heads and their cache; ``cp > 1`` is refused); the mesh rides on
    the AutoModel as ``mesh_ctx``. Without it (``serve``, the profiler) a
    section asking for more than one device is refused: serving under
    tensor parallelism (the paged pool sharded with the kv heads) is not
    ported."""
    section = cfg.get("distributed", None)
    dist = dict(_plain(section) or {})
    if not parallel:
        many = {
            k: v for k, v in dist.items()
            if k in ("dp_replicate", "dp_shard", "tp", "cp", "pp", "ep") and v not in (None, 1, -1)
        }
        if many:
            raise ValueError(
                f"distributed: {many}: serving on more than one device (the paged pool sharded with the kv "
                "heads) is not ported to the torch backend yet"
            )
        return build_auto_from_model_section(cfg.model, cfg.get("device", None), seed=cfg.get("seed", 0))
    from automodel_tpu_torch.device import resolve_device
    from automodel_tpu_torch.parallel.mesh import MeshConfig, build_mesh, initialize_distributed
    from automodel_tpu_torch.parallel.plans import parallelize

    device = resolve_device(cfg.get("device", None))
    if section is None:
        return build_auto_from_model_section(cfg.model, device, seed=cfg.get("seed", 0))
    mcfg = MeshConfig.from_section(dist)
    mcfg.check_ported()
    if mcfg.cp > 1:
        raise ValueError(f"distributed.cp={mcfg.cp}: generation with the sequence split over ranks is not ported")
    initialize_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    ctx = build_mesh(mcfg, device_type=device.type)
    auto = build_auto_from_model_section(cfg.model, device, seed=cfg.get("seed", 0))
    parallelize(auto.model, ctx, fsdp=False)
    auto.mesh_ctx = ctx
    return auto


# -- CLI ----------------------------------------------------------------------


def _plain(section: Any) -> Any:
    return section.to_dict() if hasattr(section, "to_dict") else section


def _parse_id_prompt(p: Any) -> Optional[list[int]]:
    toks = str(p).replace(",", " ").split()
    try:
        return [int(t) for t in toks] if toks else None
    except ValueError:
        return None


def main(cfg: Any) -> int:
    """``python -m automodel_tpu_torch.cli.app generate -c cfg.yaml
    [--prompt '1 2 3'] [--device=cpu]``: the model from the ``model:``
    section on the config's ``device``, sampling and lengths from
    ``generation:``, prompts from ``--prompt`` (token ids as text),
    ``generation.prompts`` or ``generation.prompt_ids``. Prints a
    ``prompt:`` and a ``completion:`` line per prompt, then one
    ``{"event": "generation", ...}`` JSON line; exit 2 without a prompt."""
    from automodel_tpu_torch.serving.server import refuse_unported_top_sections

    refuse_unported_top_sections(cfg)
    gen_section = dict(_plain(cfg.get("generation", None)) or {})
    resolve_tokenizer(gen_section.pop("tokenizer", None), cfg.model.get("pretrained_model_name_or_path", None))
    prompts = cfg.get("prompt", None)
    prompts = gen_section.pop("prompts", None) if prompts is None else prompts
    prompt_ids = gen_section.pop("prompt_ids", None)
    if prompts is None and prompt_ids is None:
        print("no prompt: pass --prompt '...' or set generation.prompts / generation.prompt_ids")
        return 2
    if prompt_ids is not None:
        ids = [[int(t) for t in p] for p in prompt_ids]
    else:
        prompts = [prompts] if isinstance(prompts, (str, int)) else list(prompts)
        ids = [_parse_id_prompt(p) for p in prompts]
        if any(i is None for i in ids):
            print("no tokenizer in the torch backend: prompts must be token ids (e.g. --prompt '1 2 3')")
            return 2
    auto = build_auto_from_cfg(cfg, parallel=True)
    engine = GenerationEngine(auto, GenerationConfig.from_dict(gen_section))
    out = engine.generate_ids(ids)
    if getattr(auto, "mesh_ctx", None) is not None and auto.mesh_ctx.rank != 0:
        return 0  # every rank decodes the same tokens; rank 0 prints them
    for p, t in zip(ids, out["tokens"]):
        print(f"prompt: {' '.join(map(str, p))}")
        print(f"completion: {' '.join(map(str, t))}")
    stats = {k: out[k] for k in ("ttft_s", "decode_tps", "gen_tokens", "prefill_tokens", "decode_steps", "cache_bytes")}
    print(json.dumps({"event": "generation", **stats}))
    return 0

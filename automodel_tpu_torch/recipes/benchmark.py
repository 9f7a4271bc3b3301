"""The benchmark recipe, port of ``BenchmarkingRecipeForNextTokenPrediction``
and ``main`` of ``automodel_tpu/recipes/benchmark.py``.

    python -m automodel_tpu_torch.cli.app benchmark llm -c cfg.yaml [--device=cpu]

It reuses the training recipe's setup and step (recipes/train_ft.py) and
adds a ``benchmark:`` section: ``warmup_steps`` (default 3),
``measure_steps`` (default 10) and ``output_json``. One batch is taken
from the step scheduler and placed on the device (popped from the
prefetch pipeline under ``data.prefetch``, whose producers are then
joined); the warmup steps run and end in a synchronise; then each measured step is timed as ``step``,
``dispatch`` (until ``train_step`` returns) and ``device`` (the
synchronise after it), with one JSONL row a step (``bench_step``,
``step_time_s``, ``ts``). The result holds the JAX recipe's keys:
tokens/s, TFLOP/s and MFU from the FLOP laws (utils/flops_utils.py) over
the card's peak (``mfu: null`` where the card's name is not in the table,
or on the CPU), step times, the timers, host dispatch against device
time, the cost of the timing itself, and the memory reading
(telemetry/memory.py); it is written to ``output_json`` when set and
printed as one JSON line. ``n_chips`` is 1: the port runs one device.

Where ``train_step`` waits on the device inside (a host read of a device
value), ``dispatch`` holds that device time too; the result shows it as
a ``dispatch_mean_s`` near ``step_time_mean_s``.

Legs after the measured steps, each a null-with-reason when it cannot run:
- decode (``generation:`` section, ``bench_batch`` x ``bench_prompt_len``
  random prompts): ``GenerationEngine.generate_ids`` twice on the live
  weights, the second timed: ``gen_ttft_s``, ``gen_decode_tps``;
- serving (``serving:`` section): a warm-up request, then Poisson arrivals
  (``bench_*`` keys) through ``ServingEngine.run_workload`` on the live
  trained module: ``serve_tokens_per_s``, ``serve_ttft_p50_s`` / ``p99``;
  with ``serving.speculative`` on (JAX :306-425), ``serve_accept_rate``,
  ``serve_draft_tps`` and ``serve_spec_ab``: the same arrivals through a
  second engine with the draft disabled, built after the first engine's
  pools are released (``spec_on_tokens_per_s`` / ``spec_off_tokens_per_s``
  / ``speedup``);
- spill (``serving.kv_spill.enabled``, JAX :453-606): the same
  shared-prefix arrivals through a one-slot engine whose pool holds about
  one group, spill on and spill off: ``serve_spill_tokens_per_s``,
  ``serve_spill_ttft_p50_s``, ``serve_effective_hit_rate``,
  ``serve_spill_reloads`` and ``serve_spill_ab``;
- fleet: not ported; its section is refused, so the leg reports JAX's
  reason for a missing section.

With ``profiling`` on (the default), the first warmup step runs under the
cost counter (telemetry/profiling/cost.py) and the result carries ``cost``
(the counted FLOPs and bytes with the roofline class) and
``mfu_measured_pct`` beside ``mfu`` (JAX :184-210); a run without a warmup
step reports ``cost_error`` instead. ``benchmark.profile`` (a
``ProfilerConfig``: ``enabled``, ``start_step``, ``end_step``,
``trace_dir``, default ``<output_dir>/trace``) opens a ``torch.profiler``
window over those measured steps. The watchdog runs during the benchmark
and each measured step pets it. The result has no
``recompiles_during_measure`` (XLA's; the port builds its kernels in the
warmup) and no ``pipeline``. Refused by name at setup: a ``fleet:``
section, besides what the training recipe and ``ServeConfig`` refuse.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Any

import numpy as np

from automodel_tpu_torch.generation.engine import GenerationConfig
from automodel_tpu_torch.recipes.train_ft import READ_SECTIONS, TrainFinetuneRecipeForNextTokenPrediction, _plain
from automodel_tpu_torch.serving.engine import ServeConfig, ServingEngine
from automodel_tpu_torch.telemetry.memory import memory_snapshot
from automodel_tpu_torch.training.timers import Timers, barrier
from automodel_tpu_torch.utils.profiler import ProfilerConfig, StepProfiler
from automodel_tpu_torch.utils.flops_utils import (
    calculate_mfu,
    device_peak_tflops,
    flops_per_token_for_config,
)

logger = logging.getLogger(__name__)

BENCHMARK_KEYS = ("warmup_steps", "measure_steps", "output_json", "profile")
# the memory census's top groups (JAX's TelemetryConfig.census_top_k default)
CENSUS_TOP_K = 8
# generation: keys that describe prompts, not the engine
_PROMPT_KEYS = ("prompts", "prompt_ids", "tokenizer", "enabled")


def check_benchmark_sections(cfg: Any) -> None:
    """Raise ``ValueError`` naming a benchmark-side section or key the port
    does not run."""
    bcfg = dict(_plain(cfg.get("benchmark", None)) or {})
    unknown = sorted(set(bcfg) - set(BENCHMARK_KEYS))
    if unknown:
        raise ValueError(f"benchmark keys {unknown} are unknown (it takes {list(BENCHMARK_KEYS)})")
    ProfilerConfig(**dict(_plain(bcfg.get("profile")) or {}))
    if cfg.get("serving", None) is not None:
        # names serving.warm_start / serving.kv_transfer / ... when enabled
        ServeConfig.from_dict(dict(_plain(cfg.serving) or {}))


class BenchmarkingRecipeForNextTokenPrediction(TrainFinetuneRecipeForNextTokenPrediction):
    read_sections = READ_SECTIONS + ("benchmark", "serving")
    runs_parallel = False  # a distributed: section past one device is refused

    def setup(self) -> None:
        check_benchmark_sections(self.cfg)
        super().setup()

    def run_benchmark(self) -> dict:
        # a leg hangs the ways training does: the watchdog turns a stuck
        # leg into stacks and a flight-recorder dump; each measured step pets it
        self.guard.start()
        try:
            with self.telemetry.crash_guard():
                return self._run_benchmark_body()
        finally:
            self.guard.close()
            self._close_prefetch()
            if self._prom_server is not None:
                self._prom_server.shutdown()
            self.resilience.close()
            self.step_scheduler.restore_signal_handlers()
            self.ledger.close(reason="exit")

    def _run_benchmark_body(self) -> dict:
        bcfg = dict(_plain(self.cfg.get("benchmark", None)) or {})
        warmup = int(bcfg.get("warmup_steps", 3))
        measure = int(bcfg.get("measure_steps", 10))
        pcfg = dict(_plain(bcfg.get("profile")) or {})
        pcfg.setdefault("trace_dir", str(self.output_dir / "trace"))
        prof = StepProfiler(ProfilerConfig(**pcfg))
        timers = Timers()

        try:
            # a queue pop under data.prefetch (the pipeline stacked and placed
            # the group), else collate, stack and copy (JAX :64-70)
            stacked, batch, _ = self._next_batch(iter(self.step_scheduler))
        finally:
            self._close_prefetch()
        tokens_per_step = int(np.prod(stacked["input_ids"].shape))

        state = self.state
        metrics = None
        cost = None
        count = self.profiling.enabled and self.profiling.cost_attribution
        for i in range(warmup):
            if i == 0 and count:
                # the first warmup step is the counted one: no extra step
                from automodel_tpu_torch.telemetry.profiling import count_cost

                metrics, cost = count_cost(self.train_step, state, batch, program="train_step")
            else:
                metrics = self.train_step(state, batch)
        if metrics is not None:
            barrier(metrics["loss"])

        # the cost of every per-step timing op the loop adds (timer starts
        # and stops, the JSONL row); the brackets cost about one timer call
        # each, so the estimate over-counts slightly
        tel_overhead_s = 0.0
        for i in range(measure):
            _t = time.perf_counter()
            prof.on_step(i)
            timers("step").start()
            timers("dispatch").start()
            tel_overhead_s += time.perf_counter() - _t
            metrics = self.train_step(state, batch)
            _t = time.perf_counter()
            timers("dispatch").stop()
            timers("device").start()
            tel_overhead_s += time.perf_counter() - _t
            barrier(metrics["loss"])
            _t = time.perf_counter()
            timers("device").stop()
            dt = timers("step").stop()
            self.metric_logger.log({"bench_step": i, "step_time_s": dt, "ts": time.time()})
            self.guard.on_step(i)  # the heartbeat only
            tel_overhead_s += time.perf_counter() - _t
        prof.close()

        n_chips = 1
        mean_s = timers("step").mean()
        tps = tokens_per_step / mean_s
        seq_len = stacked["input_ids"].shape[-1]
        fpt = flops_per_token_for_config(self.model.config, seq_len)
        peak = device_peak_tflops(self.device)
        result = {
            "tokens_per_second": tps,
            "tokens_per_second_per_chip": tps / n_chips,
            "tflops_per_second_per_chip": tps / n_chips * fpt / 1e12,
            "mfu": calculate_mfu(tps / n_chips, fpt, peak) if peak == peak else None,
            "step_time_mean_s": mean_s,
            "step_time_min_s": timers("step").min(),
            "step_time_max_s": timers("step").max(),
            "n_chips": n_chips,
            "tokens_per_step": tokens_per_step,
            "loss": float(metrics["loss"]),
            "timers": timers.summary(),
            # host dispatch against device execution (the batch is placed
            # before the window, so there is no data-wait leg)
            "step_decomposition": {
                "dispatch_mean_s": timers("dispatch").mean(),
                "device_mean_s": timers("device").mean(),
            },
            "telemetry_overhead_s_per_step": tel_overhead_s / max(measure, 1),
            "telemetry_overhead_fraction": (tel_overhead_s / max(measure, 1)) / max(mean_s, 1e-12),
            # what filled the card at the end of the window
            "memory": memory_snapshot(CENSUS_TOP_K, self.device),
        }
        with self.guard.phase("eval"):
            result.update(self._generation_leg())
        with self.guard.phase("eval"):
            result.update(self._serving_leg())
        with self.guard.phase("eval"):
            result.update(self._spill_leg())
        result.update(self._fleet_leg())
        # the counted step's FLOPs beside the analytic law the `mfu` key
        # comes from; drift between the two is what the law does not count
        if count:
            if cost is None:
                result["cost_error"] = "no warmup step to count (benchmark.warmup_steps: 0)"
            else:
                from automodel_tpu_torch.telemetry import profiling as profmod

                basis = self.profiling.roofline_basis()
                result["cost"] = {**cost.to_dict(), **profmod.roofline(cost, basis)}
                m = profmod.mfu_measured_pct(cost.flops, mean_s, n_chips, basis)
                result["mfu_measured_pct"] = round(m, 3) if m is not None else None
        out_path = bcfg.get("output_json")
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
        logger.info(
            "benchmark: %s", json.dumps({k: v for k, v in result.items() if k not in ("timers", "memory")})
        )
        print(json.dumps(result), flush=True)
        return result

    def _gen_config(self) -> GenerationConfig:
        return GenerationConfig.from_dict(
            {k: v for k, v in self._gen_section.items() if k not in _PROMPT_KEYS}
        )

    def _generation_leg(self) -> dict:
        """→ {gen_ttft_s, gen_decode_tps, gen_failure[, gen_tokens,
        gen_cache_bytes]}. The first call warms up (allocator, kernel
        builds), the second is measured. Random prompts of
        ``generation.bench_batch`` x ``generation.bench_prompt_len``."""
        if self._gen_engine is None:
            return {
                "gen_ttft_s": None,
                "gen_decode_tps": None,
                "gen_failure": self._gen_skip_reason or "no generation: section in config",
            }
        batch = int(self._gen_section.get("bench_batch", 4))
        prompt_len = int(self._gen_section.get("bench_prompt_len", 64))
        vocab = int(self.model.config.vocab_size)
        prompts = np.random.default_rng(0).integers(1, vocab, size=(batch, prompt_len)).tolist()
        try:
            self._gen_engine.generate_ids(prompts)
            out = self._gen_engine.generate_ids(prompts)
        except Exception as e:
            return {"gen_ttft_s": None, "gen_decode_tps": None, "gen_failure": f"{type(e).__name__}: {e}"}
        return {
            "gen_ttft_s": round(out["ttft_s"], 6),
            "gen_decode_tps": round(out["decode_tps"], 2),
            "gen_tokens": out["gen_tokens"],
            "gen_cache_bytes": out["cache_bytes"],
            "gen_failure": None,
        }

    def _poisson_arrivals(self, scfg: ServeConfig) -> list:
        """The serving leg's workload: Poisson arrivals over mixed-length
        random prompts, derived from seed 0 (the first arrives at t=0)."""
        vocab = int(self.model.config.vocab_size)
        rng = np.random.default_rng(0)
        lens = rng.integers(scfg.bench_prompt_len_min, scfg.bench_prompt_len_max + 1, size=scfg.bench_requests)
        gaps = rng.exponential(1.0 / max(scfg.bench_rate, 1e-6), size=scfg.bench_requests)
        offsets = np.cumsum(gaps) - gaps[0]
        return [
            (float(offsets[i]), rng.integers(1, vocab, size=int(lens[i])).tolist(), scfg.bench_max_new_tokens)
            for i in range(scfg.bench_requests)
        ]

    def _serving_leg(self) -> dict:
        """→ {serve_tokens_per_s, serve_ttft_p50_s, serve_ttft_p99_s,
        serve_block_occupancy_peak, serve_requests, serve_failure, ...}:
        ``serving.bench_requests`` Poisson arrivals at ``bench_rate``
        req/s, driven in real time through the continuous-batching engine
        on the live trained module, after one warm-up request. An engine
        that recovered from a fault (a rebuild after an error or a stall)
        fails the leg: ``run_workload`` raises and ``serve_failure`` says
        why."""
        nulls = {
            "serve_tokens_per_s": None,
            "serve_ttft_p50_s": None,
            "serve_ttft_p99_s": None,
            "serve_block_occupancy_peak": None,
            "serve_requests": None,
            "serve_accept_rate": None,
            "serve_draft_tps": None,
        }
        section = self.cfg.get("serving", None)
        if section is None:
            reason = "no serving: section in config"
            return {**nulls, "serve_failure": reason, "serve_spec_failure": reason}
        engine = off_engine = None
        ab = None
        try:
            scfg = ServeConfig.from_dict(dict(_plain(section) or {}))
            gen_cfg = self._gen_config()
            vocab = int(self.model.config.vocab_size)
            arrivals = self._poisson_arrivals(scfg)
            rng = np.random.default_rng(1)

            def workload(cfg: ServeConfig):
                eng = ServingEngine(self.auto, cfg, gen_cfg)
                # warm-up: allocator and kernel builds outside the window
                eng.submit(rng.integers(1, vocab, size=len(arrivals[0][1])).tolist(), max_new_tokens=2)
                eng.run()
                return eng, eng.run_workload(arrivals)[1]

            engine, stats = workload(scfg)
            decode_backend = engine.decode_backend
            if scfg.speculative.enabled:
                # spec on/off A/B on the same arrivals: the speculative
                # engine's pools are released first, so two chip-sized pools
                # are never resident at once
                engine.release_pools()
                off_cfg = dataclasses.replace(
                    scfg, speculative=dataclasses.replace(scfg.speculative, enabled=False, draft=None)
                )
                off_engine, off_stats = workload(off_cfg)
                on_tps, off_tps = stats["sustained_tokens_per_s"], off_stats["sustained_tokens_per_s"]
                ab = {
                    "spec_on_tokens_per_s": round(on_tps, 2),
                    "spec_off_tokens_per_s": round(off_tps, 2),
                    "speedup": round(on_tps / off_tps, 3) if off_tps > 0 else None,
                }
        except Exception as e:
            reason = f"{type(e).__name__}: {e}"
            return {**nulls, "serve_failure": reason, "serve_spec_failure": reason}
        finally:
            for eng in (engine, off_engine):
                if eng is not None:
                    eng.release_pools()
        out = {
            "serve_tokens_per_s": round(stats["sustained_tokens_per_s"], 2),
            "serve_ttft_p50_s": round(stats["ttft_p50_s"], 6),
            "serve_ttft_p99_s": round(stats["ttft_p99_s"], 6),
            "serve_block_occupancy_peak": stats["block_occupancy_peak"],
            "serve_requests": stats["requests"],
            "serve_prefix_cache": stats["prefix_cache"],
            "serve_queue_depth_peak": stats["queue_depth_peak"],
            "serve_decode_backend": decode_backend,
            "serve_kv_cache_dtype": scfg.kv_cache_dtype,
            "serve_failure": None,
        }
        if scfg.speculative.enabled:
            out["serve_accept_rate"] = stats.get("accept_rate")
            out["serve_draft_tps"] = (
                round(stats["draft_tps"], 2) if isinstance(stats.get("draft_tps"), float) else None
            )
            out["serve_spec_ab"] = ab
            out["serve_spec_failure"] = (
                None if stats.get("accept_rate") is not None
                else "no speculative round ran inside the workload"
            )
        else:
            out["serve_accept_rate"] = None
            out["serve_draft_tps"] = None
            out["serve_spec_failure"] = "speculative decoding disabled"
        return out

    def _spill_arrivals(self, scfg: ServeConfig, prefix_blocks: int, groups: int, repeats: int) -> list:
        """The spill A/B's prefill-heavy workload (JAX :428-451): ``groups``
        shared prefixes of ``prefix_blocks`` full blocks, each arriving
        ``repeats`` times with a fresh one-block suffix, round-robin with
        Poisson gaps, so every return to a group comes after the other
        groups churned the pool. From seed 2; both legs replay this list."""
        bs = scfg.block_size
        vocab = int(self.model.config.vocab_size)
        rng = np.random.default_rng(2)
        prefixes = [rng.integers(1, vocab, size=prefix_blocks * bs).tolist() for _ in range(groups)]
        n = groups * repeats
        gaps = rng.exponential(1.0 / max(scfg.bench_rate, 1e-6), size=n)
        offsets = np.cumsum(gaps) - gaps[0]
        out = []
        for i in range(n):
            suffix = rng.integers(1, vocab, size=bs).tolist()
            out.append((float(offsets[i]), prefixes[i % groups] + suffix, 4))
        return out

    def _spill_leg(self) -> dict:
        """→ {serve_spill_tokens_per_s, serve_spill_ttft_p50_s,
        serve_effective_hit_rate, serve_spill_reloads, serve_spill_ab,
        serve_spill_failure} (JAX :453-606). Two engines, spill on and
        spill off, share one undersized pool (one slot, ``prefix_blocks +
        6`` blocks: about one group's working set) and the same arrivals,
        so the only difference is whether an evicted prefix reloads from
        host memory or prefills again. Each engine is warmed (and the spill
        engine's spill → reload cycle run once) before its counters are
        zeroed; the pools of one engine are released before the next is
        built. A rebuild, a failed spill extract, or an eviction that was
        neither spilled nor refused by the byte budget fails the leg, with
        ``serve_spill_failure`` saying why."""
        nulls = {
            "serve_spill_tokens_per_s": None,
            "serve_spill_ttft_p50_s": None,
            "serve_effective_hit_rate": None,
            "serve_spill_reloads": None,
        }
        section = self.cfg.get("serving", None)
        if section is None:
            return {**nulls, "serve_spill_failure": "no serving: section in config"}
        engine = None
        try:
            scfg = ServeConfig.from_dict(dict(_plain(section) or {}))
            if not scfg.kv_spill.enabled:
                return {**nulls, "serve_spill_failure": "serving.kv_spill disabled"}
            gen_cfg = self._gen_config()
            prefix_blocks, groups, repeats = 12, 3, 3
            per_req = prefix_blocks + 2  # suffix block + decode spill-over
            num_blocks = per_req + 4
            base = dataclasses.replace(
                scfg, slots=1, num_blocks=num_blocks,
                max_seq_len=max(scfg.max_seq_len, num_blocks * scfg.block_size),
                speculative=dataclasses.replace(scfg.speculative, enabled=False, draft=None),
            )
            arrivals = self._spill_arrivals(base, prefix_blocks, groups, repeats)
            legs = {}
            for name, enabled in (("on", True), ("off", False)):
                cfg_leg = dataclasses.replace(base, kv_spill=dataclasses.replace(scfg.kv_spill, enabled=enabled))
                engine = ServingEngine(self.auto, cfg_leg, gen_cfg)
                engine.submit(arrivals[0][1][: base.block_size], max_new_tokens=2)
                engine.run()
                if enabled:
                    # the spill → reload cycle once outside the window: park
                    # a prefix, churn it out of the pool, serve it again
                    warm = arrivals[0][1]
                    churn_len = min((num_blocks - 1) * base.block_size, base.max_seq_len) - 2
                    churn = (list(arrivals[1][1]) * 2)[:churn_len]
                    for p in (warm, churn, warm):
                        engine.submit(p, max_new_tokens=2)
                        engine.run()
                engine.pool.clear_prefix_cache()
                # the warm-up must not pollute the reported ledgers; zeroed
                # together (pool and tier) so the cross-tier invariants hold
                tier = engine.pool.spill
                for d in [engine.pool.counters] + ([tier.counters] if tier is not None else []):
                    for key in d:
                        d[key] = 0
                _, stats = engine.run_workload(arrivals)
                engine.check_invariants()
                if tier is not None:
                    # every eviction in the window was spilled, or refused
                    # by the tier's byte budget
                    c = engine.pool.counters
                    if c["spilled_blocks"] + tier.counters["spill_rejected"] != c["evictions"]:
                        raise RuntimeError(
                            f"spill ledger: {c['spilled_blocks']} spilled + {tier.counters['spill_rejected']} "
                            f"rejected != {c['evictions']} evictions"
                        )
                legs[name] = stats
                engine.release_pools()
                engine = None
        except Exception as e:
            return {**nulls, "serve_spill_failure": f"{type(e).__name__}: {e}"}
        finally:
            if engine is not None:
                engine.release_pools()

        def _rate(stats):
            c = stats["prefix_cache"]
            hit, miss = c["prefix_hit_tokens"], c["prefix_miss_tokens"]
            return (round(hit / (hit + miss), 4) if hit + miss else None), c

        on_rate, on_c = _rate(legs["on"])
        off_rate, _ = _rate(legs["off"])
        on_tps = legs["on"]["sustained_tokens_per_s"]
        off_tps = legs["off"]["sustained_tokens_per_s"]
        return {
            "serve_spill_tokens_per_s": round(on_tps, 2),
            "serve_spill_ttft_p50_s": round(legs["on"]["ttft_p50_s"], 6),
            "serve_effective_hit_rate": on_rate,
            "serve_spill_reloads": on_c["spill_reloads"],
            "serve_spill_ab": {
                "spill_on_tokens_per_s": round(on_tps, 2),
                "spill_off_tokens_per_s": round(off_tps, 2),
                "spill_on_ttft_p50_s": round(legs["on"]["ttft_p50_s"], 6),
                "spill_off_ttft_p50_s": round(legs["off"]["ttft_p50_s"], 6),
                "effective_hit_rate_on": on_rate,
                "effective_hit_rate_off": off_rate,
                "spilled_blocks": on_c["spilled_blocks"],
                "reloaded_blocks": on_c["spill_reloaded_blocks"],
                "speedup": round(on_tps / off_tps, 3) if off_tps > 0 else None,
            },
            "serve_spill_failure": None,
        }

    def _fleet_leg(self) -> dict:
        """The routed fleet leg is not ported; a ``fleet:`` section is
        refused at setup, so the leg reports JAX's reason for its absence."""
        return {
            "serve_fleet_tokens_per_s": None,
            "serve_route_prefix_hit_rate": None,
            "serve_fleet_retries": None,
            "serve_fleet_failure": "no fleet: section in config",
        }


def main(cfg: Any) -> dict:
    recipe = BenchmarkingRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    return recipe.run_benchmark()

"""The port's multi-tenant QoS against the JAX package's engine.

Both engines run on the same tiny Llama weights (``params_from_jax``) with
the same tenants, the same submissions and the same ``t_submit`` clocks;
each scenario compares what both did: the admission order (tier, then
weighted fair service over weight, then earliest deadline, then FIFO), the
aging promotion, the token-bucket quotas and their one-record-per-give-up
seam, shedding lowest-tier-first, the drain that no tier jumps, an
overloaded Poisson workload of mixed tiers, and the tier/tenant labels of
``/metrics`` (the port's exposition parsed by the JAX package's own
parser). Records are compared by request: ``completion_reason``,
``retriable``, ``tenant``, ``tier`` and tokens. Mirrors
``tests/test_qos.py`` :110-365 and :524.
"""

import time

import numpy as np
import pytest

from automodel_tpu.generation.engine import GenerationConfig as JGenerationConfig
from automodel_tpu.serving import engine as jeng
from automodel_tpu.telemetry.federation import parse_exposition
from automodel_tpu_torch.generation.engine import GenerationConfig
from automodel_tpu_torch.serving import engine as teng
from torch_port_parity import jax_tiny, torch_twin

SERVE = dict(block_size=4, num_blocks=48, prefill_chunk=4, max_seq_len=32, decode_kernel="gather")


@pytest.fixture(scope="module")
def models():
    _, params, jauto = jax_tiny(seed=0)
    return jauto, torch_twin(params)


def _tenants(mod, **extra):
    base = {
        "chat": mod.TenantConfig(tier="interactive", weight=2.0),
        "ebatch": mod.TenantConfig(tier="batch"),
        "scraper": mod.TenantConfig(tier="best_effort"),
    }
    base.update({k: mod.TenantConfig(**v) for k, v in extra.items()})
    return base


def _engines(models, qos: dict | None = None, tenants: dict | None = None, **serve):
    """(JAX engine, port engine, JAX records, port records) with the same
    QoS section (``tenants`` as TenantConfig kwargs)."""
    serve.setdefault("slots", 2)
    out = []
    for mod, auto, gen in ((jeng, models[0], JGenerationConfig), (teng, models[1], GenerationConfig)):
        q = dict(qos if qos is not None else {"enabled": True})
        q["tenants"] = _tenants(mod) if tenants is None else {k: mod.TenantConfig(**v) for k, v in tenants.items()}
        records = []
        eng = mod.ServingEngine(
            auto, mod.ServeConfig(**SERVE, **serve, qos=mod.QoSConfig(**q)),
            gen(max_new_tokens=4, greedy=True), on_record=records.append,
        )
        out.append((eng, records))
    (je, jr), (te, tr) = out
    return je, te, jr, tr


def _same_records(jr: list, tr: list) -> dict:
    keys = ("completion_reason", "retriable", "tenant", "tier", "tokens")
    j = {r["request_id"]: tuple(r[k] for k in keys) for r in jr if r.get("event") == "serve_request"}
    t = {r["request_id"]: tuple(r[k] for k in keys) for r in tr if r.get("event") == "serve_request"}
    assert t == j
    assert len(t) == len([r for r in tr if r.get("event") == "serve_request"])  # one record a request
    return t


def _both(je, te, fn):
    """Call ``fn(engine)`` on both; → the two results, or the two
    exceptions' (type name, tenant, tier)."""
    out = []
    for eng in (je, te):
        try:
            out.append(fn(eng))
        except Exception as e:  # compared by name: the packages' classes differ
            out.append((type(e).__name__, getattr(e, "tenant", None), getattr(e, "tier", None)))
    return out


def test_tier_order_and_unknown_tier_rejected(models):
    assert teng.TIERS == jeng.TIERS == ("interactive", "batch", "best_effort")
    assert [teng.tier_index(t) for t in teng.TIERS] == [0, 1, 2]
    with pytest.raises(ValueError, match="unknown QoS tier"):
        teng.tier_index("interactivee")
    je, te, jr, tr = _engines(models)
    for eng in (je, te):
        with pytest.raises(ValueError, match="unknown QoS tier"):
            eng.submit([1, 2, 3], tier="premium")
        assert eng.queue_depth == 0
    assert jr == tr == []
    for bad in ({"default_tier": "gold"}, {"aging_s": 0}, {"tenants": {"a b": teng.TenantConfig()}}):
        with pytest.raises(ValueError):
            teng.QoSConfig(**bad)


def test_qos_off_is_fifo(models):
    je, te, jr, tr = _engines(models, qos={"enabled": False}, slots=1)
    for eng in (je, te):
        for i, t in enumerate(("best_effort", "batch", "interactive", "best_effort")):
            eng.submit([1 + i, 2, 3], request_id=f"r{i}", tier=t)
        while eng.queue_depth:
            assert eng._select_queued(time.perf_counter()) == 0
            eng.step()
        eng.run()
    assert [r["request_id"] for r in tr] == [r["request_id"] for r in jr] == ["r0", "r1", "r2", "r3"]
    _same_records(jr, tr)


def test_tiered_admission_order_and_edf(models):
    je, te, jr, tr = _engines(models)
    now = time.perf_counter()
    picks = []
    for eng in (je, te):
        eng.submit([1, 2, 3], request_id="be", tenant="scraper", t_submit=now)
        eng.submit([1, 2, 3], request_id="b-late", tenant="ebatch", t_submit=now, deadline_s=100.0)
        eng.submit([1, 2, 3], request_id="b-soon", tenant="ebatch", t_submit=now + 0.001, deadline_s=5.0)
        eng.submit([1, 2, 3], request_id="i", tenant="chat", t_submit=now)
        q = list(eng._queue)
        first = q[eng._select_queued(now + 0.01)].rid
        eng._queue.remove(q[3])
        q = list(eng._queue)
        picks.append((first, q[eng._select_queued(now + 0.01)].rid))
        eng.run()
    assert picks[1] == picks[0] == ("i", "b-soon")


def test_wfq_least_normalized_service_wins(models):
    tenants = {"heavy": {"tier": "interactive", "weight": 2.0}, "light": {"tier": "interactive", "weight": 1.0}}
    je, te, jr, tr = _engines(models, tenants=tenants)
    now = time.perf_counter()
    picks = []
    for eng in (je, te):
        eng.submit([1, 2, 3], request_id="l", tenant="light", t_submit=now)
        eng.submit([1, 2, 3], request_id="h", tenant="heavy", t_submit=now + 0.001)
        eng._wfq_served[("interactive", "heavy")] = 100.0
        eng._wfq_served[("interactive", "light")] = 100.0
        picks.append(list(eng._queue)[eng._select_queued(now + 0.01)].rid)
        eng.run()
    assert picks == ["h", "h"]
    assert te._wfq_served == je._wfq_served  # the admitted budgets charged the same


def test_aging_promotes_to_top_tier(models):
    je, te, jr, tr = _engines(models)
    now = time.perf_counter()
    picks = []
    for eng in (je, te):
        eng.submit([1, 2, 3], request_id="old-be", tenant="scraper", t_submit=now - eng.config.qos.aging_s - 1.0)
        eng.submit([1, 2, 3], request_id="i", tenant="chat", t_submit=now)
        old = next(q for q in eng._queue if q.rid == "old-be")
        picks.append((old.tier_idx, eng._effective_tier(old, now), list(eng._queue)[eng._select_queued(now)].rid))
        eng.run()
    assert picks[1] == picks[0] == (2, 0, "old-be")


def test_quota_buckets_reject_and_refill(models):
    tenants = {"limited": {"tier": "interactive", "requests_per_s": 1.0, "burst_s": 1.0},
               "decoder": {"tier": "batch", "decode_tokens_per_s": 8.0, "burst_s": 1.0}}
    je, te, jr, tr = _engines(models, tenants=tenants)
    t0 = time.perf_counter()
    steps = [
        dict(prompt_ids=[1, 2, 3], tenant="limited", t_submit=t0 - 10.0),
        dict(prompt_ids=[1, 2, 3], tenant="limited", t_submit=t0 - 10.0),  # bucket empty
        dict(prompt_ids=[1, 2, 3], tenant="limited", t_submit=t0 - 1.0),  # refilled
        dict(prompt_ids=[1, 2], tenant="decoder", max_new_tokens=6, t_submit=t0 - 0.5),
        dict(prompt_ids=[1, 2], tenant="decoder", max_new_tokens=6, t_submit=t0 - 0.49),  # decode budget
    ]
    for i, kw in enumerate(steps):
        j, t = _both(je, te, lambda eng: eng.submit(request_id=f"q{i}", **kw) and "ok")
        assert t == j, (i, j, t)
    assert j == ("QuotaExceeded", "decoder", "batch")
    assert te.quota_total == je.quota_total == 0 and tr == jr == []  # submit raised recordless
    for eng in (je, te):
        rec = eng.record_quota(request_id="gave-up", tenant="decoder", tier="batch")
        assert (rec["completion_reason"], rec["retriable"], rec["tenant"], rec["tier"]) == (
            "quota", True, "decoder", "batch")
        eng.run()
        eng.metrics.sync(eng)
    assert te.quota_total == je.quota_total == 1
    _same_records(jr, tr)
    jf, tf = parse_exposition(je.metrics.registry.render()), parse_exposition(te.metrics.registry.render())
    for fam, key in (("automodel_serve_requests_quota", ()),
                     ("automodel_serve_tier_requests", (("reason", "quota"), ("tier", "batch"))),
                     ("automodel_serve_tenant_requests", (("reason", "quota"), ("tenant", "decoder")))):
        assert tf[fam].samples[key] == jf[fam].samples[key] == 1.0, fam
    assert te.qos_snapshot() == je.qos_snapshot()


def test_shed_lowest_tier_first_and_newcomer_refused(models):
    je, te, jr, tr = _engines(models, max_queue=3)
    now = time.perf_counter()
    subs = [("be-1", "scraper", now), ("b-1", "ebatch", now + 0.001), ("be-2", "scraper", now + 0.002),
            ("i-1", "chat", None), ("be-3", "scraper", None), ("b-2", "ebatch", None), ("b-3", "ebatch", None)]
    outcomes = []
    for rid, tenant, t in subs:
        j, t_ = _both(je, te, lambda eng: eng.submit([1, 2, 3], request_id=rid, tenant=tenant, t_submit=t))
        outcomes.append(t_)
        assert t_ == j, rid
        assert te.shed_total == je.shed_total
        assert {q.rid for q in te._queue} == {q.rid for q in je._queue}
    assert [o for o in outcomes if isinstance(o, tuple)] == [("QueueFull", None, None)] * 2
    assert [r["request_id"] for r in tr] == ["be-2", "be-1"] and te.shed_total == 2
    for eng in (je, te):
        eng.run()
    recs = _same_records(jr, tr)
    assert recs["be-2"][:4] == ("shed", True, "scraper", "best_effort")


def test_record_shed_exactly_once_after_retries(models):
    je, te, jr, tr = _engines(models, max_queue=1)
    for eng in (je, te):
        eng.submit([1, 2, 3], request_id="first", tenant="chat")
    for _ in range(3):  # the retrying front: recordless QueueFull each time
        j, t = _both(je, te, lambda eng: eng.submit([1, 2, 3], tenant="chat"))
        assert t == j == ("QueueFull", None, None)
    assert te.shed_total == je.shed_total == 0 and tr == jr == []
    for eng in (je, te):
        eng.record_shed(request_id="gave-up", tenant="scraper", tier="best_effort")
        eng.run()
        eng.metrics.sync(eng)
    recs = _same_records(jr, tr)
    assert recs["gave-up"][:4] == ("shed", True, "scraper", "best_effort")
    jf, tf = parse_exposition(je.metrics.registry.render()), parse_exposition(te.metrics.registry.render())
    assert tf["automodel_serve_requests_shed"].samples[()] == jf["automodel_serve_requests_shed"].samples[()] == 1.0
    key = (("reason", "shed"), ("tier", "best_effort"))
    assert tf["automodel_serve_tier_requests"].samples[key] == jf["automodel_serve_tier_requests"].samples[key] == 1


def test_drain_rejects_every_tier_and_flushes_queue_retriable(models):
    je, te, jr, tr = _engines(models)
    done = []
    for eng in (je, te):
        eng.submit([1, 2, 3], request_id="q-i", tenant="chat")
        eng.submit([1, 2, 3], request_id="q-b", tenant="ebatch")
        eng.begin_drain()
    j, t = _both(je, te, lambda eng: eng.submit([1, 2, 3], request_id="jumper", tenant="chat", tier="interactive"))
    assert t == j == ("EngineDraining", None, None)
    assert tr == jr == []
    for eng in (je, te):
        done.append(sorted((r["request_id"], r["completion_reason"], r["retriable"]) for r in eng.step()))
        assert eng.idle() and eng.drain_complete() and eng.drain_duration_s is not None
    assert done[1] == done[0] == [("q-b", "draining", True), ("q-i", "draining", True)]
    _same_records(jr, tr)


def test_overload_poisson_mixed_tiers_sheds_lowest_first(models):
    """~2x capacity of mixed tiers into a 6-deep queue, the same arrivals
    (step by step) into both engines: the same requests shed, completed
    and decoded, audits clean after every step, sheds monotone in tier."""
    je, te, jr, tr = _engines(models, max_queue=6)
    tenants = ("chat", "ebatch", "scraper")
    tier_of = {"chat": "interactive", "ebatch": "batch", "scraper": "best_effort"}
    for eng in (je, te):
        rng = np.random.default_rng(20)
        n_arr = 0
        for _ in range(100_000):
            if n_arr >= 60 and eng.idle():
                break
            if n_arr < 60:
                for _ in range(int(rng.poisson(2.0))):
                    if n_arr >= 60:
                        break
                    tenant = tenants[n_arr % 3]
                    rid = f"req-{n_arr}-{tenant}"
                    prompt = rng.integers(1, 64, size=int(rng.integers(2, 7))).tolist()
                    try:
                        eng.submit(prompt, request_id=rid, tenant=tenant)
                    except (jeng.QueueFull, teng.QueueFull):
                        eng.record_shed(request_id=rid, tenant=tenant, tier=tier_of[tenant])
                    n_arr += 1
            eng.step()
            eng.check_invariants()
    recs = _same_records(jr, tr)
    assert len(recs) == 60
    frac = {}
    for tenant in tenants:
        mine = [r for rid, r in recs.items() if rid.endswith(tenant)]
        frac[tier_of[tenant]] = sum(r[0] == "shed" for r in mine) / len(mine)
    assert frac["best_effort"] > 0
    assert frac["interactive"] <= frac["batch"] <= frac["best_effort"]
    assert (te.shed_total, te.completed_total) == (je.shed_total, je.completed_total)
    assert te.qos_snapshot() == je.qos_snapshot()


def test_engine_scrape_carries_tier_and_tenant_labels(models):
    je, te, jr, tr = _engines(models)
    for eng in (je, te):
        eng.submit([1, 2, 3, 4], tenant="chat")
        eng.submit([2, 3, 4], tenant="ebatch")
        eng.run()
        eng.metrics.sync(eng)
    _same_records(jr, tr)
    jf, tf = parse_exposition(je.metrics.registry.render()), parse_exposition(te.metrics.registry.render())
    assert set(tf) == set(jf)
    for fam in ("automodel_serve_tier_requests", "automodel_serve_tenant_requests",
                "automodel_serve_requests_completed"):
        assert tf[fam].samples == jf[fam].samples, fam
    jh, th = jf["automodel_serve_tier_ttft_seconds"].histograms, tf["automodel_serve_tier_ttft_seconds"].histograms
    assert set(th) == set(jh) == {(("tier", "interactive"),), (("tier", "batch"),)}
    assert all(th[k].count == jh[k].count == 1 for k in th)

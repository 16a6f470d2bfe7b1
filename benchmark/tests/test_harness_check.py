"""The comparison that decides ``correct``, on the CPU at a small size: the
reference against the program's plain path (a sound run is correct), and a
run with the timed path broken underneath (not correct): a token altered
where it is produced, and a step that leaves the cache as it was."""

import gc
import weakref

import pytest
import torch

from smallcell import run_small


@pytest.mark.parametrize("config,traffic", [("tiny-qwen2", "tiny-open"),
                                            ("tiny-mistral-int8", "tiny-closed")])
def test_the_reference_agrees_with_the_programs_plain_path(config, traffic):
    frozen = gc.get_freeze_count()
    res = run_small(config, traffic, seed=2**31 + 3)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 3 and res["failed"] == 0
    assert res["checks"]["max_logit_gap"]["value"] <= 1e-3
    assert list(res)[-1] == "checks"
    kv = res["kv"]
    assert 0 < kv["pages_peak"] <= kv["pages"]
    assert kv["peak_bytes"] == kv["pages_peak"] * kv["page_bytes"]
    # The process is served as shipped: the harness freezes no objects
    # out of the collector's reach.
    assert gc.get_freeze_count() == frozen


def test_the_int4_control_fails_the_limit():
    res = run_small("tiny-mistral-int8", "tiny-closed", seed=7, control="int4",
                    limit=0.05)
    assert res["correct"]
    assert res["control"]["max_logit_gap"] > 0.05


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    import swiftllm_tpu_torch.models.llama as llama
    real = llama.exact_greedy

    def altered(logits, mesh=None):
        tokens = real(logits) if mesh is None else real(logits, mesh)
        return torch.where(torch.arange(tokens.numel()) == 0,
                           (tokens + 1) % logits.shape[-1], tokens)
    monkeypatch.setattr(llama, "exact_greedy", altered)
    res = run_small("tiny-qwen2", "tiny-open", seed=11)
    assert not res["correct"]
    assert res["checks"]["max_logit_gap"]["value"] > 1e-3


def test_a_step_that_leaves_the_cache_unchanged_is_not_correct(monkeypatch):
    import swiftllm_tpu_torch.models.llama as llama
    real = llama._attention_and_store

    def stale(q, kv_new, cache, *a, **kw):
        return real(q, kv_new, cache.clone(), *a, **kw)
    monkeypatch.setattr(llama, "_attention_and_store", stale)
    res = run_small("tiny-mistral-int8", "tiny-closed", seed=12)
    assert not res["correct"]


def test_a_request_that_never_finishes_is_not_correct(monkeypatch):
    from harness import serve
    real = serve.consume

    async def dropped(engine, r):
        await real(engine, r)
        if r.k == 1:
            r.done = False
    monkeypatch.setattr(serve, "consume", dropped)
    res = run_small("tiny-qwen2", "tiny-open", seed=13)
    assert not res["correct"] and res["failed"] == 1


def test_the_programs_cache_is_freed_before_the_reference_runs(monkeypatch):
    from harness import check, serve
    caches, alive = [], []
    real_free, real_compare = serve.free, check.compare

    def free(engine):
        caches.append(weakref.ref(engine.model.kv_cache))
        real_free(engine)

    def compare(*a, **kw):
        gc.collect()
        alive.append(caches[0]() is not None)
        return real_compare(*a, **kw)

    monkeypatch.setattr(serve, "free", free)
    monkeypatch.setattr(check, "compare", compare)
    res = run_small("tiny-qwen2", "tiny-open", seed=17)
    assert res["correct"] and alive == [False]

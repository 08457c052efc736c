"""ServingFrontend of deepspeed_tpu_torch against deepspeed_tpu's, token
for token and counter for counter, on the CPU (fp32, tiny Llama-3, the
engine config of tests/test_serving.py).

Each scenario of tests/test_serving.py's frontend section runs through
both packages on the same weights (``torch_serving_parity.both``): the
requests' tokens, finish reasons, states and cached tokens, every
``ServingMetrics`` counter (completed, tokens_out, prefix_tokens_reused,
engine_steps, megasteps, shed, rejected_*, ...) and the arena's page
accounting must be identical. Each scenario also keeps the reference
test's own assertions.
"""

import numpy as np
import pytest

from torch_serving_parity import JAX, TORCH, both, outcome
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _stream_matches_generate(pkg):
    eng = pkg.engine(3)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in (5, 12, 19)]
    refs = pkg.engine(3).generate(prompts, max_new_tokens=6)
    fe = pkg.serving.ServingFrontend(eng, enable_prefix_cache=True)
    seen = {i: [] for i in range(len(prompts))}
    reqs = [fe.submit(p, max_new_tokens=6,
                      stream_cb=lambda t, i=i: seen[i].append(t))
            for i, p in enumerate(prompts)]
    fe.run_until_idle()
    for i, (req, p, ref) in enumerate(zip(reqs, prompts, refs)):
        assert req.state is pkg.serving.RequestState.FINISHED
        expect = [int(t) for t in ref[len(p):]]
        assert req.tokens_out == expect and seen[i] == expect
    assert not eng.state.seqs
    st = fe.stats()
    assert st["completed"] == 3 and st["tokens_out"] == 18
    assert fe.cache.pages_cached > 0
    return outcome(fe, reqs)


def test_frontend_stream_matches_generate():
    both(_stream_matches_generate)


def _prefix_hit(pkg):
    eng = pkg.engine(3)
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, 256, size=33)]
    fe = pkg.serving.ServingFrontend(eng)
    r1 = fe.submit(prompt, max_new_tokens=4)
    fe.run_until_idle()
    steps_cold = fe.metrics.counters["engine_steps"]
    r2 = fe.submit(prompt, max_new_tokens=4)
    fe.run_until_idle()
    assert r2.cached_tokens == 32
    assert r2.tokens_out == r1.tokens_out
    assert fe.metrics.counters["prefix_tokens_reused"] == 32
    return dict(outcome(fe, [r1, r2]), steps_cold=steps_cold,
                hit_rate=fe.cache.hit_rate)


def test_frontend_prefix_hit_skips_prefill_steps():
    got = both(_prefix_hit)
    # the hit prefills one token, the cold run five chunks of 8
    assert got["counters"]["engine_steps"] - got["steps_cold"] \
        < got["steps_cold"]


def _stream_and_cancel(pkg):
    eng = pkg.engine(3)
    fe = pkg.serving.ServingFrontend(eng)
    req = fe.submit([1, 2, 3, 4, 5], max_new_tokens=50)
    got = []
    for tok in fe.stream(req):
        got.append(tok)
        if len(got) == 3:
            req.cancel()
    assert req.state is pkg.serving.RequestState.CANCELLED
    assert got == req.tokens_out[:len(got)] and len(req.tokens_out) < 50
    assert not eng.state.seqs
    return dict(outcome(fe, [req]), streamed=got)


def test_frontend_streaming_iterator_and_cancel():
    both(_stream_and_cancel)


def _rejections(pkg):
    eng = pkg.engine(3, num_blocks=3, max_seq_len=32)
    fe = pkg.serving.ServingFrontend(eng, max_queue=1)
    reasons = []
    for prompt, new in (([*range(30)], 30), ([1] * 30, 2), ([1, 2, 3], 1),
                        ([4, 5, 6], 1)):
        try:
            fe.submit(prompt, max_new_tokens=new)
            reasons.append(None)
        except pkg.serving.AdmissionError as e:
            reasons.append(e.reason)
    assert reasons == ["too_long", "kv_exhausted", None, "queue_full"]
    fe.run_until_idle()
    return dict(outcome(fe, []), reasons=reasons)


def test_frontend_rejects_with_reason():
    got = both(_rejections)
    c = got["counters"]
    assert c["rejected_too_long"] == c["rejected_kv_exhausted"] == \
        c["rejected_queue_full"] == c["completed"] == 1


def _deadline_shed(pkg):
    eng = pkg.engine(3)
    t = [0.0]
    fe = pkg.serving.ServingFrontend(eng, clock=lambda: t[0])
    doomed = fe.submit([1, 2, 3], max_new_tokens=4, timeout=5.0)
    ok = fe.submit([4, 5, 6], max_new_tokens=4)
    t[0] = 10.0
    fe.run_until_idle()
    assert doomed.state is pkg.serving.RequestState.SHED
    assert doomed.finish_reason == "deadline"
    assert ok.state is pkg.serving.RequestState.FINISHED
    running = fe.submit([7, 8, 9], max_new_tokens=64, timeout=5.0)
    fe.step()
    assert running.state is pkg.serving.RequestState.RUNNING
    t[0] = 20.0
    fe.run_until_idle()
    assert running.state is pkg.serving.RequestState.SHED
    assert not eng.state.seqs
    return outcome(fe, [doomed, ok, running])


def test_frontend_deadline_shed():
    assert both(_deadline_shed)["counters"]["shed"] == 2


def _small_budget(pkg):
    eng = pkg.engine(3)
    fe = pkg.serving.ServingFrontend(eng, token_budget=4)
    rng = np.random.default_rng(8)
    reqs = [fe.submit([int(x) for x in rng.integers(0, 256, size=11)],
                      max_new_tokens=3) for _ in range(4)]
    fe.run_until_idle()
    assert all(r.state is pkg.serving.RequestState.FINISHED for r in reqs)
    assert all(len(r.tokens_out) == 3 for r in reqs)
    return outcome(fe, reqs)


def test_frontend_small_budget_still_drains():
    both(_small_budget)


def _shared_prefix_stream(pkg, megastep):
    """bench_inference.py's shared_prefix_stream at the tiny size: a warm
    request that is only the shared prefix, then requests of the prefix
    plus unique tails submitted at once; prefix hits go through the COW
    partial page (the prefix ends mid-page)."""
    eng = pkg.engine(1, num_blocks=48)
    fe = pkg.serving.ServingFrontend(eng, megastep_tokens=megastep)
    rng = np.random.default_rng(11)
    prefix = [int(t) for t in rng.integers(0, 256, size=21)]
    warm = fe.submit(prefix, max_new_tokens=2)
    fe.run_until_idle()
    reqs = [fe.submit(prefix + [int(t) for t in
                                rng.integers(0, 256, size=3 + 4 * i)],
                      max_new_tokens=5 + i) for i in range(4)]
    fe.run_until_idle()
    assert [r.cached_tokens for r in reqs] == [21] * 4
    assert all(r.finish_reason == "length" for r in reqs)
    return outcome(fe, [warm] + reqs)


@pytest.mark.parametrize("megastep", [0, 8])
def test_frontend_shared_prefix_stream(megastep):
    got = both(lambda pkg: _shared_prefix_stream(pkg, megastep))
    assert got["counters"]["prefix_tokens_reused"] == 4 * 21
    assert (got["counters"]["megasteps"] > 0) == (megastep > 0)


def test_unported_options_raise():
    """The port raises, naming the module it lacks, where the reference
    would turn on a feature the port does not have; the engine is left
    untouched (no policy installed)."""
    eng = TORCH.engine(0)
    Frontend = TORCH.serving.ServingFrontend
    with pytest.raises(NotImplementedError, match="telemetry/explain.py"):
        Frontend(eng, slo_admission=True)
    with pytest.raises(NotImplementedError, match="serving/kvtier.py"):
        Frontend(eng, kvtier=object())
    assert eng.scheduler.policy is None
    for config, module in (
            ({"kvtier": {"enabled": True}}, "serving/kvtier.py"),
            ({"telemetry": {"history_file": "h.jsonl"}},
             "telemetry/timeseries.py"),
            ({"slo": {"objectives": ["serving/ttft_seconds:p95 <= 0.5"]}},
             "telemetry/slo.py"),
            ({"telemetry": {"goodput": {"enabled": True}}},
             "telemetry/goodput.py")):
        with pytest.raises(NotImplementedError, match=module):
            Frontend(eng, config=config)
    # the ported keys read the same in both packages, from a dict or a
    # config object
    for cfg in ({"serving": {"megastep_tokens": 16,
                             "megastep_adaptive": False},
                 "resilience": {"serving_retry_budget": 5}},):
        want = JAX.serving.ServingFrontend(JAX.engine(0), config=cfg)
        for config in (cfg, TORCH.config(**cfg)):
            got = Frontend(TORCH.engine(0), config=config)
            assert (got.megastep_tokens, got.megastep_adaptive,
                    got.retry_budget) == (want.megastep_tokens,
                                          want.megastep_adaptive,
                                          want.retry_budget) == (16, False,
                                                                 5)
    with pytest.raises(ValueError, match="megastep_tokens"):
        Frontend(eng, megastep_tokens=-1)

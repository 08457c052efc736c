"""The pure-Python serving layer of deepspeed_tpu_torch against
deepspeed_tpu's, on the same operation sequences: the ref-counted
allocator and its rollback, the radix prefix cache (match, insert, LRU
evict, exclude, invalidate; a hypothesis sequence test), the SplitFuse
TokenBudgetPolicy, the admission queue, the histograms and the
Prometheus text, and the config keys of the serving slice. Results must
be identical, exceptions included."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepspeed_tpu.telemetry.registry import MetricsRegistry as JRegistry
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry
from torch_serving_parity import JAX, PACKAGES, TORCH


def _run(pkg, program, fn):
    """Apply ``fn(pkg, op)`` for each op, recording results and errors."""
    out = []
    for op in program:
        try:
            out.append(("ok", fn(pkg, op)))
        except (RuntimeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def _both(program, fn, setup):
    results = []
    for pkg in PACKAGES:
        ctx = setup(pkg)
        results.append(_run(pkg, program, lambda p, op: fn(ctx, op)))
    assert results[1] == results[0]
    return results[0]


# ---------------------------------------------------------------------------
# allocator refcounts and rollback
# ---------------------------------------------------------------------------

def _alloc_op(ctx, op):
    st_, held = ctx
    a = st_.allocator
    kind, arg = op
    if kind == "allocate":
        held.append(a.allocate(arg))
    elif kind == "incref":
        a.incref(held[arg % len(held)] if held else [0])
    elif kind == "free":
        return a.free(held[arg % len(held)] if held else [99])
    elif kind == "adopt":
        blocks = held.pop(0) if held else []
        st_.adopt(arg, list(range(arg)), blocks, seen_tokens=len(blocks) * 4)
    elif kind == "extend":
        st_.extend(arg, [1] * 9)
    elif kind == "flush":
        st_.flush(arg)
    return (a.free_blocks, a.live_blocks, a.total_refs(),
            {u: (s.blocks, s.seen_tokens) for u, s in st_.seqs.items()})


def test_allocator_refcounts_and_rollback():
    program = [("allocate", 2), ("incref", 0), ("free", 0), ("free", 0),
               ("free", 0), ("allocate", 3), ("adopt", 11),
               ("adopt", 30),               # tail does not fit: rolled back
               ("extend", 11), ("extend", 12), ("allocate", 9),
               ("flush", 11), ("flush", 12), ("incref", 5), ("free", 7)]
    got = _both(program, _alloc_op,
                lambda pkg: (pkg.ragged.DSStateManager(
                    max_sequences=4, num_blocks=10, block_size=4), []))
    assert ("RuntimeError" in {r[0] for r in got})


# ---------------------------------------------------------------------------
# radix prefix cache: match / insert / evict / LRU / exclude / invalidate
# ---------------------------------------------------------------------------

BASES = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13],
         [1, 2, 3, 4, 5, 6, 7, 8, 20, 21, 22, 23, 24, 25],
         [1, 2, 3, 4, 30, 31, 32, 33, 34],
         [40, 41, 42, 43, 44, 45, 46, 47, 48, 49]]


def _cache_setup(pkg):
    alloc = pkg.ragged.BlockedAllocator(24, 4)
    return alloc, pkg.serving.PrefixCache(alloc, max_pages=8), []


def _cache_op(ctx, op):
    alloc, cache, held = ctx
    kind, which, n = op
    toks = BASES[which][:max(1, n)]
    res = None
    if kind == "insert":
        # a finished request publishes its prompt pages, then lets go
        blocks = alloc.allocate(-(-len(toks) // 4))
        res = cache.insert(toks, blocks)
        alloc.free(blocks)
    elif kind == "match":
        m = cache.match(toks)
        res = (m.full_blocks, m.partial_block, m.partial_len)
    elif kind == "hold":
        # a live sequence aliases the matched full pages
        m = cache.match(toks)
        alloc.incref(m.full_blocks)
        held.append(m.full_blocks)
        res = m.full_blocks
    elif kind == "release":
        if held:
            res = alloc.free(held.pop(n % len(held)))
    elif kind == "evict":
        exclude = cache.owned_blocks()[:which]
        res = cache.evict(n % 5 + 1, exclude_blocks=exclude)
    elif kind == "invalidate":
        res = cache.invalidate(toks)
    return (res, alloc.free_blocks, alloc.total_refs(), cache.pages_cached,
            sorted(cache.owned_blocks()), cache.evictable_pages(),
            cache.hits, cache.lookups, cache.tokens_hit)


_OPS = st.tuples(st.sampled_from(["insert", "match", "hold", "release",
                                  "evict", "invalidate"]),
                 st.integers(0, 3), st.integers(0, 14))


def test_prefix_cache_scripted():
    program = [("insert", 0, 13), ("match", 1, 14), ("hold", 1, 14),
               ("insert", 1, 14), ("insert", 2, 9), ("match", 2, 6),
               ("insert", 3, 10), ("evict", 1, 2), ("match", 0, 13),
               ("release", 0, 0), ("evict", 0, 4), ("invalidate", 1, 14),
               ("insert", 0, 11), ("match", 0, 12), ("invalidate", 0, 3)]
    got = _both(program, _cache_op, _cache_setup)
    full, partial, _ = got[1][1][0]       # base 1 shares two full pages
    assert len(full) == 2 and partial is None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.lists(_OPS, min_size=1, max_size=30))
def test_prefix_cache_sequences(program):
    _both(program, _cache_op, _cache_setup)


# ---------------------------------------------------------------------------
# TokenBudgetPolicy: selection, round-robin, starvation freedom
# ---------------------------------------------------------------------------

def _policy_run(pkg, budget):
    state = pkg.ragged.DSStateManager(max_sequences=16, num_blocks=64,
                                      block_size=8)
    policy = pkg.serving.TokenBudgetPolicy()
    rng = np.random.default_rng(budget)
    served = {}
    rounds = []
    for step in range(40):
        if step % 3 == 0 and len(state.seqs) < 10:
            uid = 100 - step                 # arbitrary, not arrival order
            state.extend(uid, list(rng.integers(1, 200,
                                                size=int(rng.integers(1, 20)))))
            policy.note_arrival(uid)
        picks = policy.select(state, budget, 8)
        for uid, take in picks:
            seq = state.seqs[uid]
            seq.seen_tokens += take
            served[uid] = step
            if seq.pending == 0:
                if len(seq.tokens) > 24:
                    state.flush(uid)
                    policy.forget(uid)
                else:
                    state.extend(uid, [7])
        rounds.append((picks, policy.decode_backlog(state)))
    # the decode rows left at the end, with the last step that served each
    return rounds, {u: served.get(u) for u, q in state.seqs.items()
                    if q.pending == 1}


@pytest.mark.parametrize("budget", [3, 16])
def test_token_budget_policy(budget):
    want = _policy_run(JAX, budget)
    got = _policy_run(TORCH, budget)
    assert got == want
    rounds, served = got
    # a budget below the decode population rotates: every decode row was
    # served within the last ceil(rows / budget) steps
    bound = -(-len(served) // budget)
    assert served and all(s is not None and 39 - s < bound
                          for s in served.values()), served


# ---------------------------------------------------------------------------
# admission queue: priority, shedding, cancel
# ---------------------------------------------------------------------------

def _queue_run(pkg):
    q = pkg.serving.AdmissionQueue(max_depth=3)
    Req = pkg.serving.Request
    reqs = [Req(prompt=[i], priority=p, deadline=d)
            for i, (p, d) in enumerate([(0, None), (2, 5.0), (1, None),
                                        (2, None), (0, 3.0), (5, None)])]
    log = []
    for i, r in enumerate(reqs[:4]):
        try:
            victim = q.submit(r, now=float(i))
            log.append(("submitted", i, victim.prompt if victim else None))
        except pkg.serving.AdmissionError as e:
            log.append(("rejected", i, e.reason))
    reqs[2].cancel()
    log.append(("pop", q.pop_next(1.0).prompt))
    log.append(("submit", q.submit(reqs[4], now=2.0)))
    log.append(("shed", [r.prompt for r in q.shed_expired(4.0)]))
    victim = q.submit(reqs[5], now=6.0)
    log.append(("victim", victim.prompt if victim else None))
    while True:
        r = q.pop_next(7.0)
        if r is None:
            break
        log.append(("pop", r.prompt))
    log.append([(r.state.value, r.finish_reason) for r in reqs])
    return log


def test_admission_queue_priority_shed_cancel():
    assert _queue_run(TORCH) == _queue_run(JAX)


# ---------------------------------------------------------------------------
# histograms and the Prometheus text of the serving/* series
# ---------------------------------------------------------------------------

def _metrics_run(registry_cls, serving):
    reg = registry_cls()
    m = serving.ServingMetrics()
    values = [1e-4, 3e-3, 0.02, 0.02, 0.5, 7.0, 120.0]
    for v in values:
        m.ttft.record(v)
        m.tpot.record(v / 10)
    for d in (0, 1, 3, 9, 5000):
        m.queue_depth.record(float(d))
    for name, h in (("serving/ttft_seconds", m.ttft),
                    ("serving/tpot_seconds", m.tpot),
                    ("serving/queue_depth", m.queue_depth)):
        reg.register(name, h, help=name)
    reg.counter("serving/admitted", help="admitted").inc(7)
    reg.gauge("resilience/serving_degraded", help="d").set(1.0)
    return (m.ttft.counts, m.ttft.summary(), m.tpot.summary(),
            m.queue_depth.summary(), m.events(step=3),
            reg.prometheus_text())


def test_histograms_and_prometheus_text():
    want = _metrics_run(JRegistry, JAX.serving)
    got = _metrics_run(TRegistry, TORCH.serving)
    assert got == want
    assert "serving_ttft_seconds_bucket" in got[-1]


# ---------------------------------------------------------------------------
# config: the serving slice's keys validate as in the JAX schema
# ---------------------------------------------------------------------------

def test_config_serving_resilience_telemetry_keys():
    cfg = {"serving": {"megastep_tokens": 8, "megastep_adaptive": False},
           "resilience": {"serving_retry_budget": 3,
                          "fault_plan": "serving_step:4:engine_error"},
           "telemetry": {"enabled": True, "trace_buffer_events": 64,
                         "jax_annotations": True,
                         "reqtrace": {"enabled": True, "head_sample": 0.5}}}
    j, t = JAX.config(**cfg), TORCH.config(**cfg)
    for block, keys in (("serving", ("megastep_tokens",
                                     "megastep_adaptive")),
                        ("resilience", ("serving_retry_budget",
                                        "fault_plan")),
                        ("telemetry", ("enabled", "trace_buffer_events",
                                       "jax_annotations"))):
        for k in keys:
            assert getattr(getattr(t, block), k) == \
                getattr(getattr(j, block), k)
    assert t.telemetry.reqtrace.model_dump() == \
        j.telemetry.reqtrace.model_dump()
    for bad in ({"serving": {"megastep_tokens": -1}},
                {"resilience": {"serving_retry_budget": -1}},
                {"telemetry": {"reqtrace": {"head_sample": 2.0}}}):
        with pytest.raises(ValueError):
            TORCH.config(**bad)
        with pytest.raises(ValueError):
            JAX.config(**bad)
    # the port parses the plan when the config is read (the reference
    # parses it when the injector is armed)
    with pytest.raises(ValueError, match="not a number"):
        TORCH.config(resilience={"fault_plan": "serving_step:x:hang"})
    # the training step's and the checkpoint store's hooks are ported
    t = TORCH.config(resilience={
        "fault_plan": "step:3:preempt;step:4:io_error:checkpoint",
        "ckpt_io_retries": 5})
    assert t.resilience.ckpt_io_retries == 5
    for bad, match in (
            ({"resilience": {"fault_plan": "step:3:preempt:launcher"}},
             "fault hook"),
            ({"resilience": {"fault_plan":
                             "serving_step:3:replica_kill:router"}},
             "fault hook"),
            ({"resilience": {"fault_plan": "step:3:nonfinite_grad:"
                                           "checkpoint"}}, "fault hook"),
            ({"telemetry": {"health": {"enabled": True}}},
             "telemetry/health.py"),
            ({"telemetry": {"watchdog": {"enabled": True}}}, "watchdog"),
            ({"router": {"replicas": 3}}, "serving/router.py"),
            ({"autoscale": {"enabled": True}}, "serving/autoscaler.py")):
        with pytest.raises(NotImplementedError, match=match):
            TORCH.config(**bad)


def test_training_engine_applies_telemetry_config():
    """The port's training engine applies its ``telemetry`` block as the
    JAX engine's ``_init_telemetry`` does (enable-only): span tracing with
    its ring size and profiler labels, and request tracing."""
    from deepspeed_tpu_torch import initialize, llama3_config, telemetry
    tr, rt = telemetry.tracer, telemetry.reqtrace
    try:
        initialize(llama3_config("tiny"),
                   {"train_micro_batch_size_per_gpu": 1,
                    "telemetry": {"enabled": True,
                                  "trace_buffer_events": 32,
                                  "jax_annotations": True,
                                  "reqtrace": {"enabled": True,
                                               "head_sample": 1.0}}},
                   device="cpu")
        assert tr.enabled and tr.jax_annotations and tr._buf.maxlen == 32
        assert rt.enabled and rt.head_sample == 1.0
        # enable-only: a config with telemetry off silences nothing
        initialize(llama3_config("tiny"),
                   {"train_micro_batch_size_per_gpu": 1}, device="cpu")
        assert tr.enabled and rt.enabled
    finally:
        tr.configure(enabled=False, jax_annotations=False,
                     buffer_events=100_000)
        rt.configure(enabled=False, head_sample=0.0)

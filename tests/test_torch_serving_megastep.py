"""The port's ServingFrontend against deepspeed_tpu's on the decode
megastep, the engine-fault failure domain and KV-page handoff, token for
token and counter for counter (CPU, fp32, tiny Llama-3).

Scenarios of tests/test_megastep.py (the ``_pick_megastep`` policy,
cancel at a window boundary, EOS inside a window, staggered retirement,
the stream stall error), tests/test_resilience.py (an engine fault
requeues without losing a request, an exhausted retry budget ends in
"error", /healthz is degraded while retries drain) and
tests/test_disagg.py (a handoff bundle round trip with page accounting),
each run through both packages on the same weights. Sampled streams are
not compared: the port draws from a ``torch.Generator`` (ROADMAP C,
"Differences by design").
"""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_serving_parity import ENG_CFG, JAX, PACKAGES, TORCH, both, \
    outcome, prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _disarmed():
    for pkg in PACKAGES:
        pkg.faults.disarm()
    yield
    for pkg in PACKAGES:
        pkg.faults.disarm()


def _serve(pkg, megastep, max_new, eos=None, n=3):
    eng = pkg.engine(0)
    fe = pkg.serving.ServingFrontend(eng, enable_prefix_cache=False,
                                     megastep_tokens=megastep,
                                     megastep_adaptive=False)
    max_new = [max_new] * n if isinstance(max_new, int) else max_new
    reqs = [fe.submit(p, max_new_tokens=m, eos_token_id=eos)
            for p, m in zip(prompts(n), max_new)]
    fe.run_until_idle()
    return outcome(fe, reqs)


@pytest.mark.parametrize("k", [1, 8, 32])
def test_megastep_argmax_parity(k):
    """K ∈ {1, 8, 32}: the same tokens as the stepwise run, in both
    packages, with the same engine steps and megastep counts."""
    base = both(lambda pkg: _serve(pkg, 0, 12))
    got = both(lambda pkg: _serve(pkg, k, 12))
    assert [r[:2] for r in got["requests"]] == \
        [r[:2] for r in base["requests"]]
    assert (got["counters"]["megasteps"] > 0) == (k > 1)


def test_megastep_eos_and_staggered_retirement():
    base = _serve(JAX, 0, 12)
    eos = base["requests"][0][0][2]
    got = both(lambda pkg: _serve(pkg, 8, 12, eos=eos))
    assert got["requests"][0][:2] == (base["requests"][0][0][:3], "eos")
    got = both(lambda pkg: _serve(pkg, 8, [4, 9, 17]))
    assert [len(r[0]) for r in got["requests"]] == [4, 9, 17]


def _cancel_at_boundary(pkg):
    eng = pkg.engine(0)
    fe = pkg.serving.ServingFrontend(eng, enable_prefix_cache=False,
                                     megastep_tokens=8,
                                     megastep_adaptive=False)
    req = fe.submit(prompts(1)[0], max_new_tokens=64)
    it = fe.stream(req)
    first = [next(it) for _ in range(10)]
    fe.cancel(req)
    rest = list(it)
    assert rest == req.tokens_out[10:] and req.state.value == "cancelled"
    assert eng.state.allocator.free_blocks == ENG_CFG["num_blocks"]
    return dict(outcome(fe, [req]), streamed=first + rest)


def test_megastep_cancel_at_boundary():
    both(_cancel_at_boundary)


def _pick_policy(pkg):
    """test_megastep.py:172 step by step: the K each pump would pick."""
    eng = pkg.engine(0, max_sequences=2)
    fe = pkg.serving.ServingFrontend(eng, enable_prefix_cache=False,
                                     megastep_tokens=32,
                                     megastep_adaptive=False)
    picks = [fe._pick_megastep(0.0)]
    r1 = fe.submit(prompts(1)[0], max_new_tokens=20)
    fe.step()
    picks.append(fe._pick_megastep(fe.clock()))
    while eng.state.seqs[r1.uid].pending != 1:
        fe.step()
    k_free = fe._pick_megastep(fe.clock())
    assert 1 < k_free <= 20 - len(r1.tokens_out)
    r2 = fe.submit(prompts(2, seed=1)[1], max_new_tokens=3)
    fe.step()
    while eng.state.seqs.get(r2.uid) is None or \
            eng.state.seqs[r2.uid].pending != 1:
        fe.step()
    r3 = fe.submit(prompts(1, seed=2)[0], max_new_tokens=8)
    k_gated = fe._pick_megastep(fe.clock())
    assert k_gated <= max(1, min(20 - len(r1.tokens_out),
                                 3 - len(r2.tokens_out)))
    fe.run_until_idle()
    # adaptive mode with a shallow batch and a decode step time from
    # cost records: deadlines pull K toward 1
    fe.megastep_adaptive = True
    fe.cost_records = {"decode": {"predicted_s": 0.5}}
    r4 = fe.submit(prompts(1, seed=3)[0], max_new_tokens=30,
                   deadline=fe.clock() + 1e6)
    while eng.state.seqs.get(r4.uid) is None or \
            eng.state.seqs[r4.uid].pending != 1:
        fe.step()
    picks += [k_free, k_gated, fe._pick_megastep(fe.clock())]
    fe.run_until_idle()
    return dict(outcome(fe, [r1, r2, r3, r4]), picks=picks)


def test_pick_megastep_policy():
    picks = both(_pick_policy)["picks"]
    assert picks[0] == 1 and picks[-1] < picks[-3]


def _stall(pkg):
    fe = pkg.serving.ServingFrontend(pkg.engine(0),
                                     enable_prefix_cache=False)
    orphan = pkg.serving.Request(prompt=[1, 2, 3])
    with pytest.raises(RuntimeError, match="queue_depth=0") as exc:
        list(fe.stream(orphan, poll_interval=0.001, stall_timeout=0.05))
    # the message names the request's uid, which each package counts
    return re.sub(r"uid=\d+", "uid", str(exc.value))


def test_stream_stall_raises_with_context():
    both(_stall)


def _counter(pkg, name):
    c = pkg.registry.get(name)
    return c.value if c is not None else 0.0


def _engine_fault(pkg):
    fe = pkg.serving.ServingFrontend(pkg.engine(0), retry_budget=2)
    reqs = [fe.submit([1 + i, 2, 3], max_new_tokens=4) for i in range(3)]
    pkg.faults.arm("serving_step:2:engine_error", _env=False)
    faults0 = _counter(pkg, "resilience/serving_engine_faults")
    rec0 = _counter(pkg, "resilience/recoveries")
    fe.run_until_idle()
    assert _counter(pkg, "resilience/serving_engine_faults") == faults0 + 1
    assert _counter(pkg, "resilience/recoveries") == rec0 + 1
    assert all(r.done and r.finish_reason == "length"
               and len(r.tokens_out) == 4 for r in reqs)
    assert any(r.retries == 1 for r in reqs)
    alloc = fe.engine.state.allocator
    assert alloc.free_blocks + fe.cache.pages_cached == alloc.num_blocks
    return outcome(fe, reqs)


def test_serving_engine_fault_requeues_no_lost_requests():
    got = both(_engine_fault)
    assert got["counters"]["requeued_engine_fault"] == 3


def _retry_exhausted(pkg):
    fe = pkg.serving.ServingFrontend(pkg.engine(0), retry_budget=0)
    req = fe.submit([5, 6, 7], max_new_tokens=4)
    pkg.faults.arm("serving_step:2:engine_error", _env=False)
    toks = list(fe.stream(req, stall_timeout=10.0))
    assert req.done and req.finish_reason == "error"
    assert toks == req.tokens_out
    return outcome(fe, [req])


def test_serving_retry_budget_exhausted_streams_error():
    both(_retry_exhausted)


def _degraded(pkg):
    fe = pkg.serving.ServingFrontend(pkg.engine(0), retry_budget=2,
                                     http_port=0)
    codes = []

    def probe():
        url = f"http://127.0.0.1:{fe._http.port}/healthz"
        try:
            with urllib.request.urlopen(url) as r:
                codes.append((r.status, json.loads(r.read())["status"]))
        except urllib.error.HTTPError as e:
            codes.append((e.code, json.loads(e.read())["status"]))

    try:
        probe()
        req = fe.submit([9, 8, 7], max_new_tokens=8)
        pkg.faults.arm("serving_step:2:engine_error", _env=False)
        fe.step()
        fe.step()
        probe()
        fe.run_until_idle()
        probe()
    finally:
        fe.close()
    return dict(outcome(fe, [req]), codes=codes)


def test_serving_degraded_healthz_while_retries_drain():
    got = both(_degraded)
    assert [c for c, _ in got["codes"]] == [200, 503, 200]
    assert got["codes"][1][1] == "degraded"


def _handoff(pkg):
    """test_disagg.py:328: export is read-only on the source, adopt leaves
    the destination cache as the pages' only owner, a re-adopt leaks
    nothing and the source invalidate releases the subtree once."""
    s = pkg.serving
    src = s.ServingFrontend(pkg.engine(0))
    dst = s.ServingFrontend(pkg.engine(0))
    prompt = [5, 4, 3, 2, 1, 6, 7, 8, 9, 10, 11, 12]
    src.submit(prompt, max_new_tokens=1)
    src.run_until_idle()
    src_alloc = src.engine.state.allocator
    dst_alloc = dst.engine.state.allocator
    owned_src = sorted(src.cache.owned_blocks())
    free_src0 = src_alloc.free_blocks
    bundle = s.export_bundle(src, prompt)
    assert bundle is not None and s.verify_bundle(bundle)
    assert bundle.num_pages == 2 and bundle.tokens == prompt
    assert src_alloc.free_blocks == free_src0
    assert sorted(src.cache.owned_blocks()) == owned_src
    free_dst0 = dst_alloc.free_blocks
    added = [s.adopt_bundle(dst, bundle)]
    owned_dst = dst.cache.owned_blocks()
    assert all(dst_alloc.refcount(b) == 1 for b in owned_dst)
    again = s.export_bundle(dst, prompt)
    for key in ("k", "v"):
        assert (again.pages[key] == bundle.pages[key]).all()
    added.append(s.adopt_bundle(dst, bundle))
    released = src.cache.invalidate(prompt)
    # the destination serves the prompt from the adopted pages
    req = dst.submit(prompt, max_new_tokens=4)
    dst.run_until_idle()
    return dict(outcome(dst, [req]), added=added, released=released,
                nbytes=bundle.nbytes,
                free_dst=(free_dst0, dst_alloc.free_blocks),
                src_cached=src.cache.pages_cached), bundle.pages


def test_handoff_bundle_roundtrip_page_accounting():
    (want, want_pages), (got, got_pages) = _handoff(JAX), _handoff(TORCH)
    assert got == want
    # the pages hold each package's own KV: equal to fp32 rounding
    for key in ("k", "v"):
        np.testing.assert_allclose(got_pages[key], want_pages[key],
                                   rtol=1e-5, atol=1e-5)
    assert got["added"] == [2, 0] and got["released"] == 2
    assert got["requests"][0][3] == 11          # cached_tokens
    assert got["src_cached"] == 0


def test_cross_package_handoff():
    """A bundle exported by the JAX frontend (fp32 pages) and adopted by
    the port's frontend serves the prompt with the JAX frontend's tokens,
    from the bundle's pages."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]
    src = JAX.serving.ServingFrontend(JAX.engine(0))
    want = src.submit(prompt, max_new_tokens=6)
    src.run_until_idle()
    bundle = JAX.serving.export_bundle(src, prompt)
    assert JAX.serving.verify_bundle(bundle)
    port_bundle = TORCH.serving.PageBundle(
        tokens=bundle.tokens, block_size=bundle.block_size,
        pages=bundle.pages, checksum=bundle.checksum)
    assert TORCH.serving.verify_bundle(port_bundle)
    dst = TORCH.serving.ServingFrontend(TORCH.engine(0))
    assert TORCH.serving.adopt_bundle(dst, port_bundle) == 2
    got = dst.submit(prompt, max_new_tokens=6)
    dst.run_until_idle()
    assert got.cached_tokens == len(prompt) - 1
    assert got.tokens_out == want.tokens_out
    # and back: the port's export of those pages is the JAX bundle's bytes
    back = TORCH.serving.export_bundle(dst, prompt)
    assert back.checksum == bundle.checksum

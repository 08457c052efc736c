"""The engine side of the serving front end in deepspeed_tpu_torch:
``cow_block``, ``export_pages``/``import_pages``, ``kv_page_nbytes``,
prefix-hit logits, and the telemetry the engine drives, against
deepspeed_tpu on the CPU (tiny Llama-3, tests/test_serving.py's engine
config).

Tolerances: a page-aligned prefix hit reruns only the last token and
must give the cold prefill's logits within rtol 1e-5 / atol 1e-6, a hit
through the copy-on-write page (other chunking) within rtol 1e-4 / atol
1e-5, both as tests/test_serving.py:326 and :346 hold the JAX engine;
the port's logits against the JAX engine's within 2e-4 (fp32, different
summation order). Page round trips are bit for bit.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference import engine_v2 as te
from torch_serving_parity import JAX, LOGIT_TOL, TORCH


def _arena_ptrs(eng):
    return {k: eng.arena[k].data_ptr() for k in ("k", "v")}


def test_cow_block_copies_all_layers_in_place():
    eng = TORCH.engine(0)
    alloc = eng.state.allocator
    src = alloc.allocate(1)[0]
    nl = eng.model_config.num_layers
    stride = eng.arena["k"].shape[1] // nl
    for layer in range(nl):
        eng.arena["k"][:, layer * stride + src] = float(layer + 1)
        eng.arena["v"][:, layer * stride + src] = -float(layer + 1)
    ptrs = _arena_ptrs(eng)
    dst = eng.cow_block(src)
    assert dst != src and alloc.refcount(dst) == 1
    # the captured decode graphs read the arena's storage: never rebound
    assert _arena_ptrs(eng) == ptrs
    for layer in range(nl):
        for key, sign in (("k", 1.0), ("v", -1.0)):
            got = eng.arena[key][:, layer * stride + dst]
            assert torch.equal(got, eng.arena[key][:, layer * stride + src])
            assert bool((got == sign * (layer + 1)).all())
    alloc.free([src, dst])


def _aligned_hit(pkg):
    eng = pkg.engine(0)
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, 256, size=17)]
    cold = eng.put([0], [prompt])[0]
    cache = pkg.serving.PrefixCache(eng.state.allocator)
    cache.insert(prompt, eng.state.seqs[0].blocks)
    matched = pkg.serving.adopt_cached(eng, cache, 1, prompt)
    assert matched == 16
    assert eng.state.seqs[1].blocks[:2] == eng.state.seqs[0].blocks[:2]
    hit = eng.step()
    assert set(hit) == {1}
    np.testing.assert_allclose(hit[1], cold, rtol=1e-5, atol=1e-6)
    return np.asarray(cold), np.asarray(hit[1])


def _cow_hit(pkg):
    eng = pkg.engine(0)
    rng = np.random.default_rng(1)
    base = [int(t) for t in rng.integers(0, 256, size=17)]
    prompt = base + [int(t) for t in rng.integers(0, 256, size=3)]
    eng.put([0], [base])
    cache = pkg.serving.PrefixCache(eng.state.allocator)
    cache.insert(base, eng.state.seqs[0].blocks)
    ptrs = _arena_ptrs(eng) if pkg is TORCH else None
    matched = pkg.serving.adopt_cached(eng, cache, 1, prompt)
    assert matched == 17
    assert eng.state.seqs[1].blocks[2] != eng.state.seqs[0].blocks[2]
    if ptrs is not None:
        assert _arena_ptrs(eng) == ptrs
    out = {}
    while True:
        r = eng.step()
        if r is None:
            break
        out.update(r)
    cold = pkg.engine(0).put([0], [prompt])[0]
    np.testing.assert_allclose(out[1], cold, rtol=1e-4, atol=1e-5)
    assert int(np.argmax(out[1])) == int(np.argmax(cold))
    return np.asarray(cold), np.asarray(out[1])


@pytest.mark.parametrize("scenario", [_aligned_hit, _cow_hit],
                         ids=["aligned", "cow"])
def test_prefix_hit_logits_match_cold_prefill_and_jax(scenario):
    want_cold, want_hit = scenario(JAX)
    got_cold, got_hit = scenario(TORCH)
    np.testing.assert_allclose(got_cold, want_cold, **LOGIT_TOL)
    np.testing.assert_allclose(got_hit, want_hit, **LOGIT_TOL)


def _prefilled(pkg, dtype="float32", key=0):
    eng = pkg.engine(key, dtype=dtype)
    rng = np.random.default_rng(4)
    eng.put([0], [[int(t) for t in rng.integers(0, 256, size=13)]])
    return eng, list(eng.state.seqs[0].blocks)


def test_export_import_roundtrip_fp32():
    src, blocks = _prefilled(TORCH)
    pages = src.export_pages(blocks)
    assert pages["k"].dtype == np.float32
    L = src.model_config.num_layers
    kvh, dh = src.model_config.kv_heads, src.model_config.head_dim
    assert pages["k"].shape == (kvh, L, 2, 8, dh)
    dst = TORCH.engine(1)
    ids = dst.state.allocator.allocate(2)
    ptrs = _arena_ptrs(dst)
    dst.import_pages(pages, ids)
    assert _arena_ptrs(dst) == ptrs
    again = dst.export_pages(ids)
    for key in ("k", "v"):
        np.testing.assert_array_equal(again[key], pages[key])
    # the same payload as the JAX engine's export of the same prefill
    jsrc, jblocks = _prefilled(JAX)
    jpages = jsrc.export_pages(jblocks)
    for key in ("k", "v"):
        assert jpages[key].shape == pages[key].shape
        np.testing.assert_allclose(pages[key], jpages[key], rtol=1e-5,
                                   atol=1e-5)
    assert src.kv_page_nbytes() == jsrc.kv_page_nbytes() \
        == pages["k"][:, :, :1].nbytes * 2


def test_export_import_roundtrip_bf16_as_uint16():
    src, blocks = _prefilled(TORCH, "bfloat16")
    pages = src.export_pages(blocks)
    assert pages["k"].dtype == np.uint16
    dst = TORCH.engine(1, dtype="bfloat16")
    ids = dst.state.allocator.allocate(2)
    ptrs = _arena_ptrs(dst)
    dst.import_pages(pages, ids)
    assert _arena_ptrs(dst) == ptrs
    for key in ("k", "v"):
        np.testing.assert_array_equal(dst.export_pages(ids)[key],
                                      pages[key])
    # a JAX bf16 export (ml_dtypes.bfloat16) goes in bit for bit
    jsrc, jblocks = _prefilled(JAX, "bfloat16")
    jpages = jsrc.export_pages(jblocks)
    assert jpages["k"].dtype == ml_dtypes.bfloat16
    dst.import_pages(jpages, ids)
    for key in ("k", "v"):
        np.testing.assert_array_equal(dst.export_pages(ids)[key],
                                      jpages[key].view(np.uint16))
    assert dst.kv_page_nbytes() == jsrc.kv_page_nbytes()
    # float32 values are cast to the arena's bf16
    vals = {k: jpages[k].astype(np.float32) for k in ("k", "v")}
    dst.import_pages(vals, ids)
    for key in ("k", "v"):
        np.testing.assert_array_equal(dst.export_pages(ids)[key],
                                      jpages[key].view(np.uint16))


def test_import_rejects_bad_geometry_and_dtype():
    src, blocks = _prefilled(TORCH)
    pages = src.export_pages(blocks)
    dst = TORCH.engine(0)
    ids = dst.state.allocator.allocate(2)
    with pytest.raises(ValueError, match="does not fit"):
        dst.import_pages(pages, ids[:1])
    with pytest.raises(ValueError, match="does not fit"):
        dst.import_pages({k: v[:, :1] for k, v in pages.items()}, ids)
    with pytest.raises(ValueError, match="bf16 bit patterns"):
        dst.import_pages({k: v.view(np.uint32).astype(np.uint16)
                          for k, v in pages.items()}, ids)
    with pytest.raises(ValueError, match="dtype int32"):
        dst.import_pages({k: v.view(np.int32) for k, v in pages.items()},
                         ids)


def test_dispatch_counts_publish_and_megastep_span():
    """The engine's dispatch counters reach the registry as the JAX
    engine's do, and a megastep window records a serving/megastep span."""
    eng = TORCH.engine(0)
    names = ("host_calls", "scan_steps", "megastep_launches",
             "megastep_tokens")
    before = {n: telemetry.registry.counter(f"dispatch/{n}").value
              for n in names}
    te.reset_dispatch_counts()
    telemetry.tracer.configure(enabled=True)
    telemetry.tracer.clear()
    try:
        eng.scheduler.put([0], [[5, 6, 7]])
        first = eng.step_with_budget(max_steps=8)     # prefill: stepwise
        assert len(first[0]) == 1
        eng.scheduler.put([0], [first[0]])            # fed back
        out = eng.step_with_budget(max_steps=8, row_limits={0: 6})
        assert len(out[0]) == 6
        spans = [e for e in telemetry.tracer.events()
                 if e["name"] == "serving/megastep"]
    finally:
        telemetry.tracer.configure(enabled=False)
        telemetry.tracer.clear()
    assert len(spans) == 1 and spans[0]["args"] == {"n": 1, "k": 6}
    counts = dict(te.dispatch_counts)
    assert counts == {"host_calls": 2, "scan_steps": 6,
                      "megastep_launches": 1, "megastep_tokens": 6}
    for n in names:
        assert telemetry.registry.counter(f"dispatch/{n}").value \
            - before[n] == counts[n]


def test_tracer_labels_and_flight_recorder_scalars():
    """``telemetry.jax_annotations`` labels spans with
    torch.profiler.record_function; the flight recorder resolves tensor
    scalars with .item() at dump time and reports one process when
    torch.distributed is not initialized."""
    tr = telemetry.Tracer()
    tr.configure(enabled=True, jax_annotations=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("serving/engine_step", step=3):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "serving/engine_step#3" in names
    assert [e["name"] for e in tr.events()] == ["serving/engine_step"]
    fr = telemetry.FlightRecorder()
    fr.record_step(1, kind="serving", loss=torch.tensor(2.5),
                   bad=torch.tensor(float("nan")), dur_s=0.01)
    doc = fr.snapshot()
    assert doc["steps"][0]["loss"] == 2.5
    assert doc["steps"][0]["bad"] == "nan"
    assert doc["meta"]["process_index"] == 0
    assert doc["meta"]["process_count"] == 1
    assert "metrics_text" in doc


def test_megastep_that_does_not_fit_counts_a_fallback_step():
    """A megastep window the arena cannot hold runs the step stepwise and
    counts it in ``graph_stats["fallback_steps"]`` (chip_smoke.py's front
    end run asserts none)."""
    eng = TORCH.engine(0, num_blocks=4)
    eng.scheduler.put([0], [list(range(1, 21))])     # 20 tokens: 3 pages
    first = eng.step_with_budget(max_steps=8)
    while 0 not in first:
        first = eng.step_with_budget(max_steps=8)
    eng.scheduler.put([0], [first[0]])
    eng.state.allocator.allocate(1)     # the page the window would need
    out = eng.step_with_budget(max_steps=8, row_limits={0: 8})
    assert len(out[0]) == 1
    assert eng.graph_stats["fallback_steps"] == 1

"""The fused decode loop and the decode megastep: deepspeed_tpu_torch's
RaggedInferenceEngine against deepspeed_tpu's RaggedInferenceEngineTPU in
its default fused loop (``_fused_decode_fn``) on the CPU, fp32, tiny
Llama-3 (and a tiny Mixtral for the capacity MoE layer at decode).

On the CPU the port runs its decode step eagerly, once per token of a
window; on a card it replays the same step as a CUDA graph (chip_smoke.py
holds the two against each other). Greedy tokens must be identical and
per-row counts exact; after a window the arena's live KV rows agree within
1e-5 (fp32, the two packages sum in different orders) and nothing is
written past them but to the trash page. Sampled tokens come from a
``torch.Generator`` in the port and differ from JAX's, so sampled mode is
held within the port: the stream must not depend on how a run is cut into
windows.

Engines are shared within the module where a scenario allows: each JAX
fused program compiles once per (row bucket, window length, mode).
"""

import numpy as np
import jax
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import (
    FusedDecodeUnavailable as JUnavailable, RaggedInferenceEngineTPU)
from deepspeed_tpu.models.llama import llama3_config as jllama
from deepspeed_tpu.models.mixtral import mixtral_config as jmixtral
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.telemetry.registry import registry
from deepspeed_tpu_torch.inference import engine_v2 as te
from deepspeed_tpu_torch.inference.engine_v2 import (FusedDecodeUnavailable,
                                                     RaggedInferenceEngine)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import llama3_config as tllama
from deepspeed_tpu_torch.models.mixtral import mixtral_config as tmixtral

KV_TOL = dict(rtol=1e-5, atol=1e-5)
ENG_CFG = {"dtype": "float32", "num_blocks": 32, "block_size": 8,
           "max_seq_len": 128, "prefill_chunk": 8, "max_batch_tokens": 64,
           "max_sequences": 16}
#: never sampled (the vocabulary is 0..255): a run that cannot stop early
NO_EOS = 256


@pytest.fixture(scope="module")
def llama():
    build_mesh(data=1, devices=jax.devices()[:1])
    jcfg = jllama("tiny", max_seq_len=256, vocab_size=256)
    tcfg = tllama("tiny", max_seq_len=256, vocab_size=256)
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def engines(llama):
    """One engine of each package, shared by the scenarios that leave no
    sequence behind."""
    jcfg, tcfg, jp, tp = llama
    return (RaggedInferenceEngineTPU(jcfg, ENG_CFG, params=jp),
            RaggedInferenceEngine(tcfg, ENG_CFG, params=tp, device="cpu"))


@pytest.fixture(autouse=True)
def _jax_fused(monkeypatch):
    monkeypatch.delenv("DSTPU_NO_FUSED_DECODE", raising=False)


def _fresh(llama, **over):
    jcfg, tcfg, jp, tp = llama
    cfg = dict(ENG_CFG, **over)
    return (RaggedInferenceEngineTPU(jcfg, cfg, params=jp),
            RaggedInferenceEngine(tcfg, cfg, params=tp, device="cpu"))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=6 + i).astype(np.int32)
            for i in range(n)]


def _drive(eng, k, prompts, budgets, eos=None, mode=("argmax",)):
    """Serve ``prompts`` through ``step_with_budget(max_steps=k)`` as
    ServingFrontend does (deepspeed_tpu/serving/frontend.py:489-519): row
    limits and eos ids each step, every row's last token fed back by
    ``scheduler.put`` until the row hits its budget or its eos. Returns
    the tokens of each row."""
    base = max(eng.state.seqs.keys(), default=-1) + 1
    uids = [base + i for i in range(len(prompts))]
    eng.scheduler.put(uids, prompts)
    out = {u: [] for u in uids}
    left = dict(zip(uids, budgets))
    while left:
        res = eng.step_with_budget(
            mode=mode, max_steps=k,
            row_limits={u: left[u] - len(out[u]) for u in left},
            eos_ids={u: eos for u in left} if eos is not None else None)
        assert res is not None
        for u, toks in res.items():
            toks = toks if isinstance(toks, list) else [toks]
            done = False
            for t in toks:
                out[u].append(int(t))
                if t == eos or len(out[u]) >= left[u]:
                    done = True
                    break
            if done:
                eng.flush(u)
                del left[u]
            else:
                eng.scheduler.put([u], [[toks[-1]]])
    assert not eng.state.seqs
    return [out[u] for u in uids]


# ---------------------------------------------------------------------------
# generate: the fused loop over ragged prompts, windows of 32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_eos", [False, True])
def test_generate_matches_jax_fused_loop(engines, with_eos):
    """Budgets 4, 9, 17 and 40 straddle the 32-step window: the last row
    runs a second window after the others retire. With an eos that the
    longest row emits inside its first window, every row that samples it
    stops there."""
    jeng, teng = engines
    prompts = _prompts(4)
    budgets = [4, 9, 17, 40]
    eos = None
    if with_eos:
        plain = jeng.generate(prompts, max_new_tokens=budgets)
        eos = int(plain[3][len(prompts[3]) + 12])
    want = jeng.generate(prompts, max_new_tokens=budgets, eos_token_id=eos)
    scan0 = te.dispatch_counts["scan_steps"]
    got = teng.generate(prompts, max_new_tokens=budgets, eos_token_id=eos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if with_eos:
        assert any(len(g) < len(p) + b and g[-1] == eos
                   for g, p, b in zip(got, prompts, budgets))
    else:
        assert [len(g) - len(p) for g, p in zip(got, prompts)] == budgets
        # a window of min(32, 39) steps (the 40-token row has 39 left
        # after the prefill's token), then one of 7 for that row alone
        assert te.dispatch_counts["scan_steps"] - scan0 == 32 + 7
    assert not teng.state.seqs
    assert teng.state.allocator.free_blocks == ENG_CFG["num_blocks"]


def test_generate_mixtral_capacity_layer_matches_jax(llama):
    """MoE at decode: every window step goes through the capacity layer
    (no drops: capacity = tokens), in both packages."""
    kw = dict(hidden_size=128, intermediate_size=256, vocab_size=256)
    jcfg, tcfg = jmixtral("tiny", **kw), tmixtral("tiny", **kw)
    jp = j_init(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = RaggedInferenceEngineTPU(jcfg, ENG_CFG, params=jp)
    teng = RaggedInferenceEngine(tcfg, ENG_CFG, params=tp, device="cpu")
    prompts = _prompts(3, seed=4)
    budgets = [5, 12, 34]
    want = jeng.generate(prompts, max_new_tokens=budgets)
    got = teng.generate(prompts, max_new_tokens=budgets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert teng.stats["decode"]["steps"] == 32 + 1
    assert teng.graph_stats["fallback_steps"] == 0


# ---------------------------------------------------------------------------
# the megastep against JAX step_with_budget(max_steps=K)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 8, 32])
def test_megastep_argmax_parity(engines, k):
    jeng, teng = engines
    prompts = _prompts(3)
    want = _drive(jeng, k, prompts, [12] * 3)
    got = _drive(teng, k, prompts, [12] * 3)
    assert got == want
    assert all(len(t) == 12 for t in got)


def test_megastep_eos_mid_window(engines):
    jeng, teng = engines
    prompts = _prompts(3)
    eos = _drive(jeng, 1, prompts, [12] * 3)[0][2]
    want = _drive(jeng, 8, prompts, [12] * 3, eos=eos)
    got = _drive(teng, 8, prompts, [12] * 3, eos=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) == 3


def test_megastep_staggered_budgets(engines):
    jeng, teng = engines
    prompts = _prompts(3)
    budgets = [4, 9, 17]
    want = _drive(jeng, 8, prompts, budgets)
    got = _drive(teng, 8, prompts, budgets)
    assert got == want
    assert [len(t) for t in got] == budgets


def test_megastep_emits_through_counters(engines):
    """K=32 takes the window (parity alone would also pass if megasteps
    fell back to stepwise): 3 rows x 12 tokens, 1 from the prefill and 11
    from one window of 11 steps; the port runs no dead step."""
    jeng, teng = engines
    j0 = registry.counter("dispatch/megastep_tokens").value
    te.reset_dispatch_counts()
    _drive(jeng, 32, _prompts(3), [12] * 3)
    _drive(teng, 32, _prompts(3), [12] * 3)
    assert registry.counter("dispatch/megastep_tokens").value - j0 == 33
    assert te.dispatch_counts == {"host_calls": 2, "scan_steps": 11,
                                  "megastep_launches": 1,
                                  "megastep_tokens": 33}


# ---------------------------------------------------------------------------
# one window: counts, pages and the arena
# ---------------------------------------------------------------------------

def _live_mask(eng, uids, ends):
    """[L, NB + 1, bs] True where row u's KV [0, end) lives, every layer."""
    L = eng.model_config.num_layers
    nb, bs = eng.config.num_blocks, eng.config.block_size
    mask = np.zeros((L, nb + 1, bs), bool)
    for u, end in zip(uids, ends):
        for p in range(end):
            mask[:, eng.state.seqs[u].blocks[p // bs], p % bs] = True
    return mask


def test_one_window_counts_pages_and_arena(llama):
    jeng, teng = _fresh(llama)
    prompts = _prompts(3, seed=1)
    uids = [0, 1, 2]
    budgets, steps = [5, 12, 9], 12
    res = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        first = eng._put_tokens(uids, prompts)
        starts0 = [len(eng.state.seqs[u].tokens) for u in uids]
        toks, counts = eng._fused_decode(uids, [first[u] for u in uids],
                                         steps, ("argmax",), budgets=budgets)
        arena = {k: np.asarray(eng.arena[k] if name == "jax"
                               else eng.arena[k].numpy()) for k in ("k", "v")}
        res[name] = (first, starts0, np.asarray(toks), np.asarray(counts),
                     {u: list(eng.state.seqs[u].blocks) for u in uids},
                     arena, _live_mask(eng, uids, np.asarray(starts0)
                                       + np.asarray(counts)))
    jf, js, jt, jc, jb, ja, jm = res["jax"]
    tf, ts, tt, tc, tb, ta, tm = res["torch"]
    assert tf == jf and ts == js and tb == jb
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, budgets)
    for j, c in enumerate(tc):
        np.testing.assert_array_equal(tt[:c, j], jt[:c, j])
    L, nb = teng.model_config.num_layers, teng.config.num_blocks
    not_trash = np.ones((L, nb + 1), bool)
    not_trash[:, nb] = False
    assert (tm == jm).all()
    for key in ("k", "v"):
        shape = (ta[key].shape[0], L, nb + 1) + ta[key].shape[2:]
        t, j = ta[key].reshape(shape), ja[key].reshape(shape)
        np.testing.assert_allclose(t[:, tm], j[:, jm], **KV_TOL)
        outside = ~tm & not_trash[:, :, None]
        assert not t[:, outside].any() and not j[:, outside].any(), key


# ---------------------------------------------------------------------------
# FusedDecodeUnavailable
# ---------------------------------------------------------------------------

def test_overlong_window_is_doomed(llama):
    """A window past max_seq_len is doomed in both packages; generate
    with an eos (so no up-front length check) goes stepwise, raises
    ValueError at the limit and keeps no page."""
    jeng, teng = _fresh(llama)
    long = _prompts(1, seed=2)[0].tolist() * 20
    prompt = np.asarray(long[:120], np.int32)
    for eng, exc in ((jeng, JUnavailable), (teng, FusedDecodeUnavailable)):
        first = eng._put_tokens([0], [prompt])
        with pytest.raises(exc, match="max_seq_len") as err:
            eng._fused_decode([0], [first[0]], 12, ("argmax",))
        assert err.value.doomed
        eng.flush(0)
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.generate([prompt], max_new_tokens=12, eos_token_id=NO_EOS)
        assert not eng.state.seqs
        assert eng.state.allocator.free_blocks == ENG_CFG["num_blocks"]


def test_full_arena_goes_on_stepwise(llama):
    """Six pages of 8: after the prefill (2 + 1 pages) the first window
    needs 1 + 3 more, which are not free, so it is not doomed and both
    packages go on stepwise; the 2-token row retires at once and frees
    the pages the other needs."""
    jeng, teng = _fresh(llama, num_blocks=6)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32)
               for n in (16, 8)]
    for eng, exc in ((jeng, JUnavailable), (teng, FusedDecodeUnavailable)):
        first = eng._put_tokens([0, 1], prompts)
        with pytest.raises(exc, match="too full") as err:
            eng._fused_decode([0, 1], [first[0], first[1]], 19,
                              ("argmax",), budgets=[1, 19])
        assert not err.value.doomed
        eng.flush(0)
        eng.flush(1)
    want = jeng.generate(prompts, max_new_tokens=[2, 20])
    scan0 = te.dispatch_counts["scan_steps"]
    got = teng.generate(prompts, max_new_tokens=[2, 20])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert te.dispatch_counts["scan_steps"] == scan0
    assert teng.graph_stats["fallback_steps"] == 19
    assert teng.state.allocator.free_blocks == 6


# ---------------------------------------------------------------------------
# sampled mode: the stream does not depend on the windows
# ---------------------------------------------------------------------------

def test_sampled_stream_invariant_to_windows(llama):
    """One K=8 window, two K=4 windows and the stepwise loop sample the
    same tokens: each decode step draws once from the engine's generator,
    in a window or not (budget 9 = the prefill's token + 8)."""
    tcfg, tp = llama[1], llama[3]
    prompts = _prompts(1)
    runs = []
    for k in (8, 4, 1):
        eng = RaggedInferenceEngine(tcfg, ENG_CFG, params=tp, device="cpu",
                                    generator=torch.Generator()
                                    .manual_seed(7))
        eng._temperature = 0.7
        runs.append(_drive(eng, k, prompts, [9],
                           mode=("sample", 0, False)))
    assert runs[0] == runs[1] == runs[2]
    assert len(runs[0][0]) == 9
    greedy = _drive(RaggedInferenceEngine(tcfg, ENG_CFG, params=tp,
                                          device="cpu"), 8, prompts, [9])
    assert runs[0] != greedy


# ---------------------------------------------------------------------------
# the decode step holds nothing a CUDA graph capture refuses
# ---------------------------------------------------------------------------

#: ATen ops that read a device value back to the host, or copy host data
#: to the device, inside a step: a CUDA graph capture refuses both
_HOST_OPS = ("_local_scalar_dense", "lift_fresh", "nonzero", "multinomial",
             "masked_select")


@pytest.mark.parametrize("weight_quant", [None, "int8"])
def test_decode_step_has_no_host_round_trip(weight_quant):
    """The step a window captures, run on the CPU under a dispatch mode
    that records every ATen op: greedy and top-k/top-p sampling call none
    of ``_HOST_OPS``. (The MoE capacity layer's ``F.one_hot`` checks its
    classes on the host for CPU tensors only, so MoE models are left to
    the card's capture in chip_smoke.py.)"""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(str(func))
            return func(*args, **(kwargs or {}))

    cfg = tllama("tiny", hidden_size=512, num_heads=4, num_kv_heads=2,
                 intermediate_size=1024, vocab_size=256)
    eng = RaggedInferenceEngine(cfg, dict(ENG_CFG, weight_quant=weight_quant),
                                device="cpu")
    first = eng._put_tokens([0, 1, 2], _prompts(3))
    for mode in (("argmax",), ("sample", 5, True)):
        st = eng._decode_state(4, mode)
        st.buf[:st.head + 4].copy_(torch.from_numpy(st.pack(
            [first[u] for u in range(3)],
            [len(eng.state.seqs[u].tokens) for u in range(3)], [2] * 3,
            [-1] * 3, 2, 0.7, 0.9, eng._page_table([0, 1, 2], 4))))
        rec = Record()
        with torch.no_grad(), rec:
            eng._decode_step(st, mode)
        assert "aten.index_copy_.default" in rec.ops      # the step ran
        assert not [op for op in rec.ops
                    if any(h in op for h in _HOST_OPS)], (mode, rec.ops)


# ---------------------------------------------------------------------------
# a capture records its launches; each replay counts them
# ---------------------------------------------------------------------------

def test_recorded_launches_count_once_per_replay():
    """``op_builder.recorded_launches`` turns what the wrappers count
    inside it into a record and puts every registered counter back (a
    capture launches nothing, even when it adds a key); ``add_launches``
    counts the record once per replay. The engine reaches the ops
    modules' counters only through this registry."""
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import quantized_linear as tq
    assert {"op_builder.launches", "paged_attention.form_launches",
            "grouped_matmul.form_launches",
            "quantized_linear.regime_launches",
            "quantized_linear.shape_launches"} <= set(op_builder._COUNTERS)
    launches, split = op_builder.launches, \
        tpa.form_launches["paged_attention"]
    shapes = tq.shape_launches["quantized_matmul"]
    saved = (launches["paged_attention"], split["split"], dict(shapes),
             tg.form_launches["grouped_down"]["wgmma"])
    try:
        with op_builder.recorded_launches() as record:
            launches["paged_attention"] += 2
            split["split"] += 2
            shapes["splitk 7x9"] = shapes.get("splitk 7x9", 0) + 1
        assert (launches["paged_attention"], split["split"],
                dict(shapes)) == saved[:3]
        assert record == {
            ("op_builder.launches", "paged_attention"): 2,
            ("paged_attention.form_launches", "paged_attention", "split"): 2,
            ("quantized_linear.shape_launches", "quantized_matmul",
             "splitk 7x9"): 1}
        assert split is tpa.form_launches["paged_attention"]
        op_builder.add_launches(record, 3)
        assert launches["paged_attention"] == saved[0] + 6
        assert split["split"] == saved[1] + 6
        assert shapes["splitk 7x9"] == saved[2].get("splitk 7x9", 0) + 3
        assert tg.form_launches["grouped_down"]["wgmma"] == saved[3]
        # a capture that raises counts nothing either
        with pytest.raises(RuntimeError):
            with op_builder.recorded_launches():
                split["split"] += 5
                raise RuntimeError("capture failed")
        assert split["split"] == saved[1] + 6
    finally:
        launches["paged_attention"], split["split"] = saved[:2]
        shapes.clear()
        shapes.update(saved[2])

"""Weight-only quantized linears: deepspeed_tpu_torch.ops.quantized_linear
against deepspeed_tpu.ops.quantized_linear on the CPU.

- ``quantize_weight`` / ``dequantize_weight``: the same bytes and fp32
  scales, bit for bit, for int8, fp8, int4 and fp6, 2-D and stacked, with
  columns whose scale is exactly 1 so that chosen quotients reach the
  encoders: halfway points of every grid, e3m2 powers of two and one ulp
  either side, the 2^-4 subnormal edge, the fp8 subnormals and 448.
- The plain ``qmatmul`` / ``qmatmul_batched`` against the JAX functions
  with ``interpret=True`` — the real Pallas kernels, on shapes that pass
  their 256-multiple tile gate (K/planes and N divisible by 256).
  Tolerance: fp32 outputs within 1e-5 of the output's scale (fp32 sums
  of 512-1024 terms in another order); bf16 outputs one bf16 step (2^-8
  relative) of the output's scale, since both sides round the same fp32
  sum once and a sum-order difference can flip that rounding.
- ``plan``: the kernels' launch plan from the shape (regime cut at M 64,
  every K row in one slice, grids within CUDA's limits, the workspace).
- ``quantize_param_tree`` and ``cast_quantized_tree``: the same leaf
  names, dtypes and bytes for tied, untied, MoE and shared-expert trees;
  a second call raises.
- ``init_params(..., weight_quant=)`` equals
  ``quantize_param_tree(init_params(...))`` bit for bit, drawn in many
  slices.
"""

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as j_qwen
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.ops import quantized_linear as J
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.llama import llama3_config as t_llama
from deepspeed_tpu_torch.models.mixtral import mixtral_config as t_mixtral
from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config as t_qwen
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import quantized_linear as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ("int8", "fp8", "int4", "fp6")
QMAX = {"int8": 127.0, "fp8": 448.0, "int4": 7.0, "fp6": 28.0}


def _bytes(a) -> np.ndarray:
    """A quantized array's raw bytes (fp8 as uint8) from either package."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _edge_weights(mode: str, k: int, n: int, rng) -> np.ndarray:
    """[k, n] weights: random columns, and columns whose absmax is the
    format's qmax (scale exactly 1) holding the format's edge quotients."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    qmax = QMAX[mode]
    if mode == "fp6":
        vals = [0.0, 2.0 ** -5, 2.0 ** -4, 1.5 * 2.0 ** -4, 28.0, 27.9, 26.0]
        for e in range(-4, 5):
            p = np.float32(2.0 ** e)
            vals += [p, np.nextafter(p, np.float32(0)),
                     np.nextafter(p, np.float32(np.inf)),
                     4.5 * 2.0 ** (e - 2), 7.5 * 2.0 ** (e - 2)]
    elif mode == "fp8":
        vals = [448.0, 447.0, 440.0, 2.0 ** -9, 1.5 * 2.0 ** -9, 2.0 ** -10,
                0.75 * 2.0 ** -9, 1.0 + 1 / 16, 1.0 + 3 / 16, 240.0 + 8.0]
    else:
        vals = [qmax] + [x + 0.5 for x in range(-int(qmax), int(qmax))]
    vals = np.asarray(vals, np.float32)
    vals = vals[np.abs(vals) <= qmax]
    cols = 0
    for j in range(0, len(vals), k - 1):
        chunk = vals[j:j + k - 1]
        col = np.zeros(k, np.float32)
        col[0] = qmax
        col[1:1 + len(chunk)] = np.where(np.arange(len(chunk)) % 2, chunk,
                                         -chunk)
        w[:, cols] = col
        cols += 1
    return w


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(64, 48), (2, 32, 40), (2, 3, 16, 24)])
def test_quantize_weight_bit_identical(mode, shape):
    rng = np.random.default_rng(1)
    k, n = shape[-2], shape[-1]
    w = np.stack([_edge_weights(mode, k, n, rng)
                  for _ in range(int(np.prod(shape[:-2])))]).reshape(shape)
    qj, sj = J.quantize_weight(jnp.asarray(w), mode)
    qt, st = T.quantize_weight(torch.from_numpy(w), mode)
    assert qt.is_contiguous()
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    assert _bytes(qt).dtype == _bytes(qj).dtype
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        T.dequantize_weight(qt, st).numpy(),
        np.asarray(J.dequantize_weight(qj, sj)))
    # a bf16 input quantizes from its own values, as in the JAX package
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    qj, sj = J.quantize_weight(wb, mode)
    qt, st = T.quantize_weight(torch.from_numpy(w).bfloat16(), mode)
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_fp8_conversion_follows_xla():
    x = np.asarray([1000.0, -1000.0, 464.0, np.nextafter(464.0, 500.0),
                    -464.0, 463.9, 448.5, np.inf, -np.inf, 1e-4,
                    3 * 2.0 ** -10, -0.0, np.nan], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    got = T.to_e4m3(torch.from_numpy(x))
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def _operands(mode, g, m, k, n, seed):
    rng = np.random.default_rng(seed)
    shape = (k, n) if g is None else (g, k, n)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    x = rng.standard_normal((m, k) if g is None else (g, m, k)).astype(
        np.float32)
    qj, sj = J.quantize_weight(jnp.asarray(w), mode)
    qt, st = T.quantize_weight(torch.from_numpy(w), mode)
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    return x, (qj, sj), (qt, st)


def _close(got: torch.Tensor, want, dtype) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


#: (x dtype, out dtype): fp32; bf16 → bf16; bf16 → fp32 (the head's form)
DTYPES = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
          "bf16_to_f32": (torch.bfloat16, torch.float32)}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, None: None}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,dt", [(1, "f32"), (5, "f32"), (8, "f32"),
                                  (300, "f32"), (5, "bf16"), (300, "bf16"),
                                  (8, "bf16_to_f32")])
def test_qmatmul_matches_pallas(mode, m, dt):
    k = 1024 if mode == "fp6" else 512     # K/planes >= 256: the tile gate
    x, (qj, sj), (qt, st) = _operands(mode, None, m, k, 256, 7)
    xdt, odt = DTYPES[dt]
    xj = jnp.asarray(x).astype(_JNP[xdt])
    want = J.qmatmul(xj, qj, sj, out_dtype=_JNP[odt], interpret=True)
    got = T.qmatmul(torch.from_numpy(x).to(xdt), qt, st, out_dtype=odt)
    assert got.dtype == (odt or xdt)
    _close(got, want, got.dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,dt", [(4, "f32"), (300, "f32"), (4, "bf16")])
def test_qmatmul_batched_matches_pallas(mode, m, dt):
    k = 1024 if mode == "fp6" else 256
    x, (qj, sj), (qt, st) = _operands(mode, 3, m, k, 256, 8)
    xdt, _ = DTYPES[dt]
    want = J.qmatmul_batched(jnp.asarray(x).astype(_JNP[xdt]), qj, sj,
                             interpret=True)
    got = T.qmatmul_batched(torch.from_numpy(x).to(xdt), qt, st)
    assert got.shape == (3, m, 256) and got.dtype == xdt
    _close(got, want, xdt)


def test_format_detection_and_k_checks():
    """dense: uint8 of rank 3 is fp6, else int4; batched: rank 4 fp6, rank
    3 int4; a K that does not match the packed rows raises."""
    w = torch.randn(64, 32)
    for mode, rank in (("int4", 2), ("fp6", 3)):
        q, s = T.quantize_weight(w, mode)
        assert q.dim() == rank and T._mode(q, batched=False) == mode
        qb, sb = T.quantize_weight(w[None].expand(2, 64, 32), mode)
        assert T._mode(qb, batched=True) == mode
        with pytest.raises(ValueError, match="packed rows"):
            T.qmatmul(torch.randn(3, 60), q, s)
    with pytest.raises(ValueError, match="K % 4"):
        T.quantize_weight(torch.randn(6, 8), "fp6")
    with pytest.raises(ValueError, match="even K"):
        T.quantize_weight(torch.randn(5, 8), "int4")
    with pytest.raises(ValueError, match="unsupported"):
        T.validate_weight_quant("int2")


def test_kernel_wrappers_check_inputs_and_need_the_card(monkeypatch,
                                                         tmp_path):
    """The launch wrappers refuse what the kernels do not take before any
    build, and without nvcc the build raises: nothing falls back."""
    q, s = T.quantize_weight(torch.randn(64, 32), "int8")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        T.quantized_matmul_kernel(torch.randn(2, 64).half(), q, s)
    with pytest.raises(ValueError, match="scale"):
        T.quantized_matmul_kernel(torch.randn(2, 64), q, s[:8])
    with pytest.raises(ValueError, match="int4/fp6"):
        T.quantized_matmul_packed_kernel(torch.randn(2, 64), q, s)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(op_builder, "_LIBS", {})
    monkeypatch.setattr("os.access", lambda *a, **k: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        T.quantized_matmul_kernel(torch.randn(2, 64), q, s)


# ---------------------------------------------------------------------------
# Launch plan (pure Python: which kernel form, tile, K slices, workspace)
# ---------------------------------------------------------------------------

#: (G, M, K, N): Llama-3 8B's linears at decode and prefill, Mixtral's
#: experts (G 8) at decode, capacity prefill and a ragged M 100, and the
#: awkward shapes of the card's checks: M 1, 3, 17, 64, 65; K and N off 16
#: and off 256; K whose steps the slice count does not divide (4288)
PLAN_SHAPES = [(1, m, k, n) for m in (16, 2048)
               for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                            (14336, 4096), (4096, 128256))] + [
    (8, 16, 4096, 14336), (8, 512, 14336, 4096), (8, 100, 4288, 2048),
    (1, 1, 200, 77), (1, 3, 1000, 1030), (1, 17, 4288, 4096),
    (1, 64, 4288, 4096), (1, 65, 4288, 4096), (3, 5, 200, 77),
    (2, 70, 1000, 1030), (1, 128, 1000, 1024), (1, 64, 64, 16)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("g,m,k,n", PLAN_SHAPES)
def test_plan_covers_every_k_row_once(mode, g, m, k, n):
    """Every logical K row falls in exactly one slice, a step never leaves
    its plane's K/P packed rows, the grid covers out within CUDA's limits,
    and the workspace and counters are what the split needs."""
    p = T._PLANES[mode]
    kp = k // p
    for dt in (torch.bfloat16, torch.float32):
        pl = T.plan(mode, dt, g, m, k, n)
        assert pl.regime == ("fma" if dt == torch.float32 else
                             "splitk" if m <= 64 or kp % 8 or n % 16
                             else "wgmma")
        rows = pl.packed_rows_per_step
        assert rows * (1 if pl.regime == "wgmma" else p) == 64
        assert pl.k_steps == -(-kp // rows)
        seen = np.zeros(k, np.int64)
        for s in range(pl.slices):
            t0, t1 = s * pl.steps, min(pl.k_steps, (s + 1) * pl.steps)
            assert t1 > t0, "empty slice"
            for t in range(t0, t1):
                r = np.arange(t * rows, min((t + 1) * rows, kp))
                assert r.size and r.max() < kp
                for q in range(p):
                    seen[q * kp + r] += 1
        assert (seen == 1).all()
        gx, gy, gz = pl.grid
        assert 0 < gy <= 65535 and gz == g <= 65535 and 0 < gx < 2 ** 31
        if pl.regime == "splitk":     # column tiles fastest, then M x S
            assert gx * pl.bn >= n and gy == -(-m // pl.bm) * pl.slices
            assert pl.bm == (16 if m <= 16 else 64)
        else:                         # m-tiles fastest, unsplit
            assert pl.slices == 1 and gx * pl.bm >= m and gy * pl.bn >= n
            assert (pl.bm, pl.bn) in (((128, 128), (256, 128))
                                      if pl.regime == "wgmma" else ((64, 64),))
            assert pl.bm != 256 or mode != "fp6"
        split = pl.slices > 1
        assert not split or (pl.regime == "splitk" and m <= 64)
        assert pl.workspace_bytes == (4 * g * pl.slices * m * n if split
                                      else 0)
        assert pl.counters == (g * gx if split else 0)
        assert pl.counters <= T.SPLITK_COUNTERS          # the fixed buffers
        assert pl.workspace_bytes <= 4 * T.SPLITK_WORKSPACE


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [1, 3, 16, 17, 63, 64, 65, 128, 2048])
def test_plan_regime_cut_at_m64(mode, m):
    """bf16: split-K up to M 64, wgmma above on TMA-aligned shapes (split-K
    unsplit on the others); fp32: the FMA kernel at every M."""
    pl = T.plan(mode, torch.bfloat16, 1, m, 4096, 4096)
    assert pl.regime == ("splitk" if m <= T.DECODE_MAX_M else "wgmma")
    odd = T.plan(mode, torch.bfloat16, 1, m, 1000, 1030)
    assert odd.regime == "splitk" and (odd.slices == 1 or m <= 64)
    assert T.plan(mode, torch.float32, 1, m, 4096, 4096).regime == "fma"


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096)])
def test_plan_decode_grid_fills_the_card(k, n):
    """At decode (M 16) the split-K grid puts at least one block on every
    SM and at most the target, with slices of at least the minimum steps."""
    for mode in MODES:
        pl = T.plan(mode, torch.bfloat16, 1, 16, k, n)
        blocks = pl.grid[0] * pl.grid[1] * pl.grid[2]
        assert T.NUM_SMS <= blocks <= T.SPLITK_BLOCKS_PER_SM[16] * T.NUM_SMS
        assert pl.slices == 1 or pl.steps >= T.SPLITK_MIN_STEPS
        assert pl.bn == (64 if n <= 2048 else 128)


def test_plan_refuses_grids_past_cudas_limits():
    with pytest.raises(ValueError, match="CUDA's limits"):
        T.plan("int8", torch.bfloat16, 70000, 16, 64, 64)
    with pytest.raises(ValueError, match="CUDA's limits"):
        T.plan("int8", torch.float32, 1, 16, 64, 64 * 70000)
    with pytest.raises(ValueError, match="multiple"):
        T.plan("fp6", torch.bfloat16, 1, 16, 6, 64)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

TREES = {
    "tied": (j_llama, t_llama, dict(tie_embeddings=True)),
    "untied": (j_llama, t_llama, {}),
    "moe": (j_mixtral, t_mixtral, {}),
    "shared": (j_qwen, t_qwen, {}),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _jdtype(a) -> str:
    return str(np.asarray(a).dtype)


_TDTYPE = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.uint8: "uint8",
           torch.float8_e4m3fn: "float8_e4m3fn"}


def _same_tree(jtree, ttree) -> None:
    jf, tf = _flat(jtree), _flat(ttree)
    assert sorted(jf) == sorted(tf)
    for name, jv in jf.items():
        tv = tf[name]
        assert _TDTYPE[tv.dtype] == _jdtype(jv), name
        if tv.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                tv.float().numpy(), np.asarray(jv).astype(np.float32))
        else:
            np.testing.assert_array_equal(_bytes(tv), _bytes(jv), name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tree", sorted(TREES))
def test_quantize_param_tree_matches_jax(tree, mode):
    jfn, _, kw = TREES[tree]
    jp = j_init(jfn("tiny", **kw), jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jq = J.quantize_param_tree(jp, mode=mode)
    tq = T.quantize_param_tree(tp, mode=mode)
    _same_tree(jq, tq)
    assert ("lm_head_q" in tq) == (tree == "tied")
    if tree in ("moe", "shared"):
        moe = tq["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert "router_scale" not in moe
        if tree == "shared":
            assert "gate_scale" not in moe["shared"]
            assert "wo_scale" in moe["shared"]
    for fn, t in ((J.quantize_param_tree, jq), (T.quantize_param_tree, tq)):
        with pytest.raises(ValueError, match="already quantized"):
            fn(t, mode=mode)
    # the dtype cast leaves scales, fp8 and packed planes alone
    _same_tree(J.cast_quantized_tree(jq, jnp.bfloat16),
               T.cast_quantized_tree(tq, torch.bfloat16))
    # across the packages and back, dtypes and bytes unchanged
    _same_tree(jq, params_from_jax(jax.tree.map(np.asarray, jq),
                                   device="cpu"))
    _same_tree(jq, params_from_jax(params_to_numpy(tq), device="cpu"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tree,dtype", [("tied", torch.float32),
                                        ("untied", torch.bfloat16),
                                        ("moe", torch.bfloat16),
                                        ("shared", torch.float32)])
def test_quantized_init_equals_quantize_param_tree(tree, dtype, mode,
                                                   monkeypatch):
    """Drawn in slices of at most 2048 values (so every leaf takes several
    slices, the experts one at a time, the head several column blocks),
    the quantized init is quantize_param_tree of the float init."""
    _, tfn, kw = TREES[tree]
    cfg = tfn("tiny", **kw)
    monkeypatch.setattr(tt, "INIT_SLICE_VALUES", 2048)
    want = T.quantize_param_tree(
        tt.init_params(cfg, torch.Generator().manual_seed(4), dtype),
        mode=mode)
    got = tt.init_params(cfg, torch.Generator().manual_seed(4), dtype,
                         weight_quant=mode)
    wf, gf = _flat(want), _flat(got)
    assert sorted(wf) == sorted(gf)
    for name, v in wf.items():
        assert gf[name].dtype == v.dtype, name
        assert torch.equal(gf[name].view(torch.uint8) if v.dtype ==
                           torch.float8_e4m3fn else gf[name],
                           v.view(torch.uint8) if v.dtype ==
                           torch.float8_e4m3fn else v), name

"""The launch plan of grouped_gate_up, grouped_down, grouped_dgdu,
grouped_dxs and grouped_wgrad (deepspeed_tpu_torch/ops/grouped_matmul.py
``plan``), which
picks each call's kernel form from its dtype and shape: fp32 the FMA
kernel, bf16 the wgmma kernel fed by a TMA ring where TMA can address every
operand, any other bf16 the mma.sync kernel. Pure Python: the CUDA kernels run only on the card
(chip_smoke.py phase 3 holds every form against the plain versions), so
these tests hold the plan to TMA's rules and to the C side's constants.

Shapes: the path shapes (Mixtral 8x7B and Qwen1.5-MoE prefill, the 1B/8e
and Mixtral training steps) and the awkward ones of the card's checks (d
100/130/256/1032, f 70/150/200/384/1416, E 4-60, a single token per
expert), in both dtypes.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import grouped_matmul as tg
from deepspeed_tpu_torch.ops import op_builder

CSRC = Path(tg.__file__).resolve().parent / "csrc"
BM = 64

#: (S tokens, top-k, E, d, f): the path shapes, then the awkward ones
SHAPES = [(2048, 2, 8, 4096, 14336), (2048, 4, 60, 2048, 1408),
          (16384, 2, 8, 1024, 2816), (100, 2, 4, 100, 150),
          (300, 2, 4, 256, 200), (200, 2, 6, 128, 384),
          (150, 2, 5, 128, 130), (90, 3, 4, 130, 70),
          (400, 2, 6, 512, 384), (512, 4, 60, 256, 192),
          (600, 2, 8, 1032, 1416), (1, 1, 4, 256, 64)]
KERNELS = ("grouped_gate_up", "grouped_down", "grouped_dgdu", "grouped_dxs",
           "grouped_wgrad")
DTYPES = (torch.float32, torch.bfloat16)
TMA_SHAPES = [x for x in SHAPES if x[3] % 8 == 0 and x[4] % 8 == 0]


def _rows(s, k, e):
    """R_pad of aligned_dispatch at bm 64."""
    return -(-s * k // BM) * BM + e * BM


def _dims(kernel, rows, d, f, saved=False):
    """(output rows, output columns, depth of each product, products) of a
    call: gate_up [rows, f] over d; dgdu [rows, f] over d (three products,
    gate and up recomputed and dh; one, dh, when gate/up are saved); down,
    dxs [rows, d] over f (dxs two products); wgrad dW [d, f] of each expert
    over the rows."""
    return {"grouped_gate_up": (rows, f, d, 1),
            "grouped_dgdu": (rows, f, d, 1 if saved else 3),
            "grouped_down": (rows, d, f, 1),
            "grouped_dxs": (rows, d, f, 2),
            "grouped_wgrad": (d, f, rows, 1)}[kernel]


def _expected_form(dtype, d, f, aligned=True):
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d % 8 == 0 and f % 8 == 0 and aligned else "mma"


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,k,e,d,f", SHAPES)
def test_plan_form_grid_and_k_steps(kernel, dtype, s, k, e, d, f):
    """The form follows the dtype and TMA's rules; the grid covers every
    output row (for gate_up, down and dxs every 64-row tile of R_pad, the
    wgmma form two a block; for wgrad every row of each expert's dW, the
    experts on the grid's z) and every output column exactly once, within
    CUDA's limits; the k-steps cover each product's depth once (gate_up d;
    down f; dxs f twice: dg·wgᵀ then du·wiᵀ; wgrad the rows)."""
    rows = _rows(s, k, e)
    pl = tg.plan(kernel, dtype, rows, d, f, e)
    m_out, n_out, depth, pairs = _dims(kernel, rows, d, f)
    assert pl.form == _expected_form(dtype, d, f)
    assert pl.bm == (2 * BM if pl.form == "wgmma" else BM)
    assert (pl.row_blocks - 1) * pl.bm < m_out <= pl.row_blocks * pl.bm
    assert (pl.col_tiles - 1) * pl.bn < n_out <= pl.col_tiles * pl.bn
    # the wgmma form walks the column tiles fastest (blockIdx.x); wgrad's
    # experts are the grid's z, its slowest dimension
    z = e if kernel == "grouped_wgrad" else 1
    assert pl.grid == ((pl.col_tiles, pl.row_blocks, z)
                       if pl.form == "wgmma"
                       else (pl.row_blocks, pl.col_tiles, z))
    assert pl.grid[0] <= 2 ** 31 - 1 and max(pl.grid[1:]) <= 65535
    assert len(pl.k_steps) == pairs
    for steps in pl.k_steps:
        assert (steps - 1) * pl.bk < depth <= steps * pl.bk
    if pl.form == "wgmma":
        # gate_up: 128 columns of gate beside the same 128 of up; dgdu: BN_f
        # columns of each of dg, du and h
        bn = {"grouped_gate_up": 128,
              "grouped_dgdu": tg.WG_DGDU_BN}.get(kernel, 256)
        threads = 384 if kernel == "grouped_dgdu" and bn == 128 else 288
        assert (pl.bn, pl.bk, pl.threads) == (bn, 64, threads)
        if kernel == "grouped_dgdu":
            _check_dgdu_band(pl, d, f)
        elif kernel == "grouped_gate_up" \
                and 4 * d * f > tg.GATE_UP_BAND_BYTES:
            # an expert's weights outgrow the L2 share: bands of row
            # blocks whose xs stays within it (or of one row block)
            assert 1 <= pl.band <= pl.row_blocks
            assert pl.band == 1 or \
                pl.band * pl.bm * d * 2 <= tg.GATE_UP_BAND_BYTES
            assert pl.band == pl.row_blocks or \
                (pl.band + 1) * pl.bm * d * 2 > tg.GATE_UP_BAND_BYTES
        else:
            assert pl.band == (0 if kernel == "grouped_wgrad" else 1)
    else:
        assert pl.threads == 128 and pl.bk == 32 and not pl.tma
        assert pl.band == 0


def _check_dgdu_band(pl, d, f, saved=False):
    """dgdu's raster: where one expert's weights (wg, wi, wo; wo alone
    when saved) outgrow the plan's L2 share, bands of row blocks whose dz
    (and xs) stay within GATE_UP_BAND_BYTES (or of one row block); else
    the column tiles fastest."""
    a_bytes = (1 if saved else 2) * pl.bm * d * 2
    if (1 if saved else 3) * d * f * 2 > tg.DGDU_BAND_WEIGHT_BYTES:
        assert 1 <= pl.band <= pl.row_blocks
        assert pl.band == 1 or pl.band * a_bytes <= tg.GATE_UP_BAND_BYTES
        assert pl.band == pl.row_blocks or \
            (pl.band + 1) * a_bytes > tg.GATE_UP_BAND_BYTES
    else:
        assert pl.band == 1


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("s,k,e,d,f", TMA_SHAPES)
def test_plan_tma_maps_and_ring(kernel, s, k, e, d, f):
    """The wgmma form's tensor maps obey TMA's rules (strides multiples of
    16 bytes below 2^40, box dims at most 256, a 128-byte inner box for
    the 128-byte swizzle), view each operand at its own shape with the
    expert as a dimension of its own, and the ring fits a block's 227 KB
    with at least two stages."""
    rows = _rows(s, k, e)
    pl = tg.plan(kernel, torch.bfloat16, rows, d, f, e)
    assert pl.form == "wgmma"
    for m in pl.tma:
        assert all(st % 16 == 0 and st < 2 ** 40 for st in m.strides), m
        assert all(1 <= b <= 256 for b in m.box), m
        assert m.box[0] * 2 == 128, m
        assert m.strides[0] == m.dims[0] * 2, m
        assert m.strides[1] == m.strides[0] * m.dims[1], m
    views = {m.operand: m.dims for m in pl.tma}
    tile = 64 * 64 * 2
    if kernel == "grouped_gate_up":
        # xs: a 64-row box for each half of the block's rows; wg and wi
        # MN-major: two boxes of 64 k by 64 n of each a step
        assert views == {"xs": (d, rows, 1, 1), "wg": (f, d, e, 1),
                         "wi": (f, d, e, 1)}
        assert {m.box for m in pl.tma if m.operand != "xs"} == {
            (64, 64, 1, 1)}
        box_bytes = (pl.bm // 64) * tile + 2 * (pl.bn // 64) * tile
    elif kernel == "grouped_wgrad":
        # both operands MN-major from [rows, C] views, one row a k: A = aᵀ
        # in a box for each 64 of dW's rows, B = b in four of 64 columns
        assert views == {"a": (d, rows, 1, 1), "b": (f, rows, 1, 1)}
        box_bytes = (pl.bm // 64) * tile + 4 * tile
    elif kernel == "grouped_dgdu":
        # dz, xs: a 64-row box for each half of the block's rows; wg, wi
        # MN-major [64 k, 64 n] boxes side by side; wo K-major, one [bn n,
        # 64 k] box of the [E, f, d] view
        assert views == {"dz": (d, rows, 1, 1), "xs": (d, rows, 1, 1),
                         "wg": (f, d, e, 1), "wi": (f, d, e, 1),
                         "wo": (d, f, e, 1)}
        boxes = {m.operand: m.box for m in pl.tma}
        assert boxes["wg"] == boxes["wi"] == (64, 64, 1, 1)
        assert boxes["wo"] == (64, pl.bn, 1, 1)
        box_bytes = 2 * (pl.bm // 64) * tile + 2 * (pl.bn // 64) * tile \
            + pl.bn * 64 * 2
        # the epilogue stages both groups' dg, du and h tiles in the ring
        assert pl.stages * box_bytes >= 2 * 3 * 64 * (pl.bn + 8) * 2
    elif kernel == "grouped_down":
        assert views == {"gate": (f, rows, 1, 1), "up": (f, rows, 1, 1),
                         "wo": (d, f, e, 1)}
        # gate and up: a 64-row box for each half of the block's rows;
        # wo's MN-major boxes: 64 k by 64 n, bn / 64 of them a step
        box_bytes = 2 * (pl.bm // 64) * 64 * 64 * 2 \
            + (pl.bn // 64) * 64 * 64 * 2
    else:
        assert views == {"dg": (f, rows, 1, 1), "du": (f, rows, 1, 1),
                         "wg": (f, d, e, 1), "wi": (f, d, e, 1)}
        assert {m.box for m in pl.tma if m.operand in ("wg", "wi")} == {
            (64, pl.bn, 1, 1)}
        box_bytes = (pl.bm // 64) * 64 * 64 * 2 + pl.bn * 64 * 2
    assert 2 <= pl.stages <= tg.WG_MAX_STAGES
    assert pl.smem_bytes >= pl.stages * box_bytes
    assert pl.smem_bytes <= tg.SMEM_MAX == 227 * 1024


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d,f,aligned", [(100, 150, True), (1032, 150, True),
                                         (1030, 1416, True),
                                         (1024, 2816, False)])
def test_plan_bf16_off_tma_takes_mma(kernel, d, f, aligned):
    """bf16 that TMA cannot address (a row stride off 16 bytes, or data
    off 16-byte alignment) takes the mma.sync kernel."""
    pl = tg.plan(kernel, torch.bfloat16, 1024, d, f, 8, aligned)
    assert pl.form == "mma" and pl.stages == 0 and pl.tma == ()


@pytest.mark.parametrize("s,k,e,d,f", TMA_SHAPES)
def test_plan_scaled_wgrad_runs_transposed(s, k, e, d, f):
    """dwo = hᵀ·round(dz·w) (a = h [rows, f], b = dz [rows, d]; dW [E, f,
    d]): the wgmma form runs dWᵀ = round(dz·w)ᵀ·h, so its blocks cover 128
    of dW's columns (d) by 256 of its rows (f); A's source is dz, B's h,
    and w comes in boxes of 64 beside each stage. fp32 and off-TMA bf16
    take the FMA and mma.sync kernels as the unscaled call does."""
    rows = _rows(s, k, e)
    pl = tg.plan("grouped_wgrad", torch.bfloat16, rows, f, d, e, True, True)
    assert pl.form == "wgmma" and (pl.bm, pl.bn) == (128, 256)
    assert (pl.row_blocks - 1) * 128 < d <= pl.row_blocks * 128
    assert (pl.col_tiles - 1) * 256 < f <= pl.col_tiles * 256
    assert pl.grid == (pl.col_tiles, pl.row_blocks, e)
    assert {m.operand: m.dims for m in pl.tma} == {
        "b": (d, rows, 1, 1), "a": (f, rows, 1, 1),
        "scale": (rows, 1, 1, 1)}
    for m in pl.tma:
        assert all(st % 16 == 0 for st in m.strides) and m.box[0] == 64, m
    tile = 64 * 64 * 2
    assert 2 <= pl.stages <= tg.WG_MAX_STAGES
    assert pl.smem_bytes >= pl.stages * (6 * tile + 64 * 2)
    assert pl.smem_bytes <= tg.SMEM_MAX
    # the transposed epilogue stages the 256 x 128 tile in the ring
    assert pl.stages * 6 * tile >= 256 * (128 + 8) * 2
    for dtype in DTYPES:
        assert tg.plan("grouped_wgrad", dtype, rows, f, d, e, True,
                       True).form == _expected_form(dtype, d, f)
    assert tg.plan("grouped_wgrad", torch.bfloat16, rows, f, d, e, False,
                   True).form == "mma"


@pytest.mark.parametrize("s,k,e,d,f", TMA_SHAPES)
def test_plan_saved_dgdu_runs_dh_alone(s, k, e, d, f):
    """dgdu with gate/up read from the saved forward: one product (dh) over
    d, dz and wo alone through TMA, a smaller stage (so at least as many
    stages as the recomputing form), the same grid and column tiles."""
    rows = _rows(s, k, e)
    pl = tg.plan("grouped_dgdu", torch.bfloat16, rows, d, f, e, saved=True)
    rc = tg.plan("grouped_dgdu", torch.bfloat16, rows, d, f, e)
    assert pl.form == rc.form == "wgmma"
    assert (pl.grid, pl.bn, pl.col_tiles) == (rc.grid, rc.bn, rc.col_tiles)
    assert pl.k_steps == rc.k_steps[:1] and len(rc.k_steps) == 3
    assert {m.operand: m.dims for m in pl.tma} == {
        "dz": (d, rows, 1, 1), "wo": (d, f, e, 1)}
    tile = 64 * 64 * 2
    box_bytes = (pl.bm // 64) * tile + pl.bn * 64 * 2
    assert rc.stages <= pl.stages <= tg.WG_MAX_STAGES
    assert pl.stages * box_bytes <= pl.smem_bytes <= tg.SMEM_MAX
    assert pl.stages * box_bytes >= 2 * 3 * 64 * (pl.bn + 8) * 2
    _check_dgdu_band(pl, d, f, saved=True)
    for dtype in DTYPES:
        assert tg.plan("grouped_dgdu", dtype, rows, d, f, e,
                       saved=True).form == _expected_form(dtype, d, f)


@pytest.mark.parametrize("s,k,e,d,f,band", [
    (2048, 2, 8, 4096, 14336, 8),      # Mixtral: 352 MB of weights an expert
    (16384, 2, 8, 1024, 2816, 1),      # 1B/8e: 17.3 MB, within the L2
    (2048, 4, 60, 2048, 1408, 1)])     # Qwen1.5-MoE: 17.3 MB
def test_plan_dgdu_raster_and_ring_at_the_path_shapes(s, k, e, d, f, band):
    """At Mixtral one expert's wg, wi and wo (352 MB) outgrow the L2, so
    the blocks walk bands of row blocks (each 2 MB of dz and xs); at the
    1B/8e shape (17.3 MB) the column tiles go fastest. The ring fits a
    block's shared memory, and the dw partials come in one tile per
    column tile."""
    rows = _rows(s, k, e)
    pl = tg.plan("grouped_dgdu", torch.bfloat16, rows, d, f, e)
    assert pl.form == "wgmma" and pl.band == band
    assert band == 1 or band > 1 and pl.row_blocks > band
    assert pl.smem_bytes <= tg.SMEM_MAX and pl.stages >= 2
    assert pl.col_tiles == -(-f // tg.WG_DGDU_BN)
    assert pl.grid == (pl.col_tiles, pl.row_blocks, 1)


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no kernel"):
        tg.plan("grouped_dgdw", torch.bfloat16, 1024, 256, 256, 8)
    with pytest.raises(ValueError, match="dtype"):
        tg.plan("grouped_down", torch.float16, 1024, 256, 256, 8)
    with pytest.raises(ValueError, match="a multiple of 64"):
        tg.plan("grouped_dxs", torch.bfloat16, 1000, 256, 256, 8)
    with pytest.raises(ValueError, match="CUDA's limits"):
        tg.plan("grouped_down", torch.float32, 64, 128 * 65536, 8, 1)
    with pytest.raises(ValueError, match="CUDA's limits"):
        tg.plan("grouped_dxs", torch.bfloat16, 128 * 65536, 256, 8, 1)
    with pytest.raises(ValueError, match="CUDA's limits"):
        tg.plan("grouped_gate_up", torch.bfloat16, 128 * 65536, 256, 8, 1)
    with pytest.raises(ValueError, match="CUDA's limits"):
        tg.plan("grouped_wgrad", torch.bfloat16, 1024, 256, 256, 65536)


def _constant(text: str, name: str) -> int:
    m = re.search(rf"\b{name}\s*=\s*(\d+)", text)
    assert m, name
    return int(m.group(1))


def test_plan_matches_the_cuda_sources():
    """The plan's tile, ring and form codes are the C side's."""
    header = (CSRC / "grouped_wgmma.cuh").read_text()
    assert _constant(header, "BM") == tg.WG_BM
    assert _constant(header, "BN") == tg.WG_BN
    assert _constant(header, "BK") == tg.WG_BK
    assert _constant(header, "kConsumers") + 32 == tg.WG_THREADS
    assert _constant(header, "kSmemMax") == tg.SMEM_MAX
    assert "kFit < 4 ? kFit : 4" in header and tg.WG_MAX_STAGES == 4
    # scaled wgrad: the 64 values of w a stage beside the ring
    assert "WBYTES = AF == kAScaled ? BK * 2 : 0" in header
    # dgdu: BN_f f columns a block; a producer warpgroup at 128 columns
    assert f"constexpr int kDgduBN = {tg.WG_DGDU_BN};" in header
    assert "kShift = BNF == 128;" in header
    assert "kThreads = kConsumers + (kShift ? 128 : 32)" in header
    bwd = (CSRC / "grouped_matmul_bwd.cu").read_text()
    assert "G::launch_dgdu<BNF, true>(grouped_dgdu_wgmma_kernel" in bwd
    assert "map_experts(&maps.wo, wo, num_experts, f, d, BNF, G::BK)" in bwd
    assert "n_f_tiles != (f + BNF - 1) / BNF" in bwd
    # gate_up's blocks cover half of B's columns of each output
    fwd = (CSRC / "grouped_matmul.cu").read_text()
    assert "G::launch<G::kAK, G::BN / 2>(grouped_gate_up_wgmma_kernel" in fwd
    for src in ("grouped_matmul.cu", "grouped_matmul_bwd.cu"):
        text = (CSRC / src).read_text()
        assert {f: _constant(text, {"fma": "kFma", "mma": "kMma",
                                    "wgmma": "kWgmma"}[f])
                for f in tg.FORMS} == tg.FORMS


@pytest.mark.parametrize("src,fn", [
    ("grouped_matmul.cu", "dstt_grouped_gate_up"),
    ("grouped_matmul.cu", "dstt_grouped_down"),
    ("grouped_matmul_bwd.cu", "dstt_grouped_dgdu"),
    ("grouped_matmul_bwd.cu", "dstt_grouped_dxs"),
    ("grouped_matmul_bwd.cu", "dstt_grouped_wgrad")])
def test_entry_points_take_only_the_planned_pairings(src, fn):
    """Each C entry point launches for exactly the three (dtype, form)
    pairings plan gives (fp32 FMA, bf16 mma.sync, bf16 wgmma) and refuses
    every other one: no form falls back to another."""
    text = (CSRC / src).read_text()
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    pairs = re.findall(r"if \(dtype == (\d) && form == (k\w+)\)", body)
    assert sorted(pairs) == [("0", "kFma"), ("1", "kMma"), ("1", "kWgmma")]
    assert "if (dtype == " not in re.sub(
        r"if \(dtype == \d && form == k\w+\)", "", body)
    assert re.search(r"return (kInvalid|\(int\)cudaErrorInvalidValue);\s*$",
                     body)


@pytest.mark.parametrize("name,entry", [
    ("void (anonymous namespace)::grouped_gemm_kernel<__nv_bfloat16, true, "
     "false, 2, 64>((anonymous namespace)::Operands<__nv_bfloat16>)",
     "grouped_gate_up"),
    ("void (anonymous namespace)::grouped_gemm_kernel<float, false, true, 1, "
     "128>((anonymous namespace)::Operands<float>)", "grouped_down"),
    ("_ZN12_GLOBAL__N_119grouped_gemm_kernelI13__nv_bfloat16Lb1ELb1ELi1ELi128"
     "EEEvNS_8OperandsIT_EE", "grouped_down"),
    ("(anonymous namespace)::grouped_down_wgmma_kernel(dstt::grouped::Maps, "
     "dstt::grouped::Epilogue)", "grouped_down"),
    ("(anonymous namespace)::grouped_dxs_wgmma_kernel(dstt::grouped::Maps, "
     "dstt::grouped::Epilogue)", "grouped_dxs"),
    ("void (anonymous namespace)::grouped_dxs_kernel<__nv_bfloat16>(x)",
     "grouped_dxs"),
    ("void (anonymous namespace)::grouped_wgrad_kernel<float, true>(x)",
     "grouped_wgrad"),
    ("(anonymous namespace)::grouped_gate_up_wgmma_kernel(dstt::grouped::"
     "Maps, dstt::grouped::Epilogue)", "grouped_gate_up"),
    ("_ZN12_GLOBAL__N_128grouped_gate_up_wgmma_kernelEN4dstt7grouped4MapsE"
     "NS1_8EpilogueE", "grouped_gate_up"),
    ("(anonymous namespace)::grouped_wgrad_wgmma_kernel(dstt::grouped::Maps, "
     "dstt::grouped::WgradEpilogue)", "grouped_wgrad"),
    ("(anonymous namespace)::grouped_wgrad_scaled_wgmma_kernel(dstt::"
     "grouped::Maps, dstt::grouped::WgradEpilogue)", "grouped_wgrad"),
    ("void (anonymous namespace)::grouped_dgdu_wgmma_kernel<true, true>("
     "dstt::grouped::DgduMaps, dstt::grouped::DgduEpilogue)",
     "grouped_dgdu"),
    ("_ZN12_GLOBAL__N_125grouped_dgdu_wgmma_kernelILb0ELb0EEEvN4dstt7grouped"
     "8DgduMapsENS2_12DgduEpilogueE", "grouped_dgdu"),
    ("void (anonymous namespace)::grouped_dgdu_kernel<__nv_bfloat16, true, "
     "true>((anonymous namespace)::DgduArgs<__nv_bfloat16>)",
     "grouped_dgdu"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NNT", None)])
def test_kernel_entry_names_every_form(name, entry):
    """The profile tools class device time by the entry point that
    ``kernel_entry`` reads off a kernel's name."""
    assert tg.kernel_entry(name) == entry


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the FFN and its backward run the plain versions:
    no kernel launch and no form is counted."""
    rng = np.random.default_rng(0)
    s, k, e, d, f = 12, 2, 3, 16, 24
    topi = np.stack([rng.choice(e, size=k, replace=False)
                     for _ in range(s)], 1).astype(np.int32)
    topv = rng.random((k, s)).astype(np.float32)
    tok, w, got, sizes, pos, live = tg.aligned_dispatch(
        torch.from_numpy(topi), torch.from_numpy(topv), e, BM)
    x = torch.from_numpy(rng.standard_normal((s + 1, d)).astype(np.float32))
    xs = tg.gather_rows(x, tok, pos)
    ws = [torch.from_numpy((rng.standard_normal(sh) * 0.1).astype(
        np.float32)).requires_grad_() for sh in ((e, d, f), (e, d, f),
                                                 (e, f, d))]
    op_builder.reset_launches()
    tg.reset_form_launches()
    y = tg.grouped_glu_ffn(xs, *ws, got, sizes, live, bm=BM, w=w)
    y.sum().backward()
    assert all(v == 0 for v in op_builder.launches.values())
    assert all(c == 0 for v in tg.form_launches.values() for c in v.values())
    assert all(p.grad is not None for p in ws)


class _Stream:
    cuda_stream = 0


class _DgduLib:
    """Stands in for the compiled library: records each dstt_grouped_dgdu
    call's arguments and fills the dw partials [n_f_tiles, rows] it is
    handed with dwp[j, r] = j + 1 + r / 1024, as the kernel would write
    one partial per column tile."""

    def __init__(self):
        self.calls = []

    def dstt_grouped_dgdu(self, *args):
        self.calls.append(args)
        dwp, rows, nf = args[11], args[14], args[18]
        if dwp is not None:
            part = np.ctypeslib.as_array(
                ctypes.cast(dwp, ctypes.POINTER(ctypes.c_float)),
                shape=(nf, rows))
            part[:] = (np.arange(nf)[:, None] + 1
                       + np.arange(rows)[None] / 1024)
        return 0


#: (dtype, d, f, recomputed, with w): the main paths' call (wgmma), the
#: saved form, bf16 off TMA's 8 (mma.sync), fp32 (FMA)
DGDU_WRAPPER_CASES = {
    "wgmma_rc_w": (torch.bfloat16, 256, 384, True, True),
    "wgmma_saved": (torch.bfloat16, 256, 200, False, False),
    "mma_rc_w": (torch.bfloat16, 100, 150, True, True),
    "fma_saved_w": (torch.float32, 128, 130, False, True),
}


@pytest.mark.parametrize("name", sorted(DGDU_WRAPPER_CASES))
def test_dgdu_wrapper_launches_the_plan(name, monkeypatch):
    """dgdu_kernel passes the plan's form, band and column tiles to the C
    entry (with the expert count its tensor maps need), counts one launch
    under that form, and sums the dw partials over exactly the plan's
    column tiles, zero past the live rows."""
    dtype, d, f, rc, with_w = DGDU_WRAPPER_CASES[name]
    e, r_pad, live_tiles = 4, 512, 5
    lib = _DgduLib()
    monkeypatch.setattr(op_builder, "load", lambda name: lib)
    monkeypatch.setattr(op_builder, "launches", dict(op_builder.launches))
    monkeypatch.setattr(tg, "form_launches",
                        {k: {f_: 0 for f_ in tg.FORMS} for k in tg.PLANNED})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    dz = torch.zeros((r_pad, d), dtype=dtype)
    wo = torch.zeros((e, f, d), dtype=dtype)
    got = torch.zeros(r_pad // BM, dtype=torch.int32)
    live = torch.tensor([live_tiles], dtype=torch.int32)
    kw = dict(xs=torch.zeros_like(dz), wg=torch.zeros((e, d, f), dtype=dtype),
              wi=torch.zeros((e, d, f), dtype=dtype)) if rc else \
        dict(gate=torch.zeros((r_pad, f), dtype=dtype),
             up=torch.zeros((r_pad, f), dtype=dtype))
    w = torch.ones(r_pad, dtype=dtype) if with_w else None
    dg, du, h, dw2 = tg.dgdu_kernel(dz, wo, got, live, BM, w=w, **kw)
    pl = tg.plan("grouped_dgdu", dtype, r_pad, d, f, e, saved=not rc)
    (args,) = lib.calls
    assert args[14:23] == (r_pad, d, f, BM, pl.col_tiles, e,
                           tg._DTYPES[dtype], tg.FORMS[pl.form], pl.band)
    assert (args[1] is None) == (not rc) and (args[5] is None) == rc
    assert (args[7] is None) == (args[11] is None) == (not with_w)
    assert dg.shape == du.shape == h.shape == (r_pad, f)
    assert op_builder.launches["grouped_dgdu"] == 1
    assert tg.form_launches["grouped_dgdu"] == {
        f_: int(f_ == pl.form) for f_ in tg.FORMS}
    if with_w:
        rows = np.arange(r_pad)
        nf = pl.col_tiles
        want = np.where(rows < live_tiles * BM,
                        nf * (nf + 1) / 2 + nf * rows / 1024, 0.0)
        np.testing.assert_allclose(dw2.float().numpy(), want, rtol=1e-2)
        assert dw2.dtype == dtype
    else:
        assert dw2 is None

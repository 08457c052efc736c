#!/usr/bin/env python3
"""What holds the wgmma forms of the grouped GEMMs: variants of
``deepspeed_tpu_torch/ops/csrc/grouped_wgmma.cuh`` built side by side and
timed on one NVIDIA GPU at the path shapes, beside the kernels' other
forms.

Each source variant is the checked-in source with a few text patches
(every patch must apply once), built by ``nvcc`` into its own library under
``build/variants/`` and called through the same C entry point as the port's
kernel (the wgmma form). The source variants:

- ``base``, ``dxs_base``: the sources as they are;
- ``no_up`` (down): no ``up`` operand: stages of 48 KB (gate and wo), four
  of them, and A = gate with no GLU: the same GEMM without up's bytes;
- ``glu_xor`` (down): both operands loaded and read as in ``base``, A =
  gate XOR up instead of silu(gate)·up: the GLU's arithmetic removed;
- ``n128``, ``dxs_n128``: two wgmma m64n128k16 a k16 slice instead of one
  m64n256k16 (gate_up and wgrad share the change in these libraries);
- ``dxs_bk32``: 32-deep k-steps (64-byte swizzle) and up to 8 stages;
- ``m_fast``, ``dxs_m_fast``: down's and dxs's row blocks fastest on the
  grid instead of the column tiles (one band of all row blocks);
- ``dwo_noscale`` (wgrad): the scaled product's A fragments taken from
  the dz box as they are, without w: the register-A path without its
  arithmetic;
- ``dwo_w_inline`` (wgrad): each k16 slice's 4 values of w read beside
  its ldmatrix load instead of the step's 16 before them;
- ``dgdu_n128`` (dgdu): 128 f columns a block instead of 64 (192 fp32
  accumulators a consumer thread, 80 KB stages, 2 of them, a producer
  warpgroup that hands its registers to the consumers through
  setmaxnreg); ``dgdu_n128_uniform`` (dgdu): the same with the warp's
  role read through ``__shfl_sync`` from lane 0, so that the compiler can
  see it is uniform across the warp; ``dgdu_n128_w288`` (dgdu): the same
  tile with one producer warp and no register shift (288 threads); the
  base library's dgdu is ``dgdu_n64``.

Each build's ptxas warnings that wgmma was serialized (C7513), and the
registers and spilled bytes of each wgmma kernel, are printed as a JSON
line too.

Call variants of ``base`` / ``dxs_base`` (no rebuild):

- every kernel also in its mma.sync form (``mma``: form 1), the kernel
  the wgmma form replaced on bf16 main paths;
- gate_up with the column tiles fastest (``colfast``: band 1), in bands
  of as many row blocks as keep their xs within the plan's L2 share
  whatever the weights' size (``bands``), and with the row blocks fastest
  (``rowfast``: one band of all row blocks), beside the plan's raster;
- wgrad for each of its three products of a layer: dwg = xsᵀ·dg, dwi =
  xsᵀ·du, dwo = hᵀ·round(dz·w) (the transposed, register-A form);
- dgdu (gate/up recomputed, with w: the main paths' call) with the
  column tiles fastest (``dgdu_n64_colfast``), in bands of as many row
  blocks as keep their dz and xs within the plan's L2 share whatever the
  weights' size (``dgdu_n64_bands``), in its saved form (gate/up read,
  ``dgdu_n64_saved``), beside the plan's raster.

Variants that change the function report no error. Run from the root of a
checkout on a machine with one GPU:
``python3 tools/grouped_wgmma_variants.py [--only gate_up wgrad dgdu]``; one
JSON line a (variant, kernel, shape), also written to
``grouped_wgmma_variants.jsonl`` in the checkout's output directory.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DOWN_MMA = """      if constexpr (C::kRS)
        hw::wgmma_m64n256k16_rs<TRANS_B>(acc0, acc1, af[kk], db(0), 1);
      else
        hw::wgmma_m64n256k16<TRANS_B, TRANS_A>(acc0, acc1, da, db(0), 1);"""
_N128 = """      if constexpr (C::kRS) {
        hw::wgmma_m64n128k16_rs<TRANS_B>(acc0, af[kk], db(0), 1);
        hw::wgmma_m64n128k16_rs<TRANS_B>(acc1, af[kk], db(1), 1);
      } else {
        hw::wgmma_m64n128k16<TRANS_B, TRANS_A>(acc0, da, db(0), 1);
        hw::wgmma_m64n128k16<TRANS_B, TRANS_A>(acc1, da, db(1), 1);
      }"""
_GLU = "for (int j = 0; j < 4; ++j) af[kk][j] = glu2(g[j], u[j]);"
_SW = ("  return hw::make_map_4d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims,"
       "\n                         strides, box, CU_TENSOR_MAP_SWIZZLE_{}B);"
       "\n}}\n\n// {}")
#: name → (library, [(old, new)])
VARIANTS = {
    "base": ("grouped_matmul", []),
    "no_up": ("grouped_matmul", [
        ("static constexpr int AHALF = kTile * (AF == kAGlu ? 2 : 1);",
         "static constexpr int AHALF = kTile;"),
        ("            load_a(2 + half, &maps.a[1], r);\n", ""),
        ("      ldmatrix_x4(u, a + 2 * kTile + o);\n", ""),
        (_GLU, "for (int j = 0; j < 4; ++j) af[kk][j] = g[j];")]),
    "glu_xor": ("grouped_matmul", [
        (_GLU, "for (int j = 0; j < 4; ++j) af[kk][j] = g[j] ^ u[j];")]),
    "n128": ("grouped_matmul", [(_DOWN_MMA, _N128)]),
    "m_fast": ("grouped_matmul", [
        ("static_cast<const __nv_bfloat16*>(w), gt, lt, d, f,\n"
         "                       bm, 1};",
         "static_cast<const __nv_bfloat16*>(w), gt, lt, d, f,\n"
         "                       bm, 65535};")]),
    "dxs_base": ("grouped_matmul_bwd", []),
    "dxs_bk32": ("grouped_matmul_bwd", [
        ("constexpr int BK = 64;", "constexpr int BK = 32;"),
        ("kFit < 4 ? kFit : 4;\n  static_assert(kStages >= 2, \"no room for "
         "a two-stage ring\");\n  static constexpr int SMEM = kStages * "
         "(STAGE + WBYTES)",
         "kFit < 8 ? kFit : 8;\n  static_assert(kStages >= 2, \"no room for "
         "a two-stage ring\");\n  static constexpr int SMEM = kStages * "
         "(STAGE + WBYTES)"),
        (_SW.format(128, "E matrices"), _SW.format(64, "E matrices")),
        (_SW.format(128, "A bf16 vector"), _SW.format(64, "A bf16 vector")),
        # the 64-byte swizzle's descriptors: layout type 2, 512 bytes
        # between 8-row groups, B's halves 8 KB apart
        ("hw::desc_sw128(b + q * 16384 + kk * 32, 16, 1024)",
         "(hw::desc_sw128(b + q * 8192 + kk * 32, 16, 512) ^ (3ull << 62))"),
        ("hw::desc_sw128(a + kk * 32, 16, 1024)",
         "(hw::desc_sw128(a + kk * 32, 16, 512) ^ (3ull << 62))")]),
    "dxs_n128": ("grouped_matmul_bwd", [(_DOWN_MMA, _N128)]),
    "dxs_m_fast": ("grouped_matmul_bwd", [
        ("gt, lt, d, f, bm, 1};", "gt, lt, d, f, bm, 65535};")]),
    "dwo_noscale": ("grouped_matmul_bwd", [
        ("      af[kk][0] = scale2(v[0], w0);\n"
         "      af[kk][1] = scale2(v[1], w0);\n"
         "      af[kk][2] = scale2(v[2], w1);\n"
         "      af[kk][3] = scale2(v[3], w1);\n",
         "      for (int q = 0; q < 4; ++q) af[kk][q] = v[q];\n")]),
    "dgdu_n128": ("grouped_matmul_bwd", [
        ("constexpr int kDgduBN = 64;", "constexpr int kDgduBN = 128;")]),
    "dgdu_n128_uniform": ("grouped_matmul_bwd", [
        ("constexpr int kDgduBN = 64;", "constexpr int kDgduBN = 128;"),
        ("  if (warp >= kConsumers / 32) {",
         "  if (__shfl_sync(0xffffffffu, tid / 128, 0) == "
         "kConsumers / 128) {")]),
    "dgdu_n128_w288": ("grouped_matmul_bwd", [
        ("constexpr int kDgduBN = 64;", "constexpr int kDgduBN = 128;"),
        ("static constexpr bool kShift = BNF == 128;",
         "static constexpr bool kShift = false;")]),
    "dwo_w_inline": ("grouped_matmul_bwd", [
        ("    float2 ws[BK / 16][2];\n#pragma unroll\n"
         "    for (int kk = 0; kk < BK / 16; ++kk)\n#pragma unroll\n"
         "      for (int h = 0; h < 2; ++h)\n"
         "        ws[kk][h] = __bfloat1622float2(*reinterpret_cast<\n"
         "            const __nv_bfloat162*>(w + kk * 16 + 2 * (lane & 3) + "
         "8 * h));\n", ""),
        ("      const float2 w0 = ws[kk][0], w1 = ws[kk][1];\n",
         "      const int k0 = kk * 16 + 2 * (lane & 3);\n"
         "      const float2 w0 = __bfloat1622float2(\n"
         "          *reinterpret_cast<const __nv_bfloat162*>(w + k0));\n"
         "      const float2 w1 = __bfloat1622float2(\n"
         "          *reinterpret_cast<const __nv_bfloat162*>(w + k0 + 8));\n")]),
}
#: (kernel, name, tokens, top-k, experts, d, f)
SHAPES = [("gate_up", "mixtral", 2048, 2, 8, 4096, 14336),
          ("gate_up", "qwen", 2048, 4, 60, 2048, 1408),
          ("gate_up", "1b8e", 16384, 2, 8, 1024, 2816),
          ("down", "mixtral", 2048, 2, 8, 4096, 14336),
          ("down", "qwen", 2048, 4, 60, 2048, 1408),
          ("down", "1b8e", 16384, 2, 8, 1024, 2816),
          ("dxs", "1b8e", 16384, 2, 8, 1024, 2816),
          ("dxs", "mixtral", 2048, 2, 8, 4096, 14336),
          ("wgrad", "1b8e", 16384, 2, 8, 1024, 2816),
          ("wgrad", "mixtral", 2048, 2, 8, 4096, 14336),
          ("dgdu", "1b8e", 16384, 2, 8, 1024, 2816),
          ("dgdu", "mixtral", 2048, 2, 8, 4096, 14336)]
#: the library each kernel lives in
_LIB = {"gate_up": "grouped_matmul", "down": "grouped_matmul",
        "dxs": "grouped_matmul_bwd", "wgrad": "grouped_matmul_bwd",
        "dgdu": "grouped_matmul_bwd"}
#: variants that compute another function
_CHANGED = {"no_up", "glu_xor", "dwo_noscale"}
#: the source variants of the kernels they were made for (the others run
#: only the base library's call variants)
_FOR = {"no_up": "down", "glu_xor": "down", "m_fast": "down",
        "dxs_bk32": "dxs", "dxs_m_fast": "dxs", "dwo_noscale": "wgrad",
        "dwo_w_inline": "wgrad", "dgdu_n128": "dgdu",
        "dgdu_n128_w288": "dgdu", "dgdu_n128_uniform": "dgdu"}


def _ptxas_wgmma(log):
    """Registers and spilled bytes (stores + loads) of each wgmma kernel in
    an ``nvcc -Xptxas -v`` log, by its name and template arguments (e.g.
    ``grouped_dgdu_wgmma_kernel<1, 1>``), and ptxas's lines on setmaxnreg."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            k = re.search(r"\d([a-z_]+wgmma_kernel)(?:I((?:Lb[01]E)+))?",
                          m.group(1))
            name = None
            if k:
                args = re.findall(r"Lb([01])E", k.group(2) or "")
                name = k.group(1) + (f"<{', '.join(args)}>" if args else "")
                out.setdefault(name, {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    notes = [ln.strip() for ln in log.splitlines() if "setmaxnreg" in ln]
    if notes:
        out["setmaxnreg"] = notes[:8]
    return out


def _build(op_builder, root):
    """One nvcc per variant, all started together; name → loaded lib."""
    nvcc = op_builder.find_nvcc()
    procs = {}
    for name, (stem, patches) in VARIANTS.items():
        d = os.path.join(root, name)
        shutil.copytree(op_builder.CSRC, d)
        texts = {fn: open(os.path.join(d, fn)).read() for fn in os.listdir(d)}
        for old, new in patches:
            hits = [fn for fn, t in texts.items() if old in t]
            if len(hits) != 1 or texts[hits[0]].count(old) != 1:
                raise RuntimeError(f"{name}: a patch applies {len(hits)} "
                                   f"times, not once: {old[:60]!r}")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        for fn, t in texts.items():
            with open(os.path.join(d, fn), "w") as fh:
                fh.write(t)
        cmd = [nvcc, *op_builder.NVCC_FLAGS, "-I", d, "-o",
               os.path.join(d, "lib.so"), os.path.join(d, f"{stem}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        serialized = sorted({
            re.search(r"\d([a-z_]+_kernel)", fn).group(1)
            for fn in re.findall(r"C7513\).*?function '([^']+)'", log)})
        print(json.dumps({"variant": name, "build": "ok",
                          "wgmma_serialized_in": serialized,
                          "wgmma_kernels": _ptxas_wgmma(log)}), flush=True)
        stem = VARIANTS[name][0]
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        for fn, (argtypes, restype) in op_builder._SIGNATURES[stem].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def _calls(kernel, name, lib, ops, dims, plan, st):
    """(label, form, call) of each way to run ``kernel`` on ``lib``: the
    wgmma form, and on the base libraries the mma.sync form and the
    rasters and forms the module docstring lists."""
    import torch
    tg, fm = plan, ops
    got, live, bm, e, d, f = dims
    base = name in ("base", "dxs_base")
    wg_, mma = fm["wgmma"], fm["mma"]
    out = []
    if kernel == "gate_up":
        xs, wg, wi, gate, up = ops["tensors"]
        band = tg("grouped_gate_up", torch.bfloat16, xs.shape[0], d, f,
                  e).band

        def gu(form, b):
            return lambda: lib.dstt_grouped_gate_up(
                xs.data_ptr(), wg.data_ptr(), wi.data_ptr(), gate.data_ptr(),
                up.data_ptr(), got.data_ptr(), live.data_ptr(), xs.shape[0],
                d, f, bm, e, 1, form, b, st)
        out.append((f"{name}", wg_, gu(wg_, band)))
        if base:
            # bands whose xs fills the L2 share, whatever the weights
            from deepspeed_tpu_torch.ops.grouped_matmul import \
                GATE_UP_BAND_BYTES
            bands = max(1, GATE_UP_BAND_BYTES // (128 * d * 2))
            out += [("colfast", wg_, gu(wg_, 1)),
                    ("bands", wg_, gu(wg_, bands)),
                    ("rowfast", wg_, gu(wg_, 65535)),
                    ("mma", mma, gu(mma, 0))]
    elif kernel == "down":
        a, b, wo, w, y = ops["tensors"]

        def dn(form):
            return lambda: lib.dstt_grouped_down(
                a.data_ptr(), b.data_ptr(), wo.data_ptr(), w.data_ptr(),
                y.data_ptr(), got.data_ptr(), live.data_ptr(), a.shape[0], f,
                d, bm, e, 1, form, st)
        out.append((name, wg_, dn(wg_)))
        if base:
            out.append(("mma", mma, dn(mma)))
    elif kernel == "dxs":
        a, b, wg, wi, y = ops["tensors"]

        def dx(form):
            return lambda: lib.dstt_grouped_dxs(
                a.data_ptr(), b.data_ptr(), wg.data_ptr(), wi.data_ptr(),
                y.data_ptr(), got.data_ptr(), live.data_ptr(), a.shape[0], d,
                f, bm, e, 1, form, st)
        out.append((name, wg_, dx(wg_)))
        if base:
            out.append(("mma", mma, dx(mma)))
    elif kernel == "dgdu":
        if name not in ("dxs_base", "dgdu_n128", "dgdu_n128_w288",
                        "dgdu_n128_uniform"):
            return []
        dz, xs, wg, wi, wo, w, gate, up, dg, du, h, dwp = ops["tensors"]
        bnf = 64 if base else 128
        rows = dz.shape[0]
        band = tg("grouped_dgdu", torch.bfloat16, rows, d, f, e).band
        band_saved = tg("grouped_dgdu", torch.bfloat16, rows, d, f, e,
                        saved=True).band

        def dd(form, b, rc=True):
            nf = -(-f // (bnf if form == wg_ else 64))
            return lambda: lib.dstt_grouped_dgdu(
                dz.data_ptr(), xs.data_ptr() if rc else None,
                wg.data_ptr() if rc else None, wi.data_ptr() if rc else None,
                wo.data_ptr(), None if rc else gate.data_ptr(),
                None if rc else up.data_ptr(), w.data_ptr(), dg.data_ptr(),
                du.data_ptr(), h.data_ptr(), dwp.data_ptr(), got.data_ptr(),
                live.data_ptr(), rows, d, f, bm, nf, e, 1, form, b, st)
        out.append(("dgdu_n64" if base else name, wg_, dd(wg_, band)))
        if base:
            from deepspeed_tpu_torch.ops.grouped_matmul import \
                GATE_UP_BAND_BYTES
            bands = max(1, GATE_UP_BAND_BYTES // (2 * 128 * d * 2))
            out += [("dgdu_n64_colfast", wg_, dd(wg_, 1)),
                    ("dgdu_n64_bands", wg_, dd(wg_, bands)),
                    ("dgdu_n64_saved", wg_, dd(wg_, band_saved, False)),
                    ("mma", mma, dd(mma, 0))]
    else:
        prods = ops["tensors"]          # product → (a, b, scale, out)
        for prod, (a, b, sc, y) in prods.items():
            def wgr(form, a=a, b=b, sc=sc, y=y):
                return lambda: lib.dstt_grouped_wgrad(
                    a.data_ptr(), b.data_ptr(),
                    None if sc is None else sc.data_ptr(), y.data_ptr(),
                    got.data_ptr(), live.data_ptr(), a.shape[0], a.shape[1],
                    b.shape[1], e, bm, 1, form, st)
            out.append((f"{name}:{prod}", wg_, wgr(wg_)))
            if base:
                out.append((f"mma:{prod}", mma, wgr(mma)))
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="kernels to time (gate_up, down, dxs, wgrad, dgdu)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grouped_wgmma_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.parallel.moe import GMM_BM as bm

    only = set(args.only or _LIB)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    root = os.path.join(HERE, "build", "variants")
    shutil.rmtree(root, ignore_errors=True)
    for name in [n for n, k in _FOR.items() if k not in only]:
        del VARIANTS[name]
    libs = _build(op_builder, root)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    out_path = os.path.join(HERE, "chiprun_out",
                            "grouped_wgmma_variants.jsonl")
    rng = np.random.default_rng(0)
    with open(out_path, "w") as out_file:
        for kernel, label, s, k, e, d, f in SHAPES:
            if kernel not in only:
                continue
            xs, (wg, wi, wo), (got, sizes, live), w, _ = cs._grouped_case(
                rng, s, k, e, d, f, torch.bfloat16, "router")
            end = int(live[0]) * bm
            st = torch.cuda.current_stream().cuda_stream
            g = torch.Generator(device="cuda").manual_seed(1)

            def rnd(*shape):
                return (torch.randn(*shape, generator=g, device="cuda")
                        * 0.1).bfloat16()
            refs, flops = {}, 2.0 * d * f * s * k
            if kernel == "gate_up":
                rg, ru = tg.gate_up_ref(xs, wg, wi, sizes, live, bm)
                gate, up = torch.empty_like(rg), torch.empty_like(ru)
                tensors = (xs, wg, wi, gate, up)
                refs = {"": ((rg, ru), (gate, up))}
                flops *= 2
            elif kernel == "down":
                a, b = tg.gate_up_ref(xs, wg, wi, sizes, live, bm)
                y = torch.empty((xs.shape[0], d), dtype=torch.bfloat16,
                                device="cuda")
                tensors = (a, b, wo, w, y)
                refs = {"": ((tg.down_ref(a, b, wo, sizes, live, bm, w),),
                             (y,))}
            elif kernel == "dgdu":
                # the main paths' call: gate/up recomputed, with w; the
                # saved form is fed the same gate/up, rounded as recomputed
                dz = rnd(xs.shape[0], d)
                gate, up = tg.gate_up_ref(xs, wg, wi, sizes, live, bm)
                dg, du, h = (torch.empty_like(gate) for _ in range(3))
                dwp = torch.empty((-(-f // 32), xs.shape[0]), device="cuda")
                tensors = (dz, xs, wg, wi, wo, w, gate, up, dg, du, h, dwp)
                want = tg.dgdu_ref(dz, wo, sizes, live, bm, xs=xs, wg=wg,
                                   wi=wi, w=w)
                refs = {"": (want[:3], (dg, du, h))}
                flops *= 3
            elif kernel == "dxs":
                a, b = rnd(xs.shape[0], f), rnd(xs.shape[0], f)
                y = torch.empty((xs.shape[0], d), dtype=torch.bfloat16,
                                device="cuda")
                tensors = (a, b, wg, wi, y)
                refs = {"": ((tg.dxs_ref(a, b, wg, wi, sizes, live, bm),),
                             (y,))}
                flops *= 2
            else:
                dg, du, dz = (rnd(xs.shape[0], f), rnd(xs.shape[0], f),
                              rnd(xs.shape[0], d))
                h = rnd(xs.shape[0], f)
                tensors = {}
                for prod, (a, b, sc) in (("dwg", (xs, dg, None)),
                                         ("dwi", (xs, du, None)),
                                         ("dwo", (h, dz, w))):
                    y = torch.empty((e, a.shape[1], b.shape[1]),
                                    dtype=torch.bfloat16, device="cuda")
                    tensors[prod] = (a, b, sc, y)
                    refs[prod] = ((tg.wgrad_ref(a, b, sizes, live, bm, sc),),
                                  (y,))
            ops = {"tensors": tensors, **tg.FORMS}
            for name, lib in libs.items():
                if VARIANTS[name][0] != _LIB[kernel] or \
                        _FOR.get(name, kernel) != kernel:
                    continue
                for vname, form, call in _calls(
                        kernel, name, lib, ops, (got, live, bm, e, d, f),
                        tg.plan, st):
                    op_builder.check(lib, call(), vname)
                    torch.cuda.synchronize()
                    ms = cs.cuda_time_ms(call, iters=10)
                    prod = vname.split(":")[1] if ":" in vname else ""
                    want, got_out = refs[prod]
                    rows = slice(None) if kernel == "wgrad" \
                        else slice(0, end)
                    err = None if name in _CHANGED else max(
                        cs._row_rel_err(o[rows], r[rows])
                        for o, r in zip(got_out, want))
                    row = {"variant": vname, "library": name,
                           "kernel": kernel, "shape": label, "card": card,
                           "form": {v: c for c, v in tg.FORMS.items()}[form],
                           "ms": ms, "tflops_per_s": flops / ms / 1e9,
                           "row_rel_err": err}
                    line = json.dumps(row)
                    print(line, flush=True)
                    out_file.write(line + "\n")
            del xs, wg, wi, wo, tensors, refs, ops
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

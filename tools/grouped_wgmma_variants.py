#!/usr/bin/env python3
"""What holds the wgmma forms of grouped_down and grouped_dxs: variants of
``deepspeed_tpu_torch/ops/csrc/grouped_wgmma.cuh`` built side by side and
timed on one NVIDIA GPU at the path shapes.

Each variant is the checked-in source with a few text patches (every patch
must apply), built by ``nvcc`` into its own library under
``build/variants/`` and called through the same C entry point as the port's
kernel (the wgmma form). The variants:

- ``base``, ``dxs_base``: the sources as they are;
- ``no_up`` (down): no ``up`` operand: stages of 48 KB (gate and wo), four
  of them, and A = gate with no GLU: the same GEMM without up's bytes;
- ``glu_xor`` (down): both operands loaded and read as in ``base``, A =
  gate XOR up instead of silu(gate)·up: the GLU's arithmetic removed;
- ``n128``, ``dxs_n128``: two wgmma m64n128k16 a k16 slice instead of one
  m64n256k16;
- ``dxs_bk32``: 32-deep k-steps (64-byte swizzle) and up to 8 stages;
- ``m_fast``, ``dxs_m_fast``: the row blocks fastest on the grid instead
  of the column tiles.

Variants that change the function report no error. Run from the root of a
checkout on a machine with one GPU:
``python3 tools/grouped_wgmma_variants.py``; one JSON line a (variant,
shape), also written to ``chiprun_out/grouped_wgmma_variants.jsonl``.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DOWN_MMA = """      if constexpr (kGLU)
        hw::wgmma_m64n256k16_rs<TRANS_B>(acc0, acc1, af[kk], db(0), 1);
      else
        hw::wgmma_m64n256k16<TRANS_B>(acc0, acc1, da, db(0), 1);"""
_GLU = "for (int j = 0; j < 4; ++j) af[kk][j] = glu2(g[j], u[j]);"
#: name → (library, [(old, new)])
VARIANTS = {
    "base": ("grouped_matmul", []),
    "no_up": ("grouped_matmul", [
        ("static constexpr int AHALF = kTile * (kGLU ? 2 : 1);",
         "static constexpr int AHALF = kTile;"),
        ("            load_a(2 + half, &maps.a[1], r);\n", ""),
        ("      ldmatrix_x4(u, a + 2 * kTile + o);\n", ""),
        (_GLU, "for (int j = 0; j < 4; ++j) af[kk][j] = g[j];")]),
    "glu_xor": ("grouped_matmul", [
        (_GLU, "for (int j = 0; j < 4; ++j) af[kk][j] = g[j] ^ u[j];")]),
    "n128": ("grouped_matmul", [(_DOWN_MMA, """      if constexpr (kGLU) {
        hw::wgmma_m64n128k16_rs<TRANS_B>(acc0, af[kk], db(0), 1);
        hw::wgmma_m64n128k16_rs<TRANS_B>(acc1, af[kk], db(1), 1);
      } else {
        hw::wgmma_m64n128k16<TRANS_B>(acc0, da, db(0), 1);
        hw::wgmma_m64n128k16<TRANS_B>(acc1, da, db(1), 1);
      }""")]),
    "dxs_base": ("grouped_matmul_bwd", []),
    "dxs_bk32": ("grouped_matmul_bwd", [
        ("constexpr int BK = 64;", "constexpr int BK = 32;"),
        ("static constexpr int kStages = kFit < 4 ? kFit : 4;\n  static_assert"
         "(kStages >= 2, \"no room for a two-stage ring\");\n  static "
         "constexpr int SMEM = kStages * STAGE + 16 * kStages + 1024;",
         "static constexpr int kStages = kFit < 8 ? kFit : 8;\n  static_assert"
         "(kStages >= 2, \"no room for a two-stage ring\");\n  static "
         "constexpr int SMEM = kStages * STAGE + 16 * kStages + 1024;"),
        ("                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);"
         "\n}\n\n// E matrices",
         "                         strides, box, CU_TENSOR_MAP_SWIZZLE_64B);"
         "\n}\n\n// E matrices"),
        ("  return hw::make_map_4d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims,"
         "\n                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);"
         "\n}\n\n// What TMA",
         "  return hw::make_map_4d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims,"
         "\n                         strides, box, CU_TENSOR_MAP_SWIZZLE_64B);"
         "\n}\n\n// What TMA"),
        # the 64-byte swizzle's descriptors: layout type 2, 512 bytes
        # between 8-row groups, B's halves 8 KB apart
        ("hw::desc_sw128(b + q * 16384 + kk * 32, 16, 1024)",
         "(hw::desc_sw128(b + q * 8192 + kk * 32, 16, 512) ^ (3ull << 62))"),
        ("hw::desc_sw128(a + kk * 32, 16, 1024)",
         "(hw::desc_sw128(a + kk * 32, 16, 512) ^ (3ull << 62))")]),
    "dxs_n128": ("grouped_matmul_bwd", [(_DOWN_MMA, """      if constexpr (kGLU) {
        hw::wgmma_m64n128k16_rs<TRANS_B>(acc0, af[kk], db(0), 1);
        hw::wgmma_m64n128k16_rs<TRANS_B>(acc1, af[kk], db(1), 1);
      } else {
        hw::wgmma_m64n128k16<TRANS_B>(acc0, da, db(0), 1);
        hw::wgmma_m64n128k16<TRANS_B>(acc1, da, db(1), 1);
      }""")]),
}
_MFAST = [("  const int row0 = blockIdx.y * BM;", "  const int row0 = blockIdx.x * BM;"),
          ("  const bool split = g1 != g0;\n  const int n0 = blockIdx.x * BN;",
           "  const bool split = g1 != g0;\n  const int n0 = blockIdx.y * BN;"),
          ("  const dim3 grid((ep.N + BN - 1) / BN, (rows + BM - 1) / BM);",
           "  const dim3 grid((rows + BM - 1) / BM, (ep.N + BN - 1) / BN);")]
VARIANTS["m_fast"] = ("grouped_matmul", _MFAST)
VARIANTS["dxs_m_fast"] = ("grouped_matmul_bwd", _MFAST)
#: (kernel, name, tokens, top-k, experts, d, f)
SHAPES = [("down", "mixtral", 2048, 2, 8, 4096, 14336),
          ("down", "qwen", 2048, 4, 60, 2048, 1408),
          ("down", "1b8e", 16384, 2, 8, 1024, 2816),
          ("dxs", "1b8e", 16384, 2, 8, 1024, 2816),
          ("dxs", "mixtral", 2048, 2, 8, 4096, 14336)]
#: variants that compute another function
_CHANGED = {"no_up", "glu_xor"}


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
        stem = VARIANTS[name][0]
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        for fn, (argtypes, restype) in op_builder._SIGNATURES[stem].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("grouped_wgmma_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import grouped_matmul as tg
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.parallel.moe import GMM_BM as bm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    root = os.path.join(HERE, "build", "variants")
    shutil.rmtree(root, ignore_errors=True)
    libs = _build(op_builder, root)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    out_path = os.path.join(HERE, "chiprun_out",
                            "grouped_wgmma_variants.jsonl")
    rng = np.random.default_rng(0)
    wgmma = tg.FORMS["wgmma"]
    with open(out_path, "w") as out_file:
        for kernel, label, s, k, e, d, f in SHAPES:
            xs, (wg, wi, wo), (got, sizes, live), w, _ = cs._grouped_case(
                rng, s, k, e, d, f, torch.bfloat16, "router")
            end = int(live[0]) * bm
            st = torch.cuda.current_stream().cuda_stream
            if kernel == "down":
                a, b = tg.gate_up_ref(xs, wg, wi, sizes, live, bm)
                ref = tg.down_ref(a, b, wo, sizes, live, bm, w)
                flops = 2.0 * d * f * s * k
            else:
                g = torch.Generator(device="cuda").manual_seed(1)
                a, b = ((torch.randn(xs.shape[0], f, generator=g,
                                     device="cuda") * 0.1).bfloat16()
                        for _ in range(2))
                ref = tg.dxs_ref(a, b, wg, wi, sizes, live, bm)
                flops = 4.0 * d * f * s * k
            for name, lib in libs.items():
                if (VARIANTS[name][0] == "grouped_matmul") != \
                        (kernel == "down"):
                    continue
                y = torch.empty_like(ref)
                if kernel == "down":
                    def call(lib=lib, y=y):
                        return lib.dstt_grouped_down(
                            a.data_ptr(), b.data_ptr(), wo.data_ptr(),
                            w.data_ptr(), y.data_ptr(), got.data_ptr(),
                            live.data_ptr(), xs.shape[0], f, d, bm, e, 1,
                            wgmma, st)
                else:
                    def call(lib=lib, y=y):
                        return lib.dstt_grouped_dxs(
                            a.data_ptr(), b.data_ptr(), wg.data_ptr(),
                            wi.data_ptr(), y.data_ptr(), got.data_ptr(),
                            live.data_ptr(), xs.shape[0], d, f, bm, e, 1,
                            wgmma, st)
                op_builder.check(lib, call(), name)
                torch.cuda.synchronize()
                ms = cs.cuda_time_ms(call, iters=10)
                row = {"variant": name, "kernel": kernel, "shape": label,
                       "card": card, "ms": ms, "tflops_per_s": flops / ms / 1e9,
                       "row_rel_err": None if name in _CHANGED
                       else cs._row_rel_err(y[:end], ref[:end])}
                line = json.dumps(row)
                print(line, flush=True)
                out_file.write(line + "\n")
            del xs, wg, wi, wo, a, b, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

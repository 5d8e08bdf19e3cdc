"""Where K9's and K8's time goes on the card: clock stamps and ablations of
``csrc/int8_dense.cu``.

Each variant is a patched copy of the kernel source, compiled with the
library's ``nvcc`` flags (``-Xptxas -v``, whose registers are printed) into
a library of its own under ``protosam_tpu_torch/_build/stamp_int8/`` and
called through its C entry.  Every K9 variant carries clock stamps: per
tile, thread 0 of each consumer warpgroup records the cycles (``clock64``)
it waited for the tile's first stage, spent in the main loop (until the
last products completed) and in the epilogue; the loader records when it
requested the tile's first stage, printed as how long before the consumers
had it.  Cycles are converted at the card's maximum SM clock.

K9 variants, at the phase-2 shapes of ``roofline.MAIN_PATH_SHAPES``:

- ``built``: the kernel as built;
- ``pairs``: each thread stores its D-fragment pairs straight to device
  memory, as K9's first version did, instead of through the staging tile;
- ``no_dequant`` (a timing only: its outputs are wrong): the epilogue
  stages the raw sums, without the dequant, the bias or the cast;
- ``no_epilogue`` (a timing only): nothing is written;
- ``tile_128``: 128 x 128 tiles (m64n128k32, six stages of 32 KB).

K8 variants, at the DINOv2-L fc2 rows and at the fc2 operands in one
launch:

- ``built``;
- ``reciprocal`` (a timing only): codes from x * (1 / scale) rounded,
  without the exact quotient;
- ``no_min_blocks``: without the launch bound of four blocks an SM.

    python3 -m protosam_tpu_torch.tools.stamp_int8 [--reps 10]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from protosam_tpu_torch import kernels
from protosam_tpu_torch.tools import ptxas_report
from protosam_tpu_torch.tools.roofline import MAIN_PATH_SHAPES
from protosam_tpu_torch.tools.timing import device_ms, log, require_cuda

SOURCE = kernels.CSRC_DIR / "int8_dense.cu"
OUT_DIR = kernels.BUILD_DIR / "stamp_int8"
CTAS, TILES = 256, 64  # the stamps kept: CTAs, tiles a CTA

K9_SHAPES = [k for k in MAIN_PATH_SHAPES
             if k.startswith("K9 ") and k != "K9 ragged"]
K8_ROWS, K8_OPERANDS = "K8 DINOv2-L fc2 rows", "K8 DINOv2-L fc2 operands"


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"csrc/int8_dense.cu changed: no {old[:60]!r}")
    return src.replace(old, new, 1)


def _cut(src: str, start: str, end: str, new: str) -> str:
    """``src`` with the text from ``start`` up to (not including) ``end``
    replaced by ``new``."""
    if start not in src or end not in src:
        raise ValueError("csrc/int8_dense.cu changed: no epilogue block")
    a, b = src.index(start), src.index(end)
    return src[:a] + new + src[b:]


_EPI_START = "    // the warp's 16 rows go out in chunks of 128 bytes a row"
_EPI_END = "    // this thread has read the tile's sw and bias"

_PAIRS = """#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int cl = 8 * j + 2 * t4, col = n0 + cl;
      if (col >= a.n) continue;
      const float2 swp = *reinterpret_cast<const float2*>(ep + cl);
      const float2 bp = *reinterpret_cast<const float2*>(ep + kBN + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 8 * h;
        if (row >= a.m) continue;
        const float v0 =
            dequant(acc[4 * j + 2 * h], sxr[h], swp.x, bp.x, has_bias);
        const float v1 =
            dequant(acc[4 * j + 2 * h + 1], sxr[h], swp.y, bp.y, has_bias);
        Tout* p = out + (long)row * a.n + col;
        if ((a.n & 1) == 0) {
          if constexpr (sizeof(Tout) == 4)
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
        } else {
          p[0] = from_f32<Tout>(v0);
          if (col + 1 < a.n) p[1] = from_f32<Tout>(v1);
        }
      }
    }
"""


def _wgmma_m64n128k32() -> str:
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(64))
    return ("__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(\n"
            "    int (&d)[64], uint64_t da, uint64_t db, int scale_d) {\n"
            '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
            '      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "\n'
            f'      "{{{regs}}}, %64, %65, p;\\n}}\\n"\n'
            f"      : {outs}\n"
            '      : "l"(da), "l"(db), "r"(scale_d));\n}\n')


def stamped(src: str) -> str:
    """K9 with its clock stamps and the C entries that read them."""
    src = _replace(src, "namespace {\n\nusing namespace ptk;",
                   f"__device__ long long ptk_stamp[{CTAS * TILES * 6}];\n"
                   f"__device__ long long ptk_issue[{CTAS * TILES}];\n"
                   "namespace {\n\nusing namespace ptk;")
    top = ("  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {\n"
           "    const int m0 = t / a.tiles_n * kBM;\n")
    src = _replace(src, top, top.replace(
        "gridDim.x) {\n", "gridDim.x) {\n    asm volatile(\"\" ::: \"memory\");"
        "\n    const long long st0 = clock64();\n    long long stf = 0;\n"))
    src = _replace(src, "      mbar_wait(bar(kFull + i), ph);\n",
                   "      mbar_wait(bar(kFull + i), ph);\n"
                   "      if (kt == 0) stf = clock64();\n")
    done = "    fence_regs(acc);\n    mbar_arrive(bar(kEmpty + prev), tw == 0);\n"
    src = _replace(src, done, done + "    const long long st1 = clock64();\n")
    src = _replace(src, _EPI_END, f"""    __syncwarp();
    asm volatile("" ::: "memory");
    const long long st3 = clock64();
    const int it = (t - (int)blockIdx.x) / (int)gridDim.x;
    if (tw == 0 && it < {TILES} && blockIdx.x < {CTAS}) {{
      long long* p = ptk_stamp + ((blockIdx.x * {TILES} + it) * 2 + w) * 3;
      p[0] = stf - st0;
      p[1] = st1 - stf;
      p[2] = st3 - st1;
      if (w == 0) ptk_issue[blockIdx.x * {TILES} + it] -= stf;
    }}
""" + _EPI_END)
    issue = "          mbar_expect_tx(bar(kFull + i), kATile + kBTile);\n"
    src = _replace(src, issue, issue + f"""\
          {{
            const int it = (t - (int)blockIdx.x) / (int)gridDim.x;
            if (kt == 0 && it < {TILES} && blockIdx.x < {CTAS})
              ptk_issue[blockIdx.x * {TILES} + it] = clock64();
          }}
""")
    return src + f"""
extern "C" int ptk_stamps(void* stamp, void* issue) {{
  cudaError_t e = cudaMemcpyFromSymbol(stamp, ptk_stamp, sizeof(ptk_stamp));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(issue, ptk_issue, sizeof(ptk_issue));
}}

extern "C" int ptk_zero_stamps() {{
  static long long zero[{CTAS * TILES * 6}];
  cudaError_t e = cudaMemcpyToSymbol(ptk_stamp, zero, sizeof(ptk_stamp));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(ptk_issue, zero, sizeof(ptk_issue));
}}
"""


K9_VARIANTS = {
    "built": lambda s: s,
    "pairs": lambda s: _cut(s, _EPI_START, _EPI_END, _PAIRS),
    "no_dequant": lambda s: _replace(
        s, "  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), "
           "sw);\n  return has_bias ? __fadd_rn(y, b) : y;",
        "  return __int_as_float(acc);"),
    "no_epilogue": lambda s: _cut(
        s, _EPI_START, _EPI_END,
        "    if (acc[5] == 0x7fffffff && acc[77] == 3)\n"
        "      out[0] = from_f32<Tout>(1.f);\n"),
    "tile_128": lambda s: _replace(_replace(_replace(
        s, "constexpr int kBN = 256;", "constexpr int kBN = 128;"),
        "constexpr int kStages = 4;", "constexpr int kStages = 6;"),
        "wgmma_m64n256k32_s8_ss(acc,", "wgmma_m64n128k32_s8_ss(acc,")
    .replace("constexpr int kBM = 128;",
             _wgmma_m64n128k32() + "\nconstexpr int kBM = 128;", 1),
}

K8_VARIANTS = {
    "built": lambda s: s,
    "reciprocal": lambda s: _replace(
        s, "__float2int_rn(__fdiv_rn(x, scale))",
        "__float2int_rn(__fmul_rn(x, __frcp_rn(scale)))"),
    "no_min_blocks": lambda s: _replace(
        s, "__launch_bounds__(kQuantThreads, V == 4 ? 4 : 2)",
        "__launch_bounds__(kQuantThreads)"),
}


def build(variants: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, dict]]:
    """Compile each named source in its own ``nvcc`` process, in parallel;
    returns name -> (library, ptxas table)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(kernels.CSRC_DIR), "-shared", str(cu), "-o",
             str(OUT_DIR / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        for entry, argtypes in kernels._SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = list(argtypes)
        if hasattr(lib, "ptk_stamps"):
            lib.ptk_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        out[name] = (lib, ptxas_report.parse(text))
    return out


def _registers(table: dict, kernel: str) -> int:
    return next(v["registers"] for k, v in table.items() if kernel in k)


def max_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def k9_inputs(dev, m, k, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(-127, 128, (m, k), generator=g,
                          dtype=torch.int8).to(dev),
            torch.randint(-127, 128, (n, k), generator=g,
                          dtype=torch.int8).to(dev),
            torch.rand(m, generator=g).to(dev),
            torch.rand(n, generator=g).to(dev),
            torch.randn(n, generator=g).to(dev),
            torch.empty(m, n, dtype=torch.bfloat16, device=dev))


def run_k9(libs: dict, reps: int) -> dict:
    dev, mhz, out = torch.device("cuda"), max_clock_mhz(), {}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for label in K9_SHAPES:
        m, k, n = (MAIN_PATH_SHAPES[label][1][key] for key in "mkn")
        qa, qb, sx, sw, bias, y = k9_inputs(dev, m, k, n)
        for name, (lib, table) in libs.items():
            call = lambda: lib.ptk_int8_dense(
                qa.data_ptr(), qb.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                bias.data_ptr(), y.data_ptr(), m, n, k, kernels.BF16,
                stream())
            ms = device_ms(call, reps=reps).median_ms
            if lib.ptk_zero_stamps():
                raise RuntimeError("could not zero the stamps")
            if call():
                raise RuntimeError(f"variant {name} failed to launch")
            torch.cuda.synchronize()
            st = np.zeros(CTAS * TILES * 6, np.int64)
            issue = np.zeros(CTAS * TILES, np.int64)
            if lib.ptk_stamps(st.ctypes.data, issue.ctypes.data):
                raise RuntimeError("could not read the stamps")
            st = st.reshape(CTAS, TILES, 2, 3)
            used = st[:, :, 0, 1] > 0
            us = [float(st[used][:, :, i].mean()) / mhz for i in range(3)]
            ahead = -float(issue.reshape(CTAS, TILES)[used].mean()) / mhz
            regs = _registers(table, "int8_dense_kernelI13__nv_bfloat16")
            out[(label, name)] = dict(ms=ms, wait_us=us[0], main_us=us[1],
                                      epilogue_us=us[2], ahead_us=ahead,
                                      registers=regs, tiles=int(used.sum()))
            log(f"stamp_int8 {label} ({m}x{k}x{n}) {name}: {ms:.4f} ms, "
                f"{int(used.sum())} tiles; us a tile: first stage wait "
                f"{us[0]:.2f}, main loop {us[1]:.2f}, epilogue {us[2]:.2f}; "
                f"first stage requested {ahead:.2f} us before; {regs} "
                f"registers (cycles at {mhz:.0f} MHz)")
    return out


def run_k8(libs: dict, reps: int) -> dict:
    dev, out = torch.device("cuda"), {}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    sh = MAIN_PATH_SHAPES[K8_OPERANDS][1]
    m, n, k = sh["m"], sh["n"], sh["k"]
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(m, k, generator=g) * 2).to(dev, torch.bfloat16)
    w = (torch.randn(n, k, generator=g) * 0.02).to(dev)
    qx = torch.empty(m, k, dtype=torch.int8, device=dev)
    qw = torch.empty(n, k, dtype=torch.int8, device=dev)
    sx = torch.empty(m, device=dev)
    sw = torch.empty(n, device=dev)
    for name, (lib, table) in libs.items():
        rows = lambda: lib.ptk_quantize_rows(
            x.data_ptr(), qx.data_ptr(), sx.data_ptr(), m, k, kernels.BF16,
            stream())
        both = lambda: lib.ptk_quantize_operands(
            x.data_ptr(), qx.data_ptr(), sx.data_ptr(), m, kernels.BF16,
            w.data_ptr(), qw.data_ptr(), sw.data_ptr(), n, kernels.F32, k,
            stream())
        t = dict(rows_ms=device_ms(rows, reps=reps).median_ms,
                 operands_ms=device_ms(both, reps=reps).median_ms,
                 registers=_registers(
                     table, "quantize_rows_kernelI13__nv_bfloat16fLi4"))
        out[name] = t
        log(f"stamp_int8 K8 {name}: {K8_ROWS} {t['rows_ms']:.4f} ms, "
            f"{K8_OPERANDS} {t['operands_ms']:.4f} ms; {t['registers']} "
            f"registers at 4 vectors a lane")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    src = SOURCE.read_text()
    k9 = build({f"k9_{name}": stamped(fn(src))
                for name, fn in K9_VARIANTS.items()})
    k8 = build({f"k8_{name}": fn(src) for name, fn in K8_VARIANTS.items()})
    return {"k9": run_k9({k[3:]: v for k, v in k9.items()}, args.reps),
            "k8": run_k8({k[3:]: v for k, v in k8.items()}, args.reps)}


if __name__ == "__main__":
    main()

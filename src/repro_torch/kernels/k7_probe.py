"""Probe what holds K7's large-M kernel back, on the card: variants of
``tc_large_kernel`` built from edited copies of ``csrc/dequant_matmul.cu``
into ``build/`` and timed beside the kernel as it is.

    python -m repro_torch.kernels.k7_probe

Needs a CUDA card and nvcc. Variants (their results are wrong where the
edit drops work; only their times are read):

  * ``no_widen``: the codes of each K step after the first are not widened
    (the registers keep the first step's operand A);
  * ``no_fence``: no ``wgmma.fence`` before a K step's group;
  * ``wait_all``: each K step waits for its own group (no overlap of the
    next step's widening with the tensor cores);
  * ``clocks``: the kernel as it is with clock counters in CTA 0's first
    warp of each consumer warpgroup: a K step's issue of its group, its
    wait for the group before, its wait for the next stage's data, and
    the widening of the next step's codes (cycles a step, averaged).

Prints one JSON line per shape (w_up's K 4096 and N 11008 at M 128, 256,
384 and 600, the tiles ``large_plan`` would take there or the ones named).
"""

from __future__ import annotations

import ctypes
import json

import torch

from repro_torch.kernels import build
from repro_torch.kernels.probe import build_variants, edit, timer

_STEP_HEAD = """  auto step_once = [&](int step, int steps, uint32_t (&a)[4][JN][4],
                       uint32_t (&a_next)[4][JN][4]) {
    const uint32_t xs = smem_u32(smem + (it % L::STAGES) * L::STAGE);
    wgmma_fence();"""
_WAIT = """        wgmma_rs<BM>(d[j], a[kk][j], sw128_desc(xs + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();"""
_WIDEN_NEXT = """      widen(smem + s * L::STAGE + L::XBYTES, a_next);
"""
_KEEP = """#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < JN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) keep(a_next[kk][j][e]);
"""
_ARRIVE = """    if (step > 0 && lane == 0)
      mbar_arrive(empty + 8 * ((it - 1) % L::STAGES));
    ++it;
    if (step + 1 < steps) {
      const int s = it % L::STAGES;
      mbar_wait_bounded(full + 8 * s, (it / L::STAGES) & 1);
"""
_END = """            *reinterpret_cast<float2*>(out + (size_t)m * N + n) = v;
          }
        }
      }
    }
  }
}
"""


def _variants(src: str) -> dict:
    clocks = edit(src, "namespace {\n", "namespace {\n"
                   "__device__ unsigned long long g_clocks[16];\n")
    clocks = edit(clocks, _STEP_HEAD, """  unsigned long long acc[5] = {0, 0, 0, 0, 0};
  const bool rec = blockIdx.x == 0 && lane == 0 && warp % 4 == 0;
""" + _STEP_HEAD.replace("wgmma_fence();", "const long long c0 = clock64();\n"
                         "    wgmma_fence();"))
    clocks = edit(clocks, _WAIT, _WAIT.replace(
        "    wgmma_wait<1>();",
        "    const long long c1 = clock64();\n    wgmma_wait<1>();"))
    clocks = edit(clocks, _KEEP + _ARRIVE, _KEEP + """    const long long c2 = clock64();
    long long c3 = c2, c4 = c2;
""" + _ARRIVE + "      c3 = clock64();\n")
    # the widened registers are in place before the clock is read
    clocks = edit(clocks, _WIDEN_NEXT + "    }\n  };", _WIDEN_NEXT + _KEEP
                   + """      c4 = clock64();
    }
    acc[0] += c1 - c0;
    acc[1] += c2 - c1;
    acc[2] += c3 - c2;
    acc[3] += c4 - c3;
    acc[4] += 1;
  };""")
    clocks = edit(clocks, _END, _END[:-2] + """  if (rec)
    for (int i = 0; i < 5; ++i) g_clocks[(warp / 4) * 8 + i] = acc[i];
}
""")
    clocks += """
extern "C" int probe_clocks(void* dst, int reset) {
  unsigned long long z[16] = {};
  if (reset) return (int)cudaMemcpyToSymbol(g_clocks, z, sizeof(z));
  return (int)cudaMemcpyFromSymbol(dst, g_clocks, sizeof(z));
}
"""
    return {"as_is": src,
            "no_widen": edit(src, _WIDEN_NEXT, ""),
            "no_fence": edit(src, _STEP_HEAD, _STEP_HEAD.replace(
                "    wgmma_fence();", "")),
            "wait_all": edit(src, _WAIT, _WAIT.replace("<1>", "<0>")),
            "clocks": clocks}


def _build(variants: dict) -> dict:
    libs = build_variants("k7_probe", variants)
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.dequant_matmul_large_launch.argtypes = [p, p, p, p, p] + [i] * 8 \
            + [p]
        lib.dequant_matmul_large_launch.restype = i
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    src = (build.CSRC / "dequant_matmul.cu").read_text()
    libs = _build(_variants(src))
    clocks = libs["clocks"]
    clocks.probe_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(7)
    k, n = 4096, 11008
    codes = torch.randint(-7, 8, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, bm, jn in ((128, 128, 1), (256, 256, 1), (384, 128, 2),
                      (600, 200, 1)):
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        units = -(-m // bm) * -(-n // (128 * jn))
        out = torch.empty((m, n), dtype=torch.float32, device="cuda")

        def call(lib, x=x, bm=bm, jn=jn, units=units, out=out):
            err = lib.dequant_matmul_large_launch(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                out.data_ptr(), None, m, n, k, bm, jn, 1, k,
                min(units, sms), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        us = timer({name: (lambda lib=lib: call(lib))
                     for name, lib in libs.items() if name != "clocks"})
        clocks.probe_clocks(None, 1)
        call(clocks)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        clocks.probe_clocks(buf, 0)
        per_step = {}
        for wg in (0, 1):
            v = buf[wg * 8:wg * 8 + 5]
            steps = max(v[4], 1)
            per_step[f"warpgroup_{wg}"] = {
                "issue": v[0] / steps, "wait_previous_group": v[1] / steps,
                "wait_next_stage": v[2] / steps, "widen": v[3] / steps}
        print(json.dumps({"m_k_n": [m, k, n], "bm": bm, "jn": jn, "us": us,
                          "clocks_a_step": per_step}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

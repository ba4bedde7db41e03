"""Variant builds of ``kernels/csrc/xnor_gemm.cu`` timed in turns on the
card, and one build with a globaltimer stamp a warp.

Each variant is the kept source with a few lines replaced, built by
``nvcc`` into ``experiments/xnor_gemm_variants/`` (git-ignored) and
called through its own C entry point on the phase-2 shapes of
``chip_smoke.py`` (and M = 8, 16, 64), held bitwise against the plain
version, and timed as
``chip_smoke.time_ms`` times (CUDA graph, inputs rotated past L2) in the
order kept, A, C, E, first, first, E, C, A, kept.  Variants:

  A      four steps of loads in flight at one n-tile, 16 warps an SM,
         K split at most 8 ways, blocks bounded at 256 threads
  C      A with two steps and 32 warps an SM at one n-tile
  kept   C with K split up to 16 ways at one n-tile (512-thread bound)
  E      kept with one AND MMA a chunk and the operands' popcounts on the
         CUDA cores: popc(a ^ b) = popc a + popc b - 2 popc(a & b)
  first  the first design, ``csrc/xnor_gemm_rowtile.cu``

The stamped build (kept) records, per warp, when it started, when its first
loads had come back (its first MMAs done), when its K loop ended and when
it finished; the stamps of one launch are summarised in ns.

    python src/repro_torch/probes/xnor_gemm_variants.py   # with the card
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels import pack as kpack  # noqa: E402
from repro_torch.kernels import xnor_gemm as kx  # noqa: E402

OUT = ROOT / "experiments" / "xnor_gemm_variants"


def edit(src: str, pairs) -> str:
    for old, new in pairs:
        assert src.count(old) == 1, f"variant edit does not apply: {old!r}"
        src = src.replace(old, new)
    return src


STEPS4 = ("return launch_plan<1, 2, VEC>", "return launch_plan<1, 4, VEC>")
PLAN_A = ("const long long target = p.nt == 1 ? 2 * kTargetWarps : "
          "kTargetWarps;", "const long long target = kTargetWarps;")
KS8 = ("const int max_ks = p.nt == 1 ? 16 : 8;", "const int max_ks = 8;")
BOUND256 = ("__launch_bounds__(512)", "__launch_bounds__(256)")
POPC = [
    ("""  bmma_and(dnand, ~wa.x, ~wb.x, ~wa.y, ~wb.y, ~x.x, ~x.y);
  bmma_and(dnand, ~wa.z, ~wb.z, ~wa.w, ~wb.w, ~x.z, ~x.w);
""", """  dnand[0] += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
"""),
    ("""  const int steps = (Kw + 15) / 16;
  int done = 0;""", """  const int steps = (Kw + 15) / 16;
  int done = 0, ca = 0, cb8 = 0;"""),
    ("""        ++done;
""", """        ++done;
        ca += __popc(wa[u].x) + __popc(wa[u].y) + __popc(wa[u].z) +
              __popc(wa[u].w);
        cb8 += __popc(wb[u].x) + __popc(wb[u].y) + __popc(wb[u].z) +
               __popc(wb[u].w);
"""),
    ("""      pxor[t][e] = 512 * done - dand[t][e] - dnand[t][e];
""", """      pxor[t][e] = 0;
  ca += __shfl_xor_sync(0xffffffffu, ca, 1);
  ca += __shfl_xor_sync(0xffffffffu, ca, 2);
  cb8 += __shfl_xor_sync(0xffffffffu, cb8, 1);
  cb8 += __shfl_xor_sync(0xffffffffu, cb8, 2);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    int cx = dnand[t][0];
    cx += __shfl_xor_sync(0xffffffffu, cx, 1);
    cx += __shfl_xor_sync(0xffffffffu, cx, 2);
    const int r0 = __shfl_sync(0xffffffffu, cx, 8 * tq);
    const int r1 = __shfl_sync(0xffffffffu, cx, 8 * tq + 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pxor[t][e] = (e >> 1 ? cb8 : ca) + (e & 1 ? r1 : r0) - 2 * dand[t][e];
  }
"""),
]
STAMP = [
    ('#include "common.cuh"\n', '''#include "common.cuh"
__device__ unsigned long long g_stamp[1 << 20][4];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, (size_t)n * 32);
}
#define STAMP_WARP()                                               \\
  if (lane == 0 && wid < (1 << 20)) {                              \\
    g_stamp[wid][0] = t_start; g_stamp[wid][1] = t_first;          \\
    g_stamp[wid][2] = t_loop; g_stamp[wid][3] = gtime();           \\
  }
'''),
    ("  extern __shared__ int red[];  // [ks - 1][ct][NT * 4][32]\n",
     """  extern __shared__ int red[];  // [ks - 1][ct][NT * 4][32]
  const unsigned long long t_start = gtime();
  unsigned long long t_first = 0;
  const long long wid = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
"""),
    ("""          step_mma(dand[t], dnand[t], wa[u], wb[u], x[u][t]);
      }
    }
  }
""", """          step_mma(dand[t], dnand[t], wa[u], wb[u], x[u][t]);
      }
    }
    if (!t_first) t_first = gtime() + (dand[0][0] == -7);
  }
  const unsigned long long t_loop = gtime() + (dand[0][0] == -7);
"""),
    ("    if (kslice > 0) return;\n",
     "    if (kslice > 0) {\n      STAMP_WARP();\n      return;\n    }\n"),
    ("""        out[static_cast<size_t>(r) * N + n] = valid_k - 2 * pxor[t][e];
    }
}
""", """        out[static_cast<size_t>(r) * N + n] = valid_k - 2 * pxor[t][e];
    }
  STAMP_WARP();
}
"""),
]


def sources() -> dict:
    kept = (cuda.CSRC / "xnor_gemm.cu").read_text()
    c = edit(kept, [KS8, BOUND256])
    return {"kept": kept, "A": edit(c, [STEPS4, PLAN_A]), "C": c,
            "E": edit(kept, POPC),
            "first": (cuda.CSRC / "xnor_gemm_rowtile.cu").read_text(),
            "stamped": edit(kept, STAMP)}


def build(srcs: dict) -> dict:
    procs = {}
    for tag, src in srcs.items():
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(src)
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
               str(d / "lib.so"), str(d / "k.cu")]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, p in procs.items():
        log, _ = p.communicate()
        assert p.returncode == 0, f"{tag}:\n{log}"
        libs[tag] = ctypes.CDLL(str(OUT / tag / "lib.so"))
        libs[tag].xnor_gemm.argtypes = cuda.ENTRY_POINTS["xnor_gemm"][1]
        libs[tag].xnor_gemm.restype = ctypes.c_int
    return libs


def caller(lib):
    def run(pa, pb, valid_k):
        out = torch.empty((pa.shape[0], pb.shape[0]), dtype=torch.int32,
                          device=pa.device)
        assert lib.xnor_gemm(pa.data_ptr(), pb.data_ptr(), out.data_ptr(),
                             pa.shape[0], pb.shape[0], pa.shape[1], valid_k,
                             cuda.stream(pa)) == 0
        return out
    return run


def stamps(lib, args, warps: int) -> dict:
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    torch.cuda.synchronize()
    caller(lib)(*args)
    torch.cuda.synchronize()
    buf = np.zeros((warps, 4), dtype=np.uint64)
    assert lib.read_stamps(buf.ctypes.data, warps) == 0
    t = buf.astype(np.int64) - int(buf[:, 0].min())
    ran = t[:, 1] > 0                              # warps that ran a step
    return dict(span=int(t[:, 3].max()), last_start=int(t[:, 0].max()),
                first_loads=int(np.median(t[ran, 1] - t[ran, 0])),
                loop_end=int(np.median(t[ran, 2])),
                end=int(np.median(t[:, 3])))


def main() -> int:
    print(cs.gpu_line())
    libs = build(sources())
    order = ["kept", "A", "C", "E", "first"]
    order += order[::-1]
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)

    def planes(m, k):
        x = torch.randn((m, k), generator=g, device="cuda")
        return kpack.pack(x.to(torch.bfloat16))[0]

    shapes = [("quickstart", 64, 32, 256), ("xnor-cnn", 256, 512, 512)]
    shapes += [(f"{name} M={m}", m, n, k)
               for name, (n, k) in cs.LINEAR_SHAPES.items()
               for m in (4, 8, 16, 32, 64)]
    for label, m, n, k in shapes:
        pa, pb = planes(m, k), planes(n, k)
        from repro_torch.kernels import ref
        want = ref.xnor_gemm(pa, pb, k)
        kw = pa.shape[1]
        sets = cs.copies(lambda: (planes(m, k), planes(n, k), k), n * kw * 4)
        times = {}
        for tag in order:
            f = caller(libs[tag])
            assert torch.equal(f(pa, pb, k), want), (tag, label)
            times.setdefault(tag, []).append(
                round(cs.time_ms(f, sets, 200) * 1e3, 3))
        print(f"[variants] {label} (M, N, K) = ({m}, {n}, {k}), µs in turns: "
              f"{times}", flush=True)
        if m in (4, 32) and label.split()[0] in ("w1/w3", "w2", "wq/wo"):
            plan = kx.gemm_plan(m, n, kw)
            print(f"[stamps] {label} plan {tuple(plan)}: ns "
                  f"{stamps(libs['stamped'], sets[0], plan.blocks * plan.warps)}",
                  flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

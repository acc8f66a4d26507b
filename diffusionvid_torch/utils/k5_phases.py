"""K5's phase profile on the card: where a block of the wgmma path's product
kernel spends its cycles, at Swin-B's stage maps 2 and 3 of a 4-frame chunk
(608x1024), for every product plan of ``mlp_gemm_plans``.

Run on a machine with the card, from the repository root:

    python -m diffusionvid_torch.utils.k5_phases

It copies ``csrc/swin_block_mlp.cu``, with ``csrc/swin_gemm.cuh`` written
in place of its include, and adds ``clock64`` timers at fixed points of the
product's body ``gemm_tile`` (each anchor must occur once, or it stops),
builds the copy into ``build/diffusionvid_torch/k5_phases/``, and launches
its wgmma path on random inputs, one product at the candidate plan and the
other at ``mlp_plan``'s.  Per stage and candidate it prints one JSON line:
the error against ``swin_block_mlp_ref`` (the timed copy computes the same
function), the time of one call (CUDA events, 10 calls) and the means over
the candidate product's blocks of thread 0's cycles, in thousands: ``wait``
(from the block's start until its first boxes have landed), ``main`` (the
products, waits for later boxes included) and ``epi`` (the epilogue).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build

SLOTS = 8192   # blocks whose counters are kept, per product
_ANCHORS = [
    ('#include "swin_hopper.cuh"\n',
     '#include "swin_hopper.cuh"\n__device__ long long g_phases[2 * 8192 * 4];\n'),
    ("  const int tid = threadIdx.x, lane = tid & 31;\n  const int n_tiles = N / BN, nk = K / KC;",
     "  long long T0 = clock64(), T1 = 0, T2 = 0;\n"
     "  const int tid = threadIdx.x, lane = tid & 31;\n  const int n_tiles = N / BN, nk = K / KC;"),
    ("    swin::mbar_wait(&full[slot], phase);\n",
     "    swin::mbar_wait(&full[slot], phase);\n    if (c == 0) T1 = clock64();\n"),
    ("  swin::consumers_sync();\n  bf16* stage",
     "  T2 = clock64();\n  swin::consumers_sync();\n  bf16* stage"),
    ("    *reinterpret_cast<uint4*>(out + off_of(i)) = v;\n  }\n}",
     "    *reinterpret_cast<uint4*>(out + off_of(i)) = v;\n  }\n"
     "  if (tid == 0 && blockIdx.x < 8192) {\n"
     "    long long* o = g_phases + (EPI * 8192 + blockIdx.x) * 4;\n"
     "    o[0] = T1 - T0; o[1] = T2 - T1; o[2] = clock64() - T2;\n  }\n}"),
]
_READ = ('\nextern "C" int phases_read(long long* host, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(host, g_phases, sizeof(long long) * n);\n}\n')
NAMES = ("wait", "main", "epi")


def instrumented_source() -> str:
    src = (_build.CSRC / "swin_block_mlp.cu").read_text()
    include = '#include "swin_gemm.cuh"\n'
    if src.count(include) != 1:
        raise RuntimeError(f"k5_phases: {include!r} not found once in the source")
    src = src.replace(include, (_build.CSRC / "swin_gemm.cuh").read_text())
    for old, new in _ANCHORS:
        if src.count(old) != 1:
            raise RuntimeError(f"k5_phases: anchor not found once in the source: {old!r}")
        src = src.replace(old, new)
    return src + _READ


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "k5_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "k5_phases.cu").write_text(instrumented_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(out / "libk5_phases.so"), str(out / "k5_phases.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out / "libk5_phases.so"))


def main() -> int:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as cs  # the stage maps, inputs and timer of the smoke run
    from ..ops.swin_attention import (
        MLP_GELU_TABLE, _f32, mlp_gemm_plans, mlp_plan, swin_block_mlp_ref)

    print(cs.nvidia_smi_line(), flush=True)
    lib = build()
    fn = lib.swin_block_mlp_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_float] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for s in (2, 3):
        st = cs.SWIN_B_STAGES[s]
        x, _, mlp, _ = cs._swin_inputs(torch.Generator().manual_seed(0), dev, torch.bfloat16,
                                       st, cs.SWIN_FRAMES)
        c = st["c"]
        m = x.numel() // c
        want = swin_block_mlp_ref(x, *mlp).float()
        ln_g, ln_b, w1, b1, w2, b2 = mlp
        out = torch.empty_like(x)
        y = torch.empty(m, c, dtype=x.dtype, device=dev)
        h = torch.empty(m, 4 * c, dtype=x.dtype, device=dev)
        table = torch.empty(MLP_GELU_TABLE // 2, dtype=x.dtype, device=dev)
        ptrs = [t.data_ptr() for t in (x, _f32(ln_g), _f32(ln_b), w1, _f32(b1), w2, _f32(b2),
                                       out, y, h, table)]
        picked = mlp_plan(c, m, sms)
        for epi, (prod, n, k) in enumerate((("fc1", 4 * c, c), ("fc2", c, 4 * c))):
            for cand in mlp_gemm_plans(m, n, k, prod == "fc1", sms):
                plan = {**picked, prod: cand}

                def launch(plan=plan):
                    err = fn(*ptrs, m, c, 1e-5,
                             *[plan[p][key] for p in ("fc1", "fc2")
                               for key in ("bn", "stages", "smem_bytes")],
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"k5_phases: launch failed with cudaError {err}")

                launch()
                torch.cuda.synchronize()
                res = {"stage": s, "product": prod, "plan": cand,
                       "max_abs_err": float((out.float() - want).abs().max()),
                       "ms": cs.cuda_time_ms(launch, iters=10)}
                launch()
                torch.cuda.synchronize()
                nb = min(SLOTS, cand["tiles"])
                buf = (ctypes.c_longlong * (2 * SLOTS * 4))()
                if lib.phases_read(buf, 2 * SLOTS * 4):
                    raise RuntimeError("k5_phases: reading the counters failed")
                rows = torch.tensor(list(buf), dtype=torch.float64).view(2, SLOTS, 4)
                mean = rows[epi, :nb].mean(0)
                res["kcycles"] = {key: round(float(mean[i]) / 1e3, 2)
                                  for i, key in enumerate(NAMES)}
                print(json.dumps(res), flush=True)
        del x, mlp, want, out, y, h
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K4's phase profile on the card: where a block of the bf16 kernel spends
its cycles, at the four Swin-B stage maps of a 4-frame chunk (608x1024).

Run on a machine with the card, from the repository root:

    python -m diffusionvid_torch.utils.k4_phases

It copies ``csrc/swin_block_attn.cu`` with ``clock64`` timers added at
fixed points of the kernel (each anchor must occur once, or it stops),
builds the copy into ``build/diffusionvid_torch/k4_phases/``, and launches
it with the wrapper's launch plan on random inputs, shift 0 and 3. Per
stage map it prints one JSON line: the error against ``swin_block_attn_ref``
(the timed copy computes the same function), the time of one launch (CUDA
events, 10 launches), and the means over blocks of thread 0's cycles, in
thousands: ``total``; ``ln`` (prologue and LN1); ``wait`` (waiting for ring
chunks to land); ``qkv`` (the qkv products, waits included); ``attn`` (q, k,
v stores and the attention); ``gather`` (the o exchange); ``out`` (the
out-projection, waits included).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build

SLOTS = 8192   # blocks whose counters are kept
_ANCHORS = [
    ('#include "swin_hopper.cuh"\n',
     '#include "swin_hopper.cuh"\n__device__ long long g_phases[8192 * 8];\n'),
    ("  // prologue: the barriers; the windows' tiles",
     "  long long T0 = clock64(), Tw = 0, Tq = 0, Ta = 0;\n"
     "  // prologue: the barriers; the windows' tiles"),
    ("  ln_tiles<C>(p, win0, windows, WPB * N, s_a0, lda);\n  consumers_sync();\n",
     "  ln_tiles<C>(p, win0, windows, WPB * N, s_a0, lda);\n  consumers_sync();\n"
     "  long long T1 = clock64();\n"),
    ("    mbar_wait(&bars->full[t_slot], t_phase);\n",
     "    long long tw = clock64();\n    mbar_wait(&bars->full[t_slot], t_phase);\n"
     "    Tw += clock64() - tw;\n"),
    ("    float acc[48];  // the warpgroup's head",
     "    long long tq = clock64();\n    float acc[48];  // the warpgroup's head"),
    ("    const int hl = j * SPL + half, b = j % NB;",
     "    long long ta = clock64(); Tq += ta - tq;\n    const int hl = j * SPL + half, b = j % NB;"),
    ("    if (lane == 0) mbar_arrive(&bars->bias_empty[b]);\n  }",
     "    if (lane == 0) mbar_arrive(&bars->bias_empty[b]);\n    Ta += clock64() - ta;\n  }\n"
     "  long long tg = clock64();"),
    ("  for (int pass = 0; pass < M::PASSES; ++pass) {",
     "  long long to = clock64();\n  for (int pass = 0; pass < M::PASSES; ++pass) {"),
    ("    if (mine) store_out<NO>(p, w, acc, res, p.bproj, c0);\n  }\n}",
     "    if (mine) store_out<NO>(p, w, acc, res, p.bproj, c0);\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 8192) {\n"
     "    long long* o = g_phases + blockIdx.x * 8;\n"
     "    o[0] = clock64() - T0; o[1] = T1 - T0; o[2] = Tw; o[3] = Tq; o[4] = Ta;\n"
     "    o[5] = to - tg; o[6] = clock64() - to;\n  }\n}"),
]
_READ = ('\nextern "C" int phases_read(long long* host, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(host, g_phases, sizeof(long long) * n);\n}\n')
NAMES = ("total", "ln", "wait", "qkv", "attn", "gather", "out")


def instrumented_source() -> str:
    src = (_build.CSRC / "swin_block_attn.cu").read_text()
    for old, new in _ANCHORS:
        if src.count(old) != 1:
            raise RuntimeError(f"k4_phases: anchor not found once in the source: {old!r}")
        src = src.replace(old, new)
    return src + _READ


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "k4_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "k4_phases.cu").write_text(instrumented_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(out / "libk4_phases.so"), str(out / "k4_phases.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out / "libk4_phases.so"))


def main() -> int:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as cs  # the stage maps, inputs and timer of the smoke run
    from ..models.swin import shift_attn_mask
    from ..ops.swin_attention import attn_plan, swin_block_attn_ref

    print(cs.nvidia_smi_line(), flush=True)
    lib = build()
    fn = lib.swin_block_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    for s, st in enumerate(cs.SWIN_B_STAGES):
        frames = cs.SWIN_FRAMES
        x, attn, _, (hp, wp) = cs._swin_inputs(torch.Generator().manual_seed(0), dev,
                                               torch.bfloat16, st, frames)
        c, heads = st["c"], st["heads"]
        plan = attn_plan(c, frames, hp, wp)
        windows = frames * (hp // 7) * (wp // 7)
        for shift in (0, 3):
            mask = None
            if shift:
                mask = torch.from_numpy(shift_attn_mask(hp, wp, 7, shift)).to(dev).reshape(
                    hp // 7, wp // 7, 49, 49)
            want = swin_block_attn_ref(x, *attn[:5], mask, *attn[5:], 7, heads, st["hw"], shift)
            out = torch.empty_like(x)
            scratch = torch.empty(windows, 49, c, dtype=x.dtype, device=dev)
            ptrs = [None if t is None else t.data_ptr()
                    for t in (x, *attn[:5], mask, *attn[5:], out, scratch)]

            def launch():
                err = fn(*ptrs, frames, hp, wp, c, heads, *st["hw"], shift, 7, 1e-5, 1,
                         plan["wpb"], plan["cluster"], plan["kc"], plan["stages"],
                         plan["smem_bytes"], torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"k4_phases: launch failed with cudaError {err}")

            launch()
            torch.cuda.synchronize()
            res = {"stage": s, "shift": shift, "plan": plan,
                   "max_abs_err": float((out.float() - want.float()).abs().max()),
                   "ms": cs.cuda_time_ms(launch, iters=10)}
            launch()
            torch.cuda.synchronize()
            n = min(SLOTS, plan["blocks"])
            buf = (ctypes.c_longlong * (n * 8))()
            if lib.phases_read(buf, n * 8):
                raise RuntimeError("k4_phases: reading the counters failed")
            mean = torch.tensor(list(buf), dtype=torch.float64).view(n, 8).mean(0)
            res["kcycles"] = {k: round(float(mean[i]) / 1e3, 1) for i, k in enumerate(NAMES)}
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

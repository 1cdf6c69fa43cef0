#!/usr/bin/env python3
"""Time variants of the CDF-MLP bank kernel (``csrc/cdf_mlp.cu``) on one GPU.

Run from the root of a checkout on a machine with a CUDA device and ``nvcc``:

    python3 tools/cdf_sweep.py [variant,variant,...]

Each variant is a copy of the kernel's source with one design choice
changed by a text patch (``VARIANTS``; a patch that no longer applies
raises): the blocks an SM that ``__launch_bounds__`` asks for, the points a
thread, the block size, the hidden layers' loop order, the prefetch of the
next step's points. All variants build at once (one ``nvcc`` each, the
port's flags, into ``kernels/_build/sweep/``), print their registers and any
spill from ``-Xptxas -v``, and are timed at N = 1,000,000 points and B = 196
MLPs for H = 16, 8, 32 and 4 (CUDA events over 10 launches after 2, in two
rounds, variants in turn), on a He-scale bank from seed 0. Every variant's
output must equal the first variant's bit for bit (they all compute the same
fused multiply-add chains) and the plain version's within ``atol=2e-6``;
the script raises where one does not. It prints the card (``nvidia-smi``
name and power limit) and one line per variant and width.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build, ops, ref  # noqa: E402

SRC = (_build.CSRC / "cdf_mlp.cu").read_text()
N, B = 1_000_000, 196
ATOL = 2e-6


def _between(start: str, end: str) -> str:
    return SRC[SRC.index(start):SRC.index(end)]


# the hidden layers with i outermost: every output's accumulator live at once
_HIDDEN = _between("template <int H, int P>\n__device__ __forceinline__ void hidden",
                   "// The model whose weights")
_HIDDEN_I_OUTER = '''template <int H, int P>
__device__ __forceinline__ void hidden(const float4* wm, const float4* bias,
                                       const float (&in)[P][H], float (&out)[P][H]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int j = 0; j < H; ++j) out[p][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int jb = 0; jb < H / 4; ++jb) {
      const float4 w = wm[i * (H / 4) + jb];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        out[p][4 * jb + 0] = fmaf(in[p][i], w.x, out[p][4 * jb + 0]);
        out[p][4 * jb + 1] = fmaf(in[p][i], w.y, out[p][4 * jb + 1]);
        out[p][4 * jb + 2] = fmaf(in[p][i], w.z, out[p][4 * jb + 2]);
        out[p][4 * jb + 3] = fmaf(in[p][i], w.w, out[p][4 * jb + 3]);
      }
    }
  }
#pragma unroll
  for (int jb = 0; jb < H / 4; ++jb) {
    const float4 b = bias[jb];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      out[p][4 * jb + 0] = relu(__fadd_rn(out[p][4 * jb + 0], b.x));
      out[p][4 * jb + 1] = relu(__fadd_rn(out[p][4 * jb + 1], b.y));
      out[p][4 * jb + 2] = relu(__fadd_rn(out[p][4 * jb + 2], b.z));
      out[p][4 * jb + 3] = relu(__fadd_rn(out[p][4 * jb + 3], b.w));
    }
  }
}

'''
# each step loads its own points instead of the next step's ahead
_PREFETCH = _between("  // the points of the next step load", "  for (int s = 0, step = 0;")
_STEP_LOAD = _between("      for (int p = 0; p < P; ++p) {\n        xv[p] = xn[p];",
                      "      evaluate<H, P>(w, xv, yv);")
_STEP_LOAD_OWN = '''      for (int p = 0; p < P; ++p) {
        const int k = s + p * 32 + lane;
        xv[p] = k < strip ? __ldg(x + n0 + k) : 0.f;
      }
'''
_BOUNDS = "__launch_bounds__(kThreads, 2)"
_POINTS = "return H <= 8 ? 4 : H == 16 ? 2 : 1;"
_THREADS = "constexpr int kThreads = 256;"

VARIANTS = {  # name: (old, new) text patches of the kernel's source
    "kernel": (),
    "no_prefetch": ((_PREFETCH, ""), (_STEP_LOAD, _STEP_LOAD_OWN)),
    "3_blocks_an_sm": ((_BOUNDS, "__launch_bounds__(kThreads, 3)"),),
    "4_points_at_h16": ((_BOUNDS, "__launch_bounds__(kThreads, 1)"),
                        (_POINTS, "return H <= 16 ? 4 : 1;")),
    "1_point_at_h16": ((_POINTS, "return H <= 8 ? 4 : 1;"),),
    "128_threads": ((_THREADS, "constexpr int kThreads = 128;"),
                    (_BOUNDS, "__launch_bounds__(kThreads, 4)")),
    "i_outer": ((_HIDDEN, _HIDDEN_I_OUTER),),
}


def patched(name: str) -> str:
    src = SRC
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: its patch no longer applies to cdf_mlp.cu")
        src = src.replace(old, new)
    return src


def build(names):
    """Compile every variant at once; ``{name: C entry point}``."""
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        (out / f"{name}.cu").write_text(patched(name))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
        regs = [line.split(",")[0].split(":")[-1].strip()
                for line in text.splitlines() if "registers" in line]
        spills = any("spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line
                     for line in text.splitlines())
        print(f"{name}: {regs} (H = 32, 16, 8, 4){'; SPILLS' if spills else ''}", flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).wisk_cdf_mlp
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def bank(H: int, dev):
    gen = torch.Generator().manual_seed(0)
    shapes = dict(w0=(B, 1, H), b0=(B, H), w1=(B, H, H), b1=(B, H), w2=(B, H, H), b2=(B, H),
                  w3=(B, H, 1), b3=(B, 1))
    params = {k: (torch.randn(s, generator=gen) * ((2.0 / s[1]) ** 0.5 if k[0] == "w" else 0.1))
              .to(dev) for k, s in shapes.items()}
    return params, torch.rand(N, generator=gen).to(dev)


def launch(fn, params, x, out) -> None:
    H = params["w0"].shape[2]
    err = fn(x.data_ptr(), *(params[k].data_ptr() for k in ops.CDF_PARAMS), out.data_ptr(),
             N, B, H, x.device.index, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")


def time_ms(fn, params, x, out, iters: int = 10) -> float:
    for _ in range(2):
        launch(fn, params, x, out)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch(fn, params, x, out)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("cdf_sweep: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    fns = build(names)
    dev = torch.device("cuda:0")
    for H in (16, 8, 32, 4):
        params, x = bank(H, dev)
        want = ref.cdf_mlp_ref(params, x)
        first, times = None, {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                out = torch.empty((N, B), dtype=torch.float32, device=dev)
                times[name].append(time_ms(fn, params, x, out))
                first = out if first is None else first
                if not torch.equal(out, first) or not torch.allclose(out, want, atol=ATOL, rtol=0):
                    raise AssertionError(f"variant {name} at H={H} disagrees")
        for name, t in times.items():
            print(f"H={H} N={N} B={B} {name}: {t[0]:.6f} / {t[1]:.6f} ms a launch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

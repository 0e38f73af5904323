"""Design probes of the port's Hopper kernels, on one CUDA card.

    python3 kernel_probes.py            # both probes
    python3 kernel_probes.py --stream   # act_dropout_bwd's grid layouts only
    python3 kernel_probes.py --mma      # the TF32 mma.sync ceiling only
    python3 kernel_probes.py --linear [--few-tiles] [--root DIR]
        # linear's float32 train products (or products of fewer 128 x 128
        # tiles than SMs), timed; the port imported from DIR
    python3 kernel_probes.py --wgrad [--root DIR]
        # linear_wgrad's float32 train weight gradients, timed

--stream times act_dropout_bwd's computation (dh x mask x GELU'(a), and the
mask alone) at the ViT's fc1 (135,168 x 1,536 float32) in layouts that
csrc/train.cu chose between: a grid of the resident blocks looping over n
against a grid over n (one contiguous run a block), 1 to 8 float4 of each
input a thread, 128 to 512 threads a block, with and without the
evict-first hints and an L2 prefetch hint; beside the port's kernel,
aten.gelu_backward and torch.add (the same 12 bytes an element).

--mma measures how many TF32 mma.sync m16n8k8 a card issues per second:
8 warps a block, 16 independent accumulators a warp, no memory traffic.
That is the ceiling of the 3xTF32 tiles (csrc/linear.cu, csrc/superglue.cu,
csrc/attention*.cu), which cannot use wgmma for operands that are not
K-major.

--linear times ``linear`` at the float32 train trunks' products (DINO's ViT
at 512 x 264 rows, the encoder at 2,880 x 16: the forward with its
epilogues and the dgrad) beside the port's plain version, the 3xTF32 bound
and two library yardsticks that the port never calls, torch.matmul (or
torch.addmm with a bias) with allow_tf32 False and True, and prints the route
each took (``linear.by_route``, where the port has it). With --root DIR the
port is imported from DIR (for instance the parent commit unpacked with git
archive; its kernels build under DIR/build/kernels), so two trees compare on
one card, one after the other. With --few-tiles it times products of
fewer 128 x 128 tiles than the card has SMs instead (the f32 serving ViT's
N 384 products, a learnability-sized trunk, few rows with trans_w), by CUDA
events and by CUDA-graph replay (the device's time without the host's).

--wgrad times ``linear_wgrad`` in float32 mode at the train cells' weight
gradients (ViT-S at 512 x 264 rows, ViT-g at 96 x 348, the encoder at
2,880 x 16): the weight-gradient kernel's device time and the whole call's
(its partials summed) by torch.profiler, CUDA-event time, the plain
version's, the 3xTF32 bound (x and dy read once, the partials' traffic not
counted), torch.matmul(x^T, dy) with allow_tf32 False and True (library
yardsticks the port never calls), the route (``linear_wgrad.by_route``,
where the port has it) and the largest difference from the plain version
relative to its largest value. --root DIR as for --linear.

The probe kernels are built here with nvcc into build/probes/ (they are not
part of the port). Times are CUDA-event medians after warm-up, with the
card's name and power limit printed first; nothing is written but stdout.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

SOURCE = r'''
#include "common.cuh"

template <int ACT>
__device__ __forceinline__ float one(float dh, float a, unsigned i, const DropArgs& d) {
  const float v = dh * drop_mul(d, i);
  if (ACT == ACT_GELU) return v * gelu_grad(a);
  return v;
}

template <int PF, bool HINT>
__device__ __forceinline__ float4 ld4(const float4* p) {
  float4 r;
  if (PF == 1) {
    asm volatile("ld.global.L2::256B.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w) : "l"(p));
    return r;
  }
  return HINT ? __ldcs(p) : *p;
}

// RESIDENT: a grid of the resident blocks, each thread looping over n with
// U float4 of each input in flight; else one run of TH x U float4 a block
template <int ACT, int U, int TH, bool RESIDENT, bool HINT, int PF>
__global__ void __launch_bounds__(TH) probe_stream(const float* dh, const float* a, float* out,
                                                   unsigned n, DropArgs d) {
  const unsigned n4 = n / 4;
  const float4* dh4 = reinterpret_cast<const float4*>(dh);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* o4 = reinterpret_cast<float4*>(out);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned stride = RESIDENT ? gridDim.x * TH : TH;
  const unsigned step = RESIDENT ? U * stride : 0;
  for (unsigned v0 = RESIDENT ? blockIdx.x * TH + threadIdx.x : blockIdx.x * TH * U + threadIdx.x;
       v0 < n4; v0 += step) {
    float4 x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned v = v0 + u * stride;
      x[u] = v < n4 ? ld4<PF, HINT>(dh4 + v) : z;
      y[u] = ACT != ACT_NONE && v < n4 ? ld4<PF, HINT>(a4 + v) : z;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned v = v0 + u * stride, i = 4 * v;
      const float4 r = make_float4(one<ACT>(x[u].x, y[u].x, i, d), one<ACT>(x[u].y, y[u].y, i + 1, d),
                                   one<ACT>(x[u].z, y[u].z, i + 2, d), one<ACT>(x[u].w, y[u].w, i + 3, d));
      if (v < n4) {
        if (HINT) __stcs(o4 + v, r); else o4[v] = r;
      }
    }
    if (!RESIDENT) break;
  }
}

template <int ACT, int U, int TH, bool RESIDENT, bool HINT, int PF>
int launch(const float* dh, const float* a, float* out, unsigned n, DropArgs d, cudaStream_t s) {
  auto k = probe_stream<ACT, U, TH, RESIDENT, HINT, PF>;
  int blocks = (int)((n / 4 + TH * U - 1) / (TH * U));
  if (RESIDENT) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, TH, 0);
    blocks = per_sm * sms;
  }
  k<<<blocks, TH, 0, s>>>(dh, a, out, n, d);
  return (int)cudaGetLastError();
}

#define CASE(ACT, U, TH, RES, HINT, PF) \
  if (idx == i++) return launch<ACT, U, TH, RES, HINT, PF>(dh, a, out, n, d, s);
#define CASES(ACT) \
  CASE(ACT, 4, 256, true, true, 0) CASE(ACT, 2, 256, true, true, 0) \
  CASE(ACT, 8, 256, true, true, 0) CASE(ACT, 1, 256, false, true, 0) \
  CASE(ACT, 2, 256, false, true, 0) CASE(ACT, 4, 256, false, true, 0) \
  CASE(ACT, 8, 128, false, true, 0) CASE(ACT, 2, 512, false, true, 0) \
  CASE(ACT, 2, 256, false, false, 0) CASE(ACT, 2, 256, false, true, 1)

extern "C" int probe_case_count() { return 10; }
extern "C" int probe_stream_run(int idx, int act, const float* dh, const float* a, float* out,
                                unsigned n, unsigned key, int thr, float scale, void* stream) {
  const DropArgs d{key, thr, scale};
  cudaStream_t s = (cudaStream_t)stream;
  int i = 0;
  if (act == ACT_GELU) { CASES(ACT_GELU) }
  i = 0;
  if (act == ACT_NONE) { CASES(ACT_NONE) }
  return -1;
}

__global__ void __launch_bounds__(256, 1) probe_mma(float* out, int iters) {
  float acc[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const uint32_t b0 = threadIdx.x * 3u, b1 = 7u;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < 16; ++k) mma_tf32(acc[k], a, b0, b1);
  float s = 0.f;
  for (int k = 0; k < 16; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int probe_mma_run(float* out, int blocks, int iters, void* stream) {
  probe_mma<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
'''

STREAM_CASES = ("resident grid, 4 float4 a thread, 256 threads",
                "resident grid, 2 float4, 256 threads",
                "resident grid, 8 float4, 256 threads",
                "grid over n, 1 float4, 256 threads",
                "grid over n, 2 float4, 256 threads",
                "grid over n, 4 float4, 256 threads",
                "grid over n, 8 float4, 128 threads",
                "grid over n, 2 float4, 512 threads",
                "grid over n, 2 float4, 256 threads, plain loads and stores",
                "grid over n, 2 float4, 256 threads, L2::256B prefetch")


def build():
    """Compile the probe kernels into build/probes/ and bind them."""
    from posediffusion_tpu_torch.ops import kernels as K

    out_dir = os.path.join(REPO, "build", "probes")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "probes.cu"), os.path.join(out_dir, "libprobes.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([K._nvcc(), *K._NVCC_FLAGS, "-shared", "-I", str(K._CSRC), "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    so.probe_stream_run.argtypes = [I, I, P, P, P, U, U, I, F, P]
    so.probe_mma_run.argtypes = [P, I, I, P]
    return so


def stream_probe(torch, so, time_ms):
    from posediffusion_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    M, F = 135168, 1536
    dh, a = (torch.randn((M, F), generator=g, device=dev) for _ in range(2))
    out = torch.empty_like(dh)
    drop = K.drop_args(0, 3, "mff", 0.1)
    st = torch.cuda.current_stream().cuda_stream
    for act, name, nbytes, mask in ((2, "GELU', no mask", 12, None), (0, "mask alone", 8, drop)):
        bound = nbytes * dh.numel() / 3.35e12 * 1e3
        print(f"[stream] {name} at {M}x{F}: bytes bound {bound:.4f} ms")
        args = mask.args() if mask else (0, 0, 1.0)
        for idx, label in enumerate(STREAM_CASES):
            call = lambda: so.probe_stream_run(idx, act, dh.data_ptr(), a.data_ptr(),  # noqa: E731
                                               out.data_ptr(), dh.numel(), *args, st)
            if call() != 0:
                raise RuntimeError(f"probe case {label} did not launch")
            ms = time_ms(torch, call, reps=10, inner=5)
            print(f"  {label}: {ms:.4f} ms ({100 * bound / ms:.1f}% of the bound)")
        port = (lambda: K.act_dropout_bwd(dh, a, "gelu")) if act else (
            lambda: K.act_dropout_bwd(dh, None, "none", mask))
        ms = time_ms(torch, port, reps=10, inner=5)
        print(f"  the port's act_dropout_bwd: {ms:.4f} ms ({100 * bound / ms:.1f}% of the bound)")
        if act:
            for label, fn in (("aten.gelu_backward", lambda: torch.ops.aten.gelu_backward(dh, a)),
                              ("torch.add (12 bytes an element)",
                               lambda: torch.add(dh, a, out=out))):
                ms = time_ms(torch, fn, reps=10, inner=5)
                print(f"  {label}: {ms:.4f} ms ({100 * bound / ms:.1f}% of the bound)")


def mma_probe(torch, so, time_ms):
    dev = torch.device("cuda")
    st = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, device=dev)
    iters = 6000
    for blocks in (sms, 2 * sms):
        call = lambda: so.probe_mma_run(out.data_ptr(), blocks, iters, st)  # noqa: E731
        if call() != 0:
            raise RuntimeError("probe_mma did not launch")
        ms = time_ms(torch, call, reps=5)
        mmas = blocks * 8 * 16 * iters
        print(f"[mma] {blocks} blocks of 8 warps: {ms:.4f} ms, {mmas / ms / 1e6:.1f} M TF32 "
              f"m16n8k8 a ms = {mmas * 2048 / ms / 1e9:.1f} TFLOP/s (495 dense TF32 peak)")


# (name, M, K, N, trans_w, epilogue) of the float32 train products
LINEAR_CASES = [
    ("vit qkv", 135168, 384, 1152, False, "bias"),
    ("vit proj", 135168, 384, 384, False, "residual"),
    ("vit fc1", 135168, 384, 1536, False, "gelu"),
    ("vit fc2", 135168, 1536, 384, False, "residual"),
    ("vit qkv dgrad", 135168, 1152, 384, True, None),
    ("vit proj dgrad", 135168, 384, 384, True, None),
    ("vit fc1 dgrad", 135168, 1536, 384, True, None),
    ("vit fc2 dgrad", 135168, 384, 1536, True, None),
    ("encoder linear1", 46080, 512, 1024, False, "gelu"),
    ("encoder linear1 dgrad", 46080, 1024, 512, True, None),
]


# products of fewer 128 x 128 tiles than an H100's 132 SMs
LINEAR_FEW_TILE_CASES = [
    ("serving vit proj", 5280, 384, 384, False, "bias"),
    ("serving vit fc2", 5280, 1536, 384, False, "residual"),
    ("serving vit proj dgrad", 5280, 384, 384, True, None),
    ("4000 x 512 -> 512", 4000, 512, 512, False, "bias"),
    ("learnability fc1", 2048, 256, 1024, False, "gelu"),
    ("learnability fc1 dgrad", 2048, 1024, 256, True, None),
    ("few rows dgrad", 32, 1024, 512, True, None),
    ("one tile", 128, 384, 128, False, "bias"),
]


def linear_probe(torch, time_ms, few_tiles=False):
    import json

    from chip_smoke import _graph_ms
    from posediffusion_tpu_torch.ops import kernels as K

    print(f"[linear] port from {os.path.dirname(os.path.dirname(os.path.dirname(K.__file__)))}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, M, Kd, N, trans, epi in LINEAR_FEW_TILE_CASES if few_tiles else LINEAR_CASES:
        a = torch.randn((M, Kd), generator=g, device=dev)
        w = torch.randn((N, Kd) if trans else (Kd, N), generator=g, device=dev) / Kd**0.5
        b = torch.randn(N, generator=g, device=dev) if epi else None
        kw = {}
        if epi == "residual":
            kw = dict(residual=torch.randn((M, N), generator=g, device=dev),
                      drop=K.drop_args(0, 1, "m1", 0.1))
        elif epi == "gelu":
            kw = dict(act="gelu", drop=K.drop_args(0, 1, "mff", 0.1), want_pre=True)
        io = (M * Kd + Kd * N + M * N * (2 if kw else 1) + (N if b is not None else 0)) * 4
        bound = max(io / 3.35e12, 3 * 2 * M * Kd * N / 495e12) * 1e3
        wt = w.t() if trans else w
        call = lambda: K.linear(a, w, b, trans_w=trans, **kw)  # noqa: E731
        K.reset_launch_counts()
        call()
        route = dict(getattr(K.linear, "by_route", {})) or "tf32_mma (no by_route)"
        ms = time_ms(torch, call, reps=10, inner=10 if few_tiles else 1)
        graph_ms = _graph_ms(torch, call) if few_tiles else None
        plain_ms = time_ms(torch, lambda: K.linear_plain(a, w, b, trans_w=trans, **kw), reps=5)
        lib = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            fn = (lambda: torch.addmm(b, a, wt)) if b is not None else (lambda: torch.matmul(a, wt))
            lib[f"allow_tf32={tf32}"] = time_ms(torch, fn, reps=10)
        torch.backends.cuda.matmul.allow_tf32 = False
        row = dict(case=name, M=M, K=Kd, N=N, trans_w=trans, epilogue=epi, route=route,
                   kernel_ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound,
                   pct_of_3xtf32=100 * bound / ms, library_ms=lib)
        rows.append(row)
        print(f"  {name} ({M}x{Kd} -> {N}{', trans_w' if trans else ''}, {epi}): {route} "
              f"{ms:.4f} ms{f' (graph {graph_ms:.4f})' if few_tiles else ''}, "
              f"{100 * bound / ms:.1f}% of the 3xTF32 bound {bound:.4f} ms; plain "
              f"{plain_ms:.4f}; torch f32 {lib['allow_tf32=False']:.4f}, TF32 "
              f"{lib['allow_tf32=True']:.4f}")
        del a, w, b, kw
    print(json.dumps({"linear_probe": rows}))


# (name, M, K, N) of the float32 train weight gradients
WGRAD_CASES = [
    ("vit-s fc1", 135168, 384, 1536),
    ("vit-s qkv", 135168, 384, 1152),
    ("vit-s proj", 135168, 384, 384),
    ("vit-s fc2", 135168, 1536, 384),
    ("encoder linear1", 46080, 512, 1024),
    ("vit-g w12", 33408, 1536, 8192),
    ("vit-g w3", 33408, 4096, 1536),
    ("vit-g qkv", 33408, 1536, 4608),
    ("vit-g proj", 33408, 1536, 1536),
]
WGRAD_KERNELS = ("wgrad_tf32_kernel", "wgrad_tf32_wgmma_kernel")


def wgrad_probe(torch, time_ms):
    import json

    from chip_smoke import _kernel_device_ms
    from posediffusion_tpu_torch.ops import kernels as K

    print(f"[wgrad] port from {os.path.dirname(os.path.dirname(os.path.dirname(K.__file__)))}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for name, M, Kd, N in WGRAD_CASES:
        x = torch.randn((M, Kd), generator=g, device=dev)
        dy = torch.randn((M, N), generator=g, device=dev)
        call = lambda: K.linear_wgrad(x, dy)  # noqa: E731
        K.reset_launch_counts()
        dw, db = call()
        route = dict(getattr(K.linear_wgrad, "by_route", {})) or "tf32_mma (no by_route)"
        rw, rb = K.linear_wgrad_plain(x, dy)
        err = max(((dw - rw).abs().max() / rw.abs().max()).item(),
                  ((db - rb).abs().max() / rb.abs().max()).item())
        del dw, db, rw, rb
        io = (M * Kd + M * N + Kd * N + N) * 4
        bound = max(io / 3.35e12, 3 * 2 * M * Kd * N / 495e12) * 1e3
        kernel_ms = _kernel_device_ms(torch, call, WGRAD_KERNELS, calls=10)
        call_ms = _kernel_device_ms(torch, call, None, calls=10)
        ms = time_ms(torch, call, reps=10)
        plain_ms = time_ms(torch, lambda: K.linear_wgrad_plain(x, dy), reps=5)
        lib = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            lib[f"allow_tf32={tf32}"] = time_ms(torch, lambda: torch.matmul(x.t(), dy), reps=10)
        torch.backends.cuda.matmul.allow_tf32 = False
        row = dict(case=name, M=M, K=Kd, N=N, route=route, rows=K.wgrad_rows(M, Kd, N),
                   kernel_device_ms=kernel_ms, call_device_ms=call_ms, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, pct_of_3xtf32=100 * bound / kernel_ms, library_ms=lib,
                   max_rel_err=err)
        rows.append(row)
        print(f"  {name} ({M}x{Kd})^T ({M}x{N}): {route}, kernel {kernel_ms:.4f} ms by device "
              f"time ({100 * bound / kernel_ms:.1f}% of the 3xTF32 bound {bound:.4f} ms), call "
              f"{call_ms:.4f} (events {ms:.4f}); plain {plain_ms:.4f}; torch f32 "
              f"{lib['allow_tf32=False']:.4f}, TF32 {lib['allow_tf32=True']:.4f}; rel err "
              f"{err:.2e}", flush=True)
        del x, dy
    print(json.dumps({"wgrad_probe": rows}))


def main(argv) -> int:
    if "--root" in argv:  # before the port's first import
        sys.path.insert(0, os.path.abspath(argv[argv.index("--root") + 1]))
    import torch

    if not torch.cuda.is_available():
        print("kernel_probes.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(1 if "--root" in argv else 0, REPO)
    from chip_smoke import _time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}")
    if "--linear" in argv:
        linear_probe(torch, _time_ms, few_tiles="--few-tiles" in argv)
        return 0
    if "--wgrad" in argv:
        wgrad_probe(torch, _time_ms)
        return 0
    so = build()
    if "--mma" not in argv:
        stream_probe(torch, so, _time_ms)
    if "--stream" not in argv:
        mma_probe(torch, so, _time_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

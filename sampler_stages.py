"""Stage times of the sampler's fold-in kernel (csrc/sampler.cu) on one card.

    python3 sampler_stages.py [ROWS]      # from the repository root; 20 rows by default

Writes an instrumented copy of csrc/sampler.cu into build/sampler_stages/
(a mark of the card's global timer, %globaltimer, after a block barrier at
each stage boundary, kept per block), builds it alone into a shared
library, and runs the three entries (prologue, epilogue, step boundary)
at the model's widths (D 512, HID 128, T 9, F 10) on seeded random inputs,
in a cluster of 16 and of 8. For each it prints block 0's marks in ns from
the first block's entry, and the device time a launch of the uninstrumented
kernel (torch.profiler, 20 launches). The marks' barriers add a little
time of their own. A mark that the source no longer has an anchor for
stops the script: update MARKS with the kernel.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "posediffusion_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "sampler_stages")
# (text of the source the mark goes after, mark number, what ends there)
MARKS = (
    ("  const int pstep = A.mode == MODE_BOUNDARY ? A.step + 1 : A.step;\n", 0, "entry"),
    ("    asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n  }\n", 1,
     "weights issued"),
    ("      mbar_wait(bar_w0, 0);\n      __syncthreads();\n", 2, "W0 and h's slice in"),
    ("        push_tile(cluster, acc, scr, tl, ncg, nr, HS, c);\n      }\n", 3,
     "epilogue product pushed"),
    ("      cluster_sync_all();  // 1: every partial is in its owner\n", 4, "barrier 1"),
    ("      cluster_sync_all();  // 2: every block holds the whole hidden layer\n", 5,
     "owned columns broadcast, barrier 2"),
    ("    __syncthreads();  // x (new in a boundary launch) is in xs\n", 6,
     "LayerNorm, W1 and the update"),
    ("        if (f0 == 0) feat[(2 * HH + d) * SR + r] = xv;\n      }\n", 7, "features"),
    ("      mbar_wait(bar_wp, 0);\n      __syncthreads();\n", 8, "prologue weights and zf in"),
    ("              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);\n      }\n"
     "      __syncthreads();\n", 9, "prologue product"),
    ("    __syncthreads();  // the next tile overwrites the slices, x and scr\n", 10,
     "h written"),
)


def instrument():
    """The instrumented source and its headers in OUT."""
    with open(os.path.join(CSRC, "sampler.cu")) as f:
        src = f.read()
    head = ('#include "hopper.cuh"\n__device__ long long g_marks[16 * 16];\n'
            "#define MARK(i) do { __syncthreads(); if (threadIdx.x == 0) { long long t_; "
            'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
            "g_marks[blockIdx.x * 16 + (i)] = t_; } } while (0)\n")
    assert src.count('#include "hopper.cuh"\n') == 1
    src = src.replace('#include "hopper.cuh"\n', head)
    for anchor, i, what in MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"no single anchor for mark {i} ({what}) in csrc/sampler.cu")
        src = src.replace(anchor, anchor + f"  MARK({i});\n")
    src += ("\nPD_API int pd_read_marks(long long* out) {\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_marks, sizeof(long long) * 16 * 16);\n}\n")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "sampler.cu"), "w") as f:
        f.write(src)
    for h in ("common.cuh", "hopper.cuh"):
        shutil.copy(os.path.join(CSRC, h), OUT)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from posediffusion_tpu_torch.ops import kernels as K

    rows = int(argv[1]) if len(argv) > 1 else 20
    instrument()
    so = os.path.join(OUT, "libsampler_stages.so")
    subprocess.run([K._nvcc(), *K._NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(OUT, "sampler.cu")], check=True)
    probe = ctypes.CDLL(so)
    for name, argtypes in K._SIGNATURES.items():
        if hasattr(probe, name):
            getattr(probe, name).argtypes = argtypes
            getattr(probe, name).restype = ctypes.c_int
    probe.pd_read_marks.argtypes = [ctypes.c_void_p]
    real_lib, real_cluster = K.load_library(), K.sampler_cluster_size

    dev = torch.device("cuda")
    r = np.random.default_rng(0)
    D, HID, TD, NH, R = 512, 128, 9, 10, 4
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()  # noqa: E731
    x = t(r.normal(size=(rows, TD)))
    pro = [t(r.normal(size=(TD * NH, D)) * 0.05), t(r.normal(size=(TD * NH, D)) * 0.05),
           t(r.normal(size=(TD, D)) * 0.05), t(r.normal(size=(rows, D))), t(r.normal(size=(R, D)))]
    head = [t(r.normal(size=(rows, D)))] + [t(r.normal(size=s) * c) for s, c in (
        ((D, HID), 0.05), ((HID,), 0.1), ((HID,), 1.0), ((HID,), 0.1), ((HID, TD), 0.1),
        ((TD,), 0.1))] + [t(r.uniform(0.5, 1.5, size=(R, 2))), t(r.normal(size=(R, rows, TD)) * 0.1)]
    calls = {"prologue": lambda: K.sampler_prologue(x.clone(), *pro, 0),
             "epilogue": lambda: K.sampler_epilogue(*head, x.clone(), 0),
             "boundary": lambda: K.sampler_boundary(*head, x.clone(), 0, *pro)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; {rows} rows")
    out = {}
    buf = np.zeros(16 * 16, np.int64)
    for cluster in (16, 8):
        K.sampler_cluster_size = lambda *a, c=cluster: c
        for mode, fn in calls.items():
            K.load_library = lambda: probe
            for _ in range(30):
                fn()
            torch.cuda.synchronize()
            probe.pd_read_marks(buf.ctypes.data)
            m = buf.reshape(16, 16)[:cluster]
            t0 = m[:, 0].min()
            marks = {what: int(m[0, i] - t0) for _, i, what in MARKS if m[0, i] >= t0}
            K.load_library = lambda: real_lib
            from torch.profiler import ProfilerActivity, profile

            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total for e in prof.key_averages()
                     if "sampler_step_kernel" in e.key) / 20
            out[f"{mode}, cluster {cluster}"] = {"marks_ns": marks, "device_us": us}
            print(f"{mode}, cluster {cluster}: device {us:.2f} us a launch; block 0's marks "
                  f"(ns): {marks}", flush=True)
    K.sampler_cluster_size = real_cluster
    print(json.dumps({"sampler_stages": out, "rows": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

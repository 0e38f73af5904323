// bf16 mode's weight gradient on bf16 wgmma (sm_90a):
//   partial[s] = round_bf16(X[rows of s])^T round_bf16(dY[rows of s])
//   and, from the blocks of k tile 0, colsum(dY[rows of s]) of the unrounded
//   dY.
// X (M, K) and dY (M, N) are float32; the (S, K, N) partials are summed in
// order by train.cu's pd_sum_partials (ops/kernels.linear_wgrad).
//
// Replaces, inside posediffusion_tpu/ops/vit_train_kernel.py _bwd_call
// (:866 -> :905), the bf16 mode's weight gradients of _mlp_residual_bwd
// (:322-325, :341-345) and _attn_residual_bwd (:403-406, :476-479):
// dot_general(cast(x), cast(dy), (((0,), (0,)), ...), preferred_element_type
// =f32) and jnp.sum(dy, axis=0), their per-chunk partials summed in order
// (:937-940).
//
// Bound: bytes. At the ViT's fc1 (135,168 x 384 and 135,168 x 1,536) the
// float32 operands are 1.04 GB, 0.311 ms at 3.35 TB/s, against 0.161 ms of
// bf16 tensor-core work. A 128 x 128 tile of dW re-reads its rows' X slice
// once per N tile and its dY slice once per K tile: at fc1 36 tiles read 4.98
// GB through the L2, 4.8x the operands. Design:
//   * Grid: one block per (row split, 128 x 128 tile of dW), the tile
//     fastest, so the blocks of one row range run together and their
//     re-reads of X and dY hit the L2; kernels.wgrad_rows splits the rows so
//     the blocks fill the 132 SMs in whole waves (one block an SM: ~197 KB
//     of shared memory).
//   * Roles: warps 0-7 are two consumer warpgroups, each owning 64 rows (k)
//     of the tile; warp 8 produces. With nine warps one SM sub-partition
//     holds three, so ptxas gives 168 registers a thread: room for the two
//     64-float accumulators without setmaxnreg.
//   * Loads: a ring of Wb::STAGES slots guarded by full and empty mbarriers;
//     a slot holds 32 rows of X (128 columns of K) and of dY (128 of N) in
//     float32, brought by two TMA boxes (unswizzled 512-byte rows; zeros past
//     M, K and N). Where a row is off 16 bytes (K % 4, N % 4 or a base off 16
//     bytes) the producer writes the same slot with element loads instead.
//   * Rounding, round_in's site: the consumers read each slot once (warp w
//     rows w, w + 8, w + 16, w + 24, a float4 a lane: 512-byte rows without
//     bank conflicts), zero the rows past the split, round both operands with
//     cvt.rn.bf16x2.f32 into a bf16 buffer in wgmma's 128-byte-swizzled
//     MN-major layout (two 64-column blocks of 32 rows), and add the
//     unrounded dY into db's column sums. Two such buffers: the consumers
//     round slice q + 1 while the tensor cores run slice q.
//   * Products: wgmma.mma_async m64n128k16, bf16 x bf16 -> f32, both
//     operands from shared memory with the transpose bits set (A = X^T and
//     B = dY both contract over rows: MN-major). A slice is two k16 steps.
//   * Precision: a bf16 x bf16 product is exact in float32 and the tensor
//     core truncates each sum into its accumulator, so every 64 rows (two
//     slices) go into a fresh accumulator that is then added, rounded to
//     nearest, into the running one, as in linear.cu's tiles. A fixed order
//     and no atomics: the result repeats bitwise.
//   * Epilogue: the accumulators go straight to the partial (float2 stores
//     where N is even); db's 8 warps' column sums are added in warp order.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int WB_TILE = 128;    // dW tile of a block: 128 (k) x 128 (n)
constexpr int WB_SLICE = 32;    // data rows a ring slot: two k16 steps
constexpr int WB_THREADS = 288;  // warps 0-7 consume (two warpgroups), warp 8 produces

// the shared memory: 1,024 bytes of alignment slack, the ring (X's and dY's
// float32 slices a slot), two bf16 buffers (X's and dY's rounded slices, two
// 64-column blocks of 32 128-byte rows each), db's per-warp column sums,
// then the full and empty barriers
struct Wb {
  static constexpr int F32 = WB_SLICE * WB_TILE * 4;  // one operand's slice
  static constexpr int SLOT = 2 * F32;
  static constexpr int STAGES = 5;
  static constexpr int HALF = WB_SLICE * 128;  // a 64-column bf16 block
  static constexpr int BF = 2 * HALF;          // one operand's rounded slice
  static constexpr int BUF = 2 * BF;
  static constexpr int RED = 8 * WB_TILE * 4;
  static constexpr int SMEM = 1024 + STAGES * SLOT + 2 * BUF + RED + 2 * STAGES * 8;
};
static_assert(Wb::SMEM <= 232448, "the ring does not fit");

#define WB_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WB_D16(i) WB_D4(i), WB_D4(i + 4), WB_D4(i + 8), WB_D4(i + 12)

// d (+)= A B, m64n128k16, A (64 x 16) and B (16 x 128) MN-major in shared
// memory by their descriptors; acc 0 zeroes d first
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : WB_D16(0), WB_D16(16), WB_D16(32), WB_D16(48)
      : "l"(da), "l"(db), "r"(acc));
}
#undef WB_D16
#undef WB_D4

__global__ void __launch_bounds__(WB_THREADS, 1)
wgrad_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_d, const float* __restrict__ X,
                        const float* __restrict__ dY, float* __restrict__ pw,
                        float* __restrict__ pb, int M, int K, int N, int rows, int use_tma) {
  extern __shared__ __align__(1024) unsigned char wb_smem[];
  unsigned char* smem = wb_smem + ((1024 - (smem_u32(wb_smem) & 1023)) & 1023);
  unsigned char* bufs = smem + Wb::STAGES * Wb::SLOT;
  float* red = reinterpret_cast<float*>(bufs + 2 * Wb::BUF);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * WB_TILE);
  uint64_t* empty = full + Wb::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + WB_TILE - 1) / WB_TILE;
  const int tiles = tiles_n * ((K + WB_TILE - 1) / WB_TILE);
  const int tile = (int)(blockIdx.x % tiles), split = (int)(blockIdx.x / tiles);
  const int k0 = (tile / tiles_n) * WB_TILE, n0 = (tile % tiles_n) * WB_TILE;
  const int r0 = split * rows, r1 = min(M, r0 + rows);
  const int slices = (r1 - r0 + WB_SLICE - 1) / WB_SLICE;

  if (tid == 0) {
    for (int s = 0; s < Wb::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    int stage = 0;
    uint32_t phase = 0;
    for (int q = 0; q < slices; ++q) {
      mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every slot free
      const int m0 = r0 + q * WB_SLICE;
      float* sx = reinterpret_cast<float*>(smem + stage * Wb::SLOT);
      float* sd = sx + WB_SLICE * WB_TILE;
      if (use_tma) {
        if (lane == 0) {
          mbar_expect_tx(&full[stage], Wb::SLOT);
          tma_load_2d(sx, &tm_x, k0, m0, &full[stage]);
          tma_load_2d(sd, &tm_d, n0, m0, &full[stage]);
        }
      } else {
        for (int e = lane; e < WB_SLICE * WB_TILE; e += 32) {
          const int m = m0 + e / WB_TILE, c = e % WB_TILE;
          sx[e] = m < M && k0 + c < K ? X[(size_t)m * K + k0 + c] : 0.f;
          sd[e] = m < M && n0 + c < N ? dY[(size_t)m * N + n0 + c] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[stage]);
      }
      if (++stage == Wb::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // the consumers
  const int wg = warp >> 2;
  const bool bias = pb != nullptr && k0 == 0;  // block-uniform
  float acc[64], part[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  float bs[4] = {0.f, 0.f, 0.f, 0.f};  // columns 4 lane .. 4 lane + 3 of dY, warp's rows
  for (int q = 0; q < slices; ++q) {
    const int stage = q % Wb::STAGES;
    mbar_wait(&full[stage], (q / Wb::STAGES) & 1);
    const float* sx = reinterpret_cast<const float*>(smem + stage * Wb::SLOT);
    const float* sd = sx + WB_SLICE * WB_TILE;
    unsigned char* xb = bufs + (q & 1) * Wb::BUF;
    unsigned char* db = xb + Wb::BF;
    const int live = r1 - (r0 + q * WB_SLICE);  // rows of the slot inside the split
    // lane l rounds columns 4l .. 4l + 3 of row r into 64-column block l / 16
    const int off = (lane >> 4) * Wb::HALF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x = r < live ? reinterpret_cast<const float4*>(sx + r * WB_TILE)[lane] : zero;
      const float4 d = r < live ? reinterpret_cast<const float4*>(sd + r * WB_TILE)[lane] : zero;
      const int o = off + bw_swz(r, 8 * (lane & 15));
      *reinterpret_cast<uint2*>(xb + o) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
      *reinterpret_cast<uint2*>(db + o) = make_uint2(pack_bf16(d.x, d.y), pack_bf16(d.z, d.w));
      if (bias) {
        bs[0] += d.x;
        bs[1] += d.y;
        bs[2] += d.z;
        bs[3] += d.w;
      }
    }
    // generic-proxy stores, read by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (q > 0) {  // slice q - 1's products are done: its buffer is free again
      wgmma_wait_all();
      reg_fence(part);
      if ((q & 1) == 0) {  // a 64-row group ends with slice q - 1
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += part[j];
      }
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");  // both warpgroups' rows are in
    wgmma_fence();
    // k16 step kk: rows 16 kk .. 16 kk + 15 of the slice, 2,048 bytes into
    // each block; LBO the stride of 64-column blocks, SBO of 8-row groups.
    // This warpgroup's 64 rows of dW are block wg of X's buffer.
    const uint32_t a = smem_u32(xb + wg * Wb::HALF), b = smem_u32(db);
    wgmma_ss(part, bw_desc(a, Wb::HALF, 1024), bw_desc(b, Wb::HALF, 1024), q & 1);
    wgmma_ss(part, bw_desc(a + 2048, Wb::HALF, 1024), bw_desc(b + 2048, Wb::HALF, 1024), 1);
    wgmma_commit();
  }
  wgmma_wait_all();
  reg_fence(part);
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] += part[j];

  // accumulator 4j + 2h + c is dW row k0 + 64 wg + 16 (warp % 4) + g + 8h,
  // column n0 + 8j + 2t + c
  const int g = lane >> 2, t = lane & 3;
  float* out = pw + (size_t)split * K * N;
  const bool vec = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + 64 * wg + 16 * (warp & 3) + g + 8 * h;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float* dst = out + (size_t)k * N + n;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (vec && n < N) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (n < N) dst[0] = v0;
        if (n + 1 < N) dst[1] = v1;
      }
    }
  }
  if (bias) {
    reinterpret_cast<float4*>(red + warp * WB_TILE)[lane] = make_float4(bs[0], bs[1], bs[2], bs[3]);
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (tid < WB_TILE && n0 + tid < N) {
      float s = 0.f;
      for (int w = 0; w < 8; ++w) s += red[w * WB_TILE + tid];
      pb[(size_t)split * N + n0 + tid] = s;
    }
  }
}

}  // namespace

// The dW tile of a block (ops/kernels.py WGRAD_TILE[True]).
int wgrad_bf16_tile() { return WB_TILE; }

// X (M, K), dY (M, N) -> partials pw (S, K, N) and pb (S, N) (pb may be
// null), S = ceil(M / rows); the caller checked M, K, N and rows >= 1.
int launch_wgrad_bf16(const float* x, const float* dy, float* pw, float* pb, int M, int K,
                      int N, int rows, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Wb::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles =
      (long long)((K + WB_TILE - 1) / WB_TILE) * ((N + WB_TILE - 1) / WB_TILE);
  const long long blocks = tiles * ((M + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x{}, tm_d{};
  const int use_tma = K % 4 == 0 && N % 4 == 0 && aligned(x, 16) && aligned(dy, 16);
  if (use_tma &&
      !(tmap_2d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, WB_SLICE, WB_TILE,
                CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tmap_2d(&tm_d, dy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, N, WB_SLICE, WB_TILE,
                CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  wgrad_bf16_wgmma_kernel<<<(unsigned)blocks, WB_THREADS, Wb::SMEM, s>>>(
      tm_x, tm_d, x, dy, pw, pb, M, K, N, rows, use_tma);
  return (int)cudaGetLastError();
}

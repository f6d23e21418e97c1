// VQT magnitude: the framed complex-filterbank product of the audio
// frontend, with the magnitude taken in the epilogue.
//
// Replaces piano_a2s_tpu/ops/vqt_pallas.py::_vqt_kernel (the TPU Pallas
// kernel). For clip b, frame t and bin f:
//
//   re[b,t,f] = sum_{j<W} y_pad[b, t*hop + j] * cos_k[j, f]
//   im[b,t,f] = sum_{j<W} y_pad[b, t*hop + j] * sin_k[j, f]
//   out[b,t,f] = sqrt(re^2 + im^2)
//
// y_pad is the audio padded by W/2 zeros on both sides.
//
// Numerics: the product runs on the TF32 tensor cores with float32
// accuracy ("3xTF32"). Every operand x is split into x_hi = rna_tf32(x) and
// x_lo = rna_tf32(x - x_hi), and the kernel sums A_hi*B_hi + A_hi*B_lo +
// A_lo*B_hi in float32; the dropped A_lo*B_lo term and the rounding of x_lo
// are ~2^-22 relative. One TF32 pass alone is ~300x less accurate than
// float32, which the Transcriber's float32 contract forbids. The tensor
// cores' own float32 accumulation truncates, and over all 420 products of a
// tap sum it cost 4-9x the error of a plain float32 product; so each 32-tap
// chunk is summed by the tensor cores into a fresh accumulator and added to
// the running sum with a rounded float32 add.
//
// Operands:
//  - B, the filters, is packed once per filter pair by the Python wrapper
//    (ops/vqt_cuda.py::pack_filters): (2, N_pad, W) f32 = {hi, lo} of the
//    filters K-major, row 2f = cos of bin f and row 2f+1 = sin of bin f, zero
//    rows up to a multiple of TILE_N. tf32 wgmma reads shared memory
//    K-major only; the interleave puts re and im of one bin in one thread's
//    accumulator pair, so the magnitude never leaves registers.
//  - A, the frames, is never written to memory. A pre-pass
//    (pad_split_kernel) writes the padded audio as {hi, lo} rows of hop
//    samples, (2, B, R, hop) with R = n_frames + W/hop - 1. Tap d*hop + c of
//    frame t is row t+d, column c, so the A tile of frames t0..t0+TILE_M-1
//    and taps [d*hop + c0, +KC) is one TMA box at (c0, t0+d, b, part) of a
//    4D tensor map. Rows past R read as zeros: that masks the ragged last
//    frame tile. The split audio (24 MB at 16 x 12 s) stays in the 50 MB L2
//    across its W/hop-fold reuse.
//
// Pipeline: one producer thread keeps TMA loads of A and B (hi and lo, 72 KB
// per 32-tap chunk) in flight into a ring of STAGES shared-memory stages,
// guarded by full/empty mbarriers. Two consumer warpgroups (64 frames each)
// issue wgmma.m64n160k8 tf32: per chunk, 4 k-steps x 3 products. While one
// warpgroup adds its chunk sum, the other keeps the tensor cores busy.
//
// Bound: at the serving shape (16 clips x 1201 frames, 480 bins, W = 1120)
// the three products are 124 GFLOP of TF32 tensor-core work (0.25 ms at the
// data sheet's 495 TFLOP/s) against ~70 MB of device memory traffic: it is
// compute-bound, and with 72 KB of shared-memory operands per 3.9 MFLOP
// chunk the SMs together also pull ~9 TB/s from L2 at the peak rate.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;          // taps per chunk: 128 B of f32, one swizzle row
constexpr int TILE_M = 128;     // frames per block: one 64-row wgmma per warpgroup
constexpr int TILE_N = 160;     // packed columns per block: 80 bins x {re, im}
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int A_BYTES = TILE_M * KC * 4;       // 16 KB per part
constexpr int B_BYTES = TILE_N * KC * 4;       // 20 KB per part
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int ACC = TILE_N / 2;                // f32 accumulators per thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with 128 B swizzle:
// rows of 128 B, 8-row groups 1024 B apart (SBO); the tile starts 1024 B
// aligned, so the base offset is 0. LBO is unused for swizzled K-major tiles.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d = A(64 x 8, tf32) * B(8 x 160, tf32) + (accumulate ? d : 0), both
// operands from shared memory.
__device__ __forceinline__ void wgmma_m64n160k8(float (&d)[ACC], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// (B, L) audio -> (2, B, R, hop): {hi, lo} of the audio padded by `pad`
// zeros, as rows of hop samples.
__global__ void pad_split_kernel(const float* __restrict__ y,
                                 float* __restrict__ a, long long n_split,
                                 long long per_clip, int n_samples, int pad) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_split; i += stride) {
    const long long b = i / per_clip;
    const long long s = i - b * per_clip - pad;
    const float v = (s >= 0 && s < n_samples) ? y[b * n_samples + s] : 0.0f;
    const float hi = tf32_rna(v);
    a[i] = hi;
    a[n_split + i] = tf32_rna(v - hi);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
vqt_mag_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap b_map,
               float* __restrict__ out, int n_frames, int n_bins, int hop,
               int n_chunks, int n_frame_tiles, int n_bin_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // Bin tiles vary fastest, so the blocks that share an A tile run together.
  const int bin_tile = blockIdx.x % n_bin_tiles;
  const int rest = blockIdx.x / n_bin_tiles;
  const int frame_tile = rest % n_frame_tiles;
  const int b = rest / n_frame_tiles;
  const int t0 = frame_tile * TILE_M;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // Producer: one thread issues every load.
    if (threadIdx.x == CONSUMERS * 128) {
      const int n0 = bin_tile * TILE_N;
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % STAGES;
        mbar_wait(&empty[s], ((k / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        const int tap = k * KC;
        const int d = tap / hop;
        const int c0 = tap - d * hop;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_4d(st, &a_map, &full[s], c0, t0 + d, b, 0);
        tma_load_4d(st + A_BYTES, &a_map, &full[s], c0, t0 + d, b, 1);
        tma_load_3d(st + 2 * A_BYTES, &b_map, &full[s], tap, n0, 0);
        tma_load_3d(st + 2 * A_BYTES + B_BYTES, &b_map, &full[s], tap, n0, 1);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns frames t0 + 64*wg .. +63.
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
  float part[ACC];  // this chunk's sum
#pragma unroll
  for (int i = 0; i < ACC; ++i) part[i] = 0.0f;

  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % STAGES;
    mbar_wait(&full[s], (k / STAGES) & 1);
    uint8_t* st = smem + s * STAGE_BYTES;
    const uint64_t a_hi = desc_sw128(st + wg * (A_BYTES / 2));
    const uint64_t a_lo = desc_sw128(st + A_BYTES + wg * (A_BYTES / 2));
    const uint64_t b_hi = desc_sw128(st + 2 * A_BYTES);
    const uint64_t b_lo = desc_sw128(st + 2 * A_BYTES + B_BYTES);
    fence_acc(part);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      // 8 taps = 32 B further along the swizzled row: +2 in 16 B units.
      const uint64_t step = 2 * kk;
      wgmma_m64n160k8(part, a_hi + step, b_hi + step, kk > 0);
      wgmma_m64n160k8(part, a_hi + step, b_lo + step, 1);
      wgmma_m64n160k8(part, a_lo + step, b_hi + step, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(part);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] += part[i];
  }

  // Accumulator layout of m64nN: thread (warp w, lane l) holds rows
  // 16w + l/4 (acc[4j], acc[4j+1]) and 16w + 8 + l/4 (acc[4j+2], acc[4j+3])
  // at columns 8j + 2(l%4) and +1: re and im of bin 4j + l%4 of the tile.
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int row = t0 + 64 * wg + 16 * warp + lane / 4;
  const int f0 = bin_tile * (TILE_N / 2) + lane % 4;
  float* out_b = out + static_cast<long long>(b) * n_frames * n_bins;
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
    const int f = f0 + 4 * j;
    if (f >= n_bins) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = row + 8 * h;
      if (t < n_frames) {
        const float re = acc[4 * j + 2 * h];
        const float im = acc[4 * j + 2 * h + 1];
        out_b[static_cast<long long>(t) * n_bins + f] = sqrtf(re * re + im * im);
      }
    }
  }
}

// Tensor map over an f32 array of `rank` dims (innermost first) whose
// dims[0] is contiguous; boxes of KC x box_rows, 128 B swizzle, zeros out
// of bounds.
CUresult encode_map(CUtensorMap* map, const float* base, int rank,
                    const cuuint64_t* dims, int box_rows) {
  cuuint64_t strides[3];
  cuuint64_t stride = dims[0] * sizeof(float);
  for (int i = 1; i < rank; ++i) {
    strides[i - 1] = stride;
    stride *= dims[i];
  }
  const cuuint32_t box[4] = {KC, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

extern "C" {

// Packed filter columns per block: pack_filters pads to a multiple of this.
int vqt_mag_tile_cols() { return TILE_N; }

// Launches the pre-pass and the product on `stream`. `packed` is
// (2, n_cols, window) from pack_filters; `a_split` is scratch of
// 2 * batch * (n_frames + window / hop - 1) * hop floats. Returns 0, a
// cudaError_t (> 0), or minus a CUresult of the tensor-map encoding.
// Preconditions (checked by the Python wrapper): hop % KC == 0,
// window % hop == 0, n_cols % TILE_N == 0, f32 device memory, contiguous.
int vqt_mag_launch(const float* y, const float* packed, float* a_split,
                   float* out, int batch, int n_samples, int n_frames,
                   int n_bins, int n_cols, int window, int hop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n_frames + window / hop - 1;
  const long long per_clip = static_cast<long long>(rows) * hop;
  const long long n_split = per_clip * batch;
  const int split_blocks = static_cast<int>(
      (n_split + 255) / 256 < 132 * 16 ? (n_split + 255) / 256 : 132 * 16);
  pad_split_kernel<<<split_blocks, 256, 0, st>>>(y, a_split, n_split,
                                                 per_clip, n_samples,
                                                 window / 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap a_map, b_map;
  const cuuint64_t a_dims[4] = {static_cast<cuuint64_t>(hop),
                                static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(batch), 2};
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(window),
                                static_cast<cuuint64_t>(n_cols), 2};
  CUresult res = encode_map(&a_map, a_split, 4, a_dims, TILE_M);
  if (res == CUDA_SUCCESS) res = encode_map(&b_map, packed, 3, b_dims, TILE_N);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);

  err = cudaFuncSetAttribute(vqt_mag_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_frame_tiles = (n_frames + TILE_M - 1) / TILE_M;
  const int n_bin_tiles = n_cols / TILE_N;
  const long long blocks =
      static_cast<long long>(batch) * n_frame_tiles * n_bin_tiles;
  vqt_mag_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, st>>>(
      a_map, b_map, out, n_frames, n_bins, hop, window / KC, n_frame_tiles,
      n_bin_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

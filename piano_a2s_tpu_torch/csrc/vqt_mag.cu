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
// y_pad is the audio padded by W/2 zeros on both sides (the wrapper builds
// it). With W = 7 * hop, frame t is rows t..t+6 of y_pad viewed as rows of
// hop samples, so a tile of TILE_T frames reads only TILE_T + 6 rows: the
// (B, n_frames, W) frame matrix is never written to device memory.
//
// Bound: f32 FFMA. At the serving shape (16 clips of 1201 frames, 480 bins,
// W = 1120) the product is ~41 GFLOP against ~12 MB of audio and 4.3 MB of
// filters, far above the card's ridge point. The design keeps the FFMA units
// fed from registers: each thread owns an 8-frame x 4-bin tile of both re
// and im (64 accumulators), so one k-step costs 8 scalar shared loads and 2
// float4 shared loads for 64 FFMA. The audio rows of the tile sit in shared
// memory for the whole K loop; the filter columns stream through shared
// memory in chunks of KC taps.
//
// Later work: wgmma (3xTF32 or split-f32) tensor-core products fed by TMA,
// and double-buffered filter chunks. This version is the simple correct one.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_T = 64;    // frames per block
constexpr int TILE_F = 64;    // bins per block (each for re and im)
constexpr int KC = 32;        // taps per filter chunk; divides hop
constexpr int THREADS = 128;  // 16 bin groups x 8 frame groups
constexpr int FR = 8;         // frames per thread (strided by 8)
constexpr int FB = 4;         // bins per thread (contiguous)

__global__ void __launch_bounds__(THREADS)
vqt_mag_kernel(const float* __restrict__ y_pad,
               const float* __restrict__ cos_k,
               const float* __restrict__ sin_k,
               float* __restrict__ out,
               int padded_len, int n_frames, int n_bins, int hop,
               int n_rows_per_frame) {
  extern __shared__ float smem[];
  const int row_stride = hop + 4;  // hop % 32 == 0: rows land 4 banks apart
  const int n_tile_rows = TILE_T + n_rows_per_frame - 1;
  float* s_audio = smem;                               // n_tile_rows x row_stride
  float* s_cos = s_audio + n_tile_rows * row_stride;   // KC x TILE_F
  float* s_sin = s_cos + KC * TILE_F;                  // KC x TILE_F

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TILE_T;
  const int f0 = blockIdx.y * TILE_F;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bin group: bins f0 + 4*tx .. +3
  const int ty = tid / 16;  // frame group: frames t0 + ty + 8*i

  // Stage the tile's audio rows; samples past the padded clip read as 0
  // (the ragged last frame tile).
  const float* y_b = y_pad + static_cast<long long>(b) * padded_len;
  const long long base = static_cast<long long>(t0) * hop;
  for (int e = tid; e < n_tile_rows * hop; e += THREADS) {
    const int r = e / hop;
    const int c = e - r * hop;
    const long long s = base + e;
    s_audio[r * row_stride + c] = s < padded_len ? y_b[s] : 0.0f;
  }

  float re[FR][FB];
  float im[FR][FB];
#pragma unroll
  for (int i = 0; i < FR; ++i) {
#pragma unroll
    for (int q = 0; q < FB; ++q) {
      re[i][q] = 0.0f;
      im[i][q] = 0.0f;
    }
  }

  const int n_taps = n_rows_per_frame * hop;
  for (int j0 = 0; j0 < n_taps; j0 += KC) {
    __syncthreads();  // previous chunk consumed (and audio staged, first time)
    for (int e = tid; e < KC * TILE_F; e += THREADS) {
      const int kk = e / TILE_F;
      const int ff = e - kk * TILE_F;
      const int f = f0 + ff;
      const long long g = static_cast<long long>(j0 + kk) * n_bins + f;
      s_cos[e] = f < n_bins ? cos_k[g] : 0.0f;
      s_sin[e] = f < n_bins ? sin_k[g] : 0.0f;
    }
    __syncthreads();

    // KC divides hop, so the chunk lies in one row offset d.
    const int d = j0 / hop;
    const int c0 = j0 - d * hop;
    const float* a_base = s_audio + (ty + d) * row_stride + c0;
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[FR];
#pragma unroll
      for (int i = 0; i < FR; ++i) a[i] = a_base[(8 * i) * row_stride + kk];
      const float4 cv = *reinterpret_cast<const float4*>(s_cos + kk * TILE_F + 4 * tx);
      const float4 sv = *reinterpret_cast<const float4*>(s_sin + kk * TILE_F + 4 * tx);
      const float c[FB] = {cv.x, cv.y, cv.z, cv.w};
      const float sn[FB] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < FR; ++i) {
#pragma unroll
        for (int q = 0; q < FB; ++q) {
          re[i][q] = fmaf(a[i], c[q], re[i][q]);
          im[i][q] = fmaf(a[i], sn[q], im[i][q]);
        }
      }
    }
  }

  float* out_b = out + static_cast<long long>(b) * n_frames * n_bins;
#pragma unroll
  for (int i = 0; i < FR; ++i) {
    const int t = t0 + ty + 8 * i;
    if (t >= n_frames) continue;
#pragma unroll
    for (int q = 0; q < FB; ++q) {
      const int f = f0 + 4 * tx + q;
      if (f < n_bins) {
        out_b[static_cast<long long>(t) * n_bins + f] =
            sqrtf(re[i][q] * re[i][q] + im[i][q] * im[i][q]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
int vqt_mag_smem_bytes(int hop, int n_rows_per_frame) {
  return static_cast<int>(sizeof(float)) *
         ((TILE_T + n_rows_per_frame - 1) * (hop + 4) + 2 * KC * TILE_F);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Preconditions (checked by the Python wrapper): hop % KC == 0, all
// pointers are f32 device memory, rows contiguous.
int vqt_mag_launch(const float* y_pad, const float* cos_k, const float* sin_k,
                   float* out, int batch, int padded_len, int n_frames,
                   int n_bins, int hop, int n_rows_per_frame, void* stream) {
  const int smem = vqt_mag_smem_bytes(hop, n_rows_per_frame);
  cudaError_t err = cudaFuncSetAttribute(
      vqt_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_frames + TILE_T - 1) / TILE_T, (n_bins + TILE_F - 1) / TILE_F,
            batch);
  vqt_mag_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      y_pad, cos_k, sin_k, out, padded_len, n_frames, n_bins, hop,
      n_rows_per_frame);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

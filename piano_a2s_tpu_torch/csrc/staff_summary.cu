// K3: the staff summaries of the greedy hierarchical decoder, both
// directions of the staff GRU in one launch, lengths read on the card.
//
// Replaces no Pallas kernel: the JAX package's staff summary is the XLA
// scan of piano_a2s_tpu/ops/gru.py::bidir_final_fused, and the port ran it
// as one packed, bidirectional, batch-first nn.GRU call (ops/gru.py::
// bidir_final_fused): cuDNN launches two kernels a step and direction (a
// 32 x 96 recurrent product and an element-wise cell, about 1,600 launches
// a bar at the caps), and pack_padded_sequence reads the lengths back to
// the host before each call. K3 computes, for each of the N = S x B
// sequences of tokens with its length len (1 <= len <= T), the final
// hidden of
//
//   forward:  h = 0, then positions 0 .. len-1
//   backward: h = 0, then positions len-1 .. 0   (from len-1, not from T-1)
//   x   = emb[token]                              (the lookup is fused)
//   r   = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
//   z   = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
//   n   = tanh(W_in x + b_in + r * (W_hn h + b_hn))
//   h'  = (1 - z) * n + z * h
//
// and writes out[seq] = [forward h ; backward h]. Positions past a
// sequence's length are never read.
//
// Bound: latency, not bytes or operations. A call at (S, B, T) = (2, 16,
// 398) moves about 100 KB and does about 0.2 GFLOP, both well under 1 us on
// this card; what takes the time is the chain of up to 398 dependent steps.
//
// Design: one warp per (sequence, direction), blocks of WARPS warps of one
// direction (grid: ceil(N / WARPS) x 2). Lane j owns hidden unit j and keeps
// its three gate rows of W_hh (3 x 32 floats) in registers; the block keeps
// its direction's W_ih in shared memory, padded so that the lanes' float4
// reads fall in distinct banks. h is exchanged through the warp's shared
// memory with one __syncwarp a step and no block-wide barrier. The input
// half (W_ih x + b_ih) depends on the tokens only, so it is computed one
// step ahead, off the h chain; the embedding rows are fetched two steps
// ahead, and the tokens 32 steps at a time, a chunk ahead, one a lane,
// handed out by shuffles a step before their row is fetched (no step waits
// on a global load). Each gate's recurrent product runs
// in two partial sums (even and odd float4 of h), added in a fixed order:
// a call is deterministic.
//
// Widths: hidden <= 32 (one lane a unit), input <= 64; the wrapper
// (ops/staff_summary_cuda.py) refuses others. One launch a call; no host
// synchronisation, nothing allocated (the wrapper allocates the output),
// safe inside CUDA graph capture. A token outside [0, V) reads the nearest
// row of the table (the callers' tokens are argmaxes and targets, all in
// range); a length outside [0, T] is clamped to it.
//
// Measured (H100 SXM, 700 W; PERF.md): 0.24-0.26 ms a call at (2, 16, 398)
// with lengths 398 and 189, about 0.6 us a step of the chain, against
// 9.8-12.3 ms for the packed cuDNN call with its host length read; 168
// registers, no spills. Built with -use_fast_math it takes 0.19-0.20 ms: the
// accurate expf, tanhf and division are about a fifth of a step.
//
// Numerics: float32 FMAs, expf / tanhf of the CUDA math library (no
// fast-math, no .approx intrinsics).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Everything one call reads and writes; float32 unless noted, contiguous.
// The GRU's tensors are nn.GRU's: weight_ih (3H, E), weight_hh (3H, H),
// biases (3H,), gates in (r, z, n) order; _f forward, _b backward.
struct StaffSummaryArgs {
  const int64_t* tokens;   // (N, T)
  const int64_t* lengths;  // (N,)
  const float* emb;        // (V, E)
  const float* w_ih_f;
  const float* w_hh_f;
  const float* b_ih_f;
  const float* b_hh_f;
  const float* w_ih_b;
  const float* w_hh_b;
  const float* b_ih_b;
  const float* b_hh_b;
  float* out;              // (N, 2H)
  int N, T, V, E, H;
};

namespace {

constexpr int HMAX = 32;             // hidden units: one lane each
constexpr int EMAX = 64;             // input width
constexpr int WARPS = 4;             // warps of a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// The input width rounded up to whole float4s.
__host__ __device__ constexpr int e_quads(int e) { return (e + 3) / 4; }

// A lane's W_ih row stride in shared memory: whole float4s, an odd number
// of them, so that 8 lanes' float4 reads at one k fall in distinct banks.
__host__ __device__ constexpr int row_stride(int e) {
  return 4 * (e_quads(e) % 2 ? e_quads(e) : e_quads(e) + 1);
}

__host__ __device__ constexpr int smem_floats(int e) {
  // W_ih [3][HMAX][row_stride], then per warp h[2][HMAX] and x[2][4 quads].
  return 3 * HMAX * row_stride(e) + WARPS * (2 * HMAX + 2 * 4 * e_quads(e));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// W_ih x + b_ih for this lane's three gates, x from shared memory.
__device__ __forceinline__ void input_half(const float* wih_lane,
                                           const float* x, int quads,
                                           int stride, const float b[3],
                                           float out[3]) {
  float acc[3] = {b[0], b[1], b[2]};
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
  for (int q = 0; q < quads; ++q) {
    const float4 xv = x4[q];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float4 w = reinterpret_cast<const float4*>(
          wih_lane + g * HMAX * stride)[q];
      acc[g] = fmaf(w.x, xv.x, acc[g]);
      acc[g] = fmaf(w.y, xv.y, acc[g]);
      acc[g] = fmaf(w.z, xv.z, acc[g]);
      acc[g] = fmaf(w.w, xv.w, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) out[g] = acc[g];
}

__global__ void __launch_bounds__(THREADS)
staff_summary_kernel(StaffSummaryArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dir = blockIdx.y;
  const int E = a.E, H = a.H, T = a.T;
  const int quads = e_quads(E), stride = row_stride(E);
  const float* __restrict__ w_ih = dir ? a.w_ih_b : a.w_ih_f;
  const float* __restrict__ w_hh = dir ? a.w_hh_b : a.w_hh_f;
  const float* __restrict__ b_ih = dir ? a.b_ih_b : a.b_ih_f;
  const float* __restrict__ b_hh = dir ? a.b_hh_b : a.b_hh_f;

  // The direction's W_ih as [gate][unit][k], zero past H and E.
  float* wih = smem;
  for (int i = threadIdx.x; i < 3 * HMAX * stride; i += THREADS) {
    const int k = i % stride, gj = i / stride;
    const int j = gj % HMAX, g = gj / HMAX;
    wih[i] = (j < H && k < E) ? w_ih[(g * H + j) * E + k] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seq = blockIdx.x * WARPS + warp;
  if (seq >= a.N) return;
  float* hs = smem + 3 * HMAX * stride + warp * (2 * HMAX + 8 * quads);
  float* xs = hs + 2 * HMAX;               // two buffers of 4 * quads
  const int xq = 4 * quads;

  const bool unit = lane < H;
  float whh[3][HMAX];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      whh[g][k] = (unit && k < H) ? w_hh[(g * H + lane) * H + k] : 0.0f;
  float bih[3], bhh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bih[g] = unit ? b_ih[g * H + lane] : 0.0f;
    bhh[g] = unit ? b_hh[g * H + lane] : 0.0f;
  }
  const float* wih_lane = wih + lane * stride;

  int64_t len64 = a.lengths[seq];
  const int len = static_cast<int>(len64 < 0 ? 0 : (len64 > T ? T : len64));
  const int64_t* __restrict__ toks = a.tokens + static_cast<int64_t>(seq) * T;
  const float* __restrict__ emb = a.emb;
  const int V = a.V;
  // Lane l's token of chunk c: that of step 32c + l (position 32c + l
  // forward, len-1-32c-l backward), 0 past the length, which is never read.
  auto chunk = [=](int c) -> int {
    const int i = 32 * c + lane;
    if (i >= len) return 0;
    int64_t t = __ldg(toks + (dir ? len - 1 - i : i));
    t = t < 0 ? 0 : (t >= V ? V - 1 : t);
    return static_cast<int>(t);
  };
  // This lane's entries (k = lane, lane + 32) of the embedding row of token
  // t, zero past E.
  auto emb_pair = [=](int t, float& lo, float& hi) {
    const float* row = emb + static_cast<int64_t>(t) * E;
    lo = lane < E ? __ldg(row + lane) : 0.0f;
    hi = lane + 32 < E ? __ldg(row + lane + 32) : 0.0f;
  };
  auto put_x = [=](float* buf, float lo, float hi) {
    if (lane < xq) buf[lane] = lo;
    if (lane + 32 < xq) buf[lane + 32] = hi;
  };

  float h = 0.0f;
  if (len > 0) {
    // Prologue: x_0 and x_1 in shared memory, x_2 in registers, tokens 3
    // and 4 in flight; h_0 = 0.
    // Tokens come a chunk of 32 steps at a time, one a lane, the next
    // chunk in flight; a step's token is a shuffle from the chunk.
    int tok_cur = chunk(0), tok_next = chunk(1);
    float lo = 0.0f, hi = 0.0f;
    emb_pair(__shfl_sync(FULL, tok_cur, 0), lo, hi);
    put_x(xs, lo, hi);
    lo = hi = 0.0f;
    if (len > 1) emb_pair(__shfl_sync(FULL, tok_cur, 1), lo, hi);
    put_x(xs + xq, lo, hi);
    float next_lo = 0.0f, next_hi = 0.0f;
    if (len > 2) emb_pair(__shfl_sync(FULL, tok_cur, 2), next_lo, next_hi);
    int tok = __shfl_sync(FULL, tok_cur, 3);     // step 3's
    hs[lane] = 0.0f;
    __syncwarp(FULL);
    float xp[3];
    input_half(wih_lane, xs, quads, stride, bih, xp);
    __syncwarp(FULL);

    for (int i = 0; i < len; ++i) {
      const int cur = i & 1, nxt = cur ^ 1;
      // The next step's input half, off the h chain.
      float xp_next[3];
      input_half(wih_lane, xs + nxt * xq, quads, stride, bih, xp_next);
      // The recurrent half from h_i, in two partial sums a gate.
      float acc[3][2];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        acc[g][0] = bhh[g];
        acc[g][1] = 0.0f;
      }
      const float4* h4 = reinterpret_cast<const float4*>(hs + cur * HMAX);
#pragma unroll
      for (int q = 0; q < HMAX / 4; ++q) {
        const float4 hv = h4[q];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float& s = acc[g][q & 1];
          s = fmaf(whh[g][4 * q + 0], hv.x, s);
          s = fmaf(whh[g][4 * q + 1], hv.y, s);
          s = fmaf(whh[g][4 * q + 2], hv.z, s);
          s = fmaf(whh[g][4 * q + 3], hv.w, s);
        }
      }
      const float hr = acc[0][0] + acc[0][1];
      const float hz = acc[1][0] + acc[1][1];
      const float hn = acc[2][0] + acc[2][1];
      const float r = sigmoidf(xp[0] + hr);
      const float z = sigmoidf(xp[1] + hz);
      const float n = tanhf(xp[2] + r * hn);
      h = unit ? (1.0f - z) * n + z * h : 0.0f;
      // x_{i+2} into the buffer x_i held; h_{i+1} into the other h buffer.
      put_x(xs + cur * xq, next_lo, next_hi);
      hs[nxt * HMAX + lane] = h;
      __syncwarp(FULL);
      if (i + 3 < len) emb_pair(tok, next_lo, next_hi);
      const int s = i + 4;                      // the next step's prefetch
      if (s < len) {
        if ((s & 31) == 0) {
          tok_cur = tok_next;
          tok_next = chunk(s / 32 + 1);
        }
        tok = __shfl_sync(FULL, tok_cur, s & 31);
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) xp[g] = xp_next[g];
    }
  }
  if (unit) a.out[static_cast<int64_t>(seq) * 2 * H + dir * H + lane] = h;
}

}  // namespace

using Args = StaffSummaryArgs;

extern "C" {

// The widths the kernel takes at most (hidden, input) and its warps a
// block.
int staff_summary_dims(int* out) {
  out[0] = HMAX;
  out[1] = EMAX;
  out[2] = WARPS;
  return 3;
}

// One call: every sequence's final forward and backward hidden.
int staff_summary_launch(const Args* a, void* stream) {
  if (a->N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((a->N + WARPS - 1) / WARPS, 2);
  const size_t smem = sizeof(float) * smem_floats(a->E);
  staff_summary_kernel<<<grid, THREADS, smem, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

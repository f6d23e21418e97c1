// K4: the recurrence of the greedy encoder's 2-layer bidirectional GRU,
// one launch a layer, both directions at once.
//
// Replaces no Pallas kernel: the JAX package's encoder is the XLA scan of
// piano_a2s_tpu/models/score_transcription.py::encoder_apply, and the port
// ran it as one nn.GRU(256, 256, num_layers=2, bidirectional=True) call:
// cuDNN launches a recurrent product and an element-wise cell a step and
// direction, about 9,600 launches for 2 layers x 2 directions x 1,201
// frames. Per layer the wrapper (ops/encoder_gru_cuda.py) first computes
// the input half of every step with cuBLAS, G = x W_ih^T + b_ih, one
// (B*T, 3H) float32 product a direction; K4 then runs the recurrence
//
//   forward:  h = 0, then t = 0 .. T-1;  backward: h = 0, then t = T-1 .. 0
//   r   = sigmoid(G_r[t] + W_hr h + b_hr)
//   z   = sigmoid(G_z[t] + W_hz h + b_hz)
//   n   = tanh(G_n[t] + r * (W_hn h + b_hn))
//   h'  = (1 - z) * n + z * h
//
// and writes out[b, t, dir*H:(dir+1)*H] = h' and h_n[dir, b] = the last h'.
//
// Bound: latency. Each step of a direction is h (B x 256) @ W_hh^T (256 x
// 768): 6.3 MFLOP at 16 rows, 0.09 us at 67 TFLOP/s on the whole card, but
// the 1,201 steps of a layer depend on one another, and no one SM can do a
// step fast: at 0.51 TFLOP/s an SM, one step of 16 rows takes 12 us. So a
// step is spread over a thread-block cluster of 16 SMs (the largest cluster
// Hopper places, a non-portable size), which exchange h through
// distributed shared memory.
//
// Design: one launch runs 2 x ceil(B / rows) clusters: a (direction, chunk
// of `rows` batch rows) each, `rows` a multiple of 8 chosen by the host so
// that every cluster is resident at once (cudaOccupancyMaxActiveClusters).
// In a cluster, CTA c owns the U = 16 hidden units [c U, (c+1) U) and
// keeps their 3 U rows of W_hh in registers: thread (unit u, slice s) holds
// the three gate rows of unit u at k = 64 q + 4 s + e (q, e in 0..3), 48
// floats; the 16 slices of a unit are a half-warp, and the two half-warps
// of a warp read the same float4s of h. Each CTA keeps the whole h of its
// chunk in shared memory, double-buffered, as 16 blocks (one a CTA, rows x
// U, padded by 64 bytes so that a half-warp's float4s fall in both halves
// of the banks). A step, for each group of 8 rows: every thread forms the
// 24 partial sums (3 gates x 8 rows) of its slice; a transposed butterfly
// over the half-warp (shuffles at lane distances 8, 4, 2 keep half of the
// rows each, distance 1 the last sum: 24 shuffles for 8 rows) leaves each
// lane pair with the three full sums of one row; both lanes take the gates
// from G (in shared memory, copied a step ahead with cp.async) and h_{t-1}
// (the local copy), and one writes h_t into its own block of the next
// buffer and into out. Then, after one CTA barrier, 15 threads each send
// that block to one other CTA of the cluster with a bulk copy
// (cp.async.bulk shared::cta -> shared::cluster) that completes on the
// receiver's barrier for that buffer (an mbarrier expecting 15 blocks of
// bytes a phase); a CTA starts a step when its barrier says that h_{t-1}
// has arrived. There is no cluster-wide barrier a step: a CTA that sends
// step i has received step i - 1 from everyone, so its receivers are done
// reading the buffer it writes. Measured on the H100 (PERF.md), this takes
// 0.4-0.6 us a step less than float4 stores into the other CTAs' shared
// memory followed by a cluster barrier, and about 1 us less than scalar
// stores from the lanes; clusters of 8 CTAs, 32 units each, took 0.6 us a
// step more. A cluster barrier at the end keeps every CTA alive until the
// copies that read its shared memory have landed.
//
// Measured (H100 SXM, 700 W; PERF.md section 6): at (16, 1201) the whole
// call, four products included, takes about 5.7 ms, 2.4 us a step of the
// 2 x 1,201-step chain, against 42-56 ms for cuDNN's call.
//
// Numerics: float32 FFMA products in a fixed order (a call is
// deterministic), expf / tanhf and a true division of the CUDA math library
// (no fast-math, no .approx intrinsics); cuDNN's gate convention (r
// multiplies W_hn h + b_hn inside the n gate).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Everything one layer's launch reads and writes, float32, contiguous.
// g_*: the input half (B*T, 3H) of each direction, x W_ih^T + b_ih, gates in
// (r, z, n) order; w_hh_* (3H, H) and b_hh_* (3H) are nn.GRU's; out (B, T,
// 2H); h_n (2, B, H), this layer's two directions.
struct EncoderGruArgs {
  const float* g_f;
  const float* g_b;
  const float* w_hh_f;
  const float* w_hh_b;
  const float* b_hh_f;
  const float* b_hh_b;
  float* out;
  float* h_n;
  int B, T, H;
};

namespace {

constexpr int HID = 256;           // hidden units (and W_hh's columns)
constexpr int CLUSTER = 16;        // CTAs a cluster
constexpr int U = HID / CLUSTER;   // hidden units a CTA
constexpr int SLICES = 16;         // k slices of a unit: a half-warp
constexpr int THREADS = SLICES * U;
constexpr int GROUP = 8;           // rows a butterfly reduces
constexpr int MAX_ROWS = 64;       // rows a cluster at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// The barriers' initialisation visible to the cluster's bulk copies.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` from bulk copies in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Shared-memory writes of this thread ordered before later bulk copies.
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` at `src` into the same offset of CTA `rank`'s shared memory,
// completing `bytes` on that CTA's barrier at the offset of `bar`.
__device__ __forceinline__ void push_block(const float* src, unsigned bytes,
                                           uint64_t* bar, int rank) {
  asm volatile("{\n .reg .b32 d, m;\n"
               " mapa.shared::cluster.u32 d, %0, %2;\n"
               " mapa.shared::cluster.u32 m, %1, %2;\n"
               " cp.async.bulk.shared::cluster.shared::cta.mbarrier::"
               "complete_tx::bytes [d], [%0], %3, [m];\n}\n"
               :: "r"(smem_addr(src)), "r"(smem_addr(bar)), "r"(rank),
                  "r"(bytes) : "memory");
}

// Keep half of v (rows lo or hi by this lane's bit) and add the other half
// from the lane at distance d, which kept the opposite half.
template <int N>
__device__ __forceinline__ void halve(const float (&v)[3][2 * N],
                                      float (&out)[3][N], bool hi, int d) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float keep = hi ? v[g][N + i] : v[g][i];
      const float send = hi ? v[g][i] : v[g][N + i];
      out[g][i] = keep + __shfl_xor_sync(FULL, send, d);
    }
}

// Floats of one CTA's block of h (rows x U, then 64 bytes of padding, so
// that the blocks a half-warp reads at once fall in both halves of the
// banks).
__host__ __device__ constexpr int block_stride(int rows) {
  return rows * U + 16;
}

// h[2][CLUSTER][block_stride], G[2][rows][3][U], then two barriers.
__host__ __device__ constexpr size_t smem_bytes(int rows) {
  return sizeof(float) * (2 * CLUSTER * block_stride(rows) + 6 * rows * U)
         + 2 * sizeof(uint64_t);
}

// `rows`: batch rows a cluster, a multiple of GROUP.
__global__ void __launch_bounds__(THREADS, 1)
encoder_gru_kernel(EncoderGruArgs a, int rows) {
  constexpr int C = CLUSTER;
  constexpr int QUADS = 3 * U / 4;   // float4s of G a row and step
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / C;
  const int dir = cl & 1;
  const int T = a.T, B = a.B;
  const int b0 = (cl >> 1) * rows;
  const int live = min(rows, B - b0);
  const int bs = block_stride(rows);
  float* hbuf = reinterpret_cast<float*>(smem4);       // [2][C][bs]
  float* gbuf = hbuf + 2 * C * bs;                     // [2][rows][3][U]
  uint64_t* bars = reinterpret_cast<uint64_t*>(gbuf + 6 * rows * U);
  const unsigned block_bytes = sizeof(float) * rows * U;

  const int tid = threadIdx.x;
  const int s = tid % SLICES;
  const int ul = tid / SLICES;
  const int j = rank * U + ul;
  const float* __restrict__ g_in = dir ? a.g_b : a.g_f;
  const float* __restrict__ w_hh = dir ? a.w_hh_b : a.w_hh_f;
  const float* __restrict__ b_hh = dir ? a.b_hh_b : a.b_hh_f;

  // This thread's 48 weights, gate g at k = 64 q + 4 s + e, and where each
  // k's float4 of h lies in a buffer (row 0).
  float4 w[3][4];
  int hk[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = 64 * q + 4 * s;
    hk[q] = (k / U) * bs + k % U;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float* row = w_hh + static_cast<size_t>(g * HID + j) * HID + k;
      w[g][q] = make_float4(row[0], row[1], row[2], row[3]);
    }
  }
  float bhh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bhh[g] = b_hh[g * HID + j];

  // Both h buffers and both G buffers zero: h_{-1} = 0, and the rows past
  // B keep a G of 0 (they compute finite values that are never written).
  for (int i = tid; i < 2 * C * bs + 6 * rows * U; i += THREADS)
    hbuf[i] = 0.0f;
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_init_fence();
    // Step 0's pushes land in buffer 1.
    if (T > 1) mbar_expect(bars + 1, (C - 1) * block_bytes);
  }
  __syncthreads();

  // G of step t (this CTA's units, every live row) into buffer `buf`.
  auto load_g = [&](int buf, int t) {
    float* dst = gbuf + buf * rows * 3 * U;
    for (int i = tid; i < live * QUADS; i += THREADS) {
      const int r = i / QUADS, k = i % QUADS;
      const int g = k / (U / 4), c4 = k % (U / 4);
      const float* src = g_in + (static_cast<size_t>(b0 + r) * T + t) * 3 * HID
                         + g * HID + rank * U + 4 * c4;
      copy16(dst + (r * 3 + g) * U + 4 * c4, src);
    }
    copies_commit();
  };

  load_g(0, dir ? T - 1 : 0);
  copies_wait();
  // Every CTA of the cluster has started, zeroed its buffers and set up its
  // barriers before any pushes into them; G of the first step is visible
  // to the whole CTA.
  cluster_arrive();
  cluster_wait();

  // This lane pair's row within a group of 8; the lane of the pair that
  // writes.
  const int row8 = s >> 1;
  const bool writer = !(s & 1);
  const size_t out_stride = static_cast<size_t>(T) * 2 * HID;
  unsigned phases = 0;     // bit b: the parity of barrier b's next phase

  for (int i = 0; i < T; ++i) {
    const int t = dir ? T - 1 - i : i;
    const int cur = i & 1, nxt = cur ^ 1;
    const bool last = i + 1 == T;
    // h_{i-1} complete; then buffer `cur` expects step i+1's pushes.
    if (i > 0) {
      mbar_wait(bars + cur, (phases >> cur) & 1);
      phases ^= 1u << cur;
    }
    if (tid == 0 && i + 2 < T) mbar_expect(bars + cur, (C - 1) * block_bytes);
    if (!last) load_g(nxt, dir ? t - 1 : t + 1);
    const float* hc = hbuf + cur * C * bs;
    const float* gc = gbuf + cur * rows * 3 * U;
    float* own = hbuf + (nxt * C + rank) * bs;     // this CTA's next block

    for (int r0 = 0; r0 < rows; r0 += GROUP) {
      // The partial sums of this slice: 3 gates x 8 rows.
      float acc[3][GROUP];
#pragma unroll
      for (int b = 0; b < GROUP; ++b) {
        const float* hrow = hc + (r0 + b) * U;
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 hv = *reinterpret_cast<const float4*>(hrow + hk[q]);
          p0 = fmaf(w[0][q].x, hv.x, p0);
          p0 = fmaf(w[0][q].y, hv.y, p0);
          p0 = fmaf(w[0][q].z, hv.z, p0);
          p0 = fmaf(w[0][q].w, hv.w, p0);
          p1 = fmaf(w[1][q].x, hv.x, p1);
          p1 = fmaf(w[1][q].y, hv.y, p1);
          p1 = fmaf(w[1][q].z, hv.z, p1);
          p1 = fmaf(w[1][q].w, hv.w, p1);
          p2 = fmaf(w[2][q].x, hv.x, p2);
          p2 = fmaf(w[2][q].y, hv.y, p2);
          p2 = fmaf(w[2][q].z, hv.z, p2);
          p2 = fmaf(w[2][q].w, hv.w, p2);
        }
        acc[0][b] = p0;
        acc[1][b] = p1;
        acc[2][b] = p2;
      }
      // The transposed butterfly over the half-warp's 16 slices.
      float v4[3][4], v2[3][2], v1[3][1];
      halve<4>(acc, v4, (s >> 3) & 1, 8);
      halve<2>(v4, v2, (s >> 2) & 1, 4);
      halve<1>(v2, v1, (s >> 1) & 1, 2);
      float hp[3];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        hp[g] = v1[g][0] + __shfl_xor_sync(FULL, v1[g][0], 1) + bhh[g];

      const int r = r0 + row8;
      const float* gr = gc + r * 3 * U + ul;
      const float hprev = hc[rank * bs + r * U + ul];
      const float rg = sigmoidf(gr[0] + hp[0]);
      const float zg = sigmoidf(gr[U] + hp[1]);
      const float ng = tanhf(gr[2 * U] + rg * hp[2]);
      const float h = (1.0f - zg) * ng + zg * hprev;

      if (writer) {
        if (!last) own[r * U + ul] = h;
        if (r < live) {
          const int b = b0 + r;
          a.out[b * out_stride + static_cast<size_t>(t) * 2 * HID
                + dir * HID + j] = h;
          if (last) a.h_n[(static_cast<size_t>(dir) * B + b) * HID + j] = h;
        }
      }
    }
    if (last) break;
    copies_wait();
    async_fence();
    __syncthreads();
    // One thread a receiver: this CTA's block into its buffer `nxt`.
    if (tid < C - 1) {
      const int to = (rank + 1 + tid) % C;
      push_block(own, block_bytes, bars + nxt, to);
    }
  }
  // No CTA leaves while a bulk copy may still read its shared memory.
  if (T > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// Per device: clusters that can be resident at once, by rows a cluster
// (-1 until asked), and whether the kernel's attributes are set.
constexpr int MAX_DEVICES = 16;
int g_resident[MAX_DEVICES][MAX_ROWS / GROUP + 1];
bool g_ready[MAX_DEVICES];

cudaLaunchConfig_t config(int clusters, int rows, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(rows);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t prepare(int dev) {
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g_ready[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_gru_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (!err)
    err = cudaFuncSetAttribute(encoder_gru_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(MAX_ROWS)));
  if (err) return err;
  for (int k = 0; k <= MAX_ROWS / GROUP; ++k) g_resident[dev][k] = -1;
  g_ready[dev] = true;
  return cudaSuccess;
}

// Clusters with `rows` rows each that the card holds at once.
cudaError_t resident(int dev, int rows, int* n) {
  int& cached = g_resident[dev][rows / GROUP];
  if (cached < 0) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(1, rows, nullptr, attr);
    int found = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveClusters(&found, encoder_gru_kernel, &cfg);
    if (err) return err;
    cached = found;
  }
  *n = cached;
  return cudaSuccess;
}

// The launch's shape for B rows: out = {rows a cluster, clusters, clusters
// resident at once}. Rows is the least multiple of 8 at which every cluster
// is resident, else the most (MAX_ROWS, or B rounded up to 8: the clusters
// then run in waves).
cudaError_t plan(int B, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = prepare(dev);
  if (err) return err;
  const int need = (B + GROUP - 1) / GROUP * GROUP;
  int rows = need < MAX_ROWS ? need : MAX_ROWS;
  int n = 0;
  for (int r = GROUP; r < rows; r += GROUP) {
    err = resident(dev, r, &n);
    if (err) return err;
    if (2 * ((B + r - 1) / r) <= n) {
      rows = r;
      break;
    }
  }
  err = resident(dev, rows, &n);
  if (err) return err;
  out[0] = rows;
  out[1] = 2 * ((B + rows - 1) / rows);
  out[2] = n;
  return cudaSuccess;
}

}  // namespace

using Args = EncoderGruArgs;

extern "C" {

// The hidden size the kernel takes, its CTAs a cluster and its rows a
// cluster at most.
int encoder_gru_dims(int* out) {
  out[0] = HID;
  out[1] = CLUSTER;
  out[2] = MAX_ROWS;
  return 3;
}

// The shape of a launch for B rows (see plan); returns a CUDA error code.
int encoder_gru_plan(int B, int* out) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(plan(B, out));
}

// One layer: both directions' recurrence over every row.
int encoder_gru_launch(const Args* a, void* stream) {
  if (a->B < 1 || a->T < 1 || a->H != HID)
    return static_cast<int>(cudaErrorInvalidValue);
  int shape[3];
  cudaError_t err = plan(a->B, shape);
  if (err) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(shape[1], shape[0],
                                  static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, encoder_gru_kernel, *a, shape[0]);
  if (err) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

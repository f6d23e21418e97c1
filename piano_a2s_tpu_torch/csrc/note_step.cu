// K2: one greedy step of both note decoders (upper and lower staff), with
// the masked updates of the decode's state.
//
// Replaces no Pallas kernel: the JAX package runs this step inside the XLA
// while_loop of its greedy note decode (piano_a2s_tpu/models/
// score_transcription.py:561), and the port ran it as about 47 torch ops
// (models/score_transcription.py::_fast_step under _masked_step). For staff
// s and row b, where the (staff, stop group) pair is active:
//
//   hq   = h @ [W_hh | W_q]                     (the step before computed it)
//   e_t  = v . tanh(enc_proj2[s, b, t] + hq[3D:])         for every frame t
//   ctx  = softmax_t(e) . enc[b]
//   x    = tok2 + ctx @ W_ih_ctx + b_ih
//   h'   = GRU gates(x, hq[:3D] + b_hh, h)
//   logp = log_softmax([h', ctx] @ W_out + b_out),   pred = argmax(logp)
//   tok2 = emb_proj[pred];  lengths = t + 1 and done where pred is <eos>
//
// and the next step's hq = h' @ [W_hh | W_q]. An inactive pair (its group
// has stopped, or t has reached its staff's cap) reads none of its
// enc_proj2 rows and none of its weights: its h, tok2 and length stay, its
// log-probs and token are 0.
//
// Bound: the step is bandwidth-bound at about 2 operations a byte. At 16
// rows with both staves active it must read enc (16 x 1201 x 512 floats,
// 39.3 MB), each staff's enc_proj2 rows (19.7 MB each) and each staff's
// weights (7.6 MB each): 94 MB, 28 us at 3.35 TB/s. The weights fit the
// 50 MB L2 from one step to the next; enc and enc_proj2 do not.
//
// Design, four launches a step (a CUDA graph replays them):
//  1. attn_kernel, one block per (frame chunk, row) covering both staves,
//     so that enc is read once for both: each warp walks its frames with
//     an online softmax (running max, sum and a 512-wide context in
//     registers); the block merges its warps, writes its partial, and the
//     row's last block (an atomic count) merges the chunks in chunk order
//     into ctx. No energy or score tensor is written. Each warp keeps the
//     next frame's loads in flight while it computes the current one; enc
//     and enc_proj2 are read with evict-first loads (ld.global.cs) so that
//     they do not push the weights out of L2. The number of chunks comes
//     from the shape (ops/note_step.py::pick_chunks): one wave of two
//     blocks an SM over the 132 SMs at every batch.
//  2. gru_kernel: x = tok2 + ctx @ W_ih_ctx + b_ih and the gates, blocks
//     over (8 hidden units, staff, 16-row tile); writes h' where active.
//  3. proj_kernel: the head's two halves ([h'] and [ctx] rows of W_out) and
//     the next step's h' @ [W_hh | W_q], blocks of 32 columns.
//  4. final_kernel, per (row, staff): the head's sum, log_softmax, argmax
//     (first index on ties, as torch.argmax), the masked updates and tok2.
// The products keep the rows of a 16-row tile in shared memory, k-major,
// and split k over 32 slices of a block; each thread loads its 16 weight
// float4s before the tile, and the slices are summed in a fixed order.
// Nothing uses float atomics, so a step is deterministic.
//
// The step boundary is a programmatic dependent launch (PDL): attn_kernel
// is launched with cudaLaunchAttributeProgrammaticStreamSerialization, and
// final_kernel lets it start once its head loads are done (after its first
// block reduction, griddepcontrol.launch_dependents), so that attn's
// launch, block ramp and first loads overlap the rest of final and, in a
// graph, the edge between steps. Before its wait (griddepcontrol.wait,
// which returns once final has completed and its writes are visible) attn
// writes no global memory and reads only v and enc_proj2, which no K2
// kernel writes, and t, which gru_kernel wrote three launches back
// (complete before proj started): t under a staff's cap says which staves'
// first enc_proj2 row to load; a staff found active after the wait that t
// ruled out (a caller wrote t in the launch right before the step) loads it
// then. enc's first row (whose loads before the wait slowed final), the
// query (proj's hq) and the stop flags (final's done) are read after the
// wait. So the launch right before a step must not write v or enc_proj2: a
// decode writes them when it binds its operands, several launches ahead.
// gru, proj and final keep plain launches: their blocks cannot be resident
// beside the kernel before them (two attn blocks fill an SM's registers; a
// gru and a proj block do not fit together; released gru blocks double up
// two an SM), and a dependent's wait is released later than a plain launch
// starts (PERF.md, K2's programmatic dependent launch).
//
// Measured (H100 SXM, 700 W; PERF.md): at 16 rows 53.8-54.8 us a step with
// both staves and 41.0-41.7 us with the upper one only, 161-163 us at 64
// rows (56.5-57.0, 42.7-42.9 and 166 us without PDL), against 248 us for
// the torch-op step; the attention pass is about 32 us of it (2.3 TB/s),
// and gru, proj and final 7, 10 and 4 us, mostly fixed latency.
//
// Numerics: float32 throughout, FFMA products, tanhf / expf / logf of the
// CUDA math library (no fast-math, no .approx intrinsics), float32
// softmax sums. Sums run in another order than cuBLAS's and torch's
// reductions, so results differ from the torch-op step by float32
// rounding (about 1e-6 relative in the log-probs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Everything one step reads and writes. Weights are stacked on a leading
// axis of 2 (upper, lower staff), right-multiply layouts; all float32
// unless noted, contiguous.
struct NoteStepArgs {
  const float* w_hq;       // (2, D, NQ)
  const float* b_hh;       // (2, G)
  const float* b_ih;       // (2, G)
  const float* emb_proj;   // (2, V, G)
  const float* w_ih_ctx;   // (2, D, G)
  const float* v;          // (2, H)
  const float* w_out;      // (2, 2D, VP): W_out zero-padded to VP columns
  const float* b_out;      // (2, V)
  const float* enc;        // (B, T, D)
  const float* enc_proj2;  // (2, B, T, H)
  float* h2;               // (2, B, D)        state, updated in place
  float* tok2;             // (2, B, G)        state
  int64_t* lengths;        // (2, B)           state
  uint8_t* done;           // (2, B) bool      state
  int64_t* t;              // ()               steps run; + 1 a step
  const int64_t* caps;     // (2,)
  const uint8_t* live;     // (2, groups) bool, or null: from done
  float* logp;             // (2, B, V)        out
  int64_t* pred;           // (2, B)           out
  float* hq;               // (2, B, NQ)       scratch from here on
  float* ctx;              // (2, B, D)
  float* part_m;           // (2, B, chunks)
  float* part_l;           // (2, B, chunks)
  float* part_ctx;         // (2, B, chunks, D)
  int* counters;           // (B,) zero between steps
  float* headp;            // (2 halves, 2, B, VP)
  uint8_t* mask;           // (2, B) bool: the step's active pairs
  int B, T, V, VP, groups, chunks, chunk_frames, eos;
};

namespace {

constexpr int D = 512;                 // decoder hidden = encoder width
constexpr int H = 256;                 // attention width
constexpr int G = 3 * D;               // GRU gate columns
constexpr int NQ = G + H;              // [W_hh | W_q] columns
constexpr int RT = 16;                 // rows of a product tile
constexpr int RP = RT + 4;             // row stride of a tile's inputs in smem
constexpr int KSL = 32;                // k slices of a product block
constexpr int KN = D / KSL;            // k's a product thread takes
constexpr int WARPS = 8;               // warps of an attention block
constexpr int ATTN_THREADS = 32 * WARPS;
constexpr int HL = H / 128;            // float4s of q, v, enc_proj2 a lane holds
constexpr int DL = D / 128;            // float4s of enc a lane holds
constexpr int DT = D / ATTN_THREADS;   // context entries an attention thread merges
constexpr int MAX_CHUNKS = 256;
constexpr int GRU_UNITS = 8;           // hidden units of a gru block
constexpr int GRU_CG = 3 * GRU_UNITS / 4;  // its float4 column groups
constexpr int GRU_THREADS = KSL * GRU_CG;
constexpr int PROJ_CG = 8;             // float4 column groups of a proj block
constexpr int PROJ_COLS = 4 * PROJ_CG;
constexpr int PROJ_THREADS = KSL * PROJ_CG;
constexpr int QT = NQ / PROJ_COLS;     // proj blocks of [W_hh | W_q] a staff
constexpr int FINAL_THREADS = 128;
constexpr int VL = 2;                  // logits a final thread holds: V <= 256

static_assert(H % 128 == 0 && D % 128 == 0 && D % ATTN_THREADS == 0, "");
static_assert(D % KSL == 0 && KN % 8 == 0 && NQ % PROJ_COLS == 0, "");
static_assert(D % GRU_UNITS == 0 && GRU_UNITS % 4 == 0, "");
static_assert(GRU_UNITS * RT <= GRU_THREADS, "");

// The k slices' partial sums: slice ks, row r, column c at
// ks * red_stride(cols) + r * cols + c; the pad spreads the slices over the
// banks.
__host__ __device__ constexpr int red_stride(int cols) { return RT * cols + 8; }
constexpr int XS_FLOATS = D * RP;
constexpr int GRU_RED = KSL * red_stride(4 * GRU_CG);
constexpr int PROJ_RED = KSL * red_stride(PROJ_COLS);
constexpr int GRU_SMEM = 4 * (XS_FLOATS > GRU_RED ? XS_FLOATS : GRU_RED);
constexpr int PROJ_SMEM = 4 * (XS_FLOATS > PROJ_RED ? XS_FLOATS : PROJ_RED);
constexpr int ATTN_SMEM = 4 * (WARPS * 2 * D + WARPS * 2 * 2);

using Args = NoteStepArgs;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Programmatic dependent launch (attn_kernel, see the design note): wait
// until the kernel before has completed and its writes are visible (a no-op
// in a kernel launched without the attribute); let the kernel after this
// one start before this one ends. "memory": no load or store moves across.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void release_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Whether the pair (s, b) steps: t is under the staff's cap and its stop
// group is live (from `live` where given, else some row of the group has
// not emitted <eos>).
__device__ bool pair_active(const Args& a, int s, int b) {
  if (*a.t >= a.caps[s]) return false;
  const int rows = a.B / a.groups, g = b / rows;
  if (a.live) return a.live[s * a.groups + g] != 0;
  const uint8_t* d = a.done + s * a.B + g * rows;
  int all_done = 1;  // no early exit: the loads go out together
#pragma unroll 16
  for (int r = 0; r < rows; ++r) all_done &= d[r];
  return !all_done;
}

// ---------------------------------------------------------------------------
// 1. Attention: one pass over enc and enc_proj2.
// ---------------------------------------------------------------------------

// q and v of a staff in shared memory (H / 4 float4s each); the lane's
// float4s of the frame's enc_proj2 row in p.
__device__ __forceinline__ float frame_score(const float4 (&p)[HL],
                                             const float4* q,
                                             const float4* v, int lane) {
  float e = 0.f;
#pragma unroll
  for (int i = 0; i < HL; ++i) {
    const float4 qi = q[lane + 32 * i], vi = v[lane + 32 * i];
    e = fmaf(vi.x, tanhf(p[i].x + qi.x), e);
    e = fmaf(vi.y, tanhf(p[i].y + qi.y), e);
    e = fmaf(vi.z, tanhf(p[i].z + qi.z), e);
    e = fmaf(vi.w, tanhf(p[i].w + qi.w), e);
  }
  return warp_sum(e);  // the same bits in every lane
}

__device__ __forceinline__ void online(float& m, float& l, float4 (&acc)[DL],
                                       float e, const float4 (&x)[DL]) {
  if (e > m) {
    const float r = expf(m - e);  // 0 at the first frame (m = -inf)
    l = fmaf(l, r, 1.f);
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      acc[i].x = fmaf(acc[i].x, r, x[i].x);
      acc[i].y = fmaf(acc[i].y, r, x[i].y);
      acc[i].z = fmaf(acc[i].z, r, x[i].z);
      acc[i].w = fmaf(acc[i].w, r, x[i].w);
    }
    m = e;
  } else {
    const float p = expf(e - m);
    l += p;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      acc[i].x = fmaf(x[i].x, p, acc[i].x);
      acc[i].y = fmaf(x[i].y, p, acc[i].y);
      acc[i].z = fmaf(x[i].z, p, acc[i].z);
      acc[i].w = fmaf(x[i].w, p, acc[i].w);
    }
  }
}

__global__ void __launch_bounds__(ATTN_THREADS, 2) attn_kernel(const Args a) {
  extern __shared__ float4 attn_smem[];
  float* wctx = reinterpret_cast<float*>(attn_smem);  // [WARPS][2][D]
  float* wm = wctx + WARPS * 2 * D;                   // [WARPS][2]
  float* wl = wm + WARPS * 2;                         // [WARPS][2]
  __shared__ int act[2];
  __shared__ int last;
  __shared__ float chunk_m[2][MAX_CHUNKS], chunk_l[2][MAX_CHUNKS];
  __shared__ float scale[2][MAX_CHUNKS], total[2];
  __shared__ float4 qv[2][2][H / 4];  // per staff: q, v
  __shared__ int may[2];  // per staff: t under its cap, before the wait

  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float4* enc = reinterpret_cast<const float4*>(a.enc) +
                      (size_t)b * a.T * (D / 4);
  const float4* ep0 = reinterpret_cast<const float4*>(a.enc_proj2) +
                      (size_t)b * a.T * (H / 4);
  const float4* ep1 = ep0 + (size_t)a.B * a.T * (H / 4);
  const int t0 = c * a.chunk_frames;
  const int t1 = min(a.T, t0 + a.chunk_frames);
  // Each warp walks its frames with the next frame's loads in flight while
  // it computes the current one: its enc row, and a staff's enc_proj2 row
  // where on0 / on1 say.
  float4 x[DL], p0[HL], p1[HL];
  auto load_enc = [&](int t, float4 (&xx)[DL]) {
#pragma unroll
    for (int i = 0; i < DL; ++i)
      xx[i] = __ldcs(enc + (size_t)t * (D / 4) + lane + 32 * i);
  };
  auto load_proj = [&](int t, float4 (&q0)[HL], float4 (&q1)[HL], bool on0,
                       bool on1) {
#pragma unroll
    for (int i = 0; i < HL; ++i) {
      if (on0) q0[i] = __ldcs(ep0 + (size_t)t * (H / 4) + lane + 32 * i);
      if (on1) q1[i] = __ldcs(ep1 + (size_t)t * (H / 4) + lane + 32 * i);
    }
  };

  // Before the wait for final_kernel: which staves may step (t under the
  // cap; t is gru_kernel's, complete since proj_kernel started), v, and
  // the warp's first enc_proj2 row of those staves.
  if (tid == 0) {
    const int64_t t = *a.t;
    may[0] = t < a.caps[0];
    may[1] = t < a.caps[1];
  }
  for (int i = tid; i < 2 * H / 4; i += ATTN_THREADS) {
    const int st = i / (H / 4), f = i % (H / 4);
    qv[st][1][f] = reinterpret_cast<const float4*>(a.v + st * H)[f];
  }
  __syncthreads();
  const bool pre[2] = {may[0] != 0, may[1] != 0};
  const bool first = t0 + warp < t1;  // the warp has a frame
  if (first) load_proj(t0 + warp, p0, p1, pre[0], pre[1]);
  wait_for_prior_grid();
  // After it (its loads would slow final_kernel beside), the warp's first
  // enc row; the query of the staves that may step, beside the stop flags'
  // reads.
  if (first && (pre[0] || pre[1])) load_enc(t0 + warp, x);
  if (tid == 0) {
    act[0] = pair_active(a, 0, b);
    act[1] = pair_active(a, 1, b);
    if (c == 0) {
      a.mask[b] = act[0];
      a.mask[a.B + b] = act[1];
    }
  }
  auto load_q = [&](bool on0, bool on1) {
    for (int i = tid; i < 2 * H / 4; i += ATTN_THREADS) {
      const int st = i / (H / 4), f = i % (H / 4);
      if (st ? on1 : on0)
        qv[st][0][f] = reinterpret_cast<const float4*>(
            a.hq + (size_t)(st * a.B + b) * NQ + G)[f];
    }
  };
  load_q(pre[0], pre[1]);
  __syncthreads();
  const bool on[2] = {act[0] != 0, act[1] != 0};
  if (!on[0] && !on[1]) return;  // every block of the row returns here
  // A staff that steps though t said otherwise (a caller wrote t in the
  // launch right before the step): its query and first frame now.
  const bool late[2] = {on[0] && !pre[0], on[1] && !pre[1]};
  if (late[0] || late[1]) {  // the same in every thread of the block
    load_q(late[0], late[1]);
    if (first && !pre[0] && !pre[1]) load_enc(t0 + warp, x);
    if (first) load_proj(t0 + warp, p0, p1, late[0], late[1]);
    __syncthreads();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float4 acc[2][DL];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[s][i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = t0 + warp; t < t1; t += WARPS) {
    float4 nx[DL], n0[HL], n1[HL];
    if (t + WARPS < t1) {
      load_enc(t + WARPS, nx);
      load_proj(t + WARPS, n0, n1, on[0], on[1]);
    }
    if (on[0])
      online(m[0], l[0], acc[0], frame_score(p0, qv[0][0], qv[0][1], lane), x);
    if (on[1])
      online(m[1], l[1], acc[1], frame_score(p1, qv[1][0], qv[1][1], lane), x);
#pragma unroll
    for (int i = 0; i < DL; ++i) x[i] = nx[i];
#pragma unroll
    for (int i = 0; i < HL; ++i) {
      p0[i] = n0[i];
      p1[i] = n1[i];
    }
  }

  // Merge the warps (a warp without frames holds m = -inf, l = 0).
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!on[s]) continue;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      reinterpret_cast<float4*>(wctx + (warp * 2 + s) * D)[lane + 32 * i] =
          acc[s][i];
    if (lane == 0) {
      wm[warp * 2 + s] = m[s];
      wl[warp * 2 + s] = l[s];
    }
  }
  __syncthreads();
  const size_t pc = (size_t)a.chunks;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!on[s]) continue;
    float mm = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, wm[w * 2 + s]);
    float ll = 0.f, cd[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) cd[j] = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float mw = wm[w * 2 + s];
      const float r = mw == -INFINITY ? 0.f : expf(mw - mm);
      ll = fmaf(wl[w * 2 + s], r, ll);
#pragma unroll
      for (int j = 0; j < DT; ++j)
        cd[j] = fmaf(wctx[(w * 2 + s) * D + tid + j * ATTN_THREADS], r, cd[j]);
    }
    const size_t row = (size_t)(s * a.B + b);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      a.part_ctx[(row * pc + c) * D + tid + j * ATTN_THREADS] = cd[j];
    if (tid == 0) {
      a.part_m[row * pc + c] = mm;
      a.part_l[row * pc + c] = ll;
    }
  }

  // The row's last block merges the chunks, in chunk order.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + b, 1) == a.chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < 2 * a.chunks; i += ATTN_THREADS) {
    const int st = i / a.chunks, k = i % a.chunks;
    if (on[st]) {
      const size_t row = (size_t)(st * a.B + b);
      chunk_m[st][k] = __ldcg(a.part_m + row * pc + k);
      chunk_l[st][k] = __ldcg(a.part_l + row * pc + k);
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * a.chunks; i += ATTN_THREADS) {
    const int st = i / a.chunks, k = i % a.chunks;
    if (on[st]) {
      float mm = -INFINITY;
      for (int kk = 0; kk < a.chunks; ++kk) mm = fmaxf(mm, chunk_m[st][kk]);
      scale[st][k] = expf(chunk_m[st][k] - mm);
    }
  }
  __syncthreads();
  if (tid < 2 && on[tid]) {
    float ll = 0.f;
    for (int k = 0; k < a.chunks; ++k)
      ll = fmaf(chunk_l[tid][k], scale[tid][k], ll);
    total[tid] = ll;
  }
  __syncthreads();
  // Thread: staff tid / (D / 4), float4 column tid % (D / 4).
  static_assert(2 * D / 4 == ATTN_THREADS, "one float4 of ctx a thread");
  {
    const int st = tid / (D / 4), f = tid % (D / 4);
    if (on[st]) {
      const size_t row = (size_t)(st * a.B + b);
      const float4* src = reinterpret_cast<const float4*>(a.part_ctx) +
                          row * pc * (D / 4) + f;
      float4 cd = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int k = 0; k < a.chunks; ++k) {
        const float4 p = __ldcg(src + (size_t)k * (D / 4));
        const float sk = scale[st][k];
        cd.x = fmaf(p.x, sk, cd.x);
        cd.y = fmaf(p.y, sk, cd.y);
        cd.z = fmaf(p.z, sk, cd.z);
        cd.w = fmaf(p.w, sk, cd.w);
      }
      const float tt = total[st];
      reinterpret_cast<float4*>(a.ctx + row * D)[f] =
          make_float4(cd.x / tt, cd.y / tt, cd.z / tt, cd.w / tt);
    }
  }
  if (tid == 0) a.counters[b] = 0;
}

// ---------------------------------------------------------------------------
// Products of a 16-row tile with a weight matrix of D rows.
// ---------------------------------------------------------------------------

// xs[k * RP + r] = src[(row0 + r) * D + k] for the tile's rows, 0 past them:
// every float4 load of the tile issued before the first store; a warp's
// threads take 16 rows of two float4 columns, so their stores hit 32 banks.
template <int THREADS>
__device__ __forceinline__ void load_tile(float* xs,
                                          const float* __restrict__ src,
                                          int row0, int rows) {
  constexpr int N4 = RT * D / 4, PER = (N4 + THREADS - 1) / THREADS;
  float4 buf[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS, r = i % RT;
    buf[j] = i < N4 && r < rows
                 ? __ldg(reinterpret_cast<const float4*>(
                       src + (size_t)(row0 + r) * D) + i / RT)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < N4) {
      float* x = xs + 4 * (i / RT) * RP + i % RT;
      x[0] = buf[j].x;
      x[RP] = buf[j].y;
      x[2 * RP] = buf[j].z;
      x[3 * RP] = buf[j].w;
    }
  }
}

// The thread's weight float4s: wv[i] = w[(ks + KSL i) * ldw + n .. n + 3].
// Issued before the tile's loads, so that both round trips overlap.
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             int ldw, int n, int ks,
                                             float4 (&wv)[KN]) {
#pragma unroll
  for (int i = 0; i < KN; ++i)
    wv[i] = __ldg(reinterpret_cast<const float4*>(
        w + (size_t)(ks + KSL * i) * ldw + n));
}

// acc[r][c] = sum over the thread's k's (ks, ks + KSL, ...) of
// xs[k][r] * wv[k's index].c.
__device__ __forceinline__ void product(const float* xs, int ks,
                                        const float4 (&wv)[KN],
                                        float (&acc)[RT][4]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll
  for (int i = 0; i < KN; ++i) {
    const float4* x4 =
        reinterpret_cast<const float4*>(xs + (ks + KSL * i) * RP);
#pragma unroll
    for (int r4 = 0; r4 < RT / 4; ++r4) {
      const float4 x = x4[r4];
      const float xr[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* o = acc[4 * r4 + u];
        o[0] = fmaf(xr[u], wv[i].x, o[0]);
        o[1] = fmaf(xr[u], wv[i].y, o[1]);
        o[2] = fmaf(xr[u], wv[i].z, o[2]);
        o[3] = fmaf(xr[u], wv[i].w, o[3]);
      }
    }
  }
}

// The thread's partial sums into red (see red_stride), as float4s; call
// after a __syncthreads() that ends every read of xs (red overlays it).
template <int COLS>
__device__ __forceinline__ void stash(float* red, int ks, int cg,
                                      const float (&acc)[RT][4]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
    *reinterpret_cast<float4*>(red + ks * red_stride(COLS) + r * COLS +
                               4 * cg) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// Row r, column col summed over the k slices, in slice order.
template <int COLS>
__device__ __forceinline__ float slices(const float* red, int col, int r) {
  float y = 0.f;
#pragma unroll 8
  for (int ks = 0; ks < KSL; ++ks) y += red[ks * red_stride(COLS) + r * COLS + col];
  return y;
}

__device__ __forceinline__ bool any_active(const Args& a, int s, int row0,
                                           int rows) {
  int any = 0;  // no early exit: the loads go out together
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (r < rows) any |= a.mask[s * a.B + row0 + r];
  return any != 0;
}

// ---------------------------------------------------------------------------
// 2. GRU: x = tok2 + ctx @ W_ih_ctx + b_ih, the gates, h' where active.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(GRU_THREADS) gru_kernel(const Args a) {
  extern __shared__ float4 gru_smem[];
  float* xs = reinterpret_cast<float*>(gru_smem);
  const int j0 = blockIdx.x * GRU_UNITS, s = blockIdx.y, row0 = blockIdx.z * RT;
  const int rows = min(RT, a.B - row0), tid = threadIdx.x;
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    *a.t += 1;
  if (!any_active(a, s, row0, rows)) return;

  const int ks = tid / GRU_CG, cg = tid % GRU_CG;
  const int gate = cg / (GRU_UNITS / 4), u4 = cg % (GRU_UNITS / 4);
  float4 wv[KN];
  load_weights(a.w_ih_ctx + (size_t)s * D * G, G, gate * D + j0 + 4 * u4, ks,
               wv);
  // The gate thread's (unit, row) inputs, loaded early too.
  const int u = tid % GRU_UNITS, r = tid / GRU_UNITS, b = row0 + r, j = j0 + u;
  const size_t row = (size_t)(s * a.B + b);
  const bool gates = tid < GRU_UNITS * RT && r < rows && a.mask[row];
  float xin[3], bin[3], hin[3], h = 0.f;
  if (gates) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int n = g * D + j;
      xin[g] = a.tok2[row * G + n];
      bin[g] = a.b_ih[(size_t)s * G + n];
      hin[g] = a.hq[row * NQ + n] + a.b_hh[(size_t)s * G + n];
    }
    h = a.h2[row * D + j];
  }
  load_tile<GRU_THREADS>(xs, a.ctx + (size_t)s * a.B * D, row0, rows);
  __syncthreads();
  float acc[RT][4];
  product(xs, ks, wv, acc);
  __syncthreads();
  stash<4 * GRU_CG>(xs, ks, cg, acc);
  __syncthreads();

  if (gates) {
    float xg[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      xg[g] = (xin[g] + slices<4 * GRU_CG>(xs, g * GRU_UNITS + u, r)) +
              bin[g];
    const float rg = sigmoid(xg[0] + hin[0]);
    const float z = sigmoid(xg[1] + hin[1]);
    const float nn = tanhf(xg[2] + rg * hin[2]);
    a.h2[row * D + j] = (1.f - z) * nn + z * h;
  }
}

// ---------------------------------------------------------------------------
// 3. The head's two halves and the next step's h' @ [W_hh | W_q].
// ---------------------------------------------------------------------------

// Blocks [0, 2 QT) compute hq = h2 @ w_hq, 32 columns each; with the head,
// blocks from 2 QT on compute headp[half] = (half ? ctx : h2) @ W_out's
// rows of that half, 32 columns each. With the head (a step), a staff
// without an active row in the tile computes nothing.
__global__ void __launch_bounds__(PROJ_THREADS) proj_kernel(const Args a,
                                                            int with_head) {
  extern __shared__ float4 proj_smem[];
  float* xs = reinterpret_cast<float*>(proj_smem);
  const int row0 = blockIdx.y * RT, rows = min(RT, a.B - row0);
  const int tid = threadIdx.x;
  int i = blockIdx.x, s, n0, ldw;
  const float* x;
  const float* w;
  float* out;
  if (i < 2 * QT) {
    s = i / QT;
    n0 = (i % QT) * PROJ_COLS;
    x = a.h2 + (size_t)s * a.B * D;
    w = a.w_hq + (size_t)s * D * NQ;
    out = a.hq + (size_t)s * a.B * NQ;
    ldw = NQ;
  } else {
    i -= 2 * QT;
    const int tiles = a.VP / PROJ_COLS;
    s = i / (2 * tiles);
    const int half = (i / tiles) % 2;
    n0 = (i % tiles) * PROJ_COLS;
    x = (half ? a.ctx : a.h2) + (size_t)s * a.B * D;
    w = a.w_out + ((size_t)s * 2 * D + (size_t)half * D) * a.VP;
    out = a.headp + (size_t)(half * 2 + s) * a.B * a.VP;
    ldw = a.VP;
  }
  if (with_head && !any_active(a, s, row0, rows)) return;
  const int ks = tid / PROJ_CG, cg = tid % PROJ_CG;
  float4 wv[KN];
  load_weights(w, ldw, n0 + 4 * cg, ks, wv);
  load_tile<PROJ_THREADS>(xs, x, row0, rows);
  __syncthreads();
  float acc[RT][4];
  product(xs, ks, wv, acc);
  __syncthreads();
  stash<PROJ_COLS>(xs, ks, cg, acc);
  __syncthreads();
  for (int o = tid; o < PROJ_COLS * RT; o += PROJ_THREADS) {
    const int col = o % PROJ_COLS, r = o / PROJ_COLS;
    if (r < rows)
      out[(size_t)(row0 + r) * ldw + n0 + col] = slices<PROJ_COLS>(xs, col, r);
  }
}

// ---------------------------------------------------------------------------
// 4. Per (row, staff): log_softmax, argmax and the masked updates.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) buf[warp] = x;
  __syncthreads();
  x = buf[0];
  for (int w = 1; w < FINAL_THREADS / 32; ++w)
    x = is_max ? fmaxf(x, buf[w]) : x + buf[w];
  return x;
}

__global__ void __launch_bounds__(FINAL_THREADS) final_kernel(const Args a) {
  __shared__ float buf[FINAL_THREADS / 32];
  __shared__ float best_v[FINAL_THREADS / 32];
  __shared__ int best_i[FINAL_THREADS / 32];
  __shared__ int token;
  const int b = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const size_t row = (size_t)(s * a.B + b);
  float* logp = a.logp + row * a.V;
  if (!a.mask[row]) {
    for (int k = tid; k < a.V; k += FINAL_THREADS) logp[k] = 0.f;
    if (tid == 0) a.pred[row] = 0;
    return;
  }
  const float* h0 = a.headp + (size_t)(0 * 2 + s) * a.B * a.VP + b * a.VP;
  const float* h1 = a.headp + (size_t)(1 * 2 + s) * a.B * a.VP + b * a.VP;
  float x[VL];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < VL; ++j) {
    const int k = tid + j * FINAL_THREADS;
    x[j] = k < a.V ? (h0[k] + h1[k]) + a.b_out[s * a.V + k] : -INFINITY;
    mx = fmaxf(mx, x[j]);
  }
  mx = block_reduce(mx, true, buf);
  // The next step's attn_kernel may start now (it waits for this grid
  // before it reads what this writes): its launch and first loads overlap
  // the rest of this kernel, whose head loads are done.
  release_dependent_grid();
  float se = 0.f;
#pragma unroll
  for (int j = 0; j < VL; ++j)
    if (tid + j * FINAL_THREADS < a.V) se += expf(x[j] - mx);
  se = block_reduce(se, false, buf);
  const float lse = logf(se);

  float bv = -INFINITY;
  int bi = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < VL; ++j) {
    const int k = tid + j * FINAL_THREADS;
    if (k < a.V) {
      const float lp = (x[j] - mx) - lse;
      logp[k] = lp;
      if (lp > bv) {
        bv = lp;
        bi = k;
      }
    }
  }
  // The largest log-prob, the first index among equals.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((tid & 31) == 0) {
    best_v[tid >> 5] = bv;
    best_i[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    float v0 = best_v[0];
    int i0 = best_i[0];
    for (int w = 1; w < FINAL_THREADS / 32; ++w)
      if (best_v[w] > v0 || (best_v[w] == v0 && best_i[w] < i0)) {
        v0 = best_v[w];
        i0 = best_i[w];
      }
    if (i0 >= a.V) i0 = 0;  // every log-prob NaN
    token = i0;
    a.pred[row] = i0;
    if (i0 == a.eos) {
      a.lengths[row] = *a.t;  // the step's index + 1 (gru_kernel added 1)
      a.done[row] = 1;
    }
  }
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(
      a.emb_proj + ((size_t)s * a.V + token) * G);
  float4* dst = reinterpret_cast<float4*>(a.tok2 + row * G);
  for (int k = tid; k < G / 4; k += FINAL_THREADS) dst[k] = src[k];
}

int tiles_of(int rows) { return (rows + RT - 1) / RT; }

// attn_kernel on `stream` as a programmatic dependent launch of the launch
// before it (see the design note); 0 or the cudaError_t.
int launch_attn(const Args& a, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.chunks, a.B);
  config.blockDim = dim3(ATTN_THREADS);
  config.dynamicSmemBytes = ATTN_SMEM;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, attn_kernel, a);
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next call
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The widths the kernels are built for: D, H, rows of a product tile, the
// head's column multiple (VP), the most chunks, the most vocabulary.
int note_step_dims(int* out) {
  out[0] = D;
  out[1] = H;
  out[2] = RT;
  out[3] = PROJ_COLS;
  out[4] = MAX_CHUNKS;
  out[5] = VL * FINAL_THREADS;
  return 6;
}

// Once per process, before any launch: the products' shared memory above
// the default 48 KB.
int note_step_init() {
  cudaFuncSetAttribute(gru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       GRU_SMEM);
  cudaFuncSetAttribute(proj_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, PROJ_SMEM);
  return static_cast<int>(cudaGetLastError());
}

// The first step's hq = h2 @ [W_hh | W_q], for every row.
int note_step_prologue(const Args* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  proj_kernel<<<dim3(2 * QT, tiles_of(a->B)), PROJ_THREADS, PROJ_SMEM, st>>>(
      *a, 0);
  return static_cast<int>(cudaGetLastError());
}

// One step: four launches on `stream`. Returns 0 or the first cudaError_t.
int note_step_launch(const Args* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (const int e = launch_attn(*a, st)) return e;
  gru_kernel<<<dim3(D / GRU_UNITS, 2, tiles_of(a->B)), GRU_THREADS, GRU_SMEM,
               st>>>(*a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  proj_kernel<<<dim3(2 * QT + 4 * (a->VP / PROJ_COLS), tiles_of(a->B)),
                PROJ_THREADS, PROJ_SMEM, st>>>(*a, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  final_kernel<<<dim3(a->B, 2), FINAL_THREADS, 0, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

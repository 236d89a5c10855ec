// trie_walk: the fused trie walk of the serving path, one launch per
// query batch whatever the trie's depth.
//
// Replaces the TPU kernel
//   repro/kernels/trie_walk/trie_walk.py::trie_walk_blocked
// and computes, bit for bit, the plain version
//   repro_torch/kernels/trie_walk/ref.py::trie_walk_core
// For each (sequence, subtree shard) cell it walks the shard's S slots in
// topological order.  Slot n seeds from its parent slot's frontier (or
// the root state when parent < 0), applies the residual-req prescreen,
// takes one embedding-join step - window gather through the inverted
// index, the containment predicate (contain_pred.cuh, shared with
// containment.cu), first-E compaction in (row, token, orientation)
// order, phi/psi update - and writes its terminal accept and
// terminal-overflow bits.
//
// Inputs (all int32, contiguous):
//   tok_c [N,T,6]  order_c [N,T]  start_c, count_c [N,K]
//   steps [N,S,8]  parent [N,S]  req [N,S,K]
// Outputs: acc, ovft [N,S] (0/1).
//
// What bounds it on the card: a cell reads its token table, index rows
// and packed subtree (about 4 (7T + 2K + S (9 + K)) bytes) and does, per
// slot, E*Tm predicate evaluations of about 2 nv + 20 integer operations
// plus the compaction and the state update: a few kilobytes and a few
// tens of thousands of operations a cell, so bytes and operations are
// both far below a launch's latency at serving batch sizes.  The limit
// of this simple design is the walk's serial chain: S slots, each a
// handful of barrier-separated phases, one of them (the compaction) run
// by one thread.
//
// Design: one block per cell.  The per-slot frontier buffers
// phi [S,E,ni], psi [S,E,nv], valid [S,E] and ovf [S] live in shared
// memory (E = emax), as do the slot's seed, its token window [Tm,6],
// its step rows [E,8] and its predicate bits [E,Tm]; at S = 8, E = 4,
// ni = 6, nv = 12 that is under 4 KB a cell.  The launcher works out
// the size from the launch's sizes and returns the CUDA error when it
// exceeds what a block may have; the wrapper raises on it.  The
// compaction keeps the first E flagged candidates in ascending
// (row, token, orientation) order - children seed from the
// compacted state, so the order is part of the result - by one thread
// scanning the E*Tm*2 candidates; it stops once it has seen E + 1
// (the (E+1)-th is the frontier overflow).  Pad slots (step_valid 0,
// parent -1, req = int32 max) fail the prescreen and come out 0/0 with
// no special case.  The TPU kernel's cell-block and slot padding have
// no counterpart: every size is taken at run time.
#include <cuda_runtime.h>

#include "contain_pred.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPadPhi = 0x3FFFFFF;
constexpr int kPadPsi = -2;

struct Sizes {
  int T, K, S, E, Tm, ni, nv;
};

__host__ __device__ inline size_t smem_ints(const Sizes& z) {
  const size_t S = z.S, E = z.E, ni = z.ni, nv = z.nv;
  return static_cast<size_t>(z.K)   // count row
         + S                        // prescreen bit per slot
         + S * E * (ni + nv + 1)    // phi / psi / valid buffers
         + S                        // ovf buffer
         + E * (ni + nv + 1)        // seed phi / psi / valid
         + static_cast<size_t>(z.Tm) * 6  // token window
         + E * contain::kSrowFields       // step rows
         + E * z.Tm                       // predicate bits
         + E                              // selected candidates
         + 8;                             // scalars
}

__global__ void __launch_bounds__(kThreads)
trie_walk_kernel(const int* __restrict__ tok_c, const int* __restrict__ order_c,
                 const int* __restrict__ start_c,
                 const int* __restrict__ count_c,
                 const int* __restrict__ steps, const int* __restrict__ parent,
                 const int* __restrict__ req, int* __restrict__ acc,
                 int* __restrict__ ovft, Sizes z) {
  const int T = z.T, K = z.K, S = z.S, E = z.E, Tm = z.Tm, ni = z.ni,
            nv = z.nv;
  const int tid = threadIdx.x;
  const long long i = blockIdx.x;
  extern __shared__ int smem[];
  int* s_count = smem;
  int* s_poss = s_count + K;
  int* phi_buf = s_poss + S;
  int* psi_buf = phi_buf + S * E * ni;
  int* valid_buf = psi_buf + S * E * nv;
  int* ovf_buf = valid_buf + S * E;
  int* seed_phi = ovf_buf + S;
  int* seed_psi = seed_phi + E * ni;
  int* seed_valid = seed_psi + E * nv;
  int* tok_w = seed_valid + E;
  int* srow = tok_w + Tm * 6;
  int* bits = srow + E * contain::kSrowFields;
  int* sel = bits + E * Tm;
  int* scal = sel + E;  // 0 n_sel, 1 frontier_ovf, 2 window_ovf

  const int* tok = tok_c + i * T * 6;
  const int* order = order_c + i * T;
  const int* start = start_c + i * K;
  const int* steps_i = steps + i * S * contain::kSrowFields;
  const int* parent_i = parent + i * S;
  const int* req_i = req + i * S * K;

  for (int k = tid; k < K; k += blockDim.x) s_count[k] = count_c[i * K + k];
  // the buffers start at zero, as the plain version's do
  for (int k = tid; k < S * E * (ni + nv + 1) + S; k += blockDim.x)
    phi_buf[k] = 0;
  __syncthreads();
  // residual prescreen of every slot: count >= req on all keys
  for (int n = tid; n < S; n += blockDim.x) {
    int ok = 1;
    for (int k = 0; k < K && ok; ++k) ok = s_count[k] >= req_i[n * K + k];
    s_poss[n] = ok;
  }
  __syncthreads();

  const int C = E * Tm * 2;
  for (int n = 0; n < S; ++n) {
    const int* step = steps_i + n * contain::kSrowFields;
    const int ty = step[0], pu1 = step[1], pu2 = step[2], lab = step[3];
    const int snew = step[4], idx = step[5], sval = step[6], key = step[7];
    const int pidx = parent_i[n];
    const bool isroot = pidx < 0;
    const int pcl = pidx < 0 ? 0 : (pidx > S - 1 ? S - 1 : pidx);
    const int poss = s_poss[n];
    const int seed_ovf = isroot ? 0 : ovf_buf[pcl];

    // ---- seed: the parent slot's compacted frontier or the root state
    for (int k = tid; k < E * ni; k += blockDim.x)
      seed_phi[k] = isroot ? kPadPhi : phi_buf[pcl * E * ni + k];
    for (int k = tid; k < E * nv; k += blockDim.x)
      seed_psi[k] = isroot ? kPadPsi : psi_buf[pcl * E * nv + k];
    for (int e = tid; e < E; e += blockDim.x)
      seed_valid[e] = (isroot ? e == 0 : valid_buf[pcl * E + e] != 0) &&
                      poss != 0;
    // ---- the step's token window through the inverted index
    const int st = start[key];
    const int ct = s_count[key];
    for (int m = tid; m < Tm; m += blockDim.x) {
      const int wpos = st + m < T - 1 ? st + m : T - 1;
      const int* src = tok + static_cast<long long>(order[wpos]) * 6;
      for (int f = 0; f < 5; ++f) tok_w[m * 6 + f] = src[f];
      tok_w[m * 6 + 5] = m < ct ? src[5] : 0;
    }
    __syncthreads();
    // ---- per-row step table
    for (int e = tid; e < E; e += blockDim.x) {
      const int* ph = seed_phi + e * ni;
      const int pi = idx - 1 < 0 ? 0 : (idx - 1 > ni - 1 ? ni - 1 : idx - 1);
      int* r = srow + e * contain::kSrowFields;
      r[0] = ty; r[1] = pu1; r[2] = pu2; r[3] = lab; r[4] = snew;
      r[5] = idx > 0 ? ph[pi] : -1;
      r[6] = ph[idx];
      r[7] = (seed_valid[e] != 0 && sval > 0) ? 1 : 0;
    }
    __syncthreads();
    // ---- the containment predicate over (row, window token)
    for (int k = tid; k < E * Tm; k += blockDim.x) {
      const int e = k / Tm;
      const int t = k - e * Tm;
      bits[k] = contain::contain_pred(tok_w + t * 6, seed_psi + e * nv, nv,
                                      srow + e * contain::kSrowFields);
    }
    __syncthreads();
    // ---- first-E compaction in (row, token, orientation) order
    if (tid == 0) {
      int cnt = 0;
      for (int c = 0; c < C && cnt <= E; ++c) {
        if ((bits[c >> 1] >> (c & 1)) & 1) {
          if (cnt < E) sel[cnt] = c;
          ++cnt;
        }
      }
      int live = 0;
      for (int e = 0; e < E; ++e) live |= seed_valid[e];
      scal[0] = cnt < E ? cnt : E;
      scal[1] = cnt > E;
      scal[2] = ct > Tm && live;
    }
    __syncthreads();
    // ---- phi / psi update into slot n's buffer row
    const int n_sel = scal[0];
    const bool is_v = ty <= 2;
    for (int k = tid; k < E * ni; k += blockDim.x) {
      const int r = k / ni;
      const int col = k - r * ni;
      const bool ok = r < n_sel;
      const int s = ok ? sel[r] : C - 1;
      const int e_old = s / (Tm * 2);
      const int t_w = (s / 2) % Tm;
      int v = seed_phi[e_old * ni + col];
      if (col == idx && snew > 0 && ok) v = tok_w[t_w * 6 + 4];
      phi_buf[n * E * ni + k] = v;
    }
    for (int k = tid; k < E * nv; k += blockDim.x) {
      const int r = k / nv;
      const int col = k - r * nv;
      const bool ok = r < n_sel;
      const int s = ok ? sel[r] : C - 1;
      const int e_old = s / (Tm * 2);
      const int t_w = (s / 2) % Tm;
      const int var = s % 2;
      const int* ps = seed_psi + e_old * nv;
      const int u1 = tok_w[t_w * 6 + 1], u2 = tok_w[t_w * 6 + 2];
      const int a = var == 0 ? u1 : u2;
      const int b = var == 0 ? u2 : u1;
      const bool fresh1 = ps[pu1] < 0;
      const bool fresh2 = ps[pu2] < 0;
      int v = ps[col];
      if (col == pu1 && fresh1 && ok) v = is_v ? u1 : a;
      if (col == pu2 && !is_v && fresh2 && ok) v = b;
      psi_buf[n * E * nv + k] = v;
    }
    for (int r = tid; r < E; r += blockDim.x) valid_buf[n * E + r] = r < n_sel;
    if (tid == 0) {
      const int f_ovf = scal[1], w_ovf = scal[2];
      acc[i * S + n] = (n_sel > 0 && poss) ? 1 : 0;
      ovft[i * S + n] = ((seed_ovf || w_ovf) && poss) ? 1 : 0;
      ovf_buf[n] = ((seed_ovf || f_ovf || w_ovf) && poss) ? 1 : 0;
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int trie_walk_launch(const int* tok_c, const int* order_c,
                                const int* start_c, const int* count_c,
                                const int* steps, const int* parent,
                                const int* req, int* acc, int* ovft, int N,
                                int T, int K, int S, int E, int Tm, int ni,
                                int nv, cudaStream_t stream) {
  if (N <= 0 || S <= 0) return 0;
  const Sizes z{T, K, S, E, Tm, ni, nv};
  const size_t smem = sizeof(int) * smem_ints(z);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trie_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return static_cast<int>(err);
    }
  }
  trie_walk_kernel<<<N, kThreads, smem, stream>>>(
      tok_c, order_c, start_c, count_c, steps, parent, req, acc, ovft, z);
  return static_cast<int>(cudaGetLastError());
}

// containment: one step of the serving path's embedding join.
//
// Replaces the TPU kernel
//   repro/kernels/containment/containment.py::contain_step_blocked
// and computes, bit for bit, the plain version
//   repro_torch/kernels/containment/ref.py::contain_step_core
// the 2-bit orientation mask of the Def-4 predicate for every
// (cell g, frontier row e, window token t).
//
// Inputs (all int32, contiguous):
//   tok [G,Tm,6]  psi [G,Ein,NV]  srow [G,Ein,8]
// Output: bits [G,Ein,Tm].
//
// What bounds it on the card: per cell it reads (6 Tm + (NV + 8) Ein)
// ints and writes Ein Tm ints, and each (e, t) pair costs about 2 NV + 20
// integer operations, so it is bound by bytes: at the largest call of a
// flat serving batch (G = 32768, Ein = 1, Tm = 8, NV = 3) 8.8 MB, 2.6 us
// at 3.35 TB/s.  Each cell is tiny (a few hundred bytes, Ein Tm pairs,
// often 8), so what stands between a kernel and that bound is
// occupancy and latency, not arithmetic: a block per cell leaves most
// lanes idle, fits 32 blocks on an SM and needs many waves, each behind
// a staging barrier.
//
// Design: one thread per output element over the flattened G Ein Tm,
// t fastest, so the [G,Ein,Tm] output is written coalesced and a block
// of 256 threads covers many cells (32 at Ein Tm = 8; the largest flat
// call is 1,024 blocks, one wave).  No shared memory and no barrier:
// a thread reads its token row (24 B, shared by the Ein rows of the
// cell), its psi row and its step row (shared by Tm threads) through
// the read-only path (__ldg), and neighbouring threads of one cell meet
// in L1.  The psi row is read only when the pair passes the cheap
// type/label/slot gates.  Indices are 32-bit unsigned: each thread
// divides twice, and in 64 bits the kernel took 0.00484 ms against 0.00466
// at the largest flat call (H100 SXM at 700 W, chip_smoke.py).  So every offset must stay below 2^31: no
// tensor of more than 2^31 - 1 ints (8 GB), which the launcher refuses
// and the wrapper raises on.  The grid covers the work once, yet the body
// sits in a grid-stride loop: nvcc then schedules the psi scan otherwise,
// and the kernel took 0.00442 ms against 0.00464 with an early return.
#include <cuda_runtime.h>

#include <climits>

#include "contain_pred.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
contain_step_kernel(const int* __restrict__ tok, const int* __restrict__ psi,
                    const int* __restrict__ srow, int* __restrict__ out,
                    unsigned total, unsigned Ein, unsigned Tm, int NV) {
  const unsigned ET = Ein * Tm;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const unsigned g = i / ET;
    const unsigned r = i - g * ET;
    const unsigned e = r / Tm;
    const unsigned t = r - e * Tm;
    const unsigned ge = g * Ein + e;
    out[i] = contain::contain_pred(
        tok + (g * Tm + t) * contain::kTokFields, psi + ge * NV, NV,
        srow + ge * contain::kSrowFields, contain::LdgLoad());
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was taken),
// or cudaErrorInvalidValue when a tensor holds more than 2^31 - 1 ints.
extern "C" int contain_step_launch(const int* tok, const int* psi,
                                   const int* srow, int* out, int G, int Ein,
                                   int Tm, int NV, cudaStream_t stream) {
  if (G <= 0 || Ein <= 0 || Tm <= 0) return 0;
  const long long total = static_cast<long long>(G) * Ein * Tm;
  const long long rows = static_cast<long long>(G) * Ein;
  const long long row_w = NV > contain::kSrowFields ? NV
                                                    : contain::kSrowFields;
  if (total > INT_MAX || static_cast<long long>(G) * Tm * 6 > INT_MAX ||
      rows * row_w > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads);
  contain_step_kernel<<<blocks, kThreads, 0, stream>>>(
      tok, psi, srow, out, static_cast<unsigned>(total),
      static_cast<unsigned>(Ein), static_cast<unsigned>(Tm), NV);
  return static_cast<int>(cudaGetLastError());
}

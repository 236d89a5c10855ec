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
// integer operations, so at the serving shapes (Ein <= 16, Tm <= 32,
// NV <= 14) it moves a few hundred bytes a cell and is bound by bytes,
// by a wide margin; a serving step's call (a few thousand cells) sits
// below a launch's latency.  The design is therefore plain: one block
// per cell stages the cell's tokens, psi rows and step rows in shared
// memory (each is read by many pairs), and its threads walk the cell's
// (e, t) pairs flattened, so the [Ein,Tm] output row is written
// coalesced.  Ein is whatever psi has (1 on a root step); the TPU
// kernel's cell-block and lane padding have no counterpart: the kernel
// takes every size at run time and masks nothing but its own loop.
#include <cuda_runtime.h>

#include "contain_pred.cuh"

namespace {

__global__ void contain_step_kernel(const int* __restrict__ tok,
                                    const int* __restrict__ psi,
                                    const int* __restrict__ srow,
                                    int* __restrict__ out, int Ein, int Tm,
                                    int NV) {
  extern __shared__ int smem[];
  int* s_tok = smem;                    // [Tm, 6]
  int* s_psi = s_tok + Tm * 6;          // [Ein, NV]
  int* s_srow = s_psi + Ein * NV;       // [Ein, 8]
  const long long g = blockIdx.x;
  const int* g_tok = tok + g * Tm * 6;
  const int* g_psi = psi + g * Ein * NV;
  const int* g_srow = srow + g * Ein * contain::kSrowFields;
  for (int i = threadIdx.x; i < Tm * 6; i += blockDim.x) s_tok[i] = g_tok[i];
  for (int i = threadIdx.x; i < Ein * NV; i += blockDim.x)
    s_psi[i] = g_psi[i];
  for (int i = threadIdx.x; i < Ein * contain::kSrowFields; i += blockDim.x)
    s_srow[i] = g_srow[i];
  __syncthreads();
  int* g_out = out + g * Ein * Tm;
  for (int i = threadIdx.x; i < Ein * Tm; i += blockDim.x) {
    const int e = i / Tm;
    const int t = i - e * Tm;
    g_out[i] = contain::contain_pred(s_tok + t * 6, s_psi + e * NV, NV,
                                     s_srow + e * contain::kSrowFields);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int contain_step_launch(const int* tok, const int* psi,
                                   const int* srow, int* out, int G, int Ein,
                                   int Tm, int NV, cudaStream_t stream) {
  if (G <= 0 || Ein <= 0 || Tm <= 0) return 0;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(Tm) * 6 +
                     static_cast<size_t>(Ein) * (NV + contain::kSrowFields));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        contain_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return static_cast<int>(err);
    }
  }
  int threads = ((Ein * Tm + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  contain_step_kernel<<<G, threads, smem, stream>>>(tok, psi, srow, out, Ein,
                                                    Tm, NV);
  return static_cast<int>(cudaGetLastError());
}

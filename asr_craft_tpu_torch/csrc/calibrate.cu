// The in-kernel elementwise calibration (K15) for Hopper (sm_90a): a timed
// chain of dependent elementwise operations over a window that stays in
// shared memory.  Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/calibrate.py, which holds the plain PyTorch
// version and the timing around the launches.
//
// Replaces the TPU kernel of asr_craft_tpu/utils/roofline.py:
//   calibrate_chain_kernel <- measure_vpu_geps_pallas, its inner `kernel`
//
// What it computes.  x (Ls, Bk) f32 is broadcast into a (Dmax, Ls, Bk)
// window.  Then `steps` times (the TPU's grid_n * frames), for every element
// of the window: read it, apply `passes` dependent operations
//   p % 8 != 7:  z = z * 0.999 + 1e-4
//   p % 8 == 7:  z = exp(z * -0.5)
// and write it back.  The whole window is returned (the TPU kernel returns
// slot 0; the wrapper cuts it out), so a test can see that every slot was
// worked on.  All Dmax slots hold the same values by construction; they are
// the work that is timed, and they live in shared memory, which the compiler
// cannot fold: a store before a block barrier must happen and a load after it
// must be executed again.
//
// Which regime it stands for, and why it is written so.  Its figure is the
// denominator of the floors in utils/roofline.py (scrf_tile_floor,
// fdt_tile_floor): the rate at which nvcc-compiled code does elementwise work
// IN THE REGIME OF THE PORT'S OWN RECURSIONS.  So it has their shape, that of
// seg_forward_kernel (segmental.cu): one block per batch column with
// threads_for(Ls) threads (kGroup lanes a label), the (Dmax, Ls) window of
// that column in dynamic shared memory, one pass over the window a step with
// a block barrier after it, expf from the CUDA math library (no fast math),
// a multiply-add where the source writes z * a + b.  The TPU body keeps one
// window for all Bk columns in its scratch memory and walks a sequential
// grid; the elements are independent, so nothing of that blocking carries
// over.  It is deliberately not tuned: more elements a thread, unrolled
// passes or no barrier would measure a regime no kernel of the port runs in.
//
// What bounds it on this card.  Operations: it moves one (Ls, Bk) plane in
// and the window out (25 KB + 393 KB at the defaults) and does steps * passes
// * Dmax * Ls * Bk element operations (1.29e10 at the defaults), 7 of 8 a
// multiply-add, 1 of 8 a multiply and an expf.  With Bk = 128 blocks of 192
// threads, 128 of the 132 SMs hold six warps each, and each thread carries
// four independent 16-deep chains a step: the rate it reaches is set by
// instruction latency and the barrier as much as by dispatch width, which is
// the point.

#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::kMaxThreads;
using fdtk::kSmemLimit;
using fdtk::opt_in;
using fdtk::threads_for;

__global__ void __launch_bounds__(kMaxThreads)
calibrate_chain_kernel(const float* __restrict__ x, float* __restrict__ window,
                       int Dmax, int Ls, int Bk, int passes, int steps) {
  extern __shared__ float buf[];               // (Dmax, Ls) of this column
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int W = Dmax * Ls;
  for (int i = tid; i < W; i += nth) buf[i] = x[(size_t)(i % Ls) * Bk + b];
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    for (int i = tid; i < W; i += nth) {
      float z = buf[i];
      for (int p = 0; p < passes; ++p)
        z = (p & 7) == 7 ? expf(z * -0.5f) : z * 0.999f + 1e-4f;
      buf[i] = z;
    }
    __syncthreads();
  }
  for (int i = tid; i < W; i += nth) window[(size_t)i * Bk + b] = buf[i];
}

}  // namespace

extern "C" {

// window (Dmax, Ls, Bk) = the chain applied `steps` times to x (Ls, Bk)
// broadcast over Dmax slots.  cudaErrorInvalidValue: a window that does not
// fit a block's shared memory.
int calibrate_chain(const float* x, float* window, int Dmax, int Ls, int Bk,
                    int passes, int steps, void* stream) {
  const size_t bytes = sizeof(float) * (size_t)Dmax * Ls;
  if (Dmax < 1 || Ls < 1 || Bk < 1 || passes < 0 || steps < 0 ||
      bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(calibrate_chain_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  calibrate_chain_kernel<<<Bk, threads_for(Ls), bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      x, window, Dmax, Ls, Bk, passes, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

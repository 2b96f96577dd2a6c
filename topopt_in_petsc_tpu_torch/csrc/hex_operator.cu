// K1: matrix-free Hex8 elasticity operator  out = K(E) u  (dof = 3, f32).
//
// Replaces the TPU kernel topopt_in_petsc_tpu/ops/blocked_hex.py::_kernel
// (the resident-layout Pallas kernel built in BlockedHexOperator.__init__).
// Plain PyTorch version: ops/hex_operator.py::apply_hex_operator followed
// by BlockedHexOperator.mask0 when mask_x0 is set.
//
//   out_i[n] = sum_{a,b} E(n - o_a) * KE[3a+i, 3b+j] * u_j[n - o_a + o_b]
//
// over the (up to) 8 elements e = n - o_a that have node n as corner a.
//
// Layout: u and out are (3, nx, ny, nz), E is (nx-1, ny-1, nz-1), all
// contiguous with z fastest.  One thread computes the three components of
// one node, so every output is written once: no atomics, deterministic.
// The element-in-grid test is the whole boundary rule (free / Neumann);
// no pad planes or halo lanes exist.  mask_x0 zeroes the x == 0 node
// plane (the cantilever's clamped wall, LinearElasticity.cc:143-156).
//
// What bounds it on an H100: 576 f32 FMAs per node against ~28 bytes of
// compulsory traffic (u read, E read, out written), so the FMA pipes, not
// HBM, set the floor (about 0.3 ms at 257^3 against 67 TFLOP/s f32).  The
// 27 neighbour reads per node come through L1/L2, since neighbouring
// threads in z read neighbouring addresses.  KE (per level: each MG level
// has its own rediscretized KE) is passed by value as a kernel parameter;
// with the loops fully unrolled every KE entry is a compile-time offset
// into the constant bank (__grid_constant__: never copied to local
// memory), so it costs no loads from device memory.  Later
// work: shared-memory tiles of u and E, and the 27-offset grouping.

#include <cuda_runtime.h>

namespace {

struct KE24 {
  float v[576];  // row-major (24, 24)
};

// reference hex corner order (grid.CORNER_OFFSETS)
__host__ __device__ constexpr int ox(int a) { return ((a + 1) >> 1) & 1; }
__host__ __device__ constexpr int oy(int a) { return (a >> 1) & 1; }
__host__ __device__ constexpr int oz(int a) { return a >> 2; }

__global__ void __launch_bounds__(256)
hex_operator_kernel(const float* __restrict__ u, const float* __restrict__ E,
                    float* __restrict__ out, const __grid_constant__ KE24 ke,
                    int nx, int ny, int nz, int mask_x0) {
  const int nnode = nx * ny * nz;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= nnode) return;
  const int z = n % nz;
  const int t = n / nz;
  const int y = t % ny;
  const int x = t / ny;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  if (!(mask_x0 && x == 0)) {
    const int ex = nx - 1, ey = ny - 1, ez = nz - 1;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int exi = x - ox(a), eyi = y - oy(a), ezi = z - oz(a);
      if (exi < 0 || exi >= ex || eyi < 0 || eyi >= ey || ezi < 0 ||
          ezi >= ez)
        continue;
      const float Ee = __ldg(E + (exi * ey + eyi) * ez + ezi);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int m = ((exi + ox(b)) * ny + (eyi + oy(b))) * nz + ezi + oz(b);
        const float u0 = __ldg(u + m);
        const float u1 = __ldg(u + nnode + m);
        const float u2 = __ldg(u + 2 * nnode + m);
        const int r = 3 * a * 24 + 3 * b;  // KE[3a + i, 3b + j] at r + 24i + j
        s0 = fmaf(ke.v[r], u0, fmaf(ke.v[r + 1], u1, fmaf(ke.v[r + 2], u2, s0)));
        s1 = fmaf(ke.v[r + 24], u0,
                  fmaf(ke.v[r + 25], u1, fmaf(ke.v[r + 26], u2, s1)));
        s2 = fmaf(ke.v[r + 48], u0,
                  fmaf(ke.v[r + 49], u1, fmaf(ke.v[r + 50], u2, s2)));
      }
      acc0 = fmaf(Ee, s0, acc0);
      acc1 = fmaf(Ee, s1, acc1);
      acc2 = fmaf(Ee, s2, acc2);
    }
  }
  out[n] = acc0;
  out[nnode + n] = acc1;
  out[2 * nnode + n] = acc2;
}

}  // namespace

extern "C" {

// u, E, out: device pointers; ke_host: host pointer to the row-major
// (24, 24) f32 element matrix; stream: a cudaStream_t.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
int hex_operator_f32(const void* u, const void* E, void* out,
                     const void* ke_host, int nx, int ny, int nz,
                     int mask_x0, void* stream) {
  KE24 ke;
  const float* src = static_cast<const float*>(ke_host);
  for (int i = 0; i < 576; ++i) ke.v[i] = src[i];
  const int nnode = nx * ny * nz;
  if (nnode > 0) {
    const int block = 256;
    const int grid = (nnode + block - 1) / block;
    hex_operator_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(E),
        static_cast<float*>(out), ke, nx, ny, nz, mask_x0);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* topopt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

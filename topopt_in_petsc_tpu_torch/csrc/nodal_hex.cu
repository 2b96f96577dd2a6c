// K3 and K4: the matrix-free Hex8 operator  out = K(E) u  on the nodal
// layout, free (Neumann) boundaries, f32, one template on DOF:
//
//   K3  helmholtz_f32  DOF 1, KF (8, 8): the Helmholtz PDE-filter operator
//       (-R^2 lap + I) with a unit element scale.  Replaces the TPU kernel
//       topopt_in_petsc_tpu/ops/pallas_hex.py::_kernel1 (built by
//       make_pallas_helmholtz_apply).
//   K4  nodal_hex_f32  DOF 3, KE (24, 24): the elasticity operator of the
//       nodal solve (-operator_impl pallas).  Replaces the TPU kernel
//       topopt_in_petsc_tpu/ops/pallas_hex.py::_kernel (built by
//       make_pallas_hex_apply).
//
// Plain PyTorch version of both: ops/hex_operator.py::apply_hex_operator.
//
//   out_i[n] = sum_{a,b} E(n - o_a) * KE[DOF a + i, DOF b + j]
//                                    * u_j[n - o_a + o_b]
//
// over the (up to) 8 elements e = n - o_a that have node n as corner a.
//
// Layout: u and out are (nx, ny, nz, DOF), E is (nx-1, ny-1, nz-1), all
// contiguous with the last axis fastest: the layout of the JAX package's
// interface, with no pads, halo lanes or y-chunk windows (those served
// Mosaic's DMA limits only).  One thread computes the DOF outputs of one
// node, so every output is written once: no atomics, deterministic.  The
// element-in-grid test is the whole boundary rule, so the coarsest MG
// levels need no special case.  Dirichlet masks stay outside the kernel
// (solvers/multigrid.py, GeometricMultigrid.apply).
//
// What bounds it on an H100:
//   K4: 576 f32 FMAs per node, as K1 (csrc/hex_operator.cu), so the FMA
//       pipes set the floor; its dof-minor reads are 12-byte strided per
//       thread (neighbouring threads still read neighbouring addresses,
//       served by L1/L2).
//   K3: 64 FMAs per node against ~12 bytes of compulsory traffic (u and E
//       read, out written): memory- or latency-bound; at 257^3 that
//       traffic is ~200 MB, a floor of ~0.06 ms at 3.35 TB/s.
// The element matrix (per MG level: each level has its own rediscretized
// matrix) is a __grid_constant__ kernel parameter (256 B for KF, 2,304 B
// for KE); with the loops fully unrolled every entry is a compile-time
// offset into the constant bank, so it costs no loads from device memory.

#include <cuda_runtime.h>

namespace {

template <int DOF>
struct ElemMat {
  float v[64 * DOF * DOF];  // row-major (8 DOF, 8 DOF)
};

// reference hex corner order (grid.CORNER_OFFSETS)
__host__ __device__ constexpr int cox(int a) { return ((a + 1) >> 1) & 1; }
__host__ __device__ constexpr int coy(int a) { return (a >> 1) & 1; }
__host__ __device__ constexpr int coz(int a) { return a >> 2; }

template <int DOF>
__global__ void __launch_bounds__(256)
nodal_hex_kernel(const float* __restrict__ u, const float* __restrict__ E,
                 float* __restrict__ out,
                 const __grid_constant__ ElemMat<DOF> ke, int nx, int ny,
                 int nz) {
  constexpr int W = 8 * DOF;  // row length of the element matrix
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= nx * ny * nz) return;
  const int z = n % nz;
  const int t = n / nz;
  const int y = t % ny;
  const int x = t / ny;
  const int ex = nx - 1, ey = ny - 1, ez = nz - 1;
  float acc[DOF];
#pragma unroll
  for (int i = 0; i < DOF; ++i) acc[i] = 0.f;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int exi = x - cox(a), eyi = y - coy(a), ezi = z - coz(a);
    if (exi < 0 || exi >= ex || eyi < 0 || eyi >= ey || ezi < 0 ||
        ezi >= ez)
      continue;
    const float Ee = __ldg(E + (exi * ey + eyi) * ez + ezi);
    float s[DOF];
#pragma unroll
    for (int i = 0; i < DOF; ++i) s[i] = 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int m =
          ((exi + cox(b)) * ny + (eyi + coy(b))) * nz + ezi + coz(b);
      float ub[DOF];
#pragma unroll
      for (int j = 0; j < DOF; ++j) ub[j] = __ldg(u + DOF * m + j);
#pragma unroll
      for (int i = 0; i < DOF; ++i) {
        const int r = (DOF * a + i) * W + DOF * b;  // KE[DOF a + i, DOF b]
#pragma unroll
        for (int j = 0; j < DOF; ++j) s[i] = fmaf(ke.v[r + j], ub[j], s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < DOF; ++i) acc[i] = fmaf(Ee, s[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < DOF; ++i) out[DOF * n + i] = acc[i];
}

template <int DOF>
int launch(const void* u, const void* E, void* out, const void* ke_host,
           int nx, int ny, int nz, void* stream) {
  ElemMat<DOF> ke;
  const float* src = static_cast<const float*>(ke_host);
  for (int i = 0; i < 64 * DOF * DOF; ++i) ke.v[i] = src[i];
  const int nnode = nx * ny * nz;
  if (nnode > 0) {
    const int block = 256;
    const int grid = (nnode + block - 1) / block;
    nodal_hex_kernel<DOF><<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(E),
        static_cast<float*>(out), ke, nx, ny, nz);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// u, E, out: device pointers; ke_host: host pointer to the row-major
// element matrix, (8, 8) for helmholtz_f32 and (24, 24) for
// nodal_hex_f32; stream: a cudaStream_t.  Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().
int helmholtz_f32(const void* u, const void* E, void* out,
                  const void* ke_host, int nx, int ny, int nz,
                  void* stream) {
  return launch<1>(u, E, out, ke_host, nx, ny, nz, stream);
}

int nodal_hex_f32(const void* u, const void* E, void* out,
                  const void* ke_host, int nx, int ny, int nz,
                  void* stream) {
  return launch<3>(u, E, out, ke_host, nx, ny, nz, stream);
}

}  // extern "C"

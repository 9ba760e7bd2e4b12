"""transport_se_tpu_torch: the tracer-transport system in PyTorch and CUDA.

The PyTorch port of `transport_se_tpu` for one NVIDIA H100.  The JAX
package stays the reference; this package imports `torch` and never
`jax`.  Host-side tables come from the JAX package's numpy-only modules
(`config`, `constants`, `grid`, `native`), so the grid is bit-identical.

The main path is the T-layout remap subcycle (`model.core.make_subcycle_fn`
driven by `model.driver.run_simulation`), in the production face DSS mode
(`perf_config`) or in gather mode.  Its six hand-written Hopper kernels
live in `csrc/`:

* `csrc/euler.cu`: the fused advection + hyperviscosity + limiter stage
  (`ops.euler.fused_advect_limit`) and the weak Laplacian
  (`ops.euler.laplace_wk_t`, gather mode);
* `csrc/ppm.cu`: the monotone PPM vertical remap (`ops.remap.remap_q_ppm_t`);
* `csrc/dss.cu`: the face DSS with its fused epilogues
  (`ops.dss_face.dss_face`), the limiter-bound prep
  (`ops.dss_face.minmax_prep`) and the neighbor min/max
  (`ops.dss_face.neighbor_minmax`).

Each kernel's wrapper runs the kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor; there is no fallback between the two.
"""

__version__ = "0.1.0"

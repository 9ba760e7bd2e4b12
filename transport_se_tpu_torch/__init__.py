"""transport_se_tpu_torch: the tracer-transport system in PyTorch and CUDA.

The PyTorch port of `transport_se_tpu` for one NVIDIA H100.  The JAX
package stays the reference; this package imports `torch` and never
`jax`, and nothing of the JAX package.  It keeps its own copies of the
JAX package's numpy host modules (`config`, `constants`, `grid`,
`native`, `io.namelist`, `io.history`, `io.restart`, `norms`), tested
bitwise against them, so the grid, the namelist parse and the file formats
are the same.

Two pipelines, chosen as the JAX package chooses them
(`model.core.make_subcycle_fn`):

* the std-layout verification path (the `Config` defaults, f64), driven
  by the CLI `python -m transport_se_tpu_torch.main namelist.nl` with
  diagnostics, history and restart; limiter 8 runs the row limiter
  (`ops.limiter.limiter_optim_stage`, `csrc/limiter.cu`);
* the T-layout perf path (`use_pallas=True`, limiter 8), in the
  production face DSS mode (`perf_config`) or in gather mode, through:

  * `csrc/euler.cu`: the fused advection + hyperviscosity + limiter stage
    (`ops.euler.fused_advect_limit`) and the weak Laplacian
    (`ops.euler.laplace_wk_t`, gather mode);
  * `csrc/ppm.cu`: the monotone PPM vertical remap
    (`ops.remap.remap_q_ppm_t`);
  * `csrc/dss.cu`: the face DSS with its fused epilogues
    (`ops.dss_face.dss_face`), the limiter-bound prep
    (`ops.dss_face.minmax_prep`) and the neighbor min/max
    (`ops.dss_face.neighbor_minmax`).

Either pipeline also runs sharded (`parallel.sharded.make_sharded_subcycle`):
the element axis cut into S contiguous chunks, each shard the same
subcycle against its halo-extended tables (`parallel.halo`), the shards
as threads on one device (`parallel.comm.ThreadComm`) or one per process
(`parallel.comm.DistComm`, `parallel.multihost`).  On the face path every
DSS of a shard is the banded face DSS (`ops.band.dss_band`,
`csrc/band.cu`), with the bound prep of `csrc/dss.cu`.

Each kernel's wrapper runs the kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor; there is no fallback between the two.
"""

__version__ = "0.1.0"

"""The port's dry run and one-device entry (`transport_se_tpu_torch/
dryrun.py`) against the JAX package's `__graft_entry__.py`.

* `dryrun_multichip(8, "cpu")` passes both of its cases, and its plan
  figures (ne, halo rounds, eloc, every shard's boundary group on the face
  path, nbound on the gather path) are those of the JAX package's
  `build_shard_plan` for the same grids, and each case's state is that of
  one device's subcycle of its configuration through the plain versions,
  to 1e-12 (f64 face) and 1e-5 (f32 gather) of the field's scale;
* its ne rule is the JAX one at other shard counts;
* `entry("cpu")` against `__graft_entry__.entry()`, NE8 DCMIP 1-1 f32 std
  layout (the port's row limiter K10 runs its plain version here).  The
  initial states agree to 1e-5 of the field's scale (measured 1.6e-6: the
  two packages' f32 trigonometry differs by ulps, and the tracers' steep
  edges amplify that).  One step from the JAX initial state agrees to
  1e-4 of the scale: the two packages associate the 4x4 contractions, the
  DSS sums and the remap's sums differently, every f32 rounding of that
  (unit roundoff 6e-8) feeds the limiter and the PPM remap, and a moved
  clip moves its column by up to the clip residual.  Measured 1.2e-5 of
  the scale (max abs 0.047 on Qdp values up to 3.9e3, at the top level;
  two points above 1e-5 of the scale), ps_v to 2.4e-7 relative, min_dp
  equal;
* the CLI refuses --device cuda without a card.
"""

import signal

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from transport_se_tpu.grid.cubesphere import build_grid as jbuild_grid
from transport_se_tpu.parallel.halo import build_shard_plan as jplan
from transport_se_tpu_torch import counters, dryrun
from transport_se_tpu_torch.model import core as tcore

torch.set_num_threads(1)

TIME_LIMIT = 300          # seconds per test
INIT_TOL = 1e-5           # of the field's scale, f32 (module docstring)
ENTRY_TOL = 1e-4


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran over its {TIME_LIMIT} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_dryrun_multichip_matches_jax_plans(capsys):
    r = dryrun.dryrun_multichip(8, torch.device("cpu"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: ne=6, 8 shards")
    assert r["ne"] == 6 and r["n_shards"] == 8
    face = jplan(jbuild_grid(6, order="raster"), 8, overlap=False)
    gather = jplan(jbuild_grid(6, order="gilbert"), 8, overlap=True)
    assert (r["eloc"], r["nrounds"]) == (face.eloc, face.nrounds) == (27, 8)
    assert r["face"]["group"] == face.bmask.sum(axis=1).tolist()
    assert 0 < min(r["face"]["group"]) <= max(r["face"]["group"]) < 27
    assert r["gather"]["nbound"] == gather.nbound
    assert 0 < gather.nbound < gather.eloc == r["eloc"]
    assert r["face"]["drift"] < 1e-12 and r["gather"]["drift"] < 1e-5
    # K1 twice a stage on every shard: the face path's boundary-group
    # duplicate, the gather path's boundary/interior split
    face_k, gather_k = r["face"]["launches"], r["gather"]["launches"]
    assert face_k["fused_advect_limit_plain"] == 2 * 9 * 8
    assert gather_k["fused_advect_limit_plain"] == 2 * 9 * 8
    # the face case assembles through K7's plain version, the gather case
    # runs K2's for its first Laplacian; no kernel launches on the CPU
    assert face_k["dss_band_plain"] > 0 and "laplace_wk_t_plain" not in face_k
    assert gather_k["laplace_wk_t_plain"] == 3 * 8
    assert not any(k in face_k or k in gather_k for k in counters.KERNELS)
    assert r["face"]["min_dp"] > 0 and r["gather"]["min_dp"] > 0
    for case, tol in (("face", 1e-12), ("gather", 1e-5)):
        m = tcore.build_model(r[case]["cfg"], "cpu")
        want = tcore.make_subcycle_fn(m, plain=True)(
            tcore.initial_qdp(m), 0)[0].double()
        got = r[case]["state"].double()
        assert got.shape == want.shape
        assert (got - want).abs().max() <= tol * want.abs().max(), case


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_dryrun_ne_rule(n):
    ne = dryrun.dryrun_ne(n)
    ok = [k for k in range(6, 200)
          if (6 * k * k) % n == 0 and (6 * k * k) // n >= 2 * k]
    assert ne == ok[0]


def test_entry_step_matches_jax():
    jstep, (jq, jn) = graft.entry()
    want, jps, jnstep, jmd = jax.jit(jstep)(jq, jn)
    want = np.asarray(want)
    step, (q, n) = dryrun.entry(torch.device("cpu"))
    jq = np.array(jq)
    assert q.dtype == torch.float32 and q.shape == jq.shape and n == 0
    assert np.abs(q.numpy() - jq).max() <= INIT_TOL * np.abs(jq).max()
    got, ps, nstep, md = step(torch.from_numpy(jq), n)
    assert nstep == int(jnstep) == 3
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= ENTRY_TOL * scale
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=1e-6)
    assert float(md) == pytest.approx(float(jmd), rel=1e-6) and float(md) > 0


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert dryrun.main(["--device", "cuda"]) == 2

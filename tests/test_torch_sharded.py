"""The port's sharded subcycle (`parallel/sharded.py`, shards as threads
through `ThreadComm`) == the JAX package's `make_sharded_subcycle` on its 8
virtual CPU devices, and == itself at any shard count.

* the T-layout face path in f64 at (ne 4, S 4) (row-aligned chunks) and
  (ne 6, S 8) (chunks cut rows), the face+overlap composition on and off,
  at the JAX tests' rtol 1e-12 / atol 1e-13
  (tests/test_sharded_face.py:159); measured max abs difference 4.4e-11
  on Qdp values up to 1.4e4 (3e-15 of the scale): the port's PyTorch
  operators and XLA associate the 4x4 contractions differently;
* the std-layout path (gather DSS) at ne 4 with 2 and 8 shards, to the
  JAX tests' 1e-13 of the field's scale (tests/test_sharded.py:58);
  measured 1.3e-10 on 3.9e3 (3.4e-14);
* S = 1 against S = 8 and overlap on against off: bitwise;
* the T-layout gather path with overlap (boundary-first element order,
  the split stage: K1 on the boundary group, then on the interior) against
  the JAX package's split pipeline at (ne 4, S 4) and (ne 6, S 8), f64, at
  the JAX test's rtol 1e-12 / atol 1e-13 (tests/test_sharded.py:107-108);
  measured max abs difference 5.1e-11 (ne 4) and 4.4e-11 (ne 6) on Qdp
  values up to 1.4e4 (3.6e-15 and 3.1e-15 of the scale), as on the face
  path; K1 twice a stage per shard shows the split ran;
* the T-layout gather path, overlap on and by default (off), against the
  single-device
  gather path at (ne 4, S 4) and (ne 6, S 8): bitwise (the same partner
  order; K1's per-column results do not depend on the elements that share
  its launch), with the launches of each;
* a failing shard fails the run instead of hanging it, and the shared
  launch counts lose no update under threads.
"""

import os
import signal
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.model import core as jcore
from transport_se_tpu.parallel.sharded import (make_mesh,
                                               make_sharded_subcycle as jmss)
from transport_se_tpu_torch import counters
from transport_se_tpu_torch.model import core as tcore
from transport_se_tpu_torch.parallel.comm import ThreadComm
from transport_se_tpu_torch.parallel.sharded import make_sharded_subcycle

from test_torch_host import port_config

torch.set_num_threads(1)

TIME_LIMIT = 300          # seconds per test
COMM_TIMEOUT = 120        # a barrier that waits longer breaks the run

FACE = dict(nlev=8, qsize=2, tstep=1200.0, vcoord="dcmip8",
            test_case="dcmip1-1", nu_q=6e16, nmax=3, dtype="f64",
            use_pallas=True, dss_mode="face", elem_order="raster")
STD = dict(ne=4, nlev=72, qsize=2, tstep=1200.0, nu_q=6e16, nmax=3)
GATHER = dict(FACE, dss_mode="gather", elem_order="gilbert")


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran over its {TIME_LIMIT} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _jax_sharded(jm, S, overlap=None):
    runner = jmss(jm, make_mesh(jax.devices()[:S]), overlap=overlap)
    out = runner.step(runner.shard_qdp(jcore.initial_qdp(jm)),
                      jnp.asarray(0, jnp.int32))
    return runner.to_model_order(out[0]), float(out[3])


def _port_sharded(tm, S, overlap=None):
    """One subcycle of the port's runner -> (Qdp [E,q,k,4,4] model order,
    min_dp, runner, launch counts)."""
    runner = make_sharded_subcycle(tm, ThreadComm(S, timeout=COMM_TIMEOUT),
                                   overlap=overlap)
    counters.reset()
    states = runner.shard_qdp(tcore.initial_qdp(tm))
    states, ps, nstep, md = runner.step(states, 0)
    assert nstep == tm.cfg.rsplit and len(ps) == S
    return runner.gather(states), float(md), runner, counters.snapshot()


@pytest.mark.parametrize("ne,S", [(4, 4), (6, 8)])
@pytest.mark.parametrize("overlap", [False, True])
def test_face_path_matches_jax(ne, S, overlap):
    jcfg = JConfig(ne=ne, **FACE)
    jm = jcore.build_model(jcfg)
    want, jmd = _jax_sharded(jm, S, overlap)
    tm = tcore.build_model(port_config(jcfg), "cpu")
    got, md, runner, c = _port_sharded(tm, S, overlap)
    assert runner.io_layout == "t" and runner.overlap_face == overlap
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)
    assert md == pytest.approx(jmd, rel=1e-12) and md > 0
    # per shard: K7 four times a step plus the six DCMIP 1-1 wind terms at
    # build (counted before the reset), never K4 or K6; with overlap K1
    # runs once more per stage on the boundary group
    assert c["dss_band_plain"] == 4 * 3 * S and c["dss_face_plain"] == 0
    assert c["neighbor_minmax_plain"] == 0
    assert c["minmax_prep_plain"] == 3 * S
    assert c["fused_advect_limit_plain"] == 9 * S * (2 if overlap else 1)


@pytest.mark.parametrize("S", [2, 8])
def test_std_path_matches_jax(S):
    jcfg = JConfig(**STD)
    jm = jcore.build_model(jcfg)
    want, jmd = _jax_sharded(jm, S)
    tm = tcore.build_model(port_config(jcfg), "cpu")
    got, md, runner, c = _port_sharded(tm, S)
    assert runner.io_layout == "std" and not runner.overlap_face
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() < 1e-13 * scale
    assert abs(md - jmd) < 1e-9
    assert c["limiter_optim_plain"] == 9 * S


def test_shard_count_and_overlap_do_not_change_the_bits():
    tm = tcore.build_model(port_config(JConfig(ne=6, **FACE)), "cpu")
    one = _port_sharded(tm, 1)[0]
    assert torch.equal(_port_sharded(tm, 8, overlap=False)[0], one)
    assert torch.equal(_port_sharded(tm, 8, overlap=True)[0], one)
    std = tcore.build_model(port_config(JConfig(**STD)), "cpu")
    assert torch.equal(_port_sharded(std, 8)[0], _port_sharded(std, 1)[0])


@pytest.mark.parametrize("ne,S", [(4, 4), (6, 8)])
def test_t_gather_path_matches_single_device(ne, S):
    """The default (overlap off on the gather path), then overlap on (the
    boundary-first split), each bitwise equal to one device.  Per shard
    and subcycle K1 runs once a stage, twice with the split (boundary
    group, interior), K2 once a step and K3 once; the DSS and the bounds
    are plain gathers."""
    tm = tcore.build_model(port_config(JConfig(ne=ne, **GATHER)), "cpu")
    single = tcore.make_subcycle_fn(tm)(tcore.initial_qdp(tm), 0)
    for overlap in (None, True):
        got, md, runner, c = _port_sharded(tm, S, overlap=overlap)
        split = overlap is True
        assert (0 < runner.plan.nbound < runner.plan.eloc) if split \
            else runner.plan.nbound == 0
        assert c["fused_advect_limit_plain"] == 9 * S * (2 if split else 1)
        assert c["laplace_wk_t_plain"] == 3 * S
        assert c["remap_q_ppm_t_plain"] == S
        assert sum(v for k, v in c.items() if not k.endswith("_plain")) == 0
        assert c["dss_band_plain"] == c["dss_face_plain"] == 0
        assert c["minmax_prep_plain"] == c["neighbor_minmax_plain"] == 0
        assert torch.equal(got, single[0])
        assert md == float(single[3])


@pytest.mark.parametrize("ne,S", [(4, 4), (6, 8)])
def test_gather_split_matches_jax(ne, S):
    jcfg = JConfig(ne=ne, **GATHER)
    jm = jcore.build_model(jcfg)
    want, jmd = _jax_sharded(jm, S)          # the JAX default: the split
    tm = tcore.build_model(port_config(jcfg), "cpu")
    got, md, runner, c = _port_sharded(tm, S, overlap=True)
    assert runner.io_layout == "t" and not runner.overlap_face
    assert 0 < runner.plan.nbound < runner.plan.eloc
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)
    assert md == pytest.approx(jmd, rel=1e-12) and md > 0


def test_gather_split_exchanges_beside_the_interior(monkeypatch):
    """In every split stage of every shard the boundary group's halo
    exchange starts after K1 on the boundary group and is waited for only
    after K1 on the interior has been issued."""
    tm = tcore.build_model(port_config(JConfig(ne=4, **GATHER)), "cpu")
    log = {}
    k1 = tcore.fused_advect_limit
    start = ThreadComm.exchange_start

    def note(event):
        log.setdefault(threading.current_thread().name, []).append(event)

    def k1_noted(Qt, *a, **k):
        note(Qt.shape[0])
        return k1(Qt, *a, **k)

    def start_noted(self, *a):
        finish = start(self, *a)
        note("start")

        def finish_noted():
            note("finish")
            return finish()
        return finish_noted
    monkeypatch.setattr(tcore, "fused_advect_limit", k1_noted)
    monkeypatch.setattr(ThreadComm, "exchange_start", start_noted)
    got, md, runner, c = _port_sharded(tm, 4, overlap=True)
    nb, el = runner.plan.nbound, runner.plan.eloc
    assert 0 < nb < el and nb != el - nb
    want = [nb, "start", el - nb, "finish"]
    for name in (f"shard-{r}" for r in range(4)):
        ev = log[name]
        assert el not in ev
        at = [j for j, e in enumerate(ev) if e == nb]
        assert len(at) == 9
        assert all(ev[j:j + 4] == want for j in at), ev


def test_failing_shard_fails_the_run():
    comm = ThreadComm(4, timeout=COMM_TIMEOUT)
    x = torch.zeros(3)

    def body(rank):
        if rank == 2:
            raise ValueError("shard 2 broke")
        return comm.min(rank, x.sum())
    with pytest.raises(ValueError, match="shard 2 broke"):
        comm.run(body)
    # the communicator runs again after a failure
    assert comm.run(lambda r: float(comm.min(r, torch.tensor(float(r))))) \
        == [0.0] * 4


def test_launch_counts_under_threads():
    """Shards count their launches into one table: under a short switch
    interval, more threads than cores lose no update."""
    n_threads, per = 4 * (os.cpu_count() or 1), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        counters.reset()
        threads = [threading.Thread(target=lambda: [
            counters.bump("dss_band") for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counters.snapshot()["dss_band"] == n_threads * per

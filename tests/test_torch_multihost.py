"""The sharded subcycle over processes (`DistComm`, one shard per process,
torch.distributed on gloo) == the same over threads of one process
(`ThreadComm`), bitwise, and a restart written by one resumes exactly in
the other (the JAX package's tests/test_multihost.py, for the port).

The test runs this file as its worker in two processes:

    python tests/test_torch_multihost.py RANK WORLD PORT OUTDIR MODE

MODE "run" runs two subcycles and writes the state after the first as a
restart file and after the second as numpy; "resume" reads a restart and
runs one subcycle; "gather" runs two subcycles of the T-layout gather path
with overlap on (boundary-first element order, each stage split into K1 on
the boundary group and K1 on the interior, the halo rounds fed by the
boundary group alone, started before the interior's K1 and waited for
after it) and writes the state as numpy.  The worker imports
only the port.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
SUBPROCESS_TIMEOUT = 300


def _config(mode="run"):
    from transport_se_tpu_torch.config import Config
    dss = dict(dss_mode="gather", elem_order="gilbert") if mode == "gather" \
        else dict(dss_mode="face", elem_order="raster")
    return Config(ne=4, nlev=8, qsize=2, tstep=1200.0, vcoord="dcmip8",
                  test_case="dcmip1-1", nu_q=6e16, nmax=6, dtype="f64",
                  use_pallas=True, **dss)


def _subcycles(runner, Qdp, nstep, n, gather):
    """n subcycles from the std-layout Qdp -> [(Qdp', nstep')] after each."""
    states = runner.shard_qdp(Qdp)
    out = []
    for _ in range(n):
        states, _, nstep, _ = runner.step(states, nstep)
        out.append((gather(states), nstep))
    return out


def worker(rank, world, port, outdir, mode):
    from transport_se_tpu_torch.io import restart
    from transport_se_tpu_torch.model import core
    from transport_se_tpu_torch.parallel import multihost
    from transport_se_tpu_torch.parallel.comm import DistComm
    from transport_se_tpu_torch.parallel.sharded import make_sharded_subcycle
    torch.set_num_threads(1)
    dev = multihost.init(f"tcp://localhost:{port}", world, rank, "cpu")
    m = core.build_model(_config(mode), dev)
    runner = make_sharded_subcycle(m, DistComm(),
                                   overlap=True if mode == "gather" else None)

    def gather(states):
        return multihost.gather_canonical(runner, states)
    if mode == "gather":
        assert 0 < runner.plan.nbound < runner.plan.eloc
        (_, (final, _)) = _subcycles(runner, core.initial_qdp(m), 0, 2,
                                     gather)
        if rank == 0:
            np.save(os.path.join(outdir, "gather.npy"), final.numpy())
    elif mode == "run":
        (mid, n1), (final, _) = _subcycles(runner, core.initial_qdp(m), 0, 2,
                                           gather)
        if rank == 0:
            restart.write_restart(os.path.join(outdir, "R0001"), m,
                                  mid.numpy(), np.zeros((m.lon.shape[0], 4,
                                                         4)), n1)
            np.save(os.path.join(outdir, "final.npy"), final.numpy())
    else:
        st = restart.read_restart(os.path.join(outdir, "R0001"))
        Qdp, _, n0 = restart.resume(st, m, 1)
        ((final, _),) = _subcycles(runner, Qdp, n0, 1, gather)
        if rank == 0:
            np.save(os.path.join(outdir, "final2.npy"), final.numpy())
    torch.distributed.destroy_process_group()


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(outdir, mode):
    env = dict(os.environ, PYTHONPATH=ROOT)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(NPROC),
         str(port), str(outdir), mode], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(NPROC)]
    try:
        outs = [p.communicate(timeout=SUBPROCESS_TIMEOUT)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


def test_two_processes_bitwise_and_resume(tmp_path):
    from transport_se_tpu_torch.io import restart
    from transport_se_tpu_torch.model import core
    from transport_se_tpu_torch.parallel.comm import ThreadComm
    from transport_se_tpu_torch.parallel.sharded import make_sharded_subcycle
    torch.set_num_threads(1)
    m = core.build_model(_config(), "cpu")
    runner = make_sharded_subcycle(m, ThreadComm(NPROC, timeout=120))
    (mid, n1), (final, _) = _subcycles(runner, core.initial_qdp(m), 0, 2,
                                       runner.gather)
    # 2 processes x 1 shard against 1 process x 2 shards
    _launch(tmp_path, "run")
    assert np.array_equal(np.load(tmp_path / "final.npy"), final.numpy()), \
        "the process count changed the bits"
    st = restart.read_restart(str(tmp_path / "R0001"))
    assert st.nstep == n1 and np.array_equal(st.Qdp, mid.numpy())
    # the threads' mid-state, resumed by the processes, lands on the
    # threads' final state
    restart.write_restart(str(tmp_path / "R0001"), m, mid.numpy(),
                          st.ps_v, n1)
    _launch(tmp_path, "resume")
    assert np.array_equal(np.load(tmp_path / "final2.npy"), final.numpy()), \
        "resume across process counts is not exact"


def test_two_processes_gather_overlap_bitwise(tmp_path):
    """The gather path's boundary-first split over 2 gloo processes gives
    the bits of the same split over 2 threads."""
    from transport_se_tpu_torch import counters
    from transport_se_tpu_torch.model import core
    from transport_se_tpu_torch.parallel.comm import ThreadComm
    from transport_se_tpu_torch.parallel.sharded import make_sharded_subcycle
    torch.set_num_threads(1)
    m = core.build_model(_config("gather"), "cpu")
    runner = make_sharded_subcycle(m, ThreadComm(NPROC, timeout=120),
                                   overlap=True)
    assert 0 < runner.plan.nbound < runner.plan.eloc
    counters.reset()
    (_, (final, _)) = _subcycles(runner, core.initial_qdp(m), 0, 2,
                                 runner.gather)
    # K1 twice a stage on each shard: the split ran
    assert counters.snapshot()["fused_advect_limit_plain"] == \
        2 * 2 * 9 * NPROC
    _launch(tmp_path, "gather")
    assert np.array_equal(np.load(tmp_path / "gather.npy"), final.numpy()), \
        "the process count changed the bits of the split"


if __name__ == "__main__":
    r, w, p, d, mode = sys.argv[1:6]
    worker(int(r), int(w), int(p), d, mode)

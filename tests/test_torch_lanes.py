"""Lane independence of the face T subcycle, on the CPU through the plain
versions.

Every kernel of the face T path computes each lane (tracer, level) of an
element column from that lane alone, the level's dp and the winds: the
tracer count changes only how many lanes there are.  So tracers 0-1 of a
6-tracer subcycle equal a 2-tracer subcycle bit for bit
(`dcmip.initial_tracer_fields` gives tracers 0-1 the same fields for any
qsize >= 2).  chip_smoke.py phase 20 rests on this: on the card it holds
the first two tracers of NE120's 35-tracer run, whose offsets pass 2^31
and whose plain versions do not fit the card, to a 2-tracer run that the
plain versions check.
"""

import dataclasses

import pytest
import torch

from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model import core

torch.set_num_threads(1)

# ne = 4 face T path, DCMIP 1-1 (tracers 0-1 are its q1 and q2); f32 with
# the production limiter cap, f64 uncapped as the verification runs it
CFG = Config(ne=4, nlev=16, qsize=2, tstep=1200.0, vcoord="dcmip16",
             test_case="dcmip1-1", nu_q=6e16, nmax=6, dtype="f64",
             use_pallas=True, disable_diagnostics=True, dss_mode="face",
             elem_order="raster")
CAP = {"f32": 4, "f64": 0}
SUBCYCLES = 2


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_first_two_tracers_do_not_depend_on_the_tracer_count(dtype):
    out = {}
    for qsize in (2, 6):
        cfg = dataclasses.replace(CFG, dtype=dtype, qsize=qsize,
                                  limiter_iter_cap=CAP[dtype])
        m = core.build_model(cfg, "cpu")
        step = core.make_subcycle_fn(m, io_layout="t")
        Q0 = core.initial_qdp_t(m)
        box, nstep, mds = [Q0.clone()], 0, []
        for _ in range(SUBCYCLES):
            box[0], _, nstep, md = step(box, nstep)
            mds.append(float(md))
        E = m.lon.shape[0]
        out[qsize] = (box[0].reshape(E, 16, qsize, cfg.nlev), mds,
                      Q0.reshape(E, 16, qsize, cfg.nlev))
    (two, md2, q2), (six, md6, q6) = out[2], out[6]
    assert torch.equal(q6[:, :, :2], q2)
    assert md2 == md6 and min(md2) > 0
    assert torch.equal(six[:, :, :2], two)
    # the run moved every tracer
    assert torch.isfinite(six).all()
    assert all(not torch.equal(six[:, :, i], q6[:, :, i]) for i in range(6))

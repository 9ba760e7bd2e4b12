"""The lane kernels (csrc/lanes.cu) == their plain PyTorch versions, and the
T subcycle's group plan == the ungrouped subcycle, on the card.

Needs a CUDA device and nvcc; skips elsewhere.  Imports no JAX, so on the
GPU machine it runs without the JAX package's test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_lanes.py
"""

import pytest
import torch

from transport_se_tpu_torch import counters
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model import core
from transport_se_tpu_torch.ops import lanes

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(a):
    return a.view(torch.int32 if a.element_size() == 4 else torch.int64)


def _both(x, lo, width):
    """(kernel, plain) of a gather, then of a scatter into a state of
    -1s, each asserted bit for bit equal."""
    counters.reset()
    g = lanes.lane_gather(x, lo, width)
    assert torch.equal(_bits(g), _bits(lanes.lane_gather_plain(x, lo,
                                                               width)))
    y_k = torch.full_like(x, -1.0)
    y_p = y_k.clone()
    lanes.lane_scatter(g, y_k, lo)
    lanes.lane_scatter_plain(g, y_p, lo)
    assert torch.equal(_bits(y_k), _bits(y_p))
    c = counters.snapshot()
    assert c["lane_gather_t"] == c["lane_scatter_t"] == 1


# (E, L, lo, width): 16-byte vectors at nlev 72; single values where the
# offset, stride or width is not a multiple of 16 bytes (nlev 5)
CASES = {"nlev72": (100, 35 * 72, 8 * 72, 9 * 72),
         "first": (100, 35 * 72, 0, 7 * 72),
         "all": (37, 4 * 72, 0, 4 * 72),
         "nlev5": (100, 7 * 5, 2 * 5, 3 * 5),
         "one_value": (3, 3, 1, 1)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_lane_kernels_bitwise(cuda, dtype, case):
    E, L, lo, width = CASES[case]
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((E, 16, L), generator=g, device=cuda,
                    dtype=DTYPES[dtype])
    _both(x, lo, width)


def test_lane_kernels_past_2_31_values(cuda):
    """A state of 86,400 x 16 x 1,560 f32 values (2.16e9, past 2^31, as
    NE120's 35-tracer state is): the last 7 tracers' lanes, whose offsets
    pass 2^31 in the last rows."""
    E, L = 86400, 1560
    assert E * 16 * L > 2**31
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((E, 16, L), generator=g, device=cuda,
                    dtype=torch.float32)
    width = 7 * 72
    _both(x, L - width, width)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_grouped_subcycle_on_the_card(cuda, dtype):
    """ne = 4 face T path, 5 tracers: forced groups through the kernels
    bit for bit against the ungrouped subcycle, two subcycles."""
    cap = {"f32": 4, "f64": 15}[dtype]
    cfg = Config(ne=4, nlev=16, qsize=5, tstep=1200.0, vcoord="dcmip16",
                 test_case="dcmip1-1", nu_q=6e16, dtype=dtype,
                 disable_diagnostics=True, dss_mode="face",
                 elem_order="raster", use_pallas=True, limiter_iter_cap=cap)
    m = core.build_model(cfg, cuda)
    Q0 = core.initial_qdp_t(m)
    one = core.make_subcycle_fn(m, io_layout="t")
    assert one.groups == [5]
    grouped = core.make_subcycle_fn(m, io_layout="t", groups=[2, 2, 1])
    a, b, na, nb = Q0.clone(), Q0.clone(), 0, 0
    for _ in range(2):
        a, _, na, ma = one([a], na)
        counters.reset()
        b, _, nb, mb = grouped([b], nb)
        c = counters.snapshot()
        assert c["lane_gather_t"] == c["lane_scatter_t"] == 3
        assert c["lane_gather_t_plain"] == 0
        assert torch.equal(_bits(a), _bits(b)) and float(ma) == float(mb)
    kept = Q0.clone()
    k = grouped(kept, 0)[0]
    assert torch.equal(_bits(kept), _bits(Q0))
    assert torch.equal(_bits(k), _bits(one([Q0.clone()], 0)[0]))

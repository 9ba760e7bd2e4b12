"""The port's benchmark (`python -m transport_se_tpu_torch.bench`), the
counterpart of the repository's `bench.py`, on the CPU at NE8.

* BENCH_NE=8 BENCH_QSIZE=2 BENCH_SUBCYCLES=1 BENCH_PROXY=0 --device cpu,
  on the T-layout path (the default) and on the std-layout path
  (BENCH_PALLAS=0): one JSON line on stdout with bench.py's keys, the work
  of a window by bench.py's formula steps * E * 16 * nlev * qsize, and the
  value the median window's rate, rounded as bench.py rounds it, the
  pooled rate (all windows' work over all their wall) beside it on stderr,
  and the warm-up one window's worth of subcycles, at least 2;
* the BENCH_* variables parse as bench.py parses them, BENCH_EB and
  BENCH_RHS_BF16 are not read;
* a broken state (min_dp <= 0, or not finite) exits 1 and prints no rate;
* --device cuda without a card exits non-zero and prints nothing on
  stdout.
"""

import json
import os
import re
import signal
import statistics
import subprocess
import sys

import pytest
import torch

from transport_se_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_LIMIT = 300          # seconds per test
BASE_KEYS = {"metric", "value", "unit", "vs_baseline"}
SMALL = dict(BENCH_NE="8", BENCH_QSIZE="2", BENCH_SUBCYCLES="1",
             BENCH_PROXY="0")


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran over its {TIME_LIMIT} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def small_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield monkeypatch
    torch.set_num_threads(threads)


@pytest.mark.parametrize("pallas", ["1", "0"])
def test_bench_cpu_ne8(small_env, capsys, pallas):
    small_env.setenv("BENCH_PALLAS", pallas)
    assert bench.main(["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == BASE_KEYS
    assert out["metric"] == "NE8 2-tracer gridpoint-tracers/s per chip"
    assert out["unit"] == "gridpoint-tracers/s"
    # bench.py's work: steps * E * 16 * nlev * qsize, 1 subcycle = 3 steps
    work = 1 * 3 * (6 * 8 * 8) * 16 * 72 * 2
    row = re.search(r"work (\d+) gridpoint-tracers a window", cap.err)
    assert int(row.group(1)) == work
    hosts = [float(h) / 1e3 for h in re.findall(
        r"window \d: events n/a ms/subcycle, host (\S+) ms/subcycle", cap.err)]
    assert len(hosts) == bench.WINDOWS
    rate = statistics.median(work / h for h in hosts)
    assert out["value"] == round(rate / 1e9, 4) * 1e9
    assert out["vs_baseline"] == round(rate / bench.BASELINE, 4)
    pooled = float(re.search(r"pooled (\S+) gridpoint", cap.err).group(1))
    assert pooled == pytest.approx(work * len(hosts) / sum(hosts), rel=1e-9)
    assert "after 2 warm-up subcycles" in cap.err
    assert "min_dp" in cap.err and "finite True" in cap.err
    # the row's launches: K1 (T path) or K10 (std path), plain here
    launched = "fused_advect_limit_plain 27" if pallas == "1" else \
        "limiter_optim_plain 27"
    assert launched in cap.err
    # the limiter counted over one subcycle after the windows: 9 stages of
    # every (element, lane) column of K1 (cap 4) or (element, tracer,
    # level) row of the row limiter K10 (15 passes)
    rows = 9 * 6 * 8 * 8 * 2 * 72
    counted = re.search(r"\((K1|K10), one subcycle after the windows\): "
                        r"\S+ passes a (column|row), \S+% capped; "
                        r"limiter_passes (\d+), limiter_rows (\d+)", cap.err)
    kernel, row, cap_ = (("K1", "column", 4) if pallas == "1"
                         else ("K10", "row", 15))
    assert counted.group(1, 2) == (kernel, row)
    assert int(counted.group(4)) == rows
    assert rows <= int(counted.group(3)) <= cap_ * rows


def test_settings_parse_as_bench_py():
    assert bench.settings({}) == dict(ne=30, qsize=35, subcycles=24,
                                      pallas=True, limcap=0, proxy=True)
    st = bench.settings(dict(BENCH_NE="42", BENCH_QSIZE="4",
                             BENCH_SUBCYCLES="8", BENCH_PALLAS="off",
                             BENCH_LIMCAP="6", BENCH_PROXY="",
                             BENCH_EB="16", BENCH_RHS_BF16="1"))
    assert st == dict(ne=42, qsize=4, subcycles=8, pallas=False, limcap=6,
                      proxy=False)
    cfg = bench.bench_config(42, 4, True, 6)
    assert (cfg.ne, cfg.qsize, cfg.tstep, cfg.nu_q, cfg.dtype,
            cfg.limiter_iter_cap, cfg.dss_mode, cfg.use_pallas) == \
        (42, 4, 75.0, 1e13, "f32", 6, "face", True)
    assert bench.bench_config(30, 35, True, 0).limiter_iter_cap == 4


@pytest.mark.parametrize("min_dp,finite", [(-1.0, True), (5.0, False)])
def test_broken_state_gives_no_rate(small_env, capsys, monkeypatch, min_dp,
                                    finite):
    monkeypatch.setattr(bench, "measure", lambda *a: dict(
        E=384, work=1, windows=[(1.0, None)] * 3, rates=[1.0] * 3,
        value=1.0, pooled=1.0, min_dp=min_dp, finite=finite, launches={}))
    assert bench.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "a broken state gives no rate" in cap.err


def test_cuda_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "transport_se_tpu_torch.bench",
                        "--device", "cuda"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT, **SMALL))
    assert p.returncode != 0 and p.stdout == ""
    assert "torch.cuda.is_available() is false" in p.stderr

"""The port's profiling helpers (utils/profiling.py) against the JAX package's.

``cost_report`` with the JAX package's constants (``hbm_bw=819e9``; its byte
rules, ``JAX_TRAFFIC``, in place of the module's ``_TRAFFIC``) must equal
JAX's ``cost_report`` node by node (kind, n, bytes, FLOPs, roofline) when
JAX's level bytes are those of plain (n, n) levels: JAX's
``ops.layout.padded_shape`` is monkeypatched to ``(n, n)`` inside the test
(nothing in the JAX package changes). With the port's defaults a fused leg at
4097² costs PERF.md §6's bound for kernels 3 and 4, 0.0651 ms (u and f read,
u written, the coarse level once), and one more 8-sweep chunk at 8193² costs
kernel 1's, 0.2404 ms.

``DeviceTimer`` and ``trace`` run on the CPU here: the timer must return
finite positive seconds, and ``trace`` must write a Chrome trace JSON.
"""

import json
import math

import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu.ops import layout as jlayout
from multigrid_poisson_solver_tpu.utils import profiling as jprof
from multigrid_poisson_solver_tpu_torch.convert import program_from_jax
from multigrid_poisson_solver_tpu_torch.schedule import (
    Ascend, CoarseSolve, Descend, parse_cycle_path,
)
from multigrid_poisson_solver_tpu_torch.utils import profiling as tprof

PROGRAMS = {
    "v_cycle": lambda m: m.v_cycle(4097, n_min=8, steps=3, coarse_option=0, coarsen=3),
    "w_cycle": lambda m: m.w_cycle(257, n_min=8, steps=2),
    "fmg": lambda m: m.fmg(129, n_min=8, steps=2),
    "trigger": lambda m: m.v_cycle(1025, n_min=5, steps=-1, coarsen=2),
    "deep_sweeps": lambda m: m.v_cycle(8193, n_min=8, steps=20, coarse_option=1, coarsen=3),
}


# JAX's byte rules (utils/profiling.py:150-210): smoothing chunks times the
# Pallas strips' 1.35, the residual and restriction as (3 fine + 2 coarse
# levels) twice, the prolongation as 2 fine levels twice, every level read
JAX_TRAFFIC = {"overhead": 1.35, "descend": (6, 4), "descend_no_sweeps": (6, 4),
               "ascend": (4, 0), "ascend_no_sweeps": (4, 0), "zero_u": 0}


@pytest.fixture
def plain_levels(monkeypatch):
    monkeypatch.setattr(jlayout, "padded_shape", lambda n: (n, n))


@pytest.mark.parametrize("name", list(PROGRAMS) + ["Vcycle.txt", "VcycleTrigger.txt",
                                                   "Wcycle.txt"])
def test_cost_report_equals_jax_node_by_node(plain_levels, monkeypatch, name):
    if name.endswith(".txt"):
        jprog = jmg.parse_cycle_path(f"schedules/{name}")
        prog = parse_cycle_path(f"schedules/{name}")
    else:
        jprog, prog = PROGRAMS[name](jmg), PROGRAMS[name](tmg)
    assert prog == program_from_jax(jprog)
    want = jprof.cost_report(jprog)
    monkeypatch.setattr(tprof, "_TRAFFIC", JAX_TRAFFIC)
    got = tprof.cost_report(prog, hbm_bw=819e9)
    assert len(got.nodes) == len(want.nodes) == len(prog.instructions)
    for g, w in zip(got.nodes, want.nodes):
        assert (g.kind, g.n, g.hbm_bytes, g.flops, g.roofline_s) == \
            (w.kind, w.n, w.hbm_bytes, w.flops, w.roofline_s)
    assert (got.total_bytes, got.total_flops, got.roofline_s) == \
        (want.total_bytes, want.total_flops, want.roofline_s)
    assert got.summary() == want.summary()


def _ms(nodes):
    return [f"{c.roofline_s * 1e3:.4f}" for c in nodes]


def test_kernel1_bound_at_8193_is_perf_md_s6():
    """A 16-pre-sweep descend at 8193² is kernel 1's 8-sweep pass and the
    8-sweep leg: the pass adds u and f read and u written once, 12 B a point
    over 3.35 TB/s."""
    def descend_ms(steps):
        prog = tmg.CycleProgram(1.0, 0.0, 0.0, 8193, (Descend(next_n=4097, steps=steps),))
        return tprof.cost_report(prog).nodes[0].roofline_s * 1e3

    extra = descend_ms(16) - descend_ms(8)
    assert f"{extra:.4f}" == "0.2404"
    assert extra == pytest.approx(12 * 8193 ** 2 / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize("n,bound_ms", [(4097, "0.0651"), (8193, "0.2605")])
def test_fused_legs_are_perf_md_s6(n, bound_ms):
    """Kernels 3 and 4 at 3 sweeps (PERF.md §6): u and f read, u written and
    the coarse level written (descend) or read (ascend) once, 3.25 levels. A
    correction level's first descend starts from u ≡ 0 and does not read u."""
    m = (n + 1) // 2
    prog = tmg.CycleProgram(1.0, 0.0, 0.0, n, (
        Descend(next_n=m, steps=3), Descend(next_n=(m + 1) // 2, steps=3),
        CoarseSolve(target_error=1e-8, option=0), Ascend(steps=3), Ascend(steps=3)))
    nodes = tprof.cost_report(prog).nodes
    assert [c.kind for c in nodes] == ["descend", "descend", "coarse", "ascend", "ascend"]
    assert _ms([nodes[0], nodes[4]]) == [bound_ms, bound_ms]
    level = 4 * n * n
    assert nodes[0].hbm_bytes == nodes[4].hbm_bytes == 3 * level + 4 * m * m
    assert nodes[1].hbm_bytes == 2 * 4 * m * m + 4 * ((m + 1) // 2) ** 2   # from zero
    assert nodes[3].hbm_bytes == 3 * 4 * m * m + 4 * ((m + 1) // 2) ** 2


def test_cost_report_port_defaults_scale_jax_bytes(monkeypatch):
    """The port's fused legs move fewer bytes than JAX's unfused transfers at
    every node of a V(3,3), a W-cycle and an FMG, with the same FLOPs, and the
    V(3,3) at 4097² sums its nodes as the legs do."""
    for name in ("v_cycle", "w_cycle", "fmg", "trigger"):
        prog = PROGRAMS[name](tmg)
        port = tprof.cost_report(prog)
        with monkeypatch.context() as m:
            m.setattr(tprof, "_TRAFFIC", JAX_TRAFFIC)
            jax_like = tprof.cost_report(prog, hbm_bw=3.35e12)
        for a, b in zip(port.nodes, jax_like.nodes):
            assert a.flops == b.flops and a.kind == b.kind and a.n == b.n
            assert a.hbm_bytes <= b.hbm_bytes if a.kind == "coarse" else \
                a.hbm_bytes < b.hbm_bytes
            assert a.roofline_s == a.hbm_bytes / 3.35e12
    # 4097² → 9²: the finest legs 3.25 levels each, a correction level's
    # descend 2.25 (from zero) and its ascend 3.25, the coarse solve 2
    sizes = [4097, 2049, 1025, 513, 257, 129, 65, 33, 17, 9]
    lv = [4 * s * s for s in sizes]
    want = 2 * (3 * lv[0] + lv[1]) + 2 * lv[-1] + sum(
        (2 * lv[i] + lv[i + 1]) + (3 * lv[i] + lv[i + 1]) for i in range(1, len(sizes) - 1))
    assert tprof.cost_report(PROGRAMS["v_cycle"](tmg)).total_bytes == want


def test_cost_report_fmg_zero_levels():
    """FMG: the restriction of f reads f and writes the coarse f; the first
    ascend onto a level that no sweep has touched does not read its u."""
    prog = tmg.fmg(33, n_min=9, steps=2, coarsen=3)
    nodes = tprof.cost_report(prog).nodes
    assert [c.kind for c in nodes[:4]] == ["descend", "descend", "coarse", "ascend"]
    assert nodes[0].hbm_bytes == 4 * 33 * 33 + 4 * 17 * 17        # f read, coarse f written
    assert nodes[3].hbm_bytes == 4 * 9 * 9 + 2 * 4 * 17 * 17      # no u read


def _work(x):
    return (x @ x).sum()


@pytest.mark.parametrize("method", ["measure", "measure_differential",
                                    "measure_differential_median", "measure_median"])
def test_device_timer_cpu_seconds(method):
    timer = tprof.DeviceTimer()
    x = torch.randn(64, 64)
    out = getattr(timer, method)(_work, x, **({"reps": 2} if "differential" in method else {}))
    t, spread = out if isinstance(out, tuple) else (out, (out, out))
    assert math.isfinite(t) and t > 0
    assert spread[0] <= t <= spread[1]


def test_device_timer_latency_and_sync():
    timer = tprof.DeviceTimer()
    lat = timer.latency
    assert math.isfinite(lat) and lat > 0 and timer.latency == lat     # cached
    assert tprof.sync(torch.tensor([[3.5, 1.0]])) == 3.5
    assert tprof.sync((torch.tensor([2.0]), torch.tensor([9.0]))) == 2.0


def test_trace_writes_chrome_json(tmp_path):
    x = torch.randn(32, 32)
    with tprof.trace(tmp_path / "prof") as prof:
        (x @ x).sum()
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert any("mm" in e.key for e in prof.key_averages())


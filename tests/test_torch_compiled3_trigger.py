"""The trigger tiers of the port's 3-D engine (compile_program3's kernel
route for trigger nodes) against the JAX package's Pallas engine at 65³, the
one size where both packages route trigger nodes to their kernels.

Each tier is engaged in both packages by forcing the same size predicates
off: the whole-loop kernel (``trigger3_fits``), the streamed whole-loop
kernel (``trigger3_stream_fits``), batched passes of the smoother's
per-sweep-error mode (an integer ``trigger_batch``), "auto" (exact sweeps,
then batched passes) and the one-sweep loop. On the CPU the port's kernel
route runs the kernels' twins; JAX's Pallas kernels run in interpret mode.

The trigger, 0.1108, lies between the slopes of the first node's sweeps 20
and 21 (0.11102 / 0.11057), 0.2% from either, far above the fp32 noise of
the errors (~27, an ulp 2e-6); the cap of 30 sweeps ends the other long
nodes. fp32 bounds: those of tests/test_torch_compiled3.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu import compiled3 as jcompiled3
from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.solver3 import Solver3D as JSolver3D
from multigrid_poisson_solver_tpu_torch import compiled3
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid3_from_jax,
                                                        problem3_from_jax_grids,
                                                        program_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3

FP32_U_RTOL, FP32_ERR_RTOL = 5e-5, 1e-3
OMEGA3 = 6.0 / 7.0
TRIGGER, CAP = 0.1108, 30

# the JAX functions a trigger tier reaches, and their port counterparts
TRIGGER_CALLS = {"fused_trigger3_vmem": "trigger_smooth3",
                 "fused_trigger3_stream": "trigger_smooth3_stream",
                 "fused_jacobi3_errs_padded": "fused_jacobi3_errs",
                 "fused_jacobi3_padded": "trigger_step3"}
_BOTH_OFF = ("trigger3_fits", "trigger3_stream_fits")
# tier -> (the predicates forced off in both packages, trigger_batch, the JAX
# functions the tier reaches)
TRIGGER_TIERS = {
    "vmem": ((), "auto", {"fused_trigger3_vmem"}),
    "stream": (("trigger3_fits",), "auto", {"fused_trigger3_stream"}),
    "batch3": (_BOTH_OFF, 3, {"fused_jacobi3_errs_padded"}),
    "auto": (_BOTH_OFF, "auto", {"fused_jacobi3_padded", "fused_jacobi3_errs_padded"}),
    "batch1": (_BOTH_OFF, 1, {"fused_jacobi3_padded"}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spy(monkeypatch, module, name, key, calls):
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls[key] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("tier", list(TRIGGER_TIERS))
def test_compiled3_trigger_tiers_match_jax_pallas(monkeypatch, tier):
    """A trigger V-cycle at 65³ (clean metric) with one tier engaged in both
    packages: the port's kernel route reaches the counterparts of the JAX
    functions JAX's Pallas engine reaches (the whole-loop kernels as many
    times; the traced loops the same set), stops where JAX's interpreted
    engine stops (batched tiers: the first node, the only one whose input is
    the same, overshoots the exact stop by less than a pass), and its
    iterate and error agree with JAX's Pallas engine's."""
    off, batch, reached = TRIGGER_TIERS[tier]
    for name in off:
        monkeypatch.setattr(jp3k, name, lambda *a, **k: False)
        monkeypatch.setattr(K3, name, lambda *a, **k: False)
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: True)
    ours, theirs = dict.fromkeys(TRIGGER_CALLS, 0), dict.fromkeys(TRIGGER_CALLS, 0)
    for jname, pname in TRIGGER_CALLS.items():
        _spy(monkeypatch, jp3k, jname, jname, theirs)
        _spy(monkeypatch, K3, pname, jname, ours)
    jprogram = jmg.v_cycle(65, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(omega=OMEGA3, compat_error=False, trigger=TRIGGER,
                            max_trigger_sweeps=CAP, trigger_batch=batch, kernels="pallas",
                            collect_node_stats=False)
    jcc = jcompiled3.compile_program3(jprogram, jp3.REFERENCE_PROBLEM_3D, jcfg)
    ju, jerr = jcc(*jcc.init())
    cc = tmg.compile_program3(program_from_jax(jprogram),
                              problem3_from_jax_grids(jp3.REFERENCE_PROBLEM_3D),
                              config_from_jax(jcfg), device="cpu")
    cc.trigger_sweeps = []
    u, err = cc(*cc.init())
    assert {k for k, v in theirs.items() if v} == {k for k, v in ours.items() if v} == reached
    if tier in ("vmem", "stream"):
        assert ours == theirs
    # the exact stops: JAX's interpreted engine reports every node's sweeps
    jcfg_x = dataclasses.replace(jcfg, kernels="xla", collect_node_stats=True)
    nodes = JSolver3D(jp3.REFERENCE_PROBLEM_3D, jcfg_x).run(jprogram).nodes
    exact = [(nd.n, nd.steps) for nd in nodes if nd.kind in ("descend", "ascend")]
    if tier in ("batch3", "auto"):
        b = batch if tier == "batch3" else K3.errs3_sweep_cap("clean")
        warm = 0 if tier == "batch3" else 2 * b
        (n0, k), (_, k1) = cc.trigger_sweeps[0], exact[0]
        assert n0 == 65 and k1 > warm and (k - warm) % b == 0 and k1 <= k < k1 + b
    else:
        assert cc.trigger_sweeps == exact
    ju = grid3_from_jax(ju, 65)
    assert float((u - ju).abs().max()) <= FP32_U_RTOL * float(ju.abs().max())
    assert float(err) == pytest.approx(float(jerr), rel=FP32_ERR_RTOL)
    assert np.isfinite(float(err))

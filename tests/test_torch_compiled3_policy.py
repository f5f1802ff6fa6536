"""compile_program3(..., policy=ZShardingPolicy3) of the port against the JAX
package's (compiled3.py under parallel/pallas_shard3.py's policy).

The same CycleProgram walk on a z-plane mesh: at 65³ on 8 shards the finest
level shards (JAX's depth 80, 10 planes a device) and 33³ down replicate.
Each program runs on the port's CPU mesh of 8 shards with the kernel routing
(its shard-mode twins) and is held

  * against JAX's compile_program3(policy=...) on its 8-device CPU mesh
    (Pallas in interpret mode) on JAX's own fp32 problem grids
    (convert.problem3_from_jax_grids), with tests/test_torch_compiled3.py's
    bounds: iterates |Δu| ≤ 5e-5·max|u| (the Pallas sweep folds the update
    into another form), error scalars 1e-4 relative (the bound
    tests/test_compiled3_policy.py holds JAX's sharded and unsharded errors
    to);
  * bit for bit against the port's unsharded engine (iterates; errors the
    unsharded one's but for the order of a float64 sum: 1e-6 relative), and
    with equal stop sweeps per level on the trigger programs;
  * for the routes it takes, by the shard modes it calls.

One exception, JAX's own: with an integer trigger_batch > 1 a sharded level
runs one exact sweep, then batched passes from its error
(``compiled3.py:294-296``), where the unsharded engine
batches from the first sweep; that program is held against JAX's and
against the same composition on the unsharded twins.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
from multigrid_poisson_solver_tpu import compiled3 as jcompiled3
from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.parallel import pallas_shard3 as jps3
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch import compiled, compiled3
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid3_from_jax,
                                                        policy3_from_jax, problem3_from_jax_grids,
                                                        program_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
from multigrid_poisson_solver_tpu_torch.parallel.mesh import ZShardingPolicy3, make_mesh_z

U_RTOL, ERR_RTOL = 5e-5, 1e-4
NEAR_TIE_ERR_RTOL = 1e-2
OMEGA3 = 6.0 / 7.0
N = 65


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jpolicy():
    return jps3.ZShardingPolicy3(jps3.make_mesh_z(jax.devices()))


@pytest.fixture
def kernel_routing(monkeypatch):
    """The engine's kernel path on CPU tensors (the twins), as on the card."""
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: cfg.kernels != "torch")


PROGRAMS = {
    "v": ("v_cycle", dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3), {}),
    "w": ("w_cycle", dict(n_min=5, steps=2, coarse_target=1e-8, coarsen=3), {}),
    "fmg": ("fmg", dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3), {}),
    "gpu": ("v_cycle", dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3),
            {"compat_error": "gpu"}),
    "trigger1": ("v_cycle", dict(n_min=5, steps=-1, coarse_target=1e-8, coarsen=3),
                 {"trigger": 1e-3, "max_trigger_sweeps": 30}),
    "xla": ("v_cycle", dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3),
            {"kernels": "xla"}),
}


def _jcfg(**kw):
    kw.setdefault("omega", OMEGA3)
    kw.setdefault("kernels", "pallas")
    kw.setdefault("collect_node_stats", False)
    return jmg.SolverConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_run(key, jpolicy):
    maker, kw, cfg = PROGRAMS[key]
    program = getattr(jmg, maker)(N, **kw)
    with jpolicy.mesh:
        cc = jcompiled3.compile_program3(program, jp3.REFERENCE_PROBLEM_3D, _jcfg(**cfg),
                                         policy=jpolicy)
        u, err = cc(*cc.init())
    return grid3_from_jax(u, N), float(err)


def _port_cc(key, policy, trigger_batch=None):
    maker, kw, cfg = PROGRAMS[key]
    jprogram = getattr(jmg, maker)(N, **kw)
    ours = config_from_jax(_jcfg(**cfg))
    if trigger_batch is not None:
        ours = dataclasses.replace(ours, trigger_batch=trigger_batch)
    cc = tmg.compile_program3(program_from_jax(jprogram),
                              problem3_from_jax_grids(jp3.REFERENCE_PROBLEM_3D), ours,
                              device="cpu", policy=policy)
    cc.trigger_sweeps = []
    return cc


def _run(cc):
    u, err = cc(*cc.init())
    return cc.unpad(u), err


# trigger_pass3_shard is kernel 10's shard mode too (one sweep, the clean
# error of its input)
ROUTED = {"fused_jacobi3_shard": "jacobi3_shard", "trigger_pass3_shard": "jacobi3_shard",
          "fused_jacobi3_errs_shard": "jacobi3_errs_shard",
          "fused_descend3_shard": "descend3_shard", "fused_ascend3_shard": "ascend3_shard",
          "residual3_shard": "residual3_shard", "fused_jacobi3_residual_shard": "10r",
          "fused_descend3": "descend3", "fused_ascend3": "ascend3",
          "trigger_smooth3": "trigger3"}


def _spy_routes(monkeypatch):
    calls = dict.fromkeys(ROUTED.values(), 0)
    for name, key in ROUTED.items():
        fn = getattr(K3, name)
        monkeypatch.setattr(K3, name, lambda *a, _f=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **kw))[1])
    return calls


def _routes(**want):
    return {k: want.get(k, 0) for k in ROUTED.values()}


@pytest.mark.parametrize("key,want", [
    # clean: both legs per shard at 65³; the last ascend fuses the error
    ("v", _routes(descend3_shard=8, ascend3_shard=8)),
    ("w", _routes(descend3_shard=8, ascend3_shard=8)),
    # FMG: its interpolation into 65³ is an ascend leg too
    ("fmg", _routes(descend3_shard=8, ascend3_shard=16)),
    # the gpu metric: smoother passes with the error, the sharded residual
    # before the restriction
    ("gpu", _routes(jacobi3_shard=16, residual3_shard=8)),
    # a trigger node: the one-sweep sharded error loop (30 sweeps a node at
    # 65³, down and up, the clean error one sweep behind: 31 passes); 33³
    # down replicate on their own tiers
    ("trigger1", _routes(jacobi3_shard=2 * 31 * 8, residual3_shard=8)),
    # no kernels: parallel.halo3's plain per-shard ops
    ("xla", _routes()),
])
def test_policy_program_matches_jax_and_unsharded(jpolicy, kernel_routing, monkeypatch, key,
                                                   want):
    policy = policy3_from_jax(jpolicy)
    assert policy.is_sharded(N) and not policy.is_sharded(33)
    calls = _spy_routes(monkeypatch)
    sharded = _port_cc(key, policy)
    got, gerr = _run(sharded)
    assert calls == want
    ju, jerr = _jax_run(key, jpolicy)
    assert float((got - ju).abs().max()) <= U_RTOL * float(ju.abs().max())
    assert float(gerr) == pytest.approx(jerr, rel=ERR_RTOL)
    single = _port_cc(key, None)
    su, serr = _run(single)
    assert torch.equal(got, su)
    assert float(gerr) == pytest.approx(float(serr), rel=1e-6)
    assert sharded.trigger_sweeps == single.trigger_sweeps


@pytest.mark.parametrize("batch", ["auto", 4])
def test_sharded_trigger_batch(jpolicy, kernel_routing, monkeypatch, batch):
    """With the whole-loop tiers masked (as tests/test_compiled3_policy.py
    masks them) a sharded trigger node batches: "auto" takes 2B exact
    sweeps, then per-sweep passes, and stops where the unsharded engine
    stops; an integer batch takes one exact sweep, then passes from its
    error (JAX's sharded form), against JAX's run and against that
    composition on the unsharded twins."""
    for mod in (jp3k, K3):
        monkeypatch.setattr(mod, "trigger3_fits", lambda *a, **k: False)
        monkeypatch.setattr(mod, "trigger3_stream_fits", lambda *a, **k: False)
    calls = _spy_routes(monkeypatch)
    jprogram = jmg.v_cycle(N, n_min=5, steps=-1, coarse_target=1e-8, coarsen=3)
    jcfg = _jcfg(trigger=1e-3, trigger_batch=batch, max_trigger_sweeps=40)
    with jpolicy.mesh:
        cc = jcompiled3.compile_program3(jprogram, jp3.REFERENCE_PROBLEM_3D, jcfg,
                                         policy=jpolicy)
        ju, jerr = cc(*cc.init())
    ju = grid3_from_jax(ju, N)

    def port(policy):
        pc = tmg.compile_program3(program_from_jax(jprogram),
                                  problem3_from_jax_grids(jp3.REFERENCE_PROBLEM_3D),
                                  config_from_jax(jcfg), device="cpu", policy=policy)
        pc.trigger_sweeps = []
        u, err = _run(pc)
        return u, err, pc.trigger_sweeps

    got, gerr, sweeps = port(policy3_from_jax(jpolicy))
    assert calls["jacobi3_errs_shard"] > 0
    assert float((got - ju).abs().max()) <= U_RTOL * float(ju.abs().max())
    # JAX's settings (tests/test_compiled3_policy.py) end the last 65³ node on
    # a near tie: its slope at sweep 12 is 9.996e-4 against the trigger 1e-3,
    # within the rounding of the two packages' clean metrics (the port's
    # float64 Σ|r|, JAX's fp32 6/(ωh²)·Σ|Δ|), so the packages may stop a sweep
    # apart there, which moves the reported error by ~4e-3 relative (ROADMAP
    # Queue 3 item 5): 1e-2 relative against JAX; bit for bit and equal stops
    # against the port's unsharded engine below
    assert float(gerr) == pytest.approx(float(jerr), rel=NEAR_TIE_ERR_RTOL)
    if batch == "auto":
        su, serr, ssweeps = port(None)
        assert sweeps == ssweeps and torch.equal(got, su)
        assert float(gerr) == pytest.approx(float(serr), rel=1e-6)
        return
    # the 65³ nodes: 1 + 4j sweeps
    assert sweeps[0][0] == N and sweeps[0][1] % 4 == 1 and sweeps[-1][1] % 4 == 1


def test_sharded_integer_batch_is_one_sweep_then_passes(kernel_routing):
    """The sharded trigger node with trigger_batch=4, against the same stop
    rule composed on the unsharded twins: one exact sweep, then per-sweep
    passes from its error (compiled._batched_trigger); iterate bit for bit,
    the same sweeps."""
    n, h = N, 1.0 / (N - 1)
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32) * 0.01)
    f = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
    policy = tmg.ZShardingPolicy3(tmg.make_mesh_z(["cpu"] * 8))
    lay = S.layout_of(policy, n)
    cfg = tmg.SolverConfig(omega=OMEGA3, trigger=0.05, trigger_batch=4, max_trigger_sweeps=60)
    su, serr, sk = compiled3._trigger_sharded(S.shard(u, lay), S.shard(f, lay), n, h, cfg,
                                              "clean", policy.planes_per_device(n), True)
    u1, e1 = K3.trigger_step3_torch(u, f, h, OMEGA3, "clean")
    wu, werr, wk = compiled._batched_trigger(
        lambda v: K3.fused_jacobi3_errs_torch(v, f, h, 4, OMEGA3, "clean"), u1, cfg, 4, e1, 1)
    assert sk == wk and sk % 4 == 1 and torch.equal(S.gather(su), wu)
    assert float(serr) == pytest.approx(float(werr), rel=1e-6)


def test_policy_state_and_chained_cycles(jpolicy, kernel_routing):
    """init() and the call give z-sharded finest levels; a warm restart
    continues from them, bit for bit the unsharded engine."""
    policy = policy3_from_jax(jpolicy)
    sharded = _port_cc("v", policy)
    single = _port_cc("v", None)
    us, fs = sharded.init()
    assert isinstance(us, S.ShardedGrid) and us.layout == S.layout_of(policy, N)
    u1 = sharded(us, fs)[0]
    u2 = sharded(u1, fs, warm=True)[0]
    w1 = single(*single.init())[0]
    w2 = single(w1, single.init()[1], warm=True)[0]
    assert torch.equal(sharded.unpad(u2), w2)
    assert torch.equal(S.gather(sharded.iterate(2)(us, fs)), w2)


def test_rdma_on_a_sharded_level_is_refused(jpolicy, kernel_routing):
    """halo='rdma' on a sharded level takes the 3-D ring kernels (on the CPU
    their twins: the ppermute engine's result, bit for bit); it is refused on
    a mesh over several cards, where one launch cannot span the ring (the
    plain path has no ring to refuse), and an unknown halo is refused."""
    policy = policy3_from_jax(jpolicy)
    program = tmg.v_cycle(N, n_min=5, steps=3, coarse_target=1e-8, coarsen=3)
    cfg = tmg.SolverConfig(omega=OMEGA3, halo="rdma")
    ring = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D, cfg, device="cpu",
                                policy=policy)
    exchange = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                                    dataclasses.replace(cfg, halo="ppermute"), device="cpu",
                                    policy=policy)
    (ur, er), (ux, ex) = ring(*ring.init()), exchange(*exchange.init())
    assert torch.equal(ring.unpad(ur), exchange.unpad(ux)) and torch.equal(er, ex)
    cards = ZShardingPolicy3(make_mesh_z(["cuda:0", "cuda:1"] * 4))
    with pytest.raises(ValueError, match="one card.*halo='ppermute'"):
        tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D, cfg, device="cpu", policy=cards)
    tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                         dataclasses.replace(cfg, kernels="torch"), device="cpu", policy=cards)
    with pytest.raises(ValueError, match="unknown halo"):
        tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                             dataclasses.replace(cfg, halo="nccl"), device="cpu", policy=policy)

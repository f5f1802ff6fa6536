"""The shard modes of the port's kernels and the sharded kernel wrappers
(multigrid_poisson_solver_tpu_torch.parallel.kernel_shard) against the JAX
package, and the compiled engine under a policy.

On the CPU every shard-mode call runs its plain twin. Each wrapper runs on
rows-8, rows-4 (a ragged last shard: 129 = 3·32 + 33) and 2×4 block
policies at 129² and 257², held

  * bit for bit against the port's unsharded twin (the sharded twins mask by
    global index, so owned cells are the unsharded op's);
  * against JAX's unsharded Pallas kernel in interpret mode, the cheap
    reference (tests/test_pallas_shard.py proves JAX's sharded calls bit-match
    it), with tests/test_torch_kernels.py's bounds: iterates |Δu| ≤
    1e-5·max|u|, error scalars 1e-4 relative, coarse right-hand sides
    2e-6·(max|f_c| + 1), residuals 8·eps·max|u|/h²;
  * and, one case per wrapper, against JAX's sharded call on the 8-device
    mesh, with the same bounds.

The engine, ``compile_program(policy=...)`` at 129² with steps 3 and −1,
is held against JAX's sharded engine (its Pallas kernels in interpret mode
on rows-8, its XLA path on the other policies; rtol 1e-4, atol 1e-6, the
bound tests/test_pallas_shard.py holds those two to each other) and bit for
bit against the port's unsharded engine, with the kernel routing (its
twins) and without kernels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import multigrid_poisson_solver_tpu as jmg
from multigrid_poisson_solver_tpu.compiled import compile_program as jcompile_program
from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import padded as P
from multigrid_poisson_solver_tpu.ops import pallas_kernels as pk
from multigrid_poisson_solver_tpu.parallel import pallas_shard as jps
from multigrid_poisson_solver_tpu.parallel.mesh import (
    BlockShardingPolicy as JBlock,
    ShardingPolicy as JRows,
    make_mesh as jmake_mesh,
    make_mesh_2d as jmake_mesh_2d,
)
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch import compiled
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid_from_jax,
                                                        policy_from_jax, program_from_jax,
                                                        sharded_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS
from multigrid_poisson_solver_tpu_torch.parallel import sharded
from multigrid_poisson_solver_tpu_torch.parallel.mesh import (
    BlockShardingPolicy,
    ShardingPolicy,
    make_mesh,
    make_mesh_2d,
)

U_RTOL = 1e-5
ERR_RTOL = 1e-4
OMEGA = 0.8
POLICIES = ["rows-8", "rows-4", "block-2x4"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _policy(kind):
    if kind == "rows-8":
        return ShardingPolicy(make_mesh(["cpu"] * 8), threshold_rows=8)
    if kind == "rows-4":
        return ShardingPolicy(make_mesh(["cpu"] * 4), threshold_rows=8)
    return BlockShardingPolicy(make_mesh_2d((2, 4), ["cpu"] * 8), threshold_rows=8)


@functools.lru_cache(maxsize=None)
def _fields(n):
    rng = np.random.default_rng(1000 + n)
    m = (n + 1) // 2
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((m, m)).astype(np.float32))


def _th(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jx(a):
    return layout.pad_grid(jnp.asarray(a))


def _split(kind, n, *arrays):
    lay = sharded.layout_of(_policy(kind), n)
    return tuple(sharded.shard(_th(a), lay) for a in arrays)


def _assert_u(got, want):
    got = sharded.gather(got).numpy() if not isinstance(got, np.ndarray) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=U_RTOL * float(np.abs(want).max()))


def _bitwise(got, want):
    assert torch.equal(sharded.gather(got), want)


# --- JAX's unsharded Pallas kernels (interpret mode), cached per input ---------

@functools.lru_cache(maxsize=None)
def _j_jacobi(n, steps, from_zero, omega=OMEGA):
    u, f, _ = _fields(n)
    u = np.zeros_like(u) if from_zero else u
    out = pk.fused_jacobi_padded(_jx(u), _jx(f), n, 1.0 / (n - 1), steps, omega=omega,
                                 from_zero=from_zero, interpret=True)
    return np.asarray(out)[:n, :n]


@functools.lru_cache(maxsize=None)
def _j_jacobi_err(n, steps, compat, smoother="jacobi"):
    u, f, _ = _fields(n)
    h = 1.0 / (n - 1)
    if smoother == "rbgs":
        out, err = pk.fused_rbgs_err_padded(_jx(u), _jx(f), n, h, steps, compat=compat,
                                            interpret=True)
    else:
        out, err = pk.fused_jacobi_err_padded(_jx(u), _jx(f), n, h, steps, omega=OMEGA,
                                              compat=compat, interpret=True)
    return np.asarray(out)[:n, :n], float(err)


@functools.lru_cache(maxsize=None)
def _j_descend(n, restriction, from_zero):
    u, f, _ = _fields(n)
    u = np.zeros_like(u) if from_zero else u
    m = (n + 1) // 2
    out, dwide, err = pk.fused_descend_padded(_jx(u), _jx(f), n, 1.0 / (n - 1), 3,
                                              omega=OMEGA, restriction=restriction,
                                              compat=True, want_err=True,
                                              from_zero=from_zero, interpret=True)
    fc = P.restrict_lanes_p(dwide, n, m, layout.padded_shape(m))
    return np.asarray(out)[:n, :n], np.asarray(fc)[:m, :m], float(err)


@functools.lru_cache(maxsize=None)
def _j_ascend(n, steps):
    u, f, uc = _fields(n)
    m = (n + 1) // 2
    rp, cp = layout.padded_shape(n)
    cwide = P.prolong_lanes_p(_jx(uc), m, n, (rp // 2 + 8, cp))
    out, err = pk.fused_ascend_padded(_jx(u), _jx(f), cwide, n, 1.0 / (n - 1), steps,
                                      omega=OMEGA, compat="gpu", want_err=True, interpret=True)
    return np.asarray(out)[:n, :n], float(err)


# --- shard modes against the unsharded kernels ----------------------------------

@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("n", [129, 257])
@pytest.mark.parametrize("steps", [1, 8, 11])
def test_sharded_smoother_matches_unsharded(kind, n, steps):
    u, f, _ = _fields(n)
    us, fs = _split(kind, n, u, f)
    got = KS.sharded_fused_jacobi(us, fs, 1.0 / (n - 1), steps, OMEGA)
    _bitwise(got, K.fused_jacobi_torch(_th(u), _th(f), 1.0 / (n - 1), steps, OMEGA))
    _assert_u(got, _j_jacobi(n, steps, False))


@pytest.mark.parametrize("kind", POLICIES)
def test_sharded_smoother_from_zero(kind):
    n = 129
    u, f, _ = _fields(n)
    us, fs = _split(kind, n, u, f)
    # from_zero: u is not read, so a nonzero u must not matter
    got = KS.sharded_fused_jacobi(us, fs, 1.0 / (n - 1), 3, OMEGA, from_zero=True)
    _bitwise(got, K.fused_jacobi_torch(torch.zeros(n, n), _th(f), 1.0 / (n - 1), 3, OMEGA,
                                       from_zero=True))
    _assert_u(got, _j_jacobi(n, 3, True))


@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_sharded_fused_err_matches_unsharded(kind, compat):
    n = 129
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n)
    us, fs = _split(kind, n, u, f)
    got_u, got_err = KS.sharded_fused_jacobi_err(us, fs, h, 11, OMEGA, compat)
    want_u, want_err = K.fused_jacobi_err_torch(_th(u), _th(f), h, 11, OMEGA, compat)
    _bitwise(got_u, want_u)
    assert float(got_err) == pytest.approx(float(want_err), rel=ERR_RTOL)
    ju, jerr = _j_jacobi_err(n, 11, compat)
    _assert_u(got_u, ju)
    assert float(got_err) == pytest.approx(jerr, rel=ERR_RTOL)


@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("compat", [True, "gpu"])
def test_sharded_per_sweep_errors(kind, compat):
    """The per-sweep mode: errs[s − 1] is the error of s sweeps."""
    n = 129
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n)
    us, fs = _split(kind, n, u, f)
    steps = K.errs_sweep_cap(compat)
    got_u, errs = KS.sharded_fused_jacobi_errs(us, fs, h, steps, OMEGA, compat)
    want_u, want_errs = K.fused_jacobi_errs_torch(_th(u), _th(f), h, steps, OMEGA, compat)
    _bitwise(got_u, want_u)
    np.testing.assert_allclose(errs.numpy(), want_errs.numpy(), rtol=ERR_RTOL)
    for s in (1, steps):
        assert float(errs[s - 1]) == float(KS.sharded_fused_jacobi_err(
            us, fs, h, s, OMEGA, compat)[1])


@pytest.mark.parametrize("kind", POLICIES)
def test_sharded_rbgs_matches_unsharded(kind):
    n = 129
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n)
    us, fs = _split(kind, n, u, f)
    for steps in (1, 4, 5):
        _bitwise(KS.sharded_fused_jacobi(us, fs, h, steps, 1.0, smoother="rbgs"),
                 K.fused_rbgs_torch(_th(u), _th(f), h, steps))
    for compat in (True, False):
        got_u, got_err = KS.sharded_fused_jacobi_err(us, fs, h, 3, 1.0, compat,
                                                     smoother="rbgs")
        ju, jerr = _j_jacobi_err(n, 3, compat, "rbgs")
        _bitwise(got_u, K.fused_rbgs_torch(_th(u), _th(f), h, 3))
        _assert_u(got_u, ju)
        assert float(got_err) == pytest.approx(jerr, rel=ERR_RTOL)


@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("n", [129, 257])
def test_sharded_residual_matches_unsharded(kind, n):
    u, f, _ = _fields(n)
    h = 1.0 / (n - 1)
    us, fs = _split(kind, n, u, f)
    got = KS.sharded_residual(us, fs, h, negate=True)
    _bitwise(got, K.residual_torch(_th(u), _th(f), h, True))
    want = np.asarray(pk.residual_pallas(_jx(u), _jx(f), n, h, negate=True,
                                         interpret=True))[:n, :n]
    atol = 8 * 1.2e-7 * float(np.abs(u).max()) / (h * h)
    np.testing.assert_allclose(sharded.gather(got).numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("from_zero", [False, True])
def test_sharded_descend_matches_unsharded(kind, restriction, from_zero):
    n = 129
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n)
    us, fs = _split(kind, n, u, f)
    got_u, got_fc, got_err = KS.sharded_fused_descend(us, fs, h, 3, OMEGA, restriction, "cpu",
                                                      from_zero)
    want_u, want_fc, want_err = K.fused_descend_torch(
        torch.zeros(n, n) if from_zero else _th(u), _th(f), h, 3, OMEGA, restriction, True,
        True, from_zero)
    _bitwise(got_u, want_u)
    _bitwise(got_fc, want_fc)
    assert float(got_err) == pytest.approx(float(want_err), rel=ERR_RTOL)
    ju, jfc, jerr = _j_descend(n, restriction, from_zero)
    _assert_u(got_u, ju)
    np.testing.assert_allclose(sharded.gather(got_fc).numpy(), jfc, rtol=0,
                               atol=2e-6 * (float(np.abs(jfc).max()) + 1))
    assert float(got_err) == pytest.approx(jerr, rel=ERR_RTOL)
    # the coarse blocks land on the coarse level's layout, or are re-split
    fc = sharded.as_level(got_fc, _policy(kind), (n + 1) // 2)
    assert torch.equal(sharded.gather(fc), want_fc)


@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("steps", [1, 8])
def test_sharded_ascend_matches_unsharded(kind, steps):
    n = 129
    h = 1.0 / (n - 1)
    u, f, uc = _fields(n)
    pol = _policy(kind)
    us, fs = _split(kind, n, u, f)
    want_u, want_err = K.fused_ascend_torch(_th(u), _th(f), _th(uc), h, steps, OMEGA, "gpu",
                                            True)
    # the coarse correction as a tensor and in the coarse level's layout
    for child in (_th(uc), sharded.as_level(_th(uc), pol, (n + 1) // 2)):
        got_u, got_err = KS.sharded_fused_ascend(us, fs, child, h, steps, OMEGA, "gpu")
        _bitwise(got_u, want_u)
        assert float(got_err) == pytest.approx(float(want_err), rel=ERR_RTOL)
    ju, jerr = _j_ascend(n, steps)
    _assert_u(got_u, ju)
    assert float(got_err) == pytest.approx(jerr, rel=ERR_RTOL)


# --- one case per wrapper against JAX's sharded call ----------------------------

@pytest.fixture(scope="module")
def jrows():
    return JRows(jmake_mesh(), threshold_rows=8)


def _jplace(jpol, n, *arrays):
    out = []
    for a in arrays:
        rp, cp = jpol.padded_shape(n)
        x = jnp.zeros((rp, cp), jnp.float32).at[:a.shape[0], :a.shape[1]].set(jnp.asarray(a))
        out.append(jax.device_put(x, NamedSharding(jpol.mesh, jpol.spec(n))))
    return out


def test_wrappers_match_jax_sharded_calls(jrows):
    n = 129
    h = 1.0 / (n - 1)
    u, f, uc = _fields(n)
    m = (n + 1) // 2
    pol = policy_from_jax(jrows)
    ju, jf = _jplace(jrows, n, u, f)
    us, fs = (sharded_from_jax(x, pol, n) for x in (ju, jf))

    want = jps.sharded_fused_jacobi(ju, jf, n, h, 11, OMEGA, jrows, interpret=True)
    _assert_u(KS.sharded_fused_jacobi(us, fs, h, 11, OMEGA), np.asarray(want)[:n, :n])

    want = jps.sharded_residual_pallas(ju, jf, n, h, jrows, negate=True, interpret=True)
    atol = 8 * 1.2e-7 * float(np.abs(u).max()) / (h * h)
    np.testing.assert_allclose(sharded.gather(KS.sharded_residual(us, fs, h, True)).numpy(),
                               np.asarray(want)[:n, :n], rtol=0, atol=atol)

    wu, werr = jps.sharded_fused_jacobi_err(ju, jf, n, h, 3, OMEGA, True, jrows, interpret=True)
    gu, gerr = KS.sharded_fused_jacobi_err(us, fs, h, 3, OMEGA, True)
    _assert_u(gu, np.asarray(wu)[:n, :n])
    assert float(gerr) == pytest.approx(float(werr), rel=ERR_RTOL)

    wu, werrs = jps.sharded_fused_jacobi_errs(ju, jf, n, h, 8, OMEGA, "gpu", jrows,
                                              interpret=True)
    gu, gerrs = KS.sharded_fused_jacobi_errs(us, fs, h, 8, OMEGA, "gpu")
    _assert_u(gu, np.asarray(wu)[:n, :n])
    np.testing.assert_allclose(gerrs.numpy(), np.asarray(werrs), rtol=ERR_RTOL)

    wu, dwide, werr = jps.sharded_fused_descend(ju, jf, n, h, 3, OMEGA, "full_weighting", "cpu",
                                                jrows, interpret=True)
    wfc = np.asarray(P.restrict_lanes_p(dwide, n, m, jrows.padded_shape(m)))[:m, :m]
    gu, gfc, gerr = KS.sharded_fused_descend(us, fs, h, 3, OMEGA, "full_weighting", "cpu")
    _assert_u(gu, np.asarray(wu)[:n, :n])
    np.testing.assert_allclose(sharded.gather(gfc).numpy(), wfc, rtol=0,
                               atol=2e-6 * (float(np.abs(wfc).max()) + 1))
    assert float(gerr) == pytest.approx(float(werr), rel=ERR_RTOL)

    rp, cp = jrows.padded_shape(n)
    cwide = jax.device_put(P.prolong_lanes_p(_jx(uc), m, n, (rp // 2, cp)),
                           NamedSharding(jrows.mesh, jrows.spec(n)))
    wu, werr = jps.sharded_fused_ascend(ju, jf, cwide, n, h, 3, OMEGA, "clean", jrows,
                                        interpret=True)
    gu, gerr = KS.sharded_fused_ascend(us, fs, _th(uc), h, 3, OMEGA, "clean")
    _assert_u(gu, np.asarray(wu)[:n, :n])
    assert float(gerr) == pytest.approx(float(werr), rel=ERR_RTOL)


# --- the engine under a policy --------------------------------------------------

def _jpolicy(kind):
    if kind == "rows-8":
        return JRows(jmake_mesh(), threshold_rows=8)
    if kind == "rows-4":
        return JRows(jmake_mesh(jax.devices()[:4]), threshold_rows=8)
    return JBlock(jmake_mesh_2d((2, 4)), threshold_rows=8)


def _port_cycle(program, cfg, policy):
    cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu", policy=policy)
    cc.trigger_sweeps = []
    u, f = cc.init()
    u1, err = cc(u, f)
    return cc.unpad(u1), float(err), cc.trigger_sweeps


@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("steps", [3, -1])
def test_engine_under_policy_matches_jax(monkeypatch, kind, steps):
    jprogram = jmg.v_cycle(129, n_min=8, steps=steps, coarse_option=0, coarsen=3)
    # JAX's Pallas sharded engine on rows-8, its XLA one (3× cheaper in
    # interpret mode, and held to the same bound by JAX's own tests) else
    jkernels = "pallas" if kind == "rows-8" else "xla"
    jcfg = jmg.SolverConfig(omega=OMEGA, kernels=jkernels, max_trigger_sweeps=200)
    jpol = _jpolicy(kind)
    cc = jcompile_program(jprogram, jmg.REFERENCE_PROBLEM, jcfg, policy=jpol, donate=False)
    ju, jf = cc.init()
    ju1, jerr = cc(ju, jf)
    want = grid_from_jax(cc.unpad(ju1), 129)

    program, pol = program_from_jax(jprogram), _policy(kind)
    cfg = config_from_jax(jmg.SolverConfig(omega=OMEGA, kernels="pallas",
                                           max_trigger_sweeps=200))
    cfg_plain = config_from_jax(jmg.SolverConfig(omega=OMEGA, kernels="xla",
                                                 max_trigger_sweeps=200))
    plain = _port_cycle(program, cfg_plain, pol)
    unsharded_plain = _port_cycle(program, cfg_plain, None)
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    routed = _port_cycle(program, cfg, pol)
    unsharded = _port_cycle(program, cfg, None)
    for got, ref in ((routed, unsharded), (plain, unsharded_plain)):
        assert torch.equal(got[0], ref[0])
        assert got[2] == ref[2]
        assert got[1] == pytest.approx(ref[1], rel=ERR_RTOL)
    np.testing.assert_allclose(routed[0].numpy(), want.numpy(), rtol=1e-4, atol=1e-6)
    assert routed[1] == pytest.approx(float(jerr), rel=1e-3)


def test_engine_routes_sharded_kernels(monkeypatch):
    """A sharded V(3,3) takes the per-shard legs on sharded levels, the
    single-device kernels on replicated ones, chains no sharded level."""
    calls = []
    for name in ("sharded_fused_descend", "sharded_fused_ascend", "sharded_fused_jacobi"):
        orig = getattr(KS, name)
        monkeypatch.setattr(KS, name, lambda *a, _o=orig, _n=name, **kw: (calls.append(
            (_n, a[0].n)), _o(*a, **kw))[1])
    for name in ("fused_descend", "fused_ascend", "chain_descend"):
        orig = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _o=orig, _n=name, **kw: (calls.append(
            (_n, a[1].shape[0] if _n != "chain_descend" else a[2][0])), _o(*a, **kw))[1])
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    pol = ShardingPolicy(make_mesh(["cpu"] * 8), threshold_rows=8)
    program = tmg.v_cycle(257, n_min=8, steps=3, coarse_option=0, coarsen=3)
    u, _, _ = _port_cycle(program, tmg.SolverConfig(omega=OMEGA), pol)
    for n in (257, 129):
        assert ("sharded_fused_descend", n) in calls and ("sharded_fused_ascend", n) in calls
    # 65 is sharded (8 rows a shard), but JAX's fused ascend wants 32 padded
    # rows a shard (65 pads to 128 rows, 16 a shard): its ascend smooths per
    # shard; 33 and below are replicated and chain
    assert ("sharded_fused_descend", 65) in calls and ("sharded_fused_jacobi", 65) in calls
    assert ("sharded_fused_ascend", 65) not in calls
    assert ("chain_descend", 33) in calls
    assert not any(name in ("fused_descend", "fused_ascend") for name, _ in calls)
    want = _port_cycle(program, tmg.SolverConfig(omega=OMEGA), None)[0]
    assert torch.equal(u, want)


def test_engine_rbgs_gpu_trigger_sweeps_through_the_shard_mode(monkeypatch):
    """A sharded rb-GS trigger level with the gpu metric smooths one sweep at
    a time through the rb-GS shard mode, as JAX's ``_sweeps`` does under a
    policy; held against JAX's sharded engine (rtol 1e-4, atol 1e-6) and the
    port's plain sharded engine (equal stop sweeps, |Δu| ≤ 1e-5·max|u|)."""
    jprogram = jmg.v_cycle(129, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(smoother="rbgs", compat_error="gpu", kernels="xla",
                            max_trigger_sweeps=200)
    jpol = _jpolicy("rows-8")
    cc = jcompile_program(jprogram, jmg.REFERENCE_PROBLEM, jcfg, policy=jpol, donate=False)
    ju, jf = cc.init()
    ju1, jerr = cc(ju, jf)
    want = grid_from_jax(cc.unpad(ju1), 129)

    program, pol = program_from_jax(jprogram), _policy("rows-8")
    cfg = tmg.SolverConfig(smoother="rbgs", compat_error="gpu", max_trigger_sweeps=200)
    plain = _port_cycle(program, cfg, pol)
    smoothers = []
    orig = K.fused_jacobi_shard
    monkeypatch.setattr(K, "fused_jacobi_shard", lambda *a, **kw: (
        smoothers.append((a[2].n, a[8], a[7])), orig(*a, **kw))[1])
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    routed = _port_cycle(program, cfg, pol)
    # 129 and 65 are sharded (8 rows a shard at threshold 8), one sweep a pass
    assert {n for n, _, _ in smoothers} == {129, 65}
    assert all(sm == "rbgs" and mode is None for _, sm, mode in smoothers)
    assert routed[2] == plain[2]
    np.testing.assert_allclose(routed[0].numpy(), plain[0].numpy(), rtol=0,
                               atol=U_RTOL * float(plain[0].abs().max()))
    np.testing.assert_allclose(routed[0].numpy(), want.numpy(), rtol=1e-4, atol=1e-6)
    assert routed[1] == pytest.approx(float(jerr), rel=1e-3)

"""The ring kernels' twins (multigrid_poisson_solver_tpu_torch.ops.rdma) and the
engine's halo="rdma" routing, against the port's exchange path and the JAX
package.

On the CPU ``rdma_jacobi`` and ``rdma_trigger`` run their twins: the halo
exchange followed by the shard-mode smoother, and the loop of one-sweep
sharded error passes. They are held

  * bit for bit against the exchange path of the port
    (``kernel_shard.sharded_fused_jacobi``, ``sharded_fused_jacobi_err``),
    on rings of 2, 3, 4 and 8 shards with a ragged last shard;
  * against JAX's unsharded Pallas smoother in interpret mode, |Δu| ≤
    1e-5·max|u| (tests/test_torch_kernels.py's U_RTOL);
  * the trigger loop's stop sweep exactly, its iterate to 1e-5·max|u| and
    its error to 1e-4 relative against JAX's per-pass sharded loop on the
    8-device mesh (the loop tests/test_rdma.py holds JAX's ring kernel to),
    for the cpu, clean and gpu metrics.

The engine takes the ring kernels for row-sharded levels with halo="rdma"
and never for a level split by columns, and gives the exchange path's
iterate bit for bit.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import pallas_kernels as pk
from multigrid_poisson_solver_tpu.parallel import pallas_shard as jps
from multigrid_poisson_solver_tpu.parallel.mesh import ShardingPolicy as JRows
from multigrid_poisson_solver_tpu.parallel.mesh import make_mesh as jmake_mesh
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch import compiled
from multigrid_poisson_solver_tpu_torch.convert import policy_from_jax, sharded_from_jax
from multigrid_poisson_solver_tpu_torch.ops import rdma
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS
from multigrid_poisson_solver_tpu_torch.parallel import sharded
from multigrid_poisson_solver_tpu_torch.parallel.mesh import (
    BlockShardingPolicy,
    ShardingPolicy,
    make_mesh,
    make_mesh_2d,
)
from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

U_RTOL = 1e-5
ERR_RTOL = 1e-4
OMEGA = 0.8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ring(shards, n, *arrays):
    lay = sharded.layout_of(ShardingPolicy(make_mesh(["cpu"] * shards), threshold_rows=8), n)
    return tuple(sharded.shard(torch.from_numpy(a), lay) for a in arrays)


def _uf(n, seed=7, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n)).astype(np.float32),
            (scale * rng.random((n, n))).astype(np.float32))


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
@pytest.mark.parametrize("steps", [1, 8, 11])
def test_rdma_smoother_twin_matches_exchange_path(shards, steps):
    n = 131                       # ragged: the last shard owns more rows
    h = 1.0 / (n - 1)
    u, f = _uf(n)
    us, fs = _ring(shards, n, u, f)
    got = KS.rdma_fused_jacobi(us, fs, h, steps, OMEGA)
    want = KS.sharded_fused_jacobi(us, fs, h, steps, OMEGA)
    assert torch.equal(sharded.gather(got), sharded.gather(want))
    jwant = np.asarray(pk.fused_jacobi_padded(layout.pad_grid(jnp.asarray(u)),
                                              layout.pad_grid(jnp.asarray(f)), n, h, steps,
                                              omega=OMEGA, interpret=True))[:n, :n]
    np.testing.assert_allclose(sharded.gather(got).numpy(), jwant, rtol=0,
                               atol=U_RTOL * float(np.abs(jwant).max()))


def test_rdma_smoother_from_zero():
    """from_zero passes skip the u exchange: u is never read."""
    n = 129
    h = 1.0 / (n - 1)
    u, f = _uf(n)
    us, fs = _ring(8, n, u, f)
    got = KS.rdma_fused_jacobi(us, fs, h, 3, 1.0, from_zero=True)
    zs = _ring(8, n, np.zeros_like(u))[0]
    assert torch.equal(sharded.gather(got),
                       sharded.gather(KS.sharded_fused_jacobi(zs, fs, h, 3, 1.0, True)))
    jwant = np.asarray(pk.fused_jacobi_padded(layout.pad_grid(jnp.zeros((n, n), jnp.float32)),
                                              layout.pad_grid(jnp.asarray(f)), n, h, 3,
                                              from_zero=True, interpret=True))[:n, :n]
    np.testing.assert_allclose(sharded.gather(got).numpy(), jwant, rtol=0,
                               atol=U_RTOL * float(np.abs(jwant).max()))


def test_rdma_rejects_block_layouts():
    n = 129
    u, f = _uf(n)
    lay = sharded.layout_of(BlockShardingPolicy(make_mesh_2d((2, 4), ["cpu"] * 8),
                                                threshold_rows=8), n)
    us, fs = (sharded.shard(torch.from_numpy(a), lay) for a in (u, f))
    with pytest.raises(ValueError, match="row partitions"):
        KS.rdma_fused_jacobi(us, fs, 1.0 / (n - 1), 3)
    with pytest.raises(ValueError, match="row partitions"):
        KS.rdma_fused_trigger(us, fs, 1.0 / (n - 1), 30.0)


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_rdma_trigger_twin_is_the_exchange_loop(shards, compat):
    """The trigger twin is the loop of one-sweep sharded error passes, bit
    for bit: stop sweep, iterate and error."""
    n = 131
    h = 1.0 / (n - 1)
    u, f = _uf(n, seed=11, scale=10.0)
    us, fs = _ring(shards, n, u, f)
    trig = 30.0 if compat != "gpu" else 100.0
    got_u, got_err, got_k = KS.rdma_fused_trigger(us, fs, h, trig, OMEGA, compat, 50)
    ru, re_, rk = trigger_loop(lambda v: KS.sharded_fused_jacobi_err(v, fs, h, 1, OMEGA, compat),
                               us, trig, 50)
    assert int(got_k) == rk < 50
    assert torch.equal(sharded.gather(got_u), sharded.gather(ru))
    assert torch.equal(got_err, re_)


@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_rdma_trigger_matches_jax_per_pass_loop(compat):
    """Against JAX's per-pass sharded trigger loop (tests/test_rdma.py's
    reference for its ring kernel), on the same inputs."""
    jpol = JRows(jmake_mesh(), threshold_rows=8)
    n, h = 129, 1.0 / 128
    rng = np.random.default_rng(11)
    rp, cp = jpol.padded_shape(n)
    u = jnp.zeros((rp, cp), jnp.float32).at[:n, :n].set(
        jnp.asarray(rng.random((n, n)), jnp.float32))
    f = jnp.zeros((rp, cp), jnp.float32).at[:n, :n].set(
        jnp.asarray(10 * rng.random((n, n)), jnp.float32))
    sh = NamedSharding(jpol.mesh, jpol.spec(n))
    ju, jf = jax.device_put(u, sh), jax.device_put(f, sh)
    trig = 30.0 if compat != "gpu" else 100.0
    v, prev, k = ju, None, 0
    while True:
        v, e = jps.sharded_fused_jacobi_err(v, jf, n, h, 1, OMEGA, compat, jpol, interpret=True)
        k += 1
        if (prev is not None and abs(float(e) - prev) <= trig) or k >= 50:
            break
        prev = float(e)
    pol = policy_from_jax(jpol)
    us, fs = sharded_from_jax(ju, pol, n), sharded_from_jax(jf, pol, n)
    got_u, got_err, got_k = KS.rdma_fused_trigger(us, fs, h, trig, OMEGA, compat, 50)
    assert int(got_k) == k < 50
    want = np.asarray(v)[:n, :n]
    np.testing.assert_allclose(sharded.gather(got_u).numpy(), want, rtol=0,
                               atol=U_RTOL * float(np.abs(want).max()))
    assert float(got_err) == pytest.approx(float(e), rel=ERR_RTOL)


def test_rdma_trigger_fits_is_jax_rule():
    from multigrid_poisson_solver_tpu.ops.pallas_rdma import rdma_trigger_fits as jfits

    for rows in (16, 48, 528, 1040, 2064):
        for cp in (256, 4224, 8320):
            assert rdma.rdma_trigger_fits(rows, cp) == jfits(rows, cp)


def _spy(monkeypatch, calls):
    for name in ("rdma_jacobi", "rdma_trigger"):
        orig = getattr(rdma, name)
        monkeypatch.setattr(rdma, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append((_n, a[1].n)), _o(*a, **kw))[1])


def _cycle(program, cfg, policy):
    cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu", policy=policy)
    cc.trigger_sweeps = []
    u, f = cc.init()
    u1, err = cc(u, f)
    return cc.unpad(u1), float(err), cc.trigger_sweeps


@pytest.mark.parametrize("steps", [3, -1])
def test_engine_routes_rdma_for_rows_policies(monkeypatch, steps):
    """halo="rdma" runs the sharded sweeps (steps 3: the non-2:1 levels of
    coarsen=1) and the sharded trigger levels (steps −1) through the ring
    kernels, and matches the exchange path's engine bit for bit."""
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    program = tmg.v_cycle(129, n_min=8, steps=steps, coarse_option=0, coarsen=1)
    pol = ShardingPolicy(make_mesh(["cpu"] * 8), threshold_rows=8)
    calls = []
    _spy(monkeypatch, calls)

    def cfg(halo):
        return tmg.SolverConfig(omega=OMEGA, halo=halo, max_trigger_sweeps=200)

    u_rdma, err_rdma, sweeps_rdma = _cycle(program, cfg("rdma"), pol)
    # the finest level's sweeps carry the error, a fused error pass (as JAX's)
    want = {("rdma_trigger", 129), ("rdma_trigger", 64)} if steps == -1 else {("rdma_jacobi", 64)}
    assert set(calls) == want
    calls.clear()
    u_pp, err_pp, sweeps_pp = _cycle(program, cfg("ppermute"), pol)
    assert not calls
    assert torch.equal(u_rdma, u_pp) and sweeps_rdma == sweeps_pp
    assert err_rdma == err_pp


@pytest.mark.parametrize("steps", [3, -1])
def test_engine_block_policy_never_takes_rdma(monkeypatch, steps):
    """Levels a block policy splits by columns keep the exchange path; a
    level it falls back to rows-only takes the ring, as in JAX."""
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    program = tmg.v_cycle(129, n_min=8, steps=steps, coarse_option=0, coarsen=1)
    pol = BlockShardingPolicy(make_mesh_2d((2, 4), ["cpu"] * 8), threshold_rows=8)
    calls = []
    _spy(monkeypatch, calls)
    cfg = tmg.SolverConfig(omega=OMEGA, halo="rdma", max_trigger_sweeps=200)
    u, _, sweeps = _cycle(program, cfg, pol)
    assert pol.spec(64) == ("rows", "cols") and pol.spec(16) == ("rows", None)
    assert all(pol.spec(n) == ("rows", None) for _, n in calls)
    assert {n for _, n in calls} == {16}
    want = _cycle(program, tmg.SolverConfig(omega=OMEGA, max_trigger_sweeps=200), None)
    assert torch.equal(u, want[0]) and sweeps == want[2]


def test_engine_trigger_too_big_for_the_ring_takes_batched_passes(monkeypatch):
    """A sharded trigger level whose padded shard fails rdma_trigger_fits
    takes the per-sweep passes (JAX's order), with "auto" batching only
    where the single-device engine would."""
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    monkeypatch.setattr(rdma, "rdma_trigger_fits", lambda rows, cp, itemsize=4: False)
    calls = []
    _spy(monkeypatch, calls)
    errs = []
    orig = KS.sharded_fused_jacobi_errs
    monkeypatch.setattr(KS, "sharded_fused_jacobi_errs", lambda *a, **kw: (
        errs.append(a[0].n), orig(*a, **kw))[1])
    monkeypatch.setattr(tmg.compiled.K, "trigger_fits", lambda n: False)
    monkeypatch.setattr(tmg.compiled.K, "trigger_stream_fits", lambda n: False)
    program = tmg.v_cycle(129, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    pol = ShardingPolicy(make_mesh(["cpu"] * 8), threshold_rows=8)
    cfg = tmg.SolverConfig(omega=OMEGA, halo="rdma", trigger_batch=7, max_trigger_sweeps=60)
    u, _, sweeps = _cycle(program, cfg, pol)
    assert not [c for c in calls if c[0] == "rdma_trigger"]
    assert 129 in errs
    assert sweeps == _cycle(program, cfg, None)[2]


def test_engine_refuses_rdma_on_a_mesh_of_several_cards(monkeypatch):
    """The ring kernels run every shard in one launch on one card: a mesh
    over several cards with halo="rdma" is refused when the engine is
    built, with the way out in the message."""
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    program = tmg.v_cycle(129, n_min=8, steps=3, coarse_option=0, coarsen=1)
    pol = ShardingPolicy(make_mesh(["cuda:0", "cuda:1"] * 4), threshold_rows=8)
    with pytest.raises(ValueError, match="one card.*cuda:0.*cuda:1.*halo='ppermute'"):
        tmg.compile_program(program, tmg.REFERENCE_PROBLEM, tmg.SolverConfig(halo="rdma"),
                            device="cpu", policy=pol)
    # a ring of shards on one card, and the exchange path on several, are taken
    for devices, halo in ((["cuda:1"] * 8, "rdma"), (["cuda:0", "cuda:1"] * 4, "ppermute")):
        tmg.compile_program(program, tmg.REFERENCE_PROBLEM, tmg.SolverConfig(halo=halo),
                            device="cpu", policy=ShardingPolicy(make_mesh(devices)))


def test_each_shard_runs_with_its_card_current(monkeypatch):
    """The sharded wrappers launch every shard's kernel with that shard's
    card made current (kernel wrappers launch on the current device), in
    shard order."""
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(str(dev))
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    devs = [torch.device(f"cuda:{k}") for k in (0, 1, 0, 1)]
    lay = sharded.Layout(64, ((0, 16), (16, 32), (32, 48), (48, 64)), ((0, 64),),
                         tuple((d,) for d in devs))
    x = sharded.ShardedGrid(lay, [[torch.zeros(16, 64)] for _ in devs])
    assert KS._each(x, lambda i, j: (i, j)) == {(k, 0): (k, 0) for k in range(4)}
    assert entered == ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    entered.clear()
    cpu = sharded.layout_of(ShardingPolicy(make_mesh(["cpu"] * 4), threshold_rows=8), 64)
    KS._each(sharded.shard(torch.zeros(64, 64), cpu), lambda i, j: None)
    assert not entered

"""The port's sharding layer (multigrid_poisson_solver_tpu_torch.parallel) against
the JAX package's on the virtual 8-device CPU mesh.

  * the policies: the port's mesh of eight shards (``cpu`` repeated) takes
    the same spec, sharded-or-not decision and padded routing shape for
    every level size as JAX's mesh of eight devices;
  * the plain per-shard ops (``parallel.halo``) against JAX's shard_map ops
    (``parallel/halo.py``) on the same numpy inputs, at sizes that do and do
    not divide the shard count, and against the port's unsharded oracle ops.

Tolerances (fp32): within the port the sharded ops are the unsharded ones
cell for cell, so they are held bit for bit. Against JAX, its XLA sweeps may
contract FMAs, so iterates differ by a few ulps: |Δu| ≤ 1e-5·max|u| after a
few sweeps (tests/test_torch_kernels.py's U_RTOL); residuals carry the fp32
cancellation noise 8·eps·max|u|/h²; error sums 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.parallel import halo as jhalo
from multigrid_poisson_solver_tpu.parallel.mesh import (
    BlockShardingPolicy as JBlock,
    ShardingPolicy as JRows,
    make_mesh as jmake_mesh,
    make_mesh_2d as jmake_mesh_2d,
    pad_rows,
    row_sharding,
    unpad_rows,
)
from multigrid_poisson_solver_tpu_torch.convert import policy_from_jax
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import stencils
from multigrid_poisson_solver_tpu_torch.parallel import halo, sharded
from multigrid_poisson_solver_tpu_torch.parallel.mesh import (
    BlockShardingPolicy,
    ShardingPolicy,
    make_mesh,
    make_mesh_2d,
)

NDEV = 8
U_RTOL = 1e-5
ERR_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == NDEV, "tests expect the 8-device CPU mesh"
    return jmake_mesh()


def _ring(n):
    """The port's level n split over a ring of eight CPU shards."""
    return sharded.layout_of(ShardingPolicy(make_mesh(["cpu"] * NDEV), threshold_rows=1), n)


def _uf(rng, n):
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32))


def _jplace(jmesh, *arrays):
    sh = row_sharding(jmesh)
    return tuple(jax.device_put(pad_rows(jnp.asarray(a), NDEV), sh) for a in arrays)


def _shard(n, *arrays):
    lay = _ring(n)
    return tuple(sharded.shard(torch.from_numpy(a), lay) for a in arrays)


def _close(got, want, rtol=U_RTOL):
    got = sharded.gather(got).numpy() if not isinstance(got, np.ndarray) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["rows", "block"])
def test_policy_specs_match_jax(jmesh, kind):
    """Spec, sharded-or-not and the padded routing shape agree with JAX's
    policy for every level size, across the threshold and both axes."""
    if kind == "rows":
        jpol = JRows(jmesh, threshold_rows=16)
    else:
        jpol = JBlock(jmake_mesh_2d((2, 4)), threshold_rows=32)
    pol = policy_from_jax(jpol, "cpu")
    assert pol.mesh.devices == (torch.device("cpu"),) * NDEV
    for n in list(range(3, 300)) + [513, 1025, 1031, 4097, 8193]:
        assert pol.spec(n) == tuple(jpol.spec(n)), n
        assert pol.is_sharded(n) == jpol.is_sharded(n), n
        assert pol.padded_shape(n) == tuple(jpol.padded_shape(n)), n


def test_sharding_policy_thresholds():
    pol = ShardingPolicy(make_mesh(["cpu"] * NDEV), threshold_rows=32)
    assert pol.n_devices == NDEV
    assert pol.is_sharded(257)          # 32 rows/device
    assert not pol.is_sharded(255)      # 31 rows/device
    assert not pol.is_sharded(17)
    assert pol.spec(257) != pol.spec(17)
    assert not ShardingPolicy(make_mesh(["cpu"])).is_sharded(8193)   # one device


def test_block_policy_transitions():
    pol = BlockShardingPolicy(make_mesh_2d((2, 4), ["cpu"] * NDEV), threshold_rows=32)
    assert pol.spec(257) == ("rows", "cols")    # 128 rows/dev, 64 cols/dev
    assert pol.spec(129) == ("rows", "cols")    # 64 rows/dev, 32 cols/dev
    assert pol.spec(100) == ("rows", None)      # cols/dev 25 < threshold
    assert pol.spec(33) == ()                   # replicated (agglomeration)


def test_layouts_split_and_gather():
    """Blocks cover the grid with even origins (a ragged last shard), live on
    their mesh entries, own their storage, and gather back exactly."""
    pol = BlockShardingPolicy(make_mesh_2d((2, 4), ["cpu"] * NDEV), threshold_rows=8)
    for n in (67, 129, 131):
        lay = sharded.layout_of(pol, n)
        for bounds in (lay.rows, lay.cols):
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(a[1] == b[0] and a[0] % 2 == 0 for a, b in zip(bounds, bounds[1:]))
        x = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
        g = sharded.shard(x, lay)
        assert torch.equal(sharded.gather(g), x)
        sharded.shard(x, lay).blocks[0][0].zero_()
        assert x[1, 1] == n + 1                         # the blocks are copies
        xp = torch.nn.functional.pad(x, (2, 2, 3, 3))     # zero beyond the grid
        for i, j in lay.order():
            (r0, r1), (c0, c1) = lay.rows[i], lay.cols[j]
            assert torch.equal(sharded.extend(g, i, j, 3, 2), xp[r0:r1 + 6, c0:c1 + 4])
    parts = [torch.tensor(v, dtype=torch.float32) for v in (1e8, 1.0, -1e8, 1.0)]
    assert float(sharded.psum(parts, lay)) == float(((parts[0] + parts[1]) + parts[2]) + parts[3])


@pytest.mark.parametrize("n", [64, 67, 257])
def test_sharded_jacobi_matches_jax(jmesh, rng, n):
    u, f = _uf(rng, n)
    h = 1.0 / (n - 1)
    ju, jf = _jplace(jmesh, u, f)
    want = unpad_rows(jhalo.sharded_smooth(ju, jf, h, 4, jmesh, omega=0.8), n)
    us, fs = _shard(n, u, f)
    got = halo.sharded_smooth(us, fs, h, 4, 0.8)
    _close(got, want)
    # the unsharded oracle, bit for bit
    oracle = torch.from_numpy(u)
    for _ in range(4):
        oracle = stencils.jacobi_sweep(oracle, torch.from_numpy(f), h, 0.8)
    assert torch.equal(sharded.gather(got), oracle)


@pytest.mark.parametrize("n", [64, 67])
def test_sharded_rbgs_matches_jax(jmesh, rng, n):
    u, f = _uf(rng, n)
    h = 1.0 / (n - 1)
    ju, jf = _jplace(jmesh, u, f)
    want = unpad_rows(jhalo.sharded_smooth(ju, jf, h, 3, jmesh, smoother="rbgs"), n)
    us, fs = _shard(n, u, f)
    got = halo.sharded_smooth(us, fs, h, 3, smoother="rbgs")
    _close(got, want)
    assert torch.equal(sharded.gather(got), K.fused_rbgs_torch(torch.from_numpy(u),
                                                               torch.from_numpy(f), h, 3))


@pytest.mark.parametrize("n", [64, 67, 257])
def test_sharded_residual_matches_jax(jmesh, rng, n):
    u, f = _uf(rng, n)
    h = 1.0 / (n - 1)
    ju, jf = _jplace(jmesh, u, f)
    want = np.asarray(unpad_rows(jhalo.sharded_residual(ju, jf, h, jmesh), n))
    us, fs = _shard(n, u, f)
    got = sharded.gather(halo.sharded_residual(us, fs, h)).numpy()
    atol = 8 * 1.2e-7 * float(np.abs(u).max()) / (h * h)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.array_equal(got, stencils.residual(torch.from_numpy(u), torch.from_numpy(f),
                                                 h).numpy())


@pytest.mark.parametrize("n", [67, 257])
@pytest.mark.parametrize("compat", [True, False])
def test_sharded_smoothing_error_matches_jax(jmesh, rng, n, compat):
    u, f = _uf(rng, n)
    h = 1.0 / (n - 1)
    ju, jf = _jplace(jmesh, u, f)
    want = float(jhalo.sharded_smoothing_error(ju, jf, h, jmesh, compat=compat))
    us, fs = _shard(n, u, f)
    got = float(halo.sharded_smoothing_error(us, fs, h, compat))
    assert got == pytest.approx(want, rel=ERR_RTOL)
    oracle = float(stencils.smoothing_error(torch.from_numpy(u), torch.from_numpy(f), h,
                                            compat))
    assert got == pytest.approx(oracle, rel=ERR_RTOL)


def test_sharded_gpu_error_matches_oracle(rng):
    n = 67
    u, f = _uf(rng, n)
    h = 1.0 / (n - 1)
    us, fs = _shard(n, u, f)
    new = halo.sharded_smooth(us, fs, h, 1, 0.8)
    got = float(halo.sharded_gpu_smoothing_error(new, us, h))
    want = float(stencils.gpu_smoothing_error(sharded.gather(new), torch.from_numpy(u), h))
    assert got == pytest.approx(want, rel=ERR_RTOL)


def test_boundary_rows_frozen_under_sharding(rng):
    """Dirichlet rows/cols (global index 0 and n−1) never change, under row
    and block layouts."""
    n = 64
    u, f = _uf(rng, n)
    h = 1.0 / (n - 1)
    block = sharded.layout_of(BlockShardingPolicy(make_mesh_2d((2, 4), ["cpu"] * NDEV),
                                                  threshold_rows=8), n)
    for lay in (_ring(n), block):
        us, fs = (sharded.shard(torch.from_numpy(a), lay) for a in (u, f))
        out = sharded.gather(halo.sharded_smooth(us, fs, h, 5)).numpy()
        for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_array_equal(out[sl], u[sl])

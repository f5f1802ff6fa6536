"""The port's ``parallel.multihost`` against the JAX package's (the
multihost tests of tests/test_block_partition.py): mesh shapes, the block
policy per level, the near-square factor, an idempotent ``initialize``, and
the multi-process branch under a mocked world; and the owner ranks a
multi-process mesh gives its layouts. A one-process mesh makes no
``torch.distributed`` call."""

import jax
import pytest
import torch
import torch.distributed as dist

import multigrid_poisson_solver_tpu as jmg
from multigrid_poisson_solver_tpu.parallel import multihost as jmultihost

import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
from multigrid_poisson_solver_tpu_torch.parallel import multihost
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

NDEV = 8
SIZES = list(range(3, 300)) + [513, 1025, 4097]


def test_single_process_mesh_shapes_match_jax():
    assert len(jax.devices()) == NDEV, "tests expect the 8-device CPU mesh"
    for kw, shape in (({}, {"rows": 2, "cols": 4}), ({"rows_parallelism": 4},
                                                     {"rows": 4, "cols": 2})):
        jmesh = jmultihost.hybrid_block_mesh(**kw)
        mesh = multihost.hybrid_block_mesh(local_devices=["cpu"] * NDEV, **kw)
        assert dict(jmesh.shape) == mesh.shape == shape
        assert mesh.ranks is None and mesh.one_process
        assert mesh.local_entries() == list(range(NDEV))


@pytest.mark.parametrize("threshold", [8, 32])
def test_block_policy_specs_match_jax(threshold):
    jpol = jmultihost.block_policy(jmultihost.hybrid_block_mesh(), threshold_rows=threshold)
    pol = multihost.block_policy(multihost.hybrid_block_mesh(local_devices=["cpu"] * NDEV),
                                 threshold_rows=threshold)
    for n in SIZES:
        assert pol.spec(n) == tuple(jpol.spec(n)), n
        assert pol.is_sharded(n) == jpol.is_sharded(n), n
    assert multihost.block_policy(pol.mesh).threshold_rows == jmultihost.block_policy(
        jpol.mesh).threshold_rows == 32


@pytest.mark.parametrize("n", range(1, 65))
def test_near_square_factor_matches_jax(n):
    assert multihost._near_square_factor(n) == jmultihost._near_square_factor(n)


def test_initialize_idempotent(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    multihost.initialize()                       # already initialized: nothing
    multihost.initialize("file:///x", 2, 1, "gloo")
    assert calls == []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    multihost.initialize("file:///tmp/x", 4, 2, "gloo")
    assert calls == [("gloo", dict(init_method="file:///tmp/x", world_size=4, rank=2))]
    multihost.initialize()                       # torchrun's environment
    assert calls[-1] == ("nccl" if torch.cuda.is_available() else "gloo", {})


def _mock_world(monkeypatch, world, rank, local):
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)

    def all_gather_object(out, obj, group=None):
        for r in range(world):
            out[r] = [f"{d}" for d in local]

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)


def test_hybrid_mesh_multi_process_branch(monkeypatch):
    """2 mocked processes with 4 entries each: processes on the row axis,
    each process's entries on the column axis, owners recorded."""
    _mock_world(monkeypatch, 2, 1, ["cpu"] * 4)
    mesh = multihost.hybrid_block_mesh(rows_parallelism=8)   # ignored across processes
    assert mesh.shape == {"rows": 2, "cols": 4}
    assert mesh.ranks == (0,) * 4 + (1,) * 4 and not mesh.one_process
    assert mesh.local_entries() == [4, 5, 6, 7]
    pol = multihost.block_policy(mesh, threshold_rows=8)
    assert pol.is_sharded(64)
    lay = S.layout_of(pol, 129)
    assert lay.ranks == ((0,) * 4, (1,) * 4)
    assert lay.local_order() == [(1, j) for j in range(4)]
    assert S.home(pol) == torch.device("cpu")
    # a level of rows only keeps both processes' rows
    assert S.layout_of(pol, 20).ranks == ((0,), (1,))
    zm = multihost.z_mesh()
    assert zm.shape == {"z": 8} and zm.ranks == mesh.ranks
    assert multihost.row_mesh().ranks == mesh.ranks


def test_layout_refuses_a_process_without_a_block(monkeypatch):
    """A level whose blocks all fall to some processes leaves the others
    out of the exchanges; the layout refuses it."""
    mesh = M.make_mesh_2d((2, 4), ["cpu"] * 8, ranks=(0, 1) * 4)   # processes on columns
    pol = M.BlockShardingPolicy(mesh, threshold_rows=8)
    assert S.layout_of(pol, 129).ranks == ((0, 1, 0, 1),) * 2
    with pytest.raises(ValueError, match="no block"):
        S.layout_of(pol, 20)                      # rows only: process 1 owns none
    with pytest.raises(ValueError, match="ranks"):
        M.make_mesh(["cpu"] * 4, ranks=(0, 1))


def test_one_process_makes_no_distributed_call(monkeypatch):
    """On a one-process mesh the sharded layer keeps its copies: every
    torch.distributed entry point it could reach raises here."""
    def refuse(*a, **k):
        raise AssertionError("torch.distributed called on a one-process mesh")

    mesh = multihost.hybrid_block_mesh(local_devices=["cpu"] * 4)
    pol = multihost.block_policy(mesh, threshold_rows=8)
    for name in ("get_rank", "get_world_size", "get_backend", "all_gather", "batch_isend_irecv",
                 "is_initialized", "all_gather_object", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    cc = tmg.compile_program(tmg.v_cycle(65, n_min=8, steps=3, coarse_option=0, coarsen=3),
                             tmg.REFERENCE_PROBLEM, device="cpu", policy=pol)
    u, f = cc.init()
    S.reset_counts()
    u1, err = cc(u, f)
    assert cc.unpad(u1).shape == (65, 65) and torch.isfinite(err)
    assert S.counts()[65]["pieces"] > 0 and S.counts()[65]["messages"] == 0

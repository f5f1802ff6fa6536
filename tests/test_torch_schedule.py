"""Schedules in the port against the JAX package: the bundled Cycle.txt
files and the V, W and FMG generators give equal programs."""

from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch.convert import config_from_jax, program_from_jax

SCHEDULES = sorted((Path(__file__).resolve().parent.parent / "schedules").glob("*.txt"))


def test_all_bundled_schedules_found():
    assert [p.name for p in SCHEDULES] == ["Vcycle.txt", "VcycleTrigger.txt",
                                           "Wcycle.txt", "test.txt"]


@pytest.mark.parametrize("path", SCHEDULES, ids=lambda p: p.name)
def test_cycle_files_parse_equal(path):
    ours = tmg.parse_cycle_path(path)
    assert ours == program_from_jax(jmg.parse_cycle_path(path))
    assert tmg.to_cycle_file(ours) == jmg.to_cycle_file(jmg.parse_cycle_path(path))
    assert tmg.parse_cycle_file(tmg.to_cycle_file(ours)) == ours


@pytest.mark.parametrize("maker", ["v_cycle", "w_cycle", "fmg"])
@pytest.mark.parametrize("n_max,steps,coarsen,option", [
    (256, 3, 1, 1), (4097, 3, 3, 0), (129, -1, 3, 2), (12, 2, 2, 1)])
def test_generators_equal(maker, n_max, steps, coarsen, option):
    kw = dict(n_min=8, steps=steps, coarse_option=option, coarsen=coarsen)
    ours = getattr(tmg, maker)(n_max, **kw)
    assert ours == program_from_jax(getattr(jmg, maker)(n_max, **kw))
    assert tmg.repeat(ours, 3) == program_from_jax(
        jmg.repeat(getattr(jmg, maker)(n_max, **kw), 3))


@pytest.mark.parametrize("rule", [1, 2, 3])
def test_level_sizes_equal(rule):
    from multigrid_poisson_solver_tpu.grid import level_sizes as jls

    for n_max, n_min in [(256, 8), (4097, 8), (100, 7), (33, 3)]:
        assert tmg.level_sizes(n_max, n_min, rule) == jls(n_max, n_min, rule)


def test_bad_cycle_files_raise_alike():
    for text in ["1.0 0 0\n3 9\n64 8\n-1\n2\n", "1.0 0 0\n3 1\n16 8\n-1\n-1\n-1\n2\n",
                 "1.0 0 0\n3 1\n16 8\n7\n2\n", "1.0 0 0\n3"]:
        with pytest.raises(ValueError) as ours:
            tmg.parse_cycle_file(text)
        with pytest.raises(ValueError) as theirs:
            jmg.parse_cycle_file(text)
        assert str(ours.value) == str(theirs.value)


def test_config_from_jax_keeps_every_field():
    cfg = jmg.SolverConfig(dtype=jnp.float64, smoother="rbgs", omega=0.7,
                           compat_error="gpu", trigger=0.02, max_trigger_sweeps=50,
                           trigger_batch=1, coarse_gs_norm="full",
                           collect_node_stats=False, kernels="pallas", zoom="matmul",
                           restriction="full_weighting", halo="rdma")
    ours = config_from_jax(cfg)
    assert ours.dtype == torch.float64 and ours.kernels == "cuda"
    for field in ("smoother", "omega", "compat_error", "trigger", "max_trigger_sweeps",
                  "trigger_batch", "coarse_gs_norm", "collect_node_stats", "zoom",
                  "restriction", "halo"):
        assert getattr(ours, field) == getattr(cfg, field), field
    assert config_from_jax(jmg.SolverConfig(kernels="xla")).kernels == "torch"
    assert config_from_jax(jmg.SolverConfig()) == tmg.SolverConfig()

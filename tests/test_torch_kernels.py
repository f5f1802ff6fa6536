"""The port's kernel module (multigrid_poisson_solver_tpu_torch.ops.kernels)
against the JAX package's Pallas kernels.

On the CPU every public kernel function runs its plain PyTorch twin, so these
tests hold each twin against the Pallas entry point it replaces, run in
interpret mode as tests/test_pallas.py runs them. The CUDA kernels themselves
are held against the same twins on the card by chip_smoke.py.

Tolerances (fp32): the Pallas smoother folds the update into
u + (ω/4)(nb − 4u) − (ω/4)h²f while the twin keeps the oracle's increment
form u + ω·¼(nb − 4u − h²f), so iterates differ by a few ulps per sweep:
|Δu| ≤ 1e-5·max|u|. Error scalars are sums of ~n² terms in another order:
1e-4 relative. Residuals carry the fp32 cancellation noise eps·|u|/h².
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import padded as P
from multigrid_poisson_solver_tpu.ops import pallas_chain as pc
from multigrid_poisson_solver_tpu.ops import pallas_kernels as pk
from multigrid_poisson_solver_tpu_torch import REFERENCE_PROBLEM, SolverConfig, v_cycle
from multigrid_poisson_solver_tpu_torch import compiled
from multigrid_poisson_solver_tpu_torch.ops import build
from multigrid_poisson_solver_tpu_torch.ops import kernels as K

U_RTOL = 1e-5
ERR_RTOL = 1e-4
OMEGA = 0.8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grids(rng, n, count):
    return [rng.standard_normal((n, n)).astype(np.float32) for _ in range(count)]


def _jx(a):
    return layout.pad_grid(jnp.asarray(a))


def _th(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unpad(x, n):
    return np.asarray(x)[:n, :n]


def _assert_u(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=U_RTOL * scale)


@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("n,steps", [(65, 3), (129, 8), (129, 11)])
def test_fused_jacobi_twin_matches_pallas(rng, n, steps, from_zero):
    u, f = _grids(rng, n, 2)
    if from_zero:
        u = np.zeros_like(u)
    h = 1.0 / (n - 1)
    want = pk.fused_jacobi_padded(_jx(u), _jx(f), n, h, steps, omega=OMEGA,
                                  from_zero=from_zero, interpret=True)
    got = K.fused_jacobi_torch(_th(u), _th(f), h, steps, OMEGA, from_zero)
    _assert_u(got, _unpad(want, n))


@pytest.mark.parametrize("n,steps,from_zero", [(65, 1, True), (129, 3, False),
                                               (129, 7, True)])
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_fused_jacobi_err_twin_matches_pallas(rng, compat, n, steps, from_zero):
    u, f = _grids(rng, n, 2)
    if from_zero:
        u = np.zeros_like(u)
    h = 1.0 / (n - 1)
    want_u, want_err = pk.fused_jacobi_err_padded(
        _jx(u), _jx(f), n, h, steps, omega=OMEGA, compat=compat,
        from_zero=from_zero, interpret=True)
    got_u, got_err = K.fused_jacobi_err_torch(_th(u), _th(f), h, steps, OMEGA, compat,
                                              from_zero)
    _assert_u(got_u, _unpad(want_u, n))
    assert float(got_err) == pytest.approx(float(want_err), rel=ERR_RTOL)


@pytest.mark.parametrize("n", [65, 129])
@pytest.mark.parametrize("negate", [False, True])
def test_residual_twin_matches_pallas(rng, n, negate):
    u, f = _grids(rng, n, 2)
    h = 1.0 / (n - 1)
    want = pk.residual_pallas(_jx(u), _jx(f), n, h, negate=negate, interpret=True)
    got = K.residual_torch(_th(u), _th(f), h, negate)
    # the fp32 cancellation noise of a 5-point residual: ~eps·|u|·k/h²
    atol = 8 * 1.2e-7 * float(np.abs(u).max()) / (h * h)
    np.testing.assert_allclose(got.numpy(), _unpad(want, n), rtol=0, atol=atol)


@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("n,steps,compat", [(65, 3, True), (129, 6, "gpu")])
def test_fused_descend_twin_matches_pallas(rng, n, steps, compat, restriction, from_zero):
    u, f = _grids(rng, n, 2)
    if from_zero:
        u = np.zeros_like(u)
    m = (n + 1) // 2
    h = 1.0 / (n - 1)
    want_u, dwide, want_err = pk.fused_descend_padded(
        _jx(u), _jx(f), n, h, steps, omega=OMEGA, restriction=restriction,
        compat=compat, want_err=True, from_zero=from_zero, interpret=True)
    want_fc = _unpad(P.restrict_lanes_p(dwide, n, m, layout.padded_shape(m)), m)
    got_u, got_fc, got_err = K.fused_descend_torch(
        _th(u), _th(f), h, steps, OMEGA, restriction, compat, True, from_zero)
    _assert_u(got_u, _unpad(want_u, n))
    assert got_fc.shape == (m, m)
    # the Pallas kernel recovers r from an extra sweep's Δ; the twin evaluates
    # r directly: fp32 op-order differences on a residual-sized quantity
    atol = 2e-6 * (float(np.abs(want_fc).max()) + 1)
    np.testing.assert_allclose(got_fc.numpy(), want_fc, rtol=0, atol=atol)
    assert float(got_err) == pytest.approx(float(want_err), rel=ERR_RTOL)


@pytest.mark.parametrize("n,steps,want_err,compat", [
    (65, 3, False, True), (65, 3, True, False), (129, 7, True, True),
    (129, 8, True, "gpu"), (129, 8, False, True)])
def test_fused_ascend_twin_matches_pallas(rng, n, steps, want_err, compat):
    uf, f = _grids(rng, n, 2)
    m = (n + 1) // 2
    uc = rng.standard_normal((m, m)).astype(np.float32)
    uc[0, :] = uc[-1, :] = uc[:, 0] = uc[:, -1] = 0
    h = 1.0 / (n - 1)
    ufp = _jx(uf)
    rp, cp = ufp.shape
    cwide = P.prolong_lanes_p(_jx(uc), m, n, (rp // 2 + 8, cp))
    want_u, want_err = pk.fused_ascend_padded(ufp, _jx(f), cwide, n, h, steps,
                                              omega=OMEGA, compat=compat,
                                              want_err=want_err, interpret=True)
    got_u, got_err = K.fused_ascend_torch(_th(uf), _th(f), _th(uc), h, steps, OMEGA,
                                          compat, want_err)
    _assert_u(got_u, _unpad(want_u, n))
    if want_err:
        assert float(got_err) == pytest.approx(float(want_err), rel=ERR_RTOL)
    else:
        assert got_err is None


def _chain_inputs(rng, n0, n_min=5):
    sizes = pc.chain_sizes(n0, n_min=n_min)
    u0, f0 = _grids(rng, n0, 2)
    return sizes, u0, f0, 1.0 / (n0 - 1)


@pytest.mark.parametrize("entry_from_zero", [False, True])
@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
def test_chain_descend_twin_matches_pallas(rng, restriction, entry_from_zero):
    sizes, u0, f0, h0 = _chain_inputs(rng, 65)
    c = len(sizes) - 1
    steps = (3, 2, 4, 1)[:c]
    want_u, want_f = pc.fused_chain_descend(
        _jx(u0), _jx(f0), sizes, h0, steps, OMEGA, restriction=restriction,
        entry_from_zero=entry_from_zero, interpret=True)
    got_u, got_f = K.chain_descend_torch(_th(u0), _th(f0), sizes, h0, steps, OMEGA,
                                         restriction, entry_from_zero)
    assert len(got_u) == len(got_f) == c
    for k in range(c):
        assert got_u[k].shape == (sizes[k], sizes[k])
        assert got_f[k].shape == (sizes[k + 1], sizes[k + 1])
        _assert_u(got_u[k], _unpad(want_u[k], sizes[k]))
        # each level's −r is formed another way (the one-level leg test's
        # 2e-6), and a level's difference carries into every level below it
        wf = _unpad(want_f[k], sizes[k + 1])
        np.testing.assert_allclose(got_f[k].numpy(), wf, rtol=0,
                                   atol=2e-6 * (k + 1) * (float(np.abs(wf).max()) + 1))


@pytest.mark.parametrize("compat,want_err", [(True, False), (True, True), (False, True)])
def test_chain_ascend_twin_matches_pallas(rng, compat, want_err):
    sizes, u0, f0, h0 = _chain_inputs(rng, 65)
    c = len(sizes) - 1
    u_list, f_list = pc.fused_chain_descend(_jx(u0), _jx(f0), sizes, h0, (2,) * c, OMEGA,
                                            interpret=True)
    nb = sizes[-1]
    uc = np.zeros((nb, nb), np.float32)
    uc[1:-1, 1:-1] = rng.standard_normal((nb - 2, nb - 2))
    f_at = [_jx(f0)] + list(f_list[:-1])
    post = (3, 0, 2, 1)[:c]
    want = pc.fused_chain_ascend(list(u_list), f_at, _jx(uc), sizes, h0, post, OMEGA,
                                 interpret=True, compat=compat if want_err else None)
    want_u, want_e = want if want_err else (want, None)
    got_u, got_e = K.chain_ascend_torch(
        [_th(_unpad(u_list[k], sizes[k])) for k in range(c)],
        [_th(_unpad(f_at[k], sizes[k])) for k in range(c)], _th(uc), sizes, h0, post,
        OMEGA, compat, want_err)
    _assert_u(got_u, _unpad(want_u, sizes[0]))
    if want_err:
        assert float(got_e) == pytest.approx(float(want_e), rel=ERR_RTOL)
    else:
        assert got_e is None


@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_trigger_smooth_twin_matches_pallas(rng, compat):
    n, h = 65, 1.0 / 64
    u, f = _grids(rng, n, 2)
    want_u, want_e = pc.fused_trigger_vmem(_jx(u), _jx(f), n, h, 0.05, 0.9, compat, 500,
                                           interpret=True)
    got_u, got_e, sweeps = K.trigger_smooth_torch(_th(u), _th(f), h, 0.9, compat, 0.05, 500)
    assert 1 < int(sweeps) < 500
    _assert_u(got_u, _unpad(want_u, n))
    assert float(got_e) == pytest.approx(float(want_e), rel=ERR_RTOL)


def test_trigger_smooth_stops_at_max_sweeps(rng):
    u, f = (_th(a) for a in _grids(rng, 33, 2))
    got_u, _, sweeps = K.trigger_smooth_torch(u, f, 1.0 / 32, OMEGA, True, 0.0, 7)
    assert int(sweeps) == 7
    assert torch.equal(got_u, K.fused_jacobi_torch(u, f, 1.0 / 32, 7, OMEGA))


@pytest.mark.parametrize("sizes,steps,match", [
    ((33, 16), (2,), "2:1"), ((33, 17, 9), (2, 9), "sweep counts"),
    ((33, 17), (2, 2), "one sweep count per level")])
def test_chain_wrappers_refuse_bad_ladders(rng, sizes, steps, match):
    u, f = (_th(a) for a in _grids(rng, 33, 2))
    with pytest.raises(ValueError, match=match):
        K.chain_descend(u, f, sizes, 1.0 / 32, steps, OMEGA)
    with pytest.raises(ValueError, match=match):
        K.chain_ascend([u], [f], u, sizes, 1.0 / 32, steps, OMEGA)


@pytest.mark.parametrize("n,fits", [(17, True), (1025, True), (2049, True), (2176, True),
                                    (2177, False), (4097, False)])
def test_trigger_fits_agrees_with_jax(n, fits):
    assert K.trigger_fits(n) == pc.trigger_fits(n) == fits


@pytest.mark.parametrize("sizes", [(1025, 513, 257), (2049, 1025), (65, 33), (65,),
                                   (64, 32), (33, 17, 10)])
def test_chain_fits_agrees_with_jax(sizes):
    assert K.chain_fits(sizes) == pc.chain_fits(sizes)


def test_public_entry_points_run_the_twins_on_cpu_tensors(rng):
    """CPU tensors route to the plain twins, and nothing else does the routing."""
    n, h = 33, 1.0 / 32
    u, f = (_th(a) for a in _grids(rng, n, 2))
    uc = _th(rng.standard_normal((17, 17)).astype(np.float32))
    assert torch.equal(K.fused_jacobi(u, f, h, 3, OMEGA),
                       K.fused_jacobi_torch(u, f, h, 3, OMEGA))
    for a, b in zip(K.fused_jacobi_err(u, f, h, 3, OMEGA, "gpu"),
                    K.fused_jacobi_err_torch(u, f, h, 3, OMEGA, "gpu")):
        assert torch.equal(a, b)
    assert torch.equal(K.residual(u, f, h, True), K.residual_torch(u, f, h, True))
    for a, b in zip(K.fused_descend(u, f, h, 2, OMEGA, "full_weighting", True, True),
                    K.fused_descend_torch(u, f, h, 2, OMEGA, "full_weighting", True, True)):
        assert torch.equal(a, b)
    for a, b in zip(K.fused_ascend(u, f, uc, h, 2, OMEGA, False, True),
                    K.fused_ascend_torch(u, f, uc, h, 2, OMEGA, False, True)):
        assert torch.equal(a, b)
    sizes = (33, 17, 9)
    args = (sizes, h, (2, 3), OMEGA, "sampling", False)
    u_list, f_list = K.chain_descend(u, f, *args)
    for a, b in zip(u_list + f_list, sum(K.chain_descend_torch(u, f, *args), [])):
        assert torch.equal(a, b)
    uc9 = _th(rng.standard_normal((9, 9)).astype(np.float32))
    args = (u_list, [f] + f_list[:-1], uc9, sizes, h, (1, 2), OMEGA, True, True)
    for a, b in zip(K.chain_ascend(*args), K.chain_ascend_torch(*args)):
        assert torch.equal(a, b)
    for a, b in zip(K.trigger_smooth(u, f, h, OMEGA, True, 0.5, 40),
                    K.trigger_smooth_torch(u, f, h, OMEGA, True, 0.5, 40)):
        assert torch.equal(a, b)
    assert all(v == 0 for v in K.launches.values())


def test_cuda_only_calls_raise_on_cpu_tensors(rng):
    """kernels='cuda' asks for the kernels: on a CPU device that is an error,
    never a silent plain run; a kernel launch refuses CPU tensors."""
    program = v_cycle(33, n_min=8, steps=3, coarse_option=0, coarsen=3)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        compiled.compile_program(program, REFERENCE_PROBLEM,
                                 SolverConfig(kernels="cuda"), device="cpu")
    u, f = (_th(a) for a in _grids(rng, 33, 2))
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        K._jacobi_cuda(u, f, 1.0 / 32, 3, OMEGA, False, None)


@pytest.mark.parametrize("cfg,missing", [
    (SolverConfig(smoother="rbgs", kernels="cuda"), "fused_rbgs_padded"),
    (SolverConfig(trigger_batch=4, kernels="cuda"), "fused_jacobi_errs_padded"),
])
def test_unported_kernel_modes_raise(monkeypatch, cfg, missing):
    """Formerly refused on the kernel path, both configurations now route to
    their kernels: the rb-GS modes for smoother='rbgs', the per-sweep error
    mode for trigger_batch=4 on a level above the whole-loop kernels."""
    compiled._check_ported(cfg, use_kernels=True)
    compiled._check_ported(cfg, use_kernels=False)
    monkeypatch.setattr(compiled, "_use_kernels", lambda c, device: True)
    monkeypatch.setattr(K, "trigger_fits", lambda n: False)
    monkeypatch.setattr(K, "trigger_stream_fits", lambda n: False)
    calls = []
    names = {"fused_rbgs_padded": ("fused_rbgs", "fused_rbgs_err"),
             "fused_jacobi_errs_padded": ("fused_jacobi_errs",)}[missing]
    for name in names:
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _name=name, **kw: (calls.append(_name),
                                                                            _fn(*a, **kw))[1])
    steps = 2 if cfg.smoother == "rbgs" else -1
    program = v_cycle(33, n_min=8, steps=steps, coarse_option=0, coarsen=3)
    cfg = SolverConfig(smoother=cfg.smoother, trigger_batch=cfg.trigger_batch,
                       restriction="full_weighting" if cfg.smoother == "rbgs" else "sampling",
                       omega=0.8)
    cc = compiled.compile_program(program, REFERENCE_PROBLEM, cfg, device="cpu")
    u, err = cc(*cc.init())
    assert torch.isfinite(u).all() and torch.isfinite(err)
    # rb-GS: 2 fused-error passes on the finest level (descend, ascend) and
    # the plain passes of the 2 levels below; the batched trigger: a pass
    # per batch on every level
    assert set(calls) == set(names) and len(calls) >= 4


@pytest.mark.parametrize("steps", [1, 4, 7, 8])
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_fused_jacobi_errs_twin_matches_pallas(rng, compat, steps):
    if steps > K.errs_sweep_cap(compat):
        with pytest.raises(ValueError, match="per-sweep error pass"):
            K.fused_jacobi_errs(*(_th(a) for a in _grids(rng, 33, 2)), 1 / 32, steps, OMEGA,
                                compat)
        return
    n = 65
    u, f = _grids(rng, n, 2)
    h = 1.0 / (n - 1)
    want_u, want_e = pk.fused_jacobi_errs_padded(_jx(u), _jx(f), n, h, steps, omega=OMEGA,
                                                 compat=compat, interpret=True)
    got_u, got_e = K.fused_jacobi_errs_torch(_th(u), _th(f), h, steps, OMEGA, compat)
    _assert_u(got_u, _unpad(want_u, n))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=ERR_RTOL)
    # errs[s − 1] is what fused_jacobi_err reports after s sweeps, bit for bit
    for s in range(1, steps + 1):
        assert torch.equal(got_e[s - 1],
                           K.fused_jacobi_err_torch(_th(u), _th(f), h, s, OMEGA, compat)[1])


@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("n,steps", [(65, 1), (65, 4), (129, 6)])
def test_fused_rbgs_twin_matches_pallas(rng, n, steps, from_zero):
    u, f = _grids(rng, n, 2)
    if from_zero:
        u = np.zeros_like(u)
    h = 1.0 / (n - 1)
    want = pk.fused_rbgs_padded(_jx(u), _jx(f), n, h, steps, from_zero=from_zero,
                                interpret=True)
    _assert_u(K.fused_rbgs_torch(_th(u), _th(f), h, steps, from_zero), _unpad(want, n))


@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("n,steps", [(65, 2), (129, 5)])
def test_fused_rbgs_err_twin_matches_pallas(rng, n, steps, compat, from_zero):
    u, f = _grids(rng, n, 2)
    if from_zero:
        u = np.zeros_like(u)
    h = 1.0 / (n - 1)
    want_u, want_e = pk.fused_rbgs_err_padded(_jx(u), _jx(f), n, h, steps, compat=compat,
                                              from_zero=from_zero, interpret=True)
    got_u, got_e = K.fused_rbgs_err_torch(_th(u), _th(f), h, steps, compat, from_zero)
    _assert_u(got_u, _unpad(want_u, n))
    assert float(got_e) == pytest.approx(float(want_e), rel=ERR_RTOL)
    with pytest.raises(ValueError, match="gpu metric"):
        K.fused_rbgs_err(_th(u), _th(f), h, steps, "gpu")


@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_trigger_stream_twin_matches_pallas(compat):
    """The streamed whole-loop kernel's twin (the sweep-at-a-time loop)
    against fused_trigger_stream in interpret mode, on the inputs of
    tests/test_pallas_chain.py: the same stop, the same iterate and error."""
    n = 129
    rng = np.random.default_rng(5)
    u = rng.standard_normal((n, n)).astype(np.float32)
    f = (10 * rng.standard_normal((n, n))).astype(np.float32)
    h = 1.0 / (n - 1)
    want_u, want_e = pc.fused_trigger_stream(_jx(u), _jx(f), n, h, 30.0, 0.8, compat, 200,
                                             interpret=True)
    got_u, got_e, sweeps = K.trigger_smooth_stream(_th(u), _th(f), h, 0.8, compat, 30.0, 200)
    assert 1 < int(sweeps) < 200
    _assert_u(got_u, _unpad(want_u, n))
    assert float(got_e) == pytest.approx(float(want_e), rel=ERR_RTOL)


@pytest.mark.parametrize("n,fits", [(129, True), (2177, True), (4097, True), (4113, True),
                                    (5232, True), (5233, False), (8193, False)])
def test_trigger_stream_fits_agrees_with_jax(n, fits):
    assert K.trigger_stream_fits(n) == pc.trigger_stream_fits(n) == fits


def test_new_entry_points_run_the_twins_on_cpu_tensors(rng):
    n, h = 33, 1.0 / 32
    u, f = (_th(a) for a in _grids(rng, n, 2))
    for a, b in zip(K.fused_jacobi_errs(u, f, h, 5, OMEGA, True),
                    K.fused_jacobi_errs_torch(u, f, h, 5, OMEGA, True)):
        assert torch.equal(a, b)
    assert torch.equal(K.fused_rbgs(u, f, h, 6, True), K.fused_rbgs_torch(u, f, h, 6, True))
    for a, b in zip(K.fused_rbgs_err(u, f, h, 5, False), K.fused_rbgs_err_torch(u, f, h, 5, False)):
        assert torch.equal(a, b)
    for a, b in zip(K.trigger_smooth_stream(u, f, h, OMEGA, "gpu", 0.5, 40),
                    K.trigger_smooth_torch(u, f, h, OMEGA, "gpu", 0.5, 40)):
        assert torch.equal(a, b)
    assert all(v == 0 for v in K.launches.values())


def test_kernel_path_refuses_other_dtypes():
    cfg = SolverConfig(dtype=torch.float64, kernels="cuda")
    with pytest.raises(TypeError, match="float32"):
        compiled._check_ported(cfg, use_kernels=True)
    compiled._check_ported(cfg, use_kernels=False)


def test_c_entry_points_match_ctypes_signatures():
    """Nothing compiles the CUDA sources on a CPU box, so check statically
    that every extern "C" entry point is declared to ctypes with its arity."""
    found = {}
    for src in build.sources():
        text = src.read_text()
        for name, params in re.findall(r'extern "C" [\w\s\*]+?\b(mg3?_\w+)\(([^)]*)\)', text):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert set(found) == set(build.SIGNATURES)
    for name, (argtypes, _) in build.SIGNATURES.items():
        assert len(argtypes) == found[name], name
    assert {s.name for s in build.sources()} == {
        "common.cuh", "legs.cuh", "jacobi.cu", "residual.cu", "descend.cu", "ascend.cu",
        "chain_descend.cu", "chain_ascend.cu", "trigger.cu", "residual_mw.cu",
        "trigger_stream.cu", "legs3.cuh", "jacobi3.cu", "descend3.cu", "ascend3.cu",
        "residual3.cu", "trigger3.cu", "trigger3_stream.cu", "residual_mw3.cu", "ring.cuh",
        "rdma.cuh", "rdma_jacobi.cu", "rdma_trigger.cu", "rdma3.cuh", "rdma_jacobi3.cu",
        "rdma_descend3.cu", "rdma_ascend3.cu", "rdma_trigger3.cu"}
    assert build.library_path().parent == build.BUILD_DIR
    assert Path(build.library_path()).name.startswith("libmg_kernels_")

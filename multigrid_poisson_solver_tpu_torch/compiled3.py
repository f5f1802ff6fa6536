"""The whole-schedule 3-D engine: a CycleProgram run as one fixed sequence of
device operations, on one device or on a z-plane mesh.

PyTorch port of ``multigrid_poisson_solver_tpu/compiled3.py``. The JAX
engine traces the instruction walk into one jitted program; PyTorch runs
eagerly, so ``_run3`` (the counterpart of ``_trace_program3``) issues the
level operations directly. Node semantics are ``solver3.Solver3D``'s.

On the kernel path (``SolverConfig.kernels`` "auto" on a CUDA device, or
"cuda") the routing keeps JAX's predicates, in JAX's order, so a schedule
reaches the same operations (``ops.kernels3``), on levels of at least 65³
with the Jacobi smoother:

  * smoothing: passes of at most 8 sweeps, the error metric fused into the
    final pass, the clean metric only with at most 7 sweeps there, else one
    residual pass;
  * descend: on a 2:1 level with the clean metric and a sweep count within
    the cap, the fused descend leg; else smoothing, then on a 2:1 level the
    negated residual kernel and the 2:1 restriction, else the general
    trilinear restriction;
  * ascend: on a 2:1 level with 1..8 sweeps and the clean metric, the fused
    ascend leg, its error fused in only when the node is the program's last
    and runs at most 7 sweeps (else one residual pass at the last node);
    else the prolongation and add, then smoothing.

A trigger node (``steps == -1``) on the kernel path at 65³ or more runs
JAX's tiers in JAX's order (``_trigger_p``): its whole loop as one kernel
where ``trigger3_fits`` (up to about 170³: 129³, 65³), or as the streamed
whole-loop kernel where ``trigger3_stream_fits`` (the 257³ class); with an
integer ``trigger_batch > 1`` passes of min(batch, ``errs3_sweep_cap``)
sweeps with the error of every iterate (``fused_jacobi3_errs``), the stop
rule replayed over them, overshooting the stop sweep by up to B − 1 sweeps;
with ``"auto"`` 2B exact sweeps first, then such passes; with 1 the exact
loop of one-sweep error launches (``trigger_step3``) and one host stop test
per sweep. All of them measure the error with one tile plan
(``ops.kernels3.err_plan3``), so the exact tiers stop where the one-sweep
loop stops, bit for bit.

Smaller levels, rb-GS, non-2:1 transfers and the coarse solves run the
oracle ops; so does every trigger node on the plain path, as
``models.poisson3d.trigger_smooth3`` does.

Under a ``parallel.mesh.ZShardingPolicy3`` (``policy=``) a level the policy
shards, with the Jacobi smoother (JAX's ``sharded()``), is a
``parallel.sharded.ShardedGrid`` of z-plane blocks; other levels are
tensors on the mesh's first device, and the glue (restriction off the
legs, prolongation, zoom, coarse solve) runs on gathered volumes. Sharded
levels route in JAX's order (``compiled3.py:126-300``, ``:496-545``,
``:619-676``), with JAX's planes per device (``padded_depth // P``):
smoothing passes with the error fused into the last
(``parallel.kernel_shard3``); a trigger node as the one-sweep sharded error
loop, with an integer batch one exact sweep and then per-sweep passes of B
sweeps (B cut until its halo fits), with "auto" 2B exact sweeps and then
such passes where the single-device engine would batch too; the descend leg
per shard where the clean metric and JAX's nl admit it, else smoothing, the
sharded residual and the restriction; the ascend leg per shard, its error
fused in at the last node where the deeper halo fits, else one sharded
residual pass. Without kernels the sharded levels run
``parallel.halo3``'s plain per-shard ops, which reproduce the unsharded
plain path.

With ``SolverConfig(halo="rdma")`` a sharded level on the kernel path takes
JAX's ring kernels (``ops.rdma3``, one launch over the ring with the plane
exchange inside) wherever JAX's admission predicates pass on its nl and
padded (rp, cp), in JAX's order (``compiled3.py:140-151``, ``:204-220``,
``:511-522``, ``:642-650``): the smoothing passes with the error
(``rdma_jacobi3_fits`` of the final pass's min(k, 7) sweeps, the clean
error's halo included); a trigger node's whole loop in one launch
(``rdma_trigger3_fits``), tested before any batching, so under "rdma" a
level that fits stops where the exact loop stops whatever
``trigger_batch`` says; the descend leg (``rdma_descend3_fits``) and the
ascend leg (``rdma_ascend3_fits``, the last node's error included). The
results are the exchange path's, bit for bit. A ring launch runs every
shard on one card: under "rdma" a mesh over several cards is refused, as
in the 2-D engine.
"""

from __future__ import annotations

import torch

from .compiled import (_batched_trigger, _check_ported, _first_pass_trigger, _two_phase_trigger,
                       _use_kernels)
from .grid import GridSpec
from .models import poisson3d as p3
from .models.poisson3d import KERNEL3_MIN_N, Problem3D
from .ops import kernels3 as K3
from .ops import rdma3 as R3
from .ops import transfers3 as T3
from .ops.zoom import zoom3
from .parallel import halo3
from .parallel import kernel_shard3 as KS3
from .parallel.sharded import as_level, gather, home, on_device
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import SolverConfig, trigger_loop
from .solver3 import _prolong_add3, _restrict_residual3, coarse_solve3, smooth3_node


def _trigger_p(lu, lf, n: int, h: float, cfg: SolverConfig, compat: str):
    """A Jacobi trigger node on the kernel path (JAX's ``trigger_p``, single
    device): (u, err, sweeps run), routed as in the module docstring."""
    args = (cfg.omega, compat, cfg.trigger, cfg.max_trigger_sweeps)
    if K3.trigger3_fits(n):
        return K3.trigger_smooth3(lu, lf, h, *args)
    if K3.trigger3_stream_fits(n):
        return K3.trigger_smooth3_stream(lu, lf, h, *args)
    batch = K3.errs3_sweep_cap(compat)
    if isinstance(cfg.trigger_batch, int) and cfg.trigger_batch > 1:
        batch = min(cfg.trigger_batch, batch)

    def step(v):
        return K3.trigger_step3(v, lf, h, cfg.omega, compat)

    def passes(v):
        return K3.fused_jacobi3_errs(v, lf, h, batch, cfg.omega, compat)

    if isinstance(cfg.trigger_batch, int) and cfg.trigger_batch > 1:
        return _first_pass_trigger(passes, lu, cfg, batch)
    if cfg.trigger_batch == "auto":
        return _two_phase_trigger(step, passes, lu, cfg, batch)
    return trigger_loop(step, lu, cfg.trigger, cfg.max_trigger_sweeps)


def _sharded3(policy, cfg: SolverConfig, n: int) -> bool:
    """Whether level n is z-sharded: the policy shards it and the smoother
    is Jacobi (JAX's ``sharded()``, ``compiled3.py:77-79``)."""
    return policy is not None and cfg.smoother == "jacobi" and policy.is_sharded(n)


def _layout3(x, n: int, policy, cfg: SolverConfig, device):
    """Level n's array in its layout: z blocks where it is sharded, else a
    tensor on ``device`` (as it is without a policy)."""
    if policy is None:
        return x
    return as_level(x, policy, n) if _sharded3(policy, cfg, n) else gather(x, device)


def _ring3(cfg: SolverConfig, use_kernels: bool) -> bool:
    """Whether sharded levels may take the ring kernels (``halo="rdma"``)."""
    return use_kernels and cfg.halo == "rdma"


def _trigger_sharded(lu, lf, n: int, h: float, cfg: SolverConfig, compat: str, nl: int,
                     use_kernels: bool):
    """A trigger node on a sharded level (JAX's sharded ``trigger_p``):
    (u, err, sweeps run), routed as in the module docstring."""
    if _ring3(cfg, use_kernels) and R3.rdma_trigger3_fits(nl, *R3.padded_rc(n), cfg.dtype.itemsize):
        return KS3.rdma_fused_trigger3(lu, lf, h, cfg.omega, compat, cfg.trigger,
                                       cfg.max_trigger_sweeps)
    if not use_kernels:
        def plain(v):
            return halo3.sharded_smooth3_err(v, lf, h, 1, cfg.omega, compat)

        return trigger_loop(plain, lu, cfg.trigger, cfg.max_trigger_sweeps)

    def step(v):
        return KS3.sharded_trigger_step3(v, lf, h, cfg.omega, compat, nl)

    cap = K3.errs3_sweep_cap(compat)
    batch = min(cfg.trigger_batch if isinstance(cfg.trigger_batch, int) else cap, cap)
    while batch > 1 and batch + (compat == "clean") > nl:
        batch -= 1   # the pass's halo must fit the planes per device

    def passes(v):
        return KS3.sharded_fused_jacobi3_errs(v, lf, h, batch, cfg.omega, compat, nl)

    if isinstance(cfg.trigger_batch, int) and cfg.trigger_batch > 1 and batch > 1:
        # one exact sweep, then passes from its error (JAX's sbatched_from)
        u1, err1 = step(lu)
        return _batched_trigger(passes, u1, cfg, batch, err1, 1)
    # "auto" batches only where the single-device engine would too
    if (cfg.trigger_batch == "auto" and batch > 1
            and not (K3.trigger3_fits(n) or K3.trigger3_stream_fits(n))):
        return _two_phase_trigger(step, passes, lu, cfg, batch)
    return trigger_loop(step, lu, cfg.trigger, cfg.max_trigger_sweeps)


def _run3(u0, f0, program: CycleProgram, problem: Problem3D, cfg: SolverConfig,
          device: torch.device, warm: bool, use_kernels: bool, trigger_sweeps=None,
          policy=None):
    """Walk the instruction sequence. Returns (u, last_err): the last level's
    iterate and the error of the most recent node that measured one;
    ``trigger_sweeps``, when a list, receives (n, sweeps run) of every
    trigger node. Under a policy, sharded levels are ShardedGrids, laid out
    for their size (``as_level``) as they are made."""
    compat = "gpu" if cfg.compat_error == "gpu" else "clean"
    jacobi = cfg.smoother == "jacobi"
    last_ins = program.instructions[-1]
    ring, isz = _ring3(cfg, use_kernels), cfg.dtype.itemsize

    def sharded(n):
        return _sharded3(policy, cfg, n)

    def lay(x, n):
        return _layout3(x, n, policy, cfg, device)

    def zeros(n):
        return lay(torch.zeros((n, n, n), dtype=cfg.dtype, device=device), n)

    def zero_interior(lu, n):
        out = gather(lu).clone()
        out[1:-1, 1:-1, 1:-1] = 0
        return lay(out, n)

    def mean_abs(r, n):
        return torch.sum(torch.abs(gather(r))) / (n ** 3)

    def smooth_sharded(lu, lf, n, h, steps):
        """(u, err, sweeps or None) of a sharded level."""
        nl = policy.planes_per_device(n)
        if steps == -1:
            return _trigger_sharded(lu, lf, n, h, cfg, compat, nl, use_kernels)
        k1 = min(steps, K3.MAX_FUSED_SWEEPS_3D, nl)
        if ring and R3.rdma_jacobi3_fits(nl, *R3.padded_rc(n), min(k1, 7), isz, err=compat != "gpu"):
            return (*KS3.rdma_fused_jacobi3_err(lu, lf, h, steps, cfg.omega, compat, nl=nl),
                    None)
        if use_kernels:
            return (*KS3.sharded_fused_jacobi3_err(lu, lf, h, steps, cfg.omega, compat,
                                                    nl=nl), None)
        return (*halo3.sharded_smooth3_err(lu, lf, h, steps, cfg.omega, compat), None)

    def smooth(lu, lf, n, h, steps):
        """(u, err); the kernel path's passes as in the module docstring."""
        fast = use_kernels and n >= KERNEL3_MIN_N and jacobi
        if sharded(n):
            lu, err, sweeps = smooth_sharded(lu, lf, n, h, steps)
            if steps == -1 and trigger_sweeps is not None:
                trigger_sweeps.append((n, int(sweeps)))
            return lu, err
        if steps == -1:
            lu, err, sweeps = (_trigger_p(lu, lf, n, h, cfg, compat) if fast
                               else smooth3_node(lu, lf, h, steps, cfg))
            if trigger_sweeps is not None:
                trigger_sweeps.append((n, int(sweeps)))
            return lu, err
        if not (fast and steps >= 1):
            return smooth3_node(lu, lf, h, steps, cfg)[:2]
        k, err = steps, None
        while k > 0:
            kk = min(k, K3.MAX_FUSED_SWEEPS_3D)
            emode = compat if k == kk else None          # the metric of the final pass
            if emode == "clean" and kk > K3.MAX_FUSED_SWEEPS_3D - 1:
                emode = None                             # the Δ ring needs ≤ 7 sweeps
            if emode is not None:
                lu, err = K3.fused_jacobi3_err(lu, lf, h, kk, cfg.omega, emode)
            else:
                lu = K3.fused_jacobi3(lu, lf, h, kk, cfg.omega)
            k -= kk
        if err is None:   # the clean metric after a full 8-sweep final pass
            err = mean_abs(K3.residual3(lu, lf, h), n)
        return lu, err

    spec0 = GridSpec(program.n_max, program.length, program.min_x, program.min_y)
    levels = [(spec0, u0, f0, False)]
    first_descend_done = warm
    last_err = torch.zeros((), dtype=cfg.dtype, device=device)

    for ins in program.instructions:
        spec, lu, lf, is_fmg = levels[-1]
        n, h = spec.n, spec.h

        if isinstance(ins, Descend):
            finest = len(levels) == 1
            if not (finest and first_descend_done) and not is_fmg:
                lu = zero_interior(lu, n) if finest else zeros(n)
            next_spec = spec.coarsened(ins.next_n)
            m = ins.next_n
            aligned = n == 2 * m - 1
            if ins.steps == 0:   # FMG descent: restrict the RHS itself
                f_c = zoom3(gather(lf), m, zero_boundary=True) + problem.boundary_grid(
                    m, cfg.dtype, device)
                levels[-1] = (spec, lu, lf, is_fmg)
                levels.append((next_spec, zeros(m), lay(f_c, m), True))
                continue
            fz = not finest and not is_fmg     # a freshly zeroed correction
            if sharded(n):
                # the descend leg per shard where JAX's shard depth admits it,
                # else smoothing, the sharded residual and the restriction
                nl = policy.planes_per_device(n)
                fw = cfg.restriction == "full_weighting"
                k_nb = ins.steps - fz
                cap = K3.MAX_DESCEND3_SWEEPS_FW if fw else K3.MAX_DESCEND3_SWEEPS_SAMPLING
                if (use_kernels and aligned and ins.steps >= 1 and compat == "clean"
                        and 0 <= k_nb <= cap and k_nb + 1 + fw <= nl):
                    down = KS3.sharded_fused_descend3
                    if ring and R3.rdma_descend3_fits(nl, *R3.padded_rc(n), ins.steps, fz, isz, fw):
                        down = KS3.rdma_fused_descend3
                    lu, f_c, last_err = down(lu, lf, h, ins.steps, cfg.omega, fz,
                                             cfg.restriction, True, nl)
                else:
                    lu, last_err = smooth(lu, lf, n, h, ins.steps)
                    if use_kernels and aligned:
                        f_c = T3.restrict3(gather(KS3.sharded_residual3(lu, lf, h, negate=True)),
                                           m, mode=cfg.restriction)
                    else:
                        f_c = _restrict_residual3(gather(lu), gather(lf), h, m,
                                                  restriction=cfg.restriction)
                levels[-1] = (spec, lu, lf, is_fmg)
                levels.append((next_spec, zeros(m), lay(f_c, m), False))
                continue
            cap = (K3.MAX_DESCEND3_SWEEPS_FW if cfg.restriction == "full_weighting"
                   else K3.MAX_DESCEND3_SWEEPS_SAMPLING)
            if (use_kernels and aligned and n >= KERNEL3_MIN_N and ins.steps >= 1
                    and compat == "clean" and jacobi and ins.steps - fz <= cap):
                # sweeps + residual + restriction + the clean error in one kernel
                lu, f_c, last_err = K3.fused_descend3(lu, lf, h, ins.steps, cfg.omega,
                                                      from_zero=fz, restriction=cfg.restriction,
                                                      want_err=True)
            else:
                lu, last_err = smooth(lu, lf, n, h, ins.steps)
                if use_kernels and aligned and n >= KERNEL3_MIN_N:
                    f_c = T3.restrict3(K3.residual3(lu, lf, h, negate=True), m,
                                       mode=cfg.restriction)
                else:
                    f_c = _restrict_residual3(lu, lf, h, m, restriction=cfg.restriction)
            levels[-1] = (spec, lu, lf, is_fmg)
            levels.append((next_spec, zeros(m), lay(f_c, m), False))

        elif isinstance(ins, CoarseSolve):
            lu, err, _ = coarse_solve3(gather(lf), h, ins, cfg.dtype, cfg.coarse_gs_norm)
            if err is not None:
                last_err = err
            levels[-1] = (spec, lay(lu, n), lf, is_fmg)

        elif isinstance(ins, Ascend):
            child_spec, cu, _, _ = levels.pop()
            spec, lu, lf, is_fmg = levels[-1]
            n, h = spec.n, spec.h
            m = child_spec.n
            aligned = n == 2 * m - 1
            if sharded(n):
                nl = policy.planes_per_device(n)
                ext_z, ext_c = KS3.ascend3_halo(ins.steps, False)
                if (use_kernels and aligned and 1 <= ins.steps <= K3.MAX_FUSED_SWEEPS_3D
                        and compat == "clean" and ext_z <= nl and ext_c + 1 <= nl // 2):
                    # the ascend leg per shard, the last node's error fused in
                    # where the deeper halo fits
                    ze, zc = KS3.ascend3_halo(ins.steps, True)
                    want_err = (ins is last_ins and ins.steps <= K3.MAX_FUSED_SWEEPS_3D - 1
                                and ze <= nl and zc + 1 <= nl // 2)
                    up = KS3.sharded_fused_ascend3
                    if ring and R3.rdma_ascend3_fits(nl, *R3.padded_rc(n), ins.steps, want_err, isz):
                        up = KS3.rdma_fused_ascend3
                    lu, err = up(lu, lf, cu, h, ins.steps, cfg.omega, want_err, nl)
                    if want_err:
                        last_err = err
                    elif ins is last_ins:
                        last_err = mean_abs(KS3.sharded_residual3(lu, lf, h), n)
                else:
                    if use_kernels and aligned:
                        lu = T3.prolong3_add(gather(lu), gather(cu, device), interior_only=True)
                    else:
                        lu = _prolong_add3(gather(cu, device), gather(lu), n)
                    lu = lay(lu, n)
                    if ins.steps != 0:
                        lu, last_err = smooth(lu, lf, n, h, ins.steps)
                if len(levels) == 1:
                    first_descend_done = True
                levels[-1] = (spec, lu, lf, is_fmg)
                continue
            cu = gather(cu, device)
            if (use_kernels and aligned and n >= KERNEL3_MIN_N
                    and 1 <= ins.steps <= K3.MAX_FUSED_SWEEPS_3D and compat == "clean"
                    and jacobi):
                # prolongation + add + post-sweeps in one kernel; the error only
                # where this node's is the program's result
                want_err = ins is last_ins and ins.steps <= K3.MAX_FUSED_SWEEPS_3D - 1
                lu, err = K3.fused_ascend3(lu, lf, cu, h, ins.steps, cfg.omega,
                                           want_err=want_err)
                if want_err:
                    last_err = err
                elif ins is last_ins:
                    last_err = mean_abs(K3.residual3(lu, lf, h), n)
            else:
                if use_kernels and aligned and n >= KERNEL3_MIN_N:
                    lu = T3.prolong3_add(lu, cu, interior_only=True)
                else:
                    lu = _prolong_add3(cu, lu, n)
                if ins.steps != 0:
                    lu, last_err = smooth(lu, lf, n, h, ins.steps)
            if len(levels) == 1:
                first_descend_done = True
            levels[-1] = (spec, lu, lf, is_fmg)
        else:  # pragma: no cover
            raise TypeError(f"unknown instruction {ins!r}")

    return levels[-1][1], last_err


class CompiledCycle3:
    """A CycleProgram bound to a 3-D problem, a numerical policy and a device.

    ``init()`` gives the finest level's ``(u0, f0)`` on the device; calling
    the object runs the program once and returns ``(u, err)``. With
    ``warm=False`` (the default, or per call) every run resets the finest
    iterate's interior first; ``warm=True`` continues from the given u (the
    reference's init flag). Arguments are never modified.

    With a ``ZShardingPolicy3`` the levels live on its mesh (``device`` is
    then the mesh's first device): ``init()`` and the call give a
    ``ShardedGrid`` where the finest level shards, and ``unpad(u)`` gathers
    the (n, n, n) volume.

    Set ``trigger_sweeps`` to a list to have every trigger node append
    ``(n, sweeps run)`` to it (one read from the device per node)."""

    trigger_sweeps = None

    def __init__(self, program: CycleProgram, problem: Problem3D,
                 config: SolverConfig = SolverConfig(), device="cuda", warm: bool = False,
                 policy=None):
        program.validate()
        self.program = program
        self.problem = problem
        self.config = config
        self.policy = policy
        self.device = home(policy, device)
        self.warm = warm
        self.use_kernels = _use_kernels(config, self.device)
        _check_ported(config, self.use_kernels)
        KS3.check_halo3(config.halo, policy.mesh if policy is not None and self.use_kernels
                        else None)

    @property
    def finest_spec(self) -> GridSpec:
        p = self.program
        return GridSpec(p.n_max, p.length, p.min_x, p.min_y)

    def _level(self, x, n: int):
        return _layout3(x, n, self.policy, self.config, self.device)

    def init(self):
        n, dtype = self.program.n_max, self.config.dtype
        b = self.problem.boundary_grid(n, dtype, self.device)
        f = self.problem.source_grid(n, dtype, self.device) + b
        return self._level(b.clone(), n), self._level(f, n)

    def __call__(self, u, f, warm=None):
        n = self.program.n_max
        with on_device(self.device):
            return _run3(self._level(u, n), self._level(f, n), self.program, self.problem,
                         self.config, self.device, self.warm if warm is None else warm,
                         self.use_kernels, self.trigger_sweeps, self.policy)

    def unpad(self, u) -> torch.Tensor:
        """The (n, n, n) volume of a finest-level iterate (gathered from its
        shards under a policy)."""
        return gather(u)

    def iterate(self, cycles: int):
        """``fn(u0, f) -> u``: one cold run, then ``cycles − 1`` warm ones."""
        def chained(u, f):
            u = self(u, f, warm=False)[0]
            for _ in range(cycles - 1):
                u = self(u, f, warm=True)[0]
            return u

        return chained


def compile_program3(program: CycleProgram, problem: Problem3D,
                     config: SolverConfig = SolverConfig(), device="cuda",
                     warm: bool = False, policy=None) -> CompiledCycle3:
    """Bind ``program`` to ``problem``, ``config`` and ``device`` (default
    ``"cuda"``; a CPU run needs ``device="cpu"``). ``policy``: a
    ``parallel.mesh.ZShardingPolicy3``; the levels then live on its mesh."""
    return CompiledCycle3(program, problem, config, device, warm, policy)

"""The whole-schedule engine: a CycleProgram run as one fixed sequence of
device operations.

PyTorch port of ``multigrid_poisson_solver_tpu/compiled.py``. The JAX engine
traces every instruction of a schedule into one jitted XLA program; PyTorch
runs eagerly, so here the same instruction walk (``_run``, the counterpart
of ``_run_traced``) issues the level operations directly. Every level shape,
sweep count and restriction target is static, so a cycle on the CUDA
kernel path enqueues kernels without reading anything back from the device,
except where the data decides: trigger smoothing (``steps == -1``) and the
Gauss-Seidel coarse solve test their stopping rule on the host once per
sweep.

Routing keeps the JAX engine's predicates, so a schedule reaches the same
operations (``ops.kernels``): a pure V below a level of at most 1025² runs
as two chain kernels around the coarse solve (``_match_chain``); a
2:1-aligned Jacobi descend or ascend with a fixed sweep count within the
fused budget runs as one fused-leg kernel; anything else runs sweeps
(Jacobi or rb-GS), residual, zoom and correction as separate operations. A
Jacobi trigger node runs, in JAX's order: its whole loop as one kernel on a
level of at most 2176² (``trigger_fits``), or up to 4097²
(``trigger_stream_fits``); with an integer ``trigger_batch > 1`` passes of
that many sweeps with the error of every iterate (``fused_jacobi_errs``),
the stop rule replayed over them; with ``"auto"`` 2B exact sweeps first and
then such passes of B = ``errs_sweep_cap`` sweeps; else the exact loop of
one fused sweep-plus-error launch and one host stop test per sweep. The
batched passes overshoot the stop sweep by up to B − 1 sweeps, as JAX's
do. The plain path keeps the exact loop everywhere, as JAX's XLA path does.
The names ``compile_program``/``CompiledCycle`` are kept for the
counterpart; nothing is compiled ahead of time except the CUDA kernels
(``ops.build``).

A bfloat16 state runs on the kernels where they have a bf16 mode, kernels
1-4 on the whole grid: a Jacobi program of fixed-step nodes without a
policy, its V-ladders level by level through the legs (the chains have no
bf16 mode). ``_check_ported`` raises for every other bf16 path on the
kernels (trigger nodes, rb-GS, a policy, 3-D) rather than run it plainly.

Under a sharding policy (``parallel.mesh``) a level the policy shards is a
``parallel.sharded.ShardedGrid``, a replicated one a tensor on the mesh's
first device; levels change layout between levels as JAX's GSPMD re-splits
them (``sharded.as_level``), and the glue (zoom, correction, coarse solve)
runs on the gathered grid. The routing keeps JAX's order: sharded levels run
the shard-mode kernels per shard after a halo exchange
(``parallel.kernel_shard``), or with ``SolverConfig(halo="rdma")`` on a
rows-only level the ring kernels (``ops.rdma``: the smoother's passes, and
the whole trigger loop where JAX's ``rdma_trigger_fits`` admits the shard);
the fused legs run per shard (JAX's ``_leg_sharded_ok``), never on a
replicated level under a policy; chains take no sharded level; replicated
levels take the single-device kernels for their sweeps and the plain ops
for the rest. Without kernels, sharded levels run ``parallel.halo``'s plain
per-shard ops. On a mesh of several processes (``parallel.multihost``) every
process runs the same calls on its own blocks, replicated levels on every
process; ``halo="rdma"`` is refused there (ROADMAP Queue 2 A1).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .grid import GridSpec
from .models.problems import Problem
from .ops import kernels as K
from .ops import rdma
from .ops import stencils
from .ops import transfers
from .ops.zoom import zoom
from .parallel import halo as sharded_halo
from .parallel import kernel_shard as KS
from .parallel import kernel_shard3 as KS3
from .parallel.sharded import as_level, gather, home, on_device
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import SolverConfig, coarse_solve, restrict, trigger_loop


def _use_kernels(cfg: SolverConfig, device: torch.device) -> bool:
    """Whether the hot path runs the CUDA kernels (``ops.kernels``)."""
    return K.use_kernels(cfg.kernels, device)


BF16_ITEM = "ROADMAP Queue 2 A2"


def _check_ported(cfg: SolverConfig, use_kernels: bool, program: CycleProgram = None,
                  policy=None, dim: int = 2) -> None:
    """The kernel path's admission rule, which refuses what the kernels do
    not take instead of quietly running the plain path: float32 everywhere;
    bfloat16 on kernels 1-4 alone (their bf16 modes), so for a 2-D Jacobi
    program whose nodes are all fixed-step (the legs, kernel 1, kernel 2,
    the plain transfers and coarse solves) without a sharding policy; a
    V-ladder that would take the chains runs level by level (``_match_chain``).
    ``kernels="torch"`` runs every dtype."""
    if not use_kernels or cfg.dtype == torch.float32:
        return
    if cfg.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernels take float32 (and bfloat16 on kernels 1-4), got "
                        f"dtype={cfg.dtype}; use kernels='torch' for other dtypes")
    if dim == 3:
        why = "the 3-D kernels (10-16, 19-22)"
    elif policy is not None:
        why = "a sharding policy (the shard modes and ring kernels)"
    elif cfg.smoother != "jacobi":
        why = f"smoother={cfg.smoother!r} (kernel 1's rb-GS mode)"
    elif program is not None and any(getattr(ins, "steps", 0) == -1
                                     for ins in program.instructions):
        why = "a trigger node (kernels 8 and 9, and kernel 1's per_sweep mode)"
    else:
        return
    raise TypeError(f"bfloat16 runs on the CUDA kernels 1-4 only: {why} run float32 only "
                    f"({BF16_ITEM}); use kernels='torch' for a bfloat16 run")


@dataclasses.dataclass
class _Level:
    spec: GridSpec
    u: torch.Tensor
    f: torch.Tensor
    is_fmg: bool = False


class CompiledCycle:
    """A CycleProgram bound to a problem, a numerical policy and a device.

    ``init()`` gives the finest level's ``(u0, f0)`` on the device; calling
    the object runs one cycle and returns ``(u, err)``, ``err`` being the
    most recent finest-level smoothing error (a device scalar). Arguments
    are never modified.

    With a sharding ``policy`` the levels live on its mesh (``device`` is
    then the mesh's first device): ``init()`` and the call give a
    ``ShardedGrid`` where the finest level is sharded, and ``unpad(u)``
    gathers the (n, n) grid (JAX's ``unpad`` crops its padding; the port's
    levels carry none).

    Warm restart (the reference's init flag, linkedlist.h:38-41): with
    ``warm=False`` every call resets the finest iterate, so chaining the
    output into the same instance repeats cycle 1. Build a ``warm=True``
    instance to continue cycles, or use :meth:`iterate`.

    Set ``trigger_sweeps`` to a list to have every trigger node append
    ``(n, sweeps run)`` to it (one read from the device per node).
    """

    trigger_sweeps = None

    def __init__(self, program: CycleProgram, problem: Problem,
                 config: SolverConfig = SolverConfig(), device="cuda",
                 warm: bool = False, policy=None):
        program.validate()
        self.program = program
        self.problem = problem
        self.config = config
        self.policy = policy
        self.device = home(policy, device)
        self.warm = warm
        self.use_kernels = _use_kernels(config, self.device)
        _check_ported(config, self.use_kernels, program, policy)
        if config.halo not in ("ppermute", "rdma"):
            raise ValueError(f"unknown halo {config.halo!r}; expected ppermute or rdma")
        if policy is not None and config.halo == "rdma":
            KS3.check_rdma_one_process(policy.mesh)
        if (policy is not None and config.halo == "rdma" and self.use_kernels
                and len(set(policy.mesh.devices)) > 1):
            raise ValueError(f"halo='rdma' runs every shard of a ring in one launch on one "
                             f"card; this mesh spans {sorted(set(map(str, policy.mesh.devices)))}"
                             f": use halo='ppermute'")
        self.finest_spec = GridSpec(program.n_max, program.length,
                                    program.min_x, program.min_y)

    def _level(self, x, n: int):
        return x if self.policy is None else as_level(x, self.policy, n)

    def init(self):
        """(u0, f0) for the finest level, on the device (sharded by the
        policy)."""
        cfg, spec = self.config, self.finest_spec
        b = self.problem.boundary_grid(spec, cfg.dtype, self.device)
        f = self.problem.source_grid(spec, cfg.dtype, self.device) + b
        return self._level(b.clone(), spec.n), self._level(f, spec.n)

    def __call__(self, u, f):
        n = self.finest_spec.n
        with on_device(self.device):
            return _run(self._level(u, n), self._level(f, n), self.program, self.problem,
                        self.config, self.device, self.warm, self.use_kernels,
                        self.trigger_sweeps, self.policy)

    def iterate(self, cycles: int):
        """``fn(u0, f) -> u``: one cold cycle, then ``cycles − 1`` warm ones."""
        warm = CompiledCycle(self.program, self.problem, self.config, self.device,
                             warm=True, policy=self.policy)

        def chained(u, f):
            u = self(u, f)[0]
            for _ in range(cycles - 1):
                u = warm(u, f)[0]
            return u

        return chained

    def unpad(self, u) -> torch.Tensor:
        """The (n, n) grid of a finest-level iterate (gathered from its
        shards under a policy)."""
        return gather(u)


def _sharded(policy, n: int) -> bool:
    return policy is not None and policy.is_sharded(n)


def _rows_only(policy, n: int) -> bool:
    """Whether level n is row-sharded with no column axis (the ring
    kernels' layouts)."""
    spec = policy.spec(n)
    return len(spec) >= 1 and spec[0] is not None and (len(spec) < 2 or spec[1] is None)


def _leg_sharded_ok(policy, n: int) -> bool:
    """Whether the policy shards level n with a leading row axis: the layouts
    the per-shard fused legs take (rows, and 2-D blocks)."""
    return _sharded(policy, n) and policy.spec(n)[0] is not None


def _fuse_descend_ok(cfg: SolverConfig, use_kernels: bool, n: int, m: int,
                     steps: int, policy=None) -> bool:
    """The JAX engine's predicate for the one-kernel descend leg: Jacobi, a
    2:1 vertex-aligned coarse level, a sweep count within the fused budget;
    single-device, or per shard on a sharded level under a policy."""
    if not (use_kernels and cfg.smoother == "jacobi" and n == 2 * m - 1):
        return False
    if policy is not None and not _leg_sharded_ok(policy, n):
        return False
    cap = 6 if cfg.restriction == "full_weighting" else 7
    return 1 <= steps <= cap


def _fuse_ascend_ok(cfg: SolverConfig, use_kernels: bool, n: int, n_child: int,
                    steps: int, finest: bool, policy=None) -> bool:
    """The JAX engine's predicate for the one-kernel ascend leg (see
    _fuse_descend_ok); under a policy JAX also wants at least 32 padded rows
    per device (its 16-row fine and coarse halos)."""
    if not (use_kernels and cfg.smoother == "jacobi" and n == 2 * n_child - 1):
        return False
    if policy is not None:
        if not _leg_sharded_ok(policy, n):
            return False
        ndev = policy.mesh.shape[policy.spec(n)[0]]
        if policy.padded_shape(n)[0] // ndev < 32:
            return False
    cap = 8 if (not finest or cfg.compat_error == "gpu") else 7
    return 1 <= steps <= cap


def _match_chain(instructions, i: int, n0: int, cfg: SolverConfig, use_kernels: bool,
                 finest: bool, policy=None):
    """Match a pure V-shaped sub-pattern starting at instruction ``i``:
    Descend×c (fixed steps, 2:1-aligned all the way), CoarseSolve, Ascend×c,
    the shape the two chain kernels run (``compiled.py::_match_chain``).
    Returns (sizes, pre_steps, post_steps, solve_ins, next_i) or None.

    JAX's guards: kernels and Jacobi only; trigger (−1) and FMG (0) descents
    never chain; no level of the ladder sharded under the policy; the ladder
    must pass ``chain_fits``; at the finest level the error metric must be
    cpu or clean. Two more here: every sweep count within the tile budget of
    the leg kernels whose tile code the chain kernels run (JAX's chain
    sweeps whole levels, uncapped); and a float32 state, since the chains
    have no bf16 mode: a bf16 ladder runs level by level through kernels 3
    and 4, the chains' twin composition (``chain_descend_torch``)."""
    if cfg.smoother != "jacobi" or not use_kernels or cfg.dtype != torch.float32:
        return None
    if finest and cfg.compat_error == "gpu":
        return None
    sizes, pre = [n0], []
    j = i
    while j < len(instructions) and isinstance(instructions[j], Descend):
        d = instructions[j]
        if d.steps <= 0 or d.next_n != (sizes[-1] + 1) // 2:
            return None
        pre.append(d.steps)
        sizes.append(d.next_n)
        j += 1
    if not pre or j >= len(instructions) or not isinstance(instructions[j], CoarseSolve):
        return None
    solve_ins = instructions[j]
    j += 1
    post = []
    while (j < len(instructions) and len(post) < len(pre)
           and isinstance(instructions[j], Ascend)):
        if instructions[j].steps == -1:
            return None
        post.append(instructions[j].steps)
        j += 1
    if len(post) != len(pre) or any(_sharded(policy, m) for m in sizes):
        return None
    if not K.chain_fits(sizes) or max(pre + post) > K.MAX_FUSED_SWEEPS:
        return None
    # instruction order ascends coarse→fine; the chain wants per-level steps
    return tuple(sizes), tuple(pre), tuple(reversed(post)), solve_ins, j


def _batched_trigger(passes, u, cfg: SolverConfig, batch: int, prev, k: int):
    """Trigger passes of ``batch`` sweeps (``passes(u) -> (u, errs)``, the
    per-sweep error mode of the smoother) after ``k`` sweeps whose last error
    is ``prev``, until a pass holds a sweep whose slope is within the trigger
    or ``max_trigger_sweeps`` is reached; the stop rule is replayed over each
    pass's error vector (JAX's ``batch_step``). The iterate is the pass's
    last, up to batch − 1 sweeps past the stop sweep; the error is that of
    the stop sweep. One host read per pass. Returns (u, err, sweeps run)."""
    while True:
        u, errs = passes(u)
        k += batch
        stop = torch.abs(errs - torch.cat([prev.reshape(1), errs[:-1]])) <= cfg.trigger
        if bool(stop.any()):
            return u, errs[int(torch.argmax(stop.to(torch.int32)))], k
        prev = errs[-1]
        if k >= cfg.max_trigger_sweeps:
            return u, prev, k


def _first_pass_trigger(passes, u, cfg: SolverConfig, batch: int):
    """An integer ``trigger_batch > 1``: batched passes from the first sweep,
    whose slope is never tested (prev = +inf masks it)."""
    inf = torch.full((), math.inf, dtype=u.dtype, device=u.device)
    return _batched_trigger(passes, u, cfg, batch, inf, 0)


def _two_phase_trigger(step, passes, u, cfg: SolverConfig, batch: int):
    """``trigger_batch="auto"``: the first 2B sweeps one at a time (``step``),
    so a level that stops within them is the trigger_batch=1 loop bit for
    bit; one still running continues in B-sweep passes. Returns (u, err,
    sweeps run)."""
    warm = min(2 * batch, cfg.max_trigger_sweeps)
    u, err = step(u)
    k, above = 1, True
    while above and k < warm:
        u, new_err = step(u)
        above = bool(torch.abs(new_err - err) > cfg.trigger)
        err, k = new_err, k + 1
    if not above or k >= cfg.max_trigger_sweeps:
        return u, err, k
    return _batched_trigger(passes, u, cfg, batch, err, k)


def _rdma_trigger_ok(cfg: SolverConfig, policy, n: int) -> bool:
    """JAX's route to the whole-loop ring kernel: halo="rdma", a rows-only
    sharded level, and its padded shard within ``rdma_trigger_fits``."""
    if cfg.halo != "rdma" or not _sharded(policy, n) or not _rows_only(policy, n):
        return False
    rp, cp = policy.padded_shape(n)
    rows = rp // policy.mesh.shape[policy.spec(n)[0]]
    return rdma.rdma_trigger_fits(rows, cp, torch.finfo(cfg.dtype).bits // 8)


def _trigger_smooth(u, f, h: float, n: int, cfg: SolverConfig, use_kernels: bool,
                    policy=None):
    """Error-triggered smoothing: sweep while |err_k − err_{k−1}| > trigger.
    Returns (u, err, sweeps run); routing as in the module docstring
    (``_trigger_smooth_traced``)."""
    max_sweeps = cfg.max_trigger_sweeps
    sharded = _sharded(policy, n)
    fuse_err = use_kernels and (cfg.smoother == "jacobi" or cfg.compat_error != "gpu")
    auto = False
    if cfg.smoother == "jacobi":
        if use_kernels and not sharded and (K.trigger_fits(n) or K.trigger_stream_fits(n)):
            loop = K.trigger_smooth if K.trigger_fits(n) else K.trigger_smooth_stream
            return loop(u, f, h, cfg.omega, cfg.compat_error, cfg.trigger, max_sweeps)
        batch = K.errs_sweep_cap(cfg.compat_error)
        if use_kernels and isinstance(cfg.trigger_batch, int) and cfg.trigger_batch > 1:
            batch = min(cfg.trigger_batch, batch)
        errs = KS.sharded_fused_jacobi_errs if sharded else K.fused_jacobi_errs

        def passes(v):
            return errs(v, f, h, batch, cfg.omega, cfg.compat_error)

        if use_kernels and isinstance(cfg.trigger_batch, int) and cfg.trigger_batch > 1:
            return _first_pass_trigger(passes, u, cfg, batch)
        if use_kernels and _rdma_trigger_ok(cfg, policy, n):
            # the whole loop over the ring in one launch
            return KS.rdma_fused_trigger(u, f, h, cfg.trigger, cfg.omega, cfg.compat_error,
                                         max_sweeps)
        # a sharded level batches only where its single-device twin would
        auto = use_kernels and cfg.trigger_batch == "auto" and not (
            sharded and (K.trigger_fits(n) or K.trigger_stream_fits(n)))
    if fuse_err and sharded:
        def step(v):
            return KS.sharded_fused_jacobi_err(v, f, h, 1, cfg.omega, cfg.compat_error,
                                               smoother=cfg.smoother)
    elif sharded:
        def step(v):
            v_new = _sweeps(v, f, h, n, 1, cfg, use_kernels, policy)
            if cfg.compat_error == "gpu":
                return v_new, sharded_halo.sharded_gpu_smoothing_error(v_new, v, h)
            return v_new, sharded_halo.sharded_smoothing_error(v_new, f, h, cfg.compat_error)
    elif cfg.smoother == "jacobi":
        fused = K.fused_jacobi_err if use_kernels else K.fused_jacobi_err_torch

        def step(v):
            return fused(v, f, h, 1, cfg.omega, cfg.compat_error)
    elif use_kernels and cfg.compat_error != "gpu":
        def step(v):
            return K.fused_rbgs_err(v, f, h, 1, cfg.compat_error)
    else:
        gs = K.fused_rbgs if use_kernels else K.fused_rbgs_torch

        def step(v):
            v_new = gs(v, f, h, 1)
            if cfg.compat_error == "gpu":
                return v_new, stencils.gpu_smoothing_error(v_new, v, h)
            return v_new, stencils.smoothing_error(v_new, f, h, compat=cfg.compat_error)
    if not auto:
        return trigger_loop(step, u, cfg.trigger, max_sweeps)
    return _two_phase_trigger(step, passes, u, cfg, batch)


def _sweeps(u, f, h: float, n: int, steps: int, cfg: SolverConfig, use_kernels: bool,
            policy, from_zero: bool = False):
    """``steps`` sweeps of a sharded level: the shard-mode kernels after a
    halo exchange per pass (or the ring kernel with halo="rdma" on a
    rows-only level), or without kernels ``parallel.halo``'s plain ops."""
    if steps <= 0:
        return u
    if use_kernels:
        if cfg.smoother == "jacobi" and cfg.halo == "rdma" and _rows_only(policy, n):
            return KS.rdma_fused_jacobi(u, f, h, steps, cfg.omega, from_zero)
        return KS.sharded_fused_jacobi(u, f, h, steps, cfg.omega, from_zero, cfg.smoother)
    if cfg.smoother == "jacobi" and from_zero:
        # the closed-form first sweep from u ≡ 0
        coef = K._zero_coef(h, cfg.omega)
        u = f.map(lambda i, j, fb: torch.where(
            sharded_halo.shard_geo(f, i, j, 0).interior(fb.device), coef * fb,
            torch.zeros((), dtype=fb.dtype, device=fb.device)))
        steps -= 1
    return sharded_halo.sharded_smooth(u, f, h, steps, cfg.omega, cfg.smoother)


def _smooth_sharded(u, f, h: float, n: int, steps: int, cfg: SolverConfig, want_err: bool,
                    use_kernels: bool, policy, from_zero: bool):
    """``_smooth`` on a sharded level (``_smooth_traced``'s sharded arms)."""
    fuse_err_ok = cfg.smoother == "jacobi" or cfg.compat_error != "gpu"
    if want_err and steps >= 1 and fuse_err_ok and use_kernels:
        # the error fused into the last pass, the shards' partials added
        return KS.sharded_fused_jacobi_err(u, f, h, steps, cfg.omega, cfg.compat_error,
                                           from_zero, cfg.smoother)
    if want_err and cfg.compat_error == "gpu" and steps >= 1:
        u_prev = u if steps == 1 else _sweeps(u, f, h, n, steps - 1, cfg, use_kernels, policy,
                                              from_zero)
        u = _sweeps(u_prev, f, h, n, 1, cfg, use_kernels, policy, from_zero and steps == 1)
        return u, sharded_halo.sharded_gpu_smoothing_error(u, u_prev, h)
    u = _sweeps(u, f, h, n, steps, cfg, use_kernels, policy, from_zero)
    if not want_err:
        return u, None
    return u, sharded_halo.sharded_smoothing_error(u, f, h, cfg.compat_error)


def _smooth(u, f, h: float, n: int, steps: int, cfg: SolverConfig, want_err: bool,
            use_kernels: bool, from_zero: bool = False, trigger_sweeps=None, policy=None):
    """``steps`` sweeps (or the trigger loop), with the finest level's error
    when ``want_err``: (u, err or None). ``from_zero``: u ≡ 0 (a freshly
    reset correction level), so the first Jacobi sweep is the closed form and
    u is not read."""
    if steps == -1:
        u, err, sweeps = _trigger_smooth(u, f, h, n, cfg, use_kernels, policy)
        if trigger_sweeps is not None:
            trigger_sweeps.append((n, int(sweeps)))
        return u, err
    if _sharded(policy, n):
        return _smooth_sharded(u, f, h, n, steps, cfg, want_err, use_kernels, policy, from_zero)
    if cfg.smoother == "jacobi" and steps >= 1:
        if want_err:
            fused = K.fused_jacobi_err if use_kernels else K.fused_jacobi_err_torch
            return fused(u, f, h, steps, cfg.omega, cfg.compat_error, from_zero)
        fused = K.fused_jacobi if use_kernels else K.fused_jacobi_torch
        return fused(u, f, h, steps, cfg.omega, from_zero), None
    gs = K.fused_rbgs if use_kernels else K.fused_rbgs_torch
    if want_err and steps >= 1:
        if use_kernels and cfg.compat_error != "gpu":
            # the cpu / clean error fused into the last pass
            return K.fused_rbgs_err(u, f, h, steps, cfg.compat_error, from_zero)
        if cfg.compat_error == "gpu":
            # the GPU metric needs the final sweep's pair (JAX's two-call form)
            u_prev = u if steps == 1 else gs(u, f, h, steps - 1, from_zero)
            u = gs(u_prev, f, h, 1, from_zero and steps == 1)
            return u, stencils.gpu_smoothing_error(u, u_prev, h)
    u = gs(u, f, h, steps, from_zero)
    if not want_err:
        return u, None
    return u, stencils.smoothing_error(u, f, h, compat=cfg.compat_error)


def _residual(u, f, h: float, n: int, use_kernels: bool, policy):
    """The 5-point residual (JAX's ``_residual``): the kernel single-device,
    per shard on a sharded level, the plain op on a replicated level under a
    policy and without kernels."""
    if _sharded(policy, n):
        if use_kernels:
            return KS.sharded_residual(u, f, h)
        return sharded_halo.sharded_residual(u, f, h)
    if use_kernels and policy is None:
        return K.residual(u, f, h)
    return stencils.residual(u, f, h)


def _err_mode(cfg: SolverConfig, finest: bool):
    return K.err_mode_of(cfg.compat_error) if finest else None


def _run(u0, f0, program: CycleProgram, problem: Problem, cfg: SolverConfig,
         device: torch.device, warm: bool, use_kernels: bool, trigger_sweeps=None, policy=None):
    """Walk the instruction sequence. Returns (u_finest, last_err), last_err
    being the most recent finest-level smoothing error; ``trigger_sweeps``,
    when a list, receives (n, sweeps run) of every trigger node. Under a
    policy, sharded levels are ShardedGrids and every level is re-laid out
    for its size (``as_level``) as it is made."""
    finest_spec = GridSpec(program.n_max, program.length, program.min_x, program.min_y)
    levels = [_Level(finest_spec, u0, f0)]
    warm_now = warm
    last_err = torch.zeros((), dtype=cfg.dtype, device=device)

    def lay(x, n):
        return x if policy is None else as_level(x, policy, n)

    def boundary(spec):
        return problem.boundary_grid(spec, cfg.dtype, device)

    def zeros(spec):
        return lay(torch.zeros(spec.shape, dtype=cfg.dtype, device=device), spec.n)

    instructions = program.instructions
    i = 0
    while i < len(instructions):
        ins = instructions[i]
        i += 1
        lvl = levels[-1]
        n, h = lvl.spec.n, lvl.spec.h
        sharded = _sharded(policy, n)

        if isinstance(ins, Descend):
            finest = len(levels) == 1
            was_zeroed = False
            if not (finest and warm_now) and not lvl.is_fmg:
                # reference memset semantics (MG_solver_CPU.cpp:209-214)
                lvl.u = lay(boundary(lvl.spec), n) if finest else zeros(lvl.spec)
                was_zeroed = not finest   # correction levels reset to u ≡ 0

            chain = _match_chain(instructions, i - 1, n, cfg, use_kernels, finest, policy)
            if chain is not None:
                # the V below this level as two launches around the coarse
                # solve; the iterate is the per-level legs' bit for bit
                sizes, pre, post, solve_ins, i = chain
                u_list, f_list = K.chain_descend(lvl.u, lvl.f, sizes, h, pre, cfg.omega,
                                                 cfg.restriction, entry_from_zero=was_zeroed)
                uc = coarse_solve(f_list[-1], lvl.spec.coarsened(sizes[-1]).h, solve_ins,
                                  cfg.dtype, cfg.coarse_gs_norm)[0]
                fuse_err = finest and post[0] != 0
                lvl.u, err = K.chain_ascend(u_list, [lvl.f] + f_list[:-1], uc, sizes, h, post,
                                            cfg.omega, cfg.compat_error, want_err=fuse_err)
                if finest:
                    # with no finest post-sweeps the metric is that of the
                    # pre-smoothed iterate
                    last_err = err if fuse_err else stencils.smoothing_error(
                        u_list[0], lvl.f, h, compat=cfg.compat_error)
                    warm_now = True
                continue

            next_spec = lvl.spec.coarsened(ins.next_n)
            m = ins.next_n
            if ins.steps == 0:
                # FMG descent: restrict the full RHS, no smoothing
                # (the reference's TODO branch, MG_solver_CPU.cpp:296-299)
                f_c = zoom(gather(lvl.f), m, zero_boundary=True, form=cfg.zoom) \
                    + boundary(next_spec)
                levels.append(_Level(next_spec, zeros(next_spec), lay(f_c, m), is_fmg=True))
                continue

            if _fuse_descend_ok(cfg, use_kernels, n, m, ins.steps, policy):
                # sweeps + residual + restriction in one kernel (per shard)
                if sharded:
                    lvl.u, f_c, err = KS.sharded_fused_descend(
                        lvl.u, lvl.f, h, ins.steps, cfg.omega, cfg.restriction,
                        _err_mode(cfg, finest), from_zero=was_zeroed)
                else:
                    lvl.u, f_c, err = K.fused_descend(
                        lvl.u, lvl.f, h, ins.steps, cfg.omega, cfg.restriction,
                        cfg.compat_error, want_err=finest, from_zero=was_zeroed)
            else:
                lvl.u, err = _smooth(lvl.u, lvl.f, h, n, ins.steps, cfg, finest,
                                     use_kernels, was_zeroed, trigger_sweeps, policy)
                d = _residual(lvl.u, lvl.f, h, n, use_kernels, policy)
                f_c = restrict(gather(d), m, cfg.restriction, cfg.zoom)
            if finest and err is not None:
                last_err = err
            levels.append(_Level(next_spec, zeros(next_spec), lay(f_c, m)))

        elif isinstance(ins, CoarseSolve):
            lvl.u = lay(coarse_solve(gather(lvl.f), h, ins, cfg.dtype, cfg.coarse_gs_norm)[0], n)

        elif isinstance(ins, Ascend):
            child = levels.pop()
            lvl = levels[-1]
            n, h = lvl.spec.n, lvl.spec.h
            sharded = _sharded(policy, n)
            if len(levels) == 1:
                warm_now = True
            finest = len(levels) == 1
            if _fuse_ascend_ok(cfg, use_kernels, n, child.spec.n, ins.steps, finest, policy):
                # prolongation + interior add + post-sweeps in one kernel (per shard)
                if sharded:
                    lvl.u, err = KS.sharded_fused_ascend(lvl.u, lvl.f, child.u, h, ins.steps,
                                                         cfg.omega, _err_mode(cfg, finest))
                else:
                    lvl.u, err = K.fused_ascend(lvl.u, lvl.f, child.u, h, ins.steps,
                                                cfg.omega, cfg.compat_error, want_err=finest)
                if finest and err is not None:
                    last_err = err
                continue
            corr = zoom(gather(child.u), n, form=cfg.zoom)
            lvl.u = lay(transfers.add_correction(gather(lvl.u), corr), n)
            if ins.steps != 0:
                lvl.u, err = _smooth(lvl.u, lvl.f, h, n, ins.steps, cfg, finest, use_kernels,
                                     trigger_sweeps=trigger_sweeps, policy=policy)
                if finest and err is not None:
                    last_err = err
        else:  # pragma: no cover
            raise TypeError(f"unknown instruction {ins!r}")

    return levels[0].u, last_err


def compile_program(program: CycleProgram, problem: Problem,
                    config: SolverConfig = SolverConfig(), device="cuda",
                    warm: bool = False, policy=None) -> CompiledCycle:
    """Bind ``program`` to ``problem``, ``config`` and ``device`` (default
    ``"cuda"``; a CPU run needs ``device="cpu"``). ``policy``: a
    ``parallel.mesh`` sharding policy; the levels then live on its mesh."""
    return CompiledCycle(program, problem, config, device, warm, policy)

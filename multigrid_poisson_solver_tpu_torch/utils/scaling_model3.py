"""Communication model of the port's z-sharded 3-D V-cycle.

PyTorch port of ``multigrid_poisson_solver_tpu/utils/scaling_model3.py``,
modelling the port's own exchanges: ``comm_report3`` walks
``parallel.kernel_shard3.v_cycle3_sharded``'s recursion on the kernel path
(JAX's routing on JAX's depths ``nl``) and counts per level what
``parallel.sharded`` counts when the cycle runs:

  * the plane exchanges in front of every per-shard pass (``extend_all``:
    the descend leg's k + 2 planes, the emit_residual pass's k + 1, the
    ascend leg's even ext_z, the smoother's min(steps, 8, nl)), u skipped
    on a from-zero pass;
  * the ascend leg's window of the coarse correction (ext_c planes above a
    shard's coarse planes, ext_c + 1 below) where the child level is
    sharded too;
  * the gathers: the agglomeration of the coarse right-hand side where the
    child is replicated (or laid out otherwise), the emit_residual route's
    gathered −r, and the prolongation's gathered levels off the fused
    ascend leg.

JAX's padded planes (rp × cp of its ×16/×128 layout), its lane-expanded
coarse planes and its GSPMD transfers are TPU layout the port does not have;
``counts()`` equals ``sharded.counts()`` of one ``v_cycle3_sharded`` call
exactly (``tests/test_torch_scaling_model3.py``), in one process and across
processes. ``hlo_manual_collectives`` has no counterpart: the counters take
its role. Constants and the time model are ``utils.scaling_model``'s.
"""

from __future__ import annotations

from typing import Optional

from ..models import poisson3d as p3
from ..ops import kernels3 as K3
from ..parallel import mesh as M
from ..parallel.kernel_shard3 import CyclePolicy3, ascend3_halo
from ..parallel.sharded import layout_of
from .scaling_model import DTYPE_BYTES, HBM_BW, CommReport, _ranks, _Tally, predicted_efficiency


def make_policy3(ndev: int, threshold_planes: int = 8, processes: int = 1) -> CyclePolicy3:
    """``v_cycle3_sharded``'s sharding rule on a z ring of ``ndev`` entries
    split over ``processes`` (contiguous runs), on placeholder devices."""
    return CyclePolicy3(M.make_mesh_z(["cpu"] * ndev, ranks=_ranks(ndev, processes)),
                        threshold_planes)


def comm_report3(n: int, ndev: int, pre: int = 3, post: int = 3, n_min: int = 5,
                 threshold_planes: int = 8, processes: int = 1,
                 coarse_sweeps: int = 50, link: str = "nvlink") -> CommReport:
    """The traffic of one ``v_cycle3_sharded(u, f, h, mesh, n_min, pre, post,
    coarse_sweeps, threshold_planes=...)`` call on the kernel path with
    ``halo="ppermute"``, per level (see the module docstring)."""
    pol = make_policy3(ndev, threshold_planes, processes)
    sizes = p3._sizes(n, n_min)
    tally = _Tally(pol.is_sharded, DTYPE_BYTES)

    def smoother(lay, steps, from_zero, nl):
        """``sharded_fused_jacobi3``: f once at min(steps, kmax) planes, u a
        pass (not on a from-zero first pass)."""
        kmax = min(K3.MAX_FUSED_SWEEPS_3D, nl)
        ext = min(steps, kmax)
        if steps > 0:
            tally.extend(lay, ext)
        first = True
        while steps > 0:
            if not (from_zero and first):
                tally.extend(lay, ext)
            steps -= min(steps, kmax)
            first = False

    def run(nn, depth, from_zero, zp, in_lay):
        """One level; ``in_lay``: the layout the level's arrays arrive in
        (None: tensors). Returns the layout of what it returns."""
        if not pol.is_sharded(nn):
            tally.gather(in_lay)      # u
            tally.gather(in_lay)      # f
            return None
        lay = layout_of(pol, nn)
        if in_lay is not None and in_lay != lay:
            tally.gather(in_lay)
            tally.gather(in_lay)
        nl = zp // ndev
        if depth == len(sizes) - 1:
            smoother(lay, coarse_sweeps, from_zero, nl)
            return lay
        m = sizes[depth + 1]
        k_nb = pre - int(from_zero)
        if nl % 2 == 0 and 1 <= k_nb <= K3.MAX_DESCEND3_SWEEPS_FW and k_nb + 2 <= nl:
            if not from_zero:
                tally.extend(lay, k_nb + 2)
            tally.extend(lay, k_nb + 2)
            half = tuple((a // 2, (b + 1) // 2) for a, b in lay.rows)
            fc_lay = lay.coarse(m, half, ((0, m),))
            zp_c = zp // 2
        else:
            k_eff = pre - int(from_zero)
            if not (1 <= pre and k_eff <= 7 and k_eff + 1 <= nl):
                smoother(lay, pre, from_zero, nl)
                tally.extend(lay, 1)
                tally.extend(lay, 1)
            else:
                if not from_zero:
                    tally.extend(lay, k_eff + 1)
                tally.extend(lay, k_eff + 1)
            tally.gather(lay)
            fc_lay = None
            zp_c = M.padded_depth3(m, ndev) if pol.is_sharded(m) else m
        m_lay = layout_of(pol, m)
        if m_lay is None:
            tally.level(m)         # the agglomeration's level (JAX's all-gather's)
        if fc_lay is not None and fc_lay != m_lay:
            tally.gather(fc_lay)       # as_level: agglomerated or re-split
        ec_lay = run(m, depth + 1, True, zp_c, m_lay)
        ext_z, ext_c = ascend3_halo(post, False)
        if (nl % 2 == 0 and 1 <= post <= K3.MAX_FUSED_SWEEPS_3D and 2 * zp_c == zp
                and ext_z <= nl and ext_c + 1 <= nl // 2):
            tally.extend(lay, ext_z)
            tally.extend(lay, ext_z)
            tally.window(ec_lay, lay, lambda i, j: (lay.rows[i][0] // 2 - ext_c,
                                                    (lay.rows[i][1] + 1) // 2 + ext_c + 1,
                                                    0, m), m)
            return lay
        tally.gather(lay)
        tally.gather(ec_lay)
        smoother(lay, post, False, nl)
        return lay

    run(n, 0, False, M.padded_depth3(n, 2 * ndev), None)
    return tally.report(ndev, processes, link)


def predicted_efficiency3(report: CommReport, t_compute_s: float) -> dict:
    """``scaling_model.predicted_efficiency`` of a 3-D report, with its n."""
    row = predicted_efficiency(report, t_compute_s)
    row["n"] = max(lc.n for lc in report.levels) if report.levels else None
    return row


def scaling_table3(t1_s: float, base_n: int = 513, ndevs=(2, 4, 8), pre: int = 3,
                   post: int = 3, threshold_planes: int = 8, mode: str = "strong",
                   link: str = "nvlink") -> list:
    """Predicted efficiency of the z-sharded cycle, one process (card) per
    shard. ``t1_s``: the measured seconds of one cycle at base_n on one
    card. ``mode="strong"``: fixed base_n, compute t1_s / c; ``"weak"``: the
    cube grows, n_c = (base_n − 1)·c + 1, compute t1_s · c² (volume ×c³ over
    c cards)."""
    rows = []
    for c in ndevs:
        n, t_comp = (base_n, t1_s / c) if mode == "strong" else ((base_n - 1) * c + 1,
                                                                  t1_s * c * c)
        rep = comm_report3(n, c, pre, post, threshold_planes=threshold_planes, processes=c,
                           link=link)
        row = predicted_efficiency3(rep, t_comp)
        row.update(n=n, mode=mode)
        rows.append(row)
    return rows


def trigger_loop_model3(n: int, ndev: int, t1_sweep_s: Optional[float] = None,
                        processes: Optional[int] = None, link: str = "nvlink") -> dict:
    """Predicted cost of one sweep of a z-sharded trigger loop on the
    exchange path (``sharded_trigger_pass3``: u and f one plane a side, one
    psum), each shard on its own card by default. ``t1_sweep_s`` defaults to
    the HBM bound of a sweep of one shard."""
    processes = ndev if processes is None else processes
    pol = make_policy3(ndev, 1, processes)
    lay = layout_of(pol, n)
    planes = max(b - a for a, b in lay.rows)
    if t1_sweep_s is None:
        t1_sweep_s = 3 * planes * n * n * DTYPE_BYTES / HBM_BW
    tally = _Tally(pol.is_sharded, DTYPE_BYTES)
    tally.extend(lay, 1)
    tally.extend(lay, 1)
    tally.psum(lay)
    t_comm = tally.report(ndev, processes, link).t_comm()
    return {"n": n, "ndev": ndev, "planes_per_shard": planes,
            "t_sweep_us": (t1_sweep_s + t_comm) * 1e6,
            "t_sweep_compute_us": t1_sweep_s * 1e6, "t_sweep_comm_us": t_comm * 1e6,
            "efficiency": t1_sweep_s / (t1_sweep_s + t_comm)}

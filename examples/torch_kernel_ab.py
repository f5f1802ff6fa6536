"""Time the port's single-device 2-D and 3-D kernels of one source tree, to
compare two trees on the same card.

    python3 examples/torch_kernel_ab.py ROOT [solve]

ROOT is a checkout (or an unpacked ``git archive``) holding
``multigrid_poisson_solver_tpu_torch``; its kernels are built from ROOT's
sources and timed with CUDA events (median of 5 rounds of 10 calls) at the
main paths' shapes (2-D at 4097² and 8193², 3-D at 513³), with one V(3,3)
cycle at 4097² (ω 0.8, coarsen=3) and one 3-D ``v_cycle3`` V(3,3) at 513³;
kernel 1's Jacobi modes (8193² with 8 sweeps and the per-sweep mode, 4097²
with one sweep and each error, 1025², 257² and 65² in device µs a call) and
the 2-D trigger kernels 8 (100 sweeps at 256², 129² and 65²; 2-4-sweep
loops at 513²-2049² in device µs a call) and 9 (98 sweeps at 4097², and
2- and 3-sweep loops in device µs) and kernel 5; the
``schedules/VcycleTrigger.txt`` compiled solve (ms, device ms) and the host
µs of one kernel-8 call at 256²; the 2-D shard modes on 8 row
shards of the card (kernel 1 at 4097² and 8193², also in device µs at 4097²,
and rb-GS, also in device µs from CUDA graph replays); rb-GS at 4097², 1025²
and 257² (device µs, graph replays); the legs (kernels 3 and 4) at 8193² to 257², whole
grid (ms; device µs from 2049²) and on 8 row shards (device µs), on the
tree's route and, where the tree has both, on each; the chains 6 and 7 from
1025² (ms, and device µs from the profiler and from CUDA graph replays), on
the tree's split and, where the tree has ``forced_chain_split``, on each
split; the V(3,3) cycle at 4097² and the tw32 refinement's cycle at 8193² in
device ms (torch.profiler), and the V(3,3) cycle with per-level legs instead
of the chains (``CHAIN_MAX_ROOT = 0``; ms and device ms); chip_smoke.py's
G2 V(3,3) coarsen=3 and
bench_scaling (coarsen=1) cycles (4097², on 8 row shards with halo
ppermute: device ms a cycle from torch.profiler and the host wall clock)
and the 8193² trigger V-cycle's wall
clock (batch 7, and "auto" on 8 row shards with rdma, with kernel 17's
device ms in it from torch.profiler); then the ring
kernels on rings of 8 shards of the card: the 2-D ones at 4097², and, where
the tree has them (``ops/rdma3.py``), the 3-D ones at 513³
(the trigger loop at 257³, 129³ and 65³, ms per sweep; the smoother and the
descend and ascend legs also at 129³ and 65³, device µs a call). The 3-D trigger
kernels follow: the whole-loop one at 129³ and 65³ and the streamed one at
257³ (98 sweeps, trigger 0, clean error; ms per sweep), the per-sweep pass
at 513³ on 8 z-shards (7 sweeps, clean error; windows of 8 halo planes)
and the residual's shard mode on the same windows (at 129³ and 65³ on
one-plane windows and on the whole grid, device µs a call), kernel 10's
emit_residual mode at 513³ (whole grid and on those windows), at 257³ on 8
z-shards and at 129³ and 65³ (whole grid and 8 z-shards, device µs a call);
kernel 10's fixed modes at 513³ (3 sweeps + gpu error, 3 from zero, 8
sweeps; whole grid, and with the clean error on 8 z-shards) and at 129³ and
65³ (1 and 8 sweeps, 3 with either error), the legs (kernels 11 and 12)
at 129³ and 65³ (3 sweeps: the descend leg with full weighting and the
clean error, or from zero; device µs a call) and at 513³ on 8 z-shards,
one ``v_cycle3_sharded`` V(3,3) cycle at 513³ on 8 z-shards (host wall
clock), its one-sweep shard step
with the clean error at 129³ and 65³ on 8 z-shards (device µs a shard step
from torch.profiler, the host's launch rate hiding it from CUDA events) and,
where the tree has it, the lagged pass that replaces it in the sharded
trigger loops; then the host wall clock of the 513³ trigger V-cycle at
trigger_batch 7, and on 8 z-shards with "auto" (halo ppermute, and rdma
where the tree has the ring kernels), medians of the warm runs. It prints
one JSON line of milliseconds (µs where the key says so). Compare two trees
in one process run each, alternating (A, B, B, A), on one card: a card set
below its power limit, or another card, moves every number. With ``solve``
it times the ``VcycleTrigger.txt`` solve and the kernel-8 call's host µs
alone (a process a side, for more pairs of that host-bound row). With
``ring`` it times only the ring smoother 18 and kernel 2's shard mode
(``ring_rows``, which the full run times too): kernel 18 on 8 row shards at
4097², 2049², 1025² and 513² and at every level G2's coarsen=1 cycle gives
it (2048² down to 128², 3 sweeps from zero and not; 8 sweeps at 4097² also
by CUDA events), on the tree's route and, where the tree has
``rdma.forced_jacobi_route``, on each; the residual of 8 row shards on
one-row windows at G2's levels (4097² down to 128², the tree's launches:
one a shard, or ``residual_shards``' one); G2's coarsen=1 cycle with halo
ppermute and rdma (device ms a cycle, and its residual and kernel 18 kernels'
share). Device µs from CUDA graph replays: a replay reuses the captured
ring tags, so its flag waits pass at once (the posts still run).
"""

import contextlib
import json
import os
import statistics
import sys
import time

import torch

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)

import multigrid_poisson_solver_tpu_torch as tmg  # noqa: E402
from multigrid_poisson_solver_tpu_torch.ops import build, kernels as K, kernels3 as K3  # noqa: E402,E501
from multigrid_poisson_solver_tpu_torch.ops import rdma  # noqa: E402
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M, sharded as S  # noqa: E402

if not K.__file__.startswith(root):
    sys.exit(f"imported {K.__file__}, not the tree under {root}")
build.build()
build.load()


def device_ms(fn, per):
    """Device time of one call of fn by torch.profiler, per ``per`` units."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / per


def kernel_device_ms(fn, match):
    """Device ms of the kernels whose name ``match`` accepts in one call of
    fn (torch.profiler), after a warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and match(e.key)) / 1e3


def walls(fn, runs=3):
    """Median host wall ms of ``runs`` calls after a warm one."""
    out = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out[1:])


def graph_us(fn, replays=20):
    """Device µs of one call of fn: the call captured in a CUDA graph and
    timed with CUDA events around ``replays`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / replays


def timed(fn, reps=10, rounds=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


g = torch.Generator(device="cuda")
g.manual_seed(7)


def rand(m):
    return torch.randn(m, m, generator=g, device="cuda")


def ring_rows(out):
    """Kernel 18 and kernel 2's shard mode at G2's shapes (see the header)."""
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16)
    routes = [None] + (["tile", "wave"] if hasattr(rdma, "forced_jacobi_route") else [])
    for m in (4097, 2049, 2048, 1025, 1024, 513, 512, 256, 128):
        lay = S.layout_of(pol, m)
        um, fm, hm = rand(m), rand(m), 1 / (m - 1)
        us, fs = S.shard(um, lay), S.shard(fm, lay)
        cases = ((3, True), (3, False)) + (((8, False),) if m == 4097 else ())
        for route in routes:
            with (rdma.forced_jacobi_route(route) if route else contextlib.nullcontext()):
                for steps, fz in cases:
                    key = (f"rdma_jacobi{steps}{'fz' if fz else ''}_{m}"
                           f"{'_' + route if route else ''}")
                    out[key + "_graph_us"] = graph_us(lambda: rdma.rdma_jacobi(
                        fs if fz else us, fs, hm, steps, 0.8, fz))
                    if steps == 8:
                        out[key] = timed(lambda: rdma.rdma_jacobi(us, fs, hm, 8, 0.8))
        if m in (2049, 1025, 513):
            continue
        wins = [(S.extend(us, i, 0, 1, 0), S.extend(fs, i, 0, 1, 0)) for i in range(8)]
        geos = [K.ShardGeo(m, r0, 0, r1 - r0, m, 1, 0) for r0, r1 in lay.rows]
        if hasattr(K, "residual_shards"):
            def res_pass():
                return K.residual_shards([w[0] for w in wins], [w[1] for w in wins], geos, hm)
        else:
            def res_pass():
                return [K.residual_shard(ue, fe, gm, hm) for (ue, fe), gm in zip(wins, geos)]
        out[f"residual_shard8_{m}_graph_us"] = graph_us(res_pass)
        if m == 4097:
            out["residual_shard8_4097"] = timed(res_pass)
    del um, fm, us, fs, wins
    g2 = {}
    for halo in ("ppermute", "rdma"):
        g2[halo] = tmg.compile_program(
            tmg.v_cycle(4097, n_min=8, steps=3, coarse_option=0, coarsen=1),
            tmg.REFERENCE_PROBLEM, tmg.SolverConfig(collect_node_stats=False, halo=halo),
            device="cuda", warm=True, policy=pol)
        gu, gf = g2[halo].init()
        out[f"g2_coarsen1_{halo}_4097_device"] = device_ms(
            lambda: [g2[halo](gu, gf) for _ in range(3)], 3)
        out[f"g2_coarsen1_{halo}_4097_residual_device"] = kernel_device_ms(
            lambda: g2[halo](gu, gf), lambda key: "residual" in key)
        if halo == "rdma":
            out["g2_coarsen1_rdma_4097_rdma_jacobi_device"] = kernel_device_ms(
                lambda: g2[halo](gu, gf), lambda key: "rdma_jacobi" in key)
        del gu, gf
    del g2


res = {}
if sys.argv[2:] == ["ring"]:
    ring_rows(res)
    print(json.dumps({"root": sys.argv[1], **{k: round(v, 4) for k, v in res.items()}}),
          flush=True)
    sys.exit(0)
ut, ft = rand(256), rand(256)
# the schedules/VcycleTrigger.txt compiled solve (chip_smoke.py's phase 4,
# its trigger nodes on kernel 8 as the engine routes them): ms a solve by
# CUDA events, median of 7 rounds of 3, its device ms (torch.profiler), and
# the host µs a kernel-8 call costs at 256² (2 sweeps; 200 calls issued,
# then one synchronize)
vsolve = tmg.compile_program(
    tmg.parse_cycle_path(os.path.join(root, "schedules", "VcycleTrigger.txt")),
    tmg.REFERENCE_PROBLEM, tmg.SolverConfig(), device="cuda")
vu, vf = vsolve.init()
res["vcycle_trigger_txt_solve"] = timed(lambda: vsolve(vu, vf), reps=3, rounds=7)
res["vcycle_trigger_txt_solve_device"] = device_ms(lambda: vsolve(vu, vf), 1)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(200):
    K.trigger_smooth(ut, ft, 1 / 255, 0.8, True, 0.0, 2)
res["trigger2_256_host_us"] = (time.perf_counter() - t0) * 1e6 / 200
torch.cuda.synchronize()
del vsolve, vu, vf
if sys.argv[2:] == ["solve"]:
    print(json.dumps({"root": sys.argv[1], **{k: round(v, 4) for k, v in res.items()}}),
          flush=True)
    sys.exit(0)
n, n8 = 4097, 8193
u, f, h = rand(n), rand(n), 1 / (n - 1)
u8, f8, h8 = rand(n8), rand(n8), 1 / (n8 - 1)
res.update({
    "jacobi8_8193": timed(lambda: K.fused_jacobi(u8, f8, h8, 8, 0.8)),
    "jacobi3err_4097": timed(lambda: K.fused_jacobi_err(u, f, h, 3, 0.8, True)),
    "residual_4097": timed(lambda: K.residual(u, f, h)),
    "rbgs2err_4097": timed(lambda: K.fused_rbgs_err(u, f, h, 2, True)),
})
prog = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False)
warm = tmg.compile_program(prog, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
u0, f0 = warm.init()
res["vcycle_4097"] = timed(lambda: warm(u0, f0), reps=5, rounds=3)
# kernel 1's Jacobi modes: the per-sweep mode at 8193², one sweep with each
# error and 8 from zero at 4097², 3 sweeps + cpu error at the small levels
# (device µs a call); the trigger kernels 8 (256², 100 sweeps) and 9 (4097²,
# 98 sweeps); kernel 5
res.update({
    "jacobi_errs7cpu_8193": timed(lambda: K.fused_jacobi_errs(u8, f8, h8, 7, 0.8, True), reps=5),
    "jacobi_errs8gpu_8193": timed(lambda: K.fused_jacobi_errs(u8, f8, h8, 8, 0.8, "gpu"), reps=5),
    "jacobi8fz_4097": timed(lambda: K.fused_jacobi(u, f, h, 8, 0.8, True)),
    "jacobi1_4097": timed(lambda: K.fused_jacobi(u, f, h, 1, 0.8)),
})
for key, mode in (("cpu", True), ("clean", False), ("gpu", "gpu")):
    res[f"jacobi1{key}_4097"] = timed(lambda: K.fused_jacobi_err(u, f, h, 1, 0.8, mode))
for m in (1025, 257, 65):
    um, fm = rand(m), rand(m)
    res[f"jacobi3err_{m}_us"] = 1e3 * device_ms(
        lambda: [K.fused_jacobi_err(um, fm, 1 / (m - 1), 3, 0.8, True) for _ in range(10)], 10)
w1, w2 = f8 * 1e-8, f8 * 1e-16
res.update({
    "trigger100_256": timed(lambda: K.trigger_smooth(ut, ft, 1 / 255, 0.8, True, 0.0, 100),
                            reps=3),
    "trigger_stream98_4097": timed(lambda: K.trigger_smooth_stream(u, f, h, 0.8, True, 0.0, 98),
                                   reps=3),
    "residual_tw_8193": timed(lambda: K.residual_tw(u8, w1, w2, f8, h8)),
})
del w1, w2
# the whole-loop trigger kernels 8 and 9 at the main paths' shapes: kernel 8
# with 100 sweeps at 129² and 65² (cpu error, trigger 0; ms), its 2-4-sweep
# loops at 513², 1025² and 2049² (path B's levels above 257²) and kernel 9's
# 2- and 3-sweep loops at 4097² (µs device a call, CUDA graph replays)
for m in (129, 65):
    um, fm = rand(m), rand(m)
    res[f"trigger100_{m}"] = timed(lambda: K.trigger_smooth(um, fm, 1 / (m - 1), 0.8, True,
                                                            0.0, 100), reps=3)
for m in (513, 1025, 2049):
    um, fm = rand(m), rand(m)
    for s in (2, 3, 4):
        res[f"trigger{s}_{m}_graph_us"] = graph_us(lambda: K.trigger_smooth(
            um, fm, 1 / (m - 1), 0.8, True, 0.0, s))
for s in (2, 3):
    res[f"trigger_stream{s}_4097_graph_us"] = graph_us(lambda: K.trigger_smooth_stream(
        u, f, h, 0.8, True, 0.0, s))
del um, fm
# the 2-D shard modes on 8 row shards of the card, on windows of KS.HALO rows
# exchanged beforehand: kernel 1 (G2's 3 sweeps + cpu error at 4097², G3's
# one sweep + cpu error and its per-sweep pass at 8193²) and rb-GS
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS  # noqa: E402

pol8 = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16)


def windows(level, a, b):
    lay = S.layout_of(pol8, level)
    xs, ys = S.shard(a, lay), S.shard(b, lay)
    return ([(S.extend(xs, i, 0, KS.HALO, 0), S.extend(ys, i, 0, KS.HALO, 0))
             for i in range(len(lay.rows))],
            [K.ShardGeo(level, r0, 0, r1 - r0, level, KS.HALO, 0) for r0, r1 in lay.rows])


w4, g4 = windows(n, u, f)
w8, g8 = windows(n8, u8, f8)


def on(wins, geos, fn):
    return lambda: [fn(ue, fe, g) for (ue, fe), g in zip(wins, geos)]


res.update({
    "jacobi_shard3cpu_4097": timed(on(w4, g4, lambda ue, fe, g: K.fused_jacobi_shard(
        ue, fe, g, h, 3, 0.8, False, "cpu"))),
    "jacobi_shard8_4097": timed(on(w4, g4, lambda ue, fe, g: K.fused_jacobi_shard(
        ue, fe, g, h, 8, 0.8))),
    "jacobi_shard1cpu_8193": timed(on(w8, g8, lambda ue, fe, g: K.fused_jacobi_shard(
        ue, fe, g, h8, 1, 0.8, False, "cpu"))),
    "jacobi_errs_shard7cpu_8193": timed(on(w8, g8, lambda ue, fe, g: K.fused_jacobi_errs_shard(
        ue, fe, g, h8, 7, 0.8, "cpu")), reps=3),
    "rbgs_shard2cpu_4097": timed(on(w4, g4, lambda ue, fe, g: K.fused_jacobi_shard(
        ue, fe, g, h, 2, 1.0, False, "cpu", "rbgs"))),
    "jacobi_shard3cpu_4097_us": 1e3 * device_ms(on(w4, g4, lambda ue, fe, g:
                                                   K.fused_jacobi_shard(ue, fe, g, h, 3, 0.8,
                                                                        False, "cpu")), 1),
    "rbgs_shard2cpu_4097_graph_us": graph_us(on(w4, g4, lambda ue, fe, g: K.fused_jacobi_shard(
        ue, fe, g, h, 2, 1.0, False, "cpu", "rbgs"))),
})
del w4, w8
# kernel 1's rb-GS mode, 2 sweeps + cpu error (path C's pass), device µs a
# call from CUDA graph replays
for m in (4097, 1025, 257):
    um, fm = rand(m), rand(m)
    res[f"rbgs2err_{m}_graph_us"] = graph_us(lambda: K.fused_rbgs_err(um, fm, 1 / (m - 1), 2,
                                                                         True))
del um, fm
# the legs (kernels 3 and 4: 3 sweeps, sampling, cpu error) at every size the
# main paths give them, whole grid (ms from 4097², device µs below) and on 8
# row shards of the card (device µs a pass of 8 launches), on the route the
# tree's size rule picks and, where the tree has both (forced_leg_route), on
# each; and the chains 6 and 7 (1025² → 9², 3 sweeps)
routes = [None] + (["tile", "wave"] if hasattr(K, "forced_leg_route") else [])
for m in (8193, 4097, 2049, 1025, 257):
    um, fm, cm, hm = rand(m), rand(m), rand((m + 1) // 2), 1 / (m - 1)
    wm, gm = windows(m, um, fm)
    ch = KS.COARSE_HALO
    cwm = [S.window(cm, g.row0 // 2 - ch, (g.row0 + g.rows + 1) // 2 + ch, -ch, (m + 1) // 2 + ch)
           for g in gm]
    calls = {
        "descend": lambda: K.fused_descend(um, fm, hm, 3, 0.8, "sampling", True, True),
        "ascend": lambda: K.fused_ascend(um, fm, cm, hm, 3, 0.8, True, True),
        "descend_shard": on(wm, gm, lambda ue, fe, g: K.fused_descend_shard(
            ue, fe, g, hm, 3, 0.8, "sampling", "cpu")),
        "ascend_shard": lambda: [K.fused_ascend_shard(ue, fe, c, g.row0 // 2 - ch, -ch, g, hm, 3,
                                                      0.8, "cpu")
                                 for (ue, fe), g, c in zip(wm, gm, cwm)],
    }
    for route in routes:
        tag = "" if route is None else f"_{route}"
        with (K.forced_leg_route(route) if route else contextlib.nullcontext()):
            for name, fn in calls.items():
                if name in ("descend", "ascend") and m >= 4097:
                    res[f"{name}_{m}{tag}"] = timed(fn, reps=10 if m < 8193 else 5)
                else:
                    res[f"{name}_{m}{tag}_us"] = 1e3 * device_ms(
                        lambda: [fn() for _ in range(10)], 10)
    del um, fm, cm, wm, gm, cwm, calls
sizes = [1025]
while sizes[-1] > 9:
    sizes.append((sizes[-1] + 1) // 2)
uq, fq = rand(1025), rand(1025)
c_args = (tuple(sizes), 1 / 1024, (3,) * 7, 0.8, "sampling", True)
u_list, f_list = K.chain_descend(uq, fq, *c_args)
a_args = (u_list, [fq] + f_list[:-1], rand(9), tuple(sizes), 1 / 1024, (3,) * 7, 0.8, True, False)
res["chain_descend_1025"] = timed(lambda: K.chain_descend(uq, fq, *c_args))
res["chain_ascend_1025"] = timed(lambda: K.chain_ascend(*a_args))
res["chain_descend_1025_us"] = 1e3 * device_ms(
    lambda: [K.chain_descend(uq, fq, *c_args) for _ in range(10)], 10)
res["chain_ascend_1025_us"] = 1e3 * device_ms(lambda: [K.chain_ascend(*a_args)
                                                       for _ in range(10)], 10)
for split in [None] + ([257, 129, 65, 0] if hasattr(K, "forced_chain_split") else []):
    tag = "" if split is None else f"_split{split}"
    with (K.forced_chain_split(split) if split is not None else contextlib.nullcontext()):
        res[f"chain_descend_1025{tag}_graph_us"] = graph_us(
            lambda: K.chain_descend(uq, fq, *c_args))
        res[f"chain_ascend_1025{tag}_graph_us"] = graph_us(lambda: K.chain_ascend(*a_args))
del uq, fq, u_list, f_list, a_args
# phase 3's V(3,3) cycle at 4097² in device ms a cycle (torch.profiler), the
# tw32 refinement's cycle at 8193² (path A) in device ms, and the bench's
# V(3,3) (coarsen=3) on 8 row shards with halo ppermute (G2): device ms a
# cycle and the host wall
res["vcycle_4097_device"] = device_ms(lambda: [warm(u0, f0) for _ in range(5)], 5)
chain_root, K.CHAIN_MAX_ROOT = K.CHAIN_MAX_ROOT, 0
res["vcycle_4097_legs"] = timed(lambda: warm(u0, f0), reps=5, rounds=3)
res["vcycle_4097_legs_device"] = device_ms(lambda: [warm(u0, f0) for _ in range(5)], 5)
K.CHAIN_MAX_ROOT = chain_root
tw = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n8, config=tmg.SolverConfig(omega=0.8),
                                   max_cycles=30, state="tw32", device="cuda")
tw_cycles = tw.solve(1e-10).cycles
res["tw32_8193_cycle_device"] = device_ms(lambda: tw.solve(1e-10), tw_cycles)
del tw
g2v = tmg.compile_program(tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3),
                          tmg.REFERENCE_PROBLEM, tmg.SolverConfig(omega=0.8,
                                                                  collect_node_stats=False),
                          device="cuda", warm=True, policy=pol8)
gu, gf = g2v.init()
res["g2_vcycle3_ppermute_4097_device"] = device_ms(lambda: [g2v(gu, gf) for _ in range(3)], 3)
res["g2_vcycle3_ppermute_4097_wall"] = walls(lambda: g2v(gu, gf))
del g2v, gu, gf
# G2's bench_scaling program (separate 3-sweep passes, coarsen=1) on 8 row
# shards with halo ppermute
g2 = tmg.compile_program(tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=1),
                         tmg.REFERENCE_PROBLEM, tmg.SolverConfig(collect_node_stats=False),
                         device="cuda", warm=True, policy=pol8)
gu, gf = g2.init()
res["g2_coarsen1_ppermute_4097_device"] = device_ms(lambda: [g2(gu, gf) for _ in range(3)], 3)
res["g2_coarsen1_ppermute_4097_wall"] = walls(lambda: g2(gu, gf))
del g2, gu, gf
# the 8193² trigger V-cycle (chip_smoke.py's path B, batch 7) and on 8 row
# shards (G3, rdma "auto"), host wall clock
tprog2 = tmg.v_cycle(n8, n_min=8, steps=-1, coarse_option=0, coarsen=3)
for tag, batch, pol, halo in (("b7", 7, None, "ppermute"),
                              ("8rows_rdma_auto", "auto",
                               M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=32),
                               "rdma")):
    tc = tmg.compile_program(tprog2, tmg.REFERENCE_PROBLEM, tmg.SolverConfig(
        omega=0.8, collect_node_stats=False, trigger_batch=batch, max_trigger_sweeps=2000,
        halo=halo), device="cuda", policy=pol)
    tu, tf = tc.init()
    res[f"trigger_vcycle_{tag}_8193_wall"] = walls(lambda: tc(tu, tf))
    if halo == "rdma":   # kernel 17's device ms in the cycle
        res[f"trigger_vcycle_{tag}_8193_rdma_trigger_device"] = kernel_device_ms(
            lambda: tc(tu, tf), lambda key: "rdma_trigger" in key)
    del tc, tu, tf
ring = S.layout_of(M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16), n)
us, fs = S.shard(u, ring), S.shard(f, ring)
res.update({
    "rdma_jacobi8_4097": timed(lambda: rdma.rdma_jacobi(us, fs, h, 8, 0.8)),
    "rdma_trigger98_4097": timed(lambda: rdma.rdma_trigger(us, fs, h, 0.8, True, 0.0, 98),
                                 reps=3),
})
del u, f, u8, f8, u0, f0, us, fs
ring_rows(res)

n3, w3 = 513, 6.0 / 7.0
h3 = 1 / (n3 - 1)
u3, f3 = (torch.randn(n3, n3, n3, generator=g, device="cuda") for _ in range(2))
c3 = torch.randn((n3 + 1) // 2, (n3 + 1) // 2, (n3 + 1) // 2, generator=g, device="cuda")
res.update({
    "jacobi3_3err_513": timed(lambda: K3.fused_jacobi3_err(u3, f3, h3, 3, w3, "clean")),
    "jacobi3_3gpu_513": timed(lambda: K3.fused_jacobi3_err(u3, f3, h3, 3, w3, "gpu")),
    "jacobi3_3fz_513": timed(lambda: K3.fused_jacobi3(u3, f3, h3, 3, w3, True)),
    "jacobi3_8_513": timed(lambda: K3.fused_jacobi3(u3, f3, h3, 8, w3), reps=3),
    "jacobi3_errs7_513": timed(lambda: K3.fused_jacobi3_errs(u3, f3, h3, 7, w3, "clean"), reps=3),
    "descend3_513": timed(lambda: K3.fused_descend3(u3, f3, h3, 3, w3, want_err=True)),
    "ascend3_513": timed(lambda: K3.fused_ascend3(u3, f3, c3, h3, 3, w3)),
    "residual3_513": timed(lambda: K3.residual3(u3, f3, h3, True)),
    # kernel 10's emit_residual mode (3 sweeps from zero, negated residual)
    "jacobi3_residual_3fz_513": timed(lambda: K3.fused_jacobi3_residual(u3, f3, h3, 3, w3, True,
                                                                        True)),
})
# kernel 10's fixed modes on the smaller kernel levels (65³ the smallest),
# device µs a call (the host's launch rate would set CUDA events' time)
for m in (129, 65):
    um, fm = (torch.randn(m, m, m, generator=g, device="cuda") for _ in range(2))
    hm = 1 / (m - 1)
    for key, fn in (("1", lambda: K3.fused_jacobi3(um, fm, hm, 1, w3)),
                    ("3gpu", lambda: K3.fused_jacobi3_err(um, fm, hm, 3, w3, "gpu")),
                    ("3clean", lambda: K3.fused_jacobi3_err(um, fm, hm, 3, w3, "clean")),
                    ("8", lambda: K3.fused_jacobi3(um, fm, hm, 8, w3))):
        res[f"jacobi3_{key}_{m}_us"] = 1e3 * device_ms(lambda: [fn() for _ in range(10)], 10)
    # the legs (kernels 11 and 12), v_cycle3's levels below the top one
    cm = torch.randn((m + 1) // 2, (m + 1) // 2, (m + 1) // 2, generator=g, device="cuda")
    for key, fn in (("descend3_3err", lambda: K3.fused_descend3(um, fm, hm, 3, w3, want_err=True)),
                    ("descend3_3fz", lambda: K3.fused_descend3(um, fm, hm, 3, w3, True)),
                    ("ascend3_3", lambda: K3.fused_ascend3(um, fm, cm, hm, 3, w3))):
        res[f"{key}_{m}_us"] = 1e3 * device_ms(lambda: [fn() for _ in range(10)], 10)
    del um, fm, cm
p3 = tmg.REFERENCE_PROBLEM_3D
b3 = p3.boundary_grid(n3, torch.float32, "cuda")
s3 = p3.source_grid(n3, torch.float32, "cuda") + b3
res["v_cycle3_513"] = timed(lambda: tmg.v_cycle3(b3, s3, h3, n_min=5, pre=3, post=3,
                                                  omega=0.857), reps=3, rounds=3)
if os.path.exists(os.path.join(root, "multigrid_poisson_solver_tpu_torch", "ops", "rdma3.py")):
    from multigrid_poisson_solver_tpu_torch.ops import rdma3  # noqa: E402

    zring = M.ZShardingPolicy3(M.make_mesh_z(["cuda:0"] * 8))
    zu, zf = (S.shard(v, S.layout_of(zring, n3)) for v in (u3, f3))
    zc = S.shard(c3, rdma3.coarse_layout3(zf))
    n15 = 257
    u15, f15 = (torch.randn(n15, n15, n15, generator=g, device="cuda") for _ in range(2))
    zu15, zf15 = (S.shard(v, S.layout_of(zring, n15)) for v in (u15, f15))
    res.update({
        "rdma_jacobi3_3gpu_513": timed(lambda: rdma3.rdma_jacobi3(zu, zf, h3, 3, w3, False,
                                                                  "gpu")),
        "rdma_descend3_513": timed(lambda: rdma3.rdma_descend3(zu, zf, h3, 3, w3, False,
                                                               "full_weighting", True)),
        "rdma_ascend3_513": timed(lambda: rdma3.rdma_ascend3(zu, zf, zc, h3, 3, w3)),
        "rdma_trigger3_98_257": timed(lambda: rdma3.rdma_trigger3(
            zu15, zf15, 1 / (n15 - 1), w3, "clean", 0.0, 98), reps=3),
    })
    for m in (129, 65):
        um, fm = (torch.randn(m, m, m, generator=g, device="cuda") for _ in range(2))
        zum, zfm = (S.shard(v, S.layout_of(zring, m)) for v in (um, fm))
        res[f"rdma_trigger3_sweep_{m}"] = timed(lambda: rdma3.rdma_trigger3(
            zum, zfm, 1 / (m - 1), w3, "clean", 0.0, 98), reps=3) / 98
        # the ring legs (kernels 21 and 22) at v_cycle3's lower ring levels,
        # device µs a call
        mc = (m + 1) // 2
        zcm = S.shard(torch.randn(mc, mc, mc, generator=g, device="cuda"),
                      rdma3.coarse_layout3(zfm))
        for key, fn in (("rdma_descend3_3err", lambda: rdma3.rdma_descend3(
                zum, zfm, 1 / (m - 1), 3, w3, False, "full_weighting", True)),
                        ("rdma_ascend3_3", lambda: rdma3.rdma_ascend3(zum, zfm, zcm, 1 / (m - 1),
                                                                      3, w3)),
                        ("rdma_jacobi3_3gpu", lambda: rdma3.rdma_jacobi3(
                            zum, zfm, 1 / (m - 1), 3, w3, False, "gpu"))):
            res[f"{key}_{m}_us"] = 1e3 * device_ms(lambda: [fn() for _ in range(10)], 10)
        del um, fm, zum, zfm, zcm
# the 3-D trigger loops' kernels at their main-path shapes, ms per sweep
t_sweeps = 98
for name, m in (("trigger3", 129), ("trigger3", 65), ("trigger3_stream", 257)):
    um, fm = (torch.randn(m, m, m, generator=g, device="cuda") for _ in range(2))
    fn = K3.trigger_smooth3 if name == "trigger3" else K3.trigger_smooth3_stream
    res[f"{name}_sweep_{m}"] = timed(lambda: fn(um, fm, 1 / (m - 1), w3, "clean", 0.0, t_sweeps),
                                     reps=3) / t_sweeps
    del um, fm
zpol = M.ZShardingPolicy3(M.make_mesh_z(["cuda:0"] * 8), threshold_planes=8)
zgeos = [K3.ShardGeo3(n3, z0, z1 - z0, 8) for z0, z1 in S.layout_of(zpol, n3).rows]
zwins = [[S.planes(v, gz.z0 - 8, gz.z0 + gz.nz + 8) for v in (u3, f3)] for gz in zgeos]
res["jacobi3_errs7_shard_513"] = timed(lambda: [K3.fused_jacobi3_errs_shard(
    ue, fe, gz, h3, 7, w3, "clean") for gz, (ue, fe) in zip(zgeos, zwins)], reps=3)
# kernel 13's shard mode on the same windows, and kernel 10's emit_residual
# mode (3 sweeps from zero; v_cycle3_sharded's 257³ pass)
res["residual3_shard_513"] = timed(lambda: [K3.residual3_shard(ue, fe, gz, h3, True)
                                            for gz, (ue, fe) in zip(zgeos, zwins)], reps=3)
res["jacobi3_residual_shard_3fz_513"] = timed(lambda: [K3.fused_jacobi3_residual_shard(
    None, fe, gz, h3, 3, w3, True, True) for gz, (_, fe) in zip(zgeos, zwins)], reps=3)
# the same at v_cycle3_sharded's odd-depth levels: 257³ on 8 z-shards (ms),
# and 129³ and 65³ on 8 z-shards and whole (device µs a call); windows of
# the 3 planes the pass reads
for m in (257, 129, 65):
    fm, hm = torch.randn(m, m, m, generator=g, device="cuda"), 1 / (m - 1)
    egeos = [K3.ShardGeo3(m, z0, z1 - z0, 3) for z0, z1 in S.layout_of(zpol, m).rows]
    ewins = [S.planes(fm, gz.z0 - 3, gz.z0 + gz.nz + 3) for gz in egeos]

    def emit_shards():
        return [K3.fused_jacobi3_residual_shard(None, fe, gz, hm, 3, w3, True, True)
                for gz, fe in zip(egeos, ewins)]

    if m == 257:
        res["jacobi3_residual_shard_3fz_257"] = timed(emit_shards, reps=3)
    else:
        res[f"jacobi3_residual_shard_3fz_{m}_us"] = 1e3 * device_ms(
            lambda: [emit_shards() for _ in range(10)], 10)
        res[f"jacobi3_residual_3fz_{m}_us"] = 1e3 * device_ms(
            lambda: [K3.fused_jacobi3_residual(None, fm, hm, 3, w3, True, True)
                     for _ in range(10)], 10)
    del fm, egeos, ewins
# kernel 10's fixed modes on 8 z-shards (windows of 8 planes: every halo fits)
for key, steps, fz, mode in (("3gpu", 3, False, "gpu"), ("3clean", 3, False, "clean"),
                             ("3fz", 3, True, None)):
    res[f"jacobi3_shard_{key}_513"] = timed(lambda: [K3.fused_jacobi3_shard(
        None if fz else ue, fe, gz, h3, steps, w3, fz, mode) for gz, (ue, fe) in zip(zgeos, zwins)],
        reps=3)
# the legs on 8 z-shards (windows of 8 planes: every halo fits; the ascend
# leg's coarse windows as sharded_fused_ascend3 cuts them for 3 sweeps)
ext_c = 2
cwins = [S.planes(c3, gz.z0 // 2 - ext_c, (gz.z0 + gz.nz + 1) // 2 + ext_c + 1) for gz in zgeos]
res["descend3_shard_3err_513"] = timed(lambda: [K3.fused_descend3_shard(
    ue, fe, gz, h3, 3, w3, False, "full_weighting", True) for gz, (ue, fe) in zip(zgeos, zwins)],
    reps=3)
res["ascend3_shard_3_513"] = timed(lambda: [K3.fused_ascend3_shard(
    ue, fe, c, gz.z0 // 2 - ext_c, gz, h3, 3, w3) for gz, (ue, fe), c in zip(zgeos, zwins, cwins)],
    reps=3)
# one v_cycle3_sharded V(3,3) cycle at 513³ on the 8 z-shards (chip_smoke.py's
# H2), host wall clock
zf3 = S.as_level(s3, zpol, n3)
res["v_cycle3_sharded_513_8z_wall"] = walls(lambda: tmg.v_cycle3_sharded(
    b3, zf3, h3, zpol.mesh, n_min=5, pre=3, post=3, omega=0.857))
del zwins, cwins, u3, f3, c3, zf3
# the one-sweep shard step with the clean error at H3's exact-loop levels, and
# the lagged pass that replaces it where the tree has one (device µs a step)
for m in (129, 65):
    um, fm = (torch.randn(m, m, m, generator=g, device="cuda") for _ in range(2))
    rows = S.layout_of(zpol, m).rows
    for key, ext in (("step1_clean_shard", 2), ("pass1_lagged_shard", 1)):
        if key == "pass1_lagged_shard" and not hasattr(K3, "trigger_pass3_shard"):
            continue
        geos = [K3.ShardGeo3(m, z0, z1 - z0, ext) for z0, z1 in rows]
        wins = [[S.planes(v, gz.z0 - ext, gz.z0 + gz.nz + ext) for v in (um, fm)] for gz in geos]
        if key == "pass1_lagged_shard":
            # kernel 13 on the same one-plane windows, and on the whole grid
            res[f"residual3_shard_{m}_us"] = 1e3 * device_ms(
                lambda: [K3.residual3_shard(ue, fe, gz, 1 / (m - 1), True)
                         for _ in range(10) for gz, (ue, fe) in zip(geos, wins)], 10)
            res[f"residual3_{m}_us"] = 1e3 * device_ms(
                lambda: [K3.residual3(um, fm, 1 / (m - 1), True) for _ in range(10)], 10)
        if key == "step1_clean_shard":
            def one(gz, ue, fe):
                return K3.fused_jacobi3_shard(ue, fe, gz, 1 / (m - 1), 1, w3, False, "clean",
                                              K3.err_plan3(gz.nz))
        else:
            def one(gz, ue, fe):
                return K3.trigger_pass3_shard(ue, fe, gz, 1 / (m - 1), w3, "clean")
        res[f"{key}_{m}_us"] = 1e3 * device_ms(
            lambda: [one(gz, ue, fe) for _ in range(10) for gz, (ue, fe) in zip(geos, wins)],
            10 * len(geos))
    del um, fm
# the 513³ trigger V-cycle (chip_smoke.py's phase E at trigger_batch 7), host wall clock
tcfg = tmg.SolverConfig(omega=w3, compat_error=False, collect_node_stats=False, trigger_batch=7,
                        max_trigger_sweeps=2000)
tprog = tmg.compile_program3(tmg.v_cycle(n3, n_min=8, steps=-1, coarse_option=0, coarsen=3),
                             p3, tcfg, device="cuda")
tu0, tf0 = tprog.init()
res["trigger_vcycle3_b7_513_wall"] = walls(lambda: tprog(tu0, tf0))
# the same V-cycle on 8 z-shards, trigger_batch "auto" (chip_smoke.py's H3 and I3)
for halo in ("ppermute", "rdma"):
    if halo == "rdma" and not os.path.exists(os.path.join(root, "multigrid_poisson_solver_tpu_torch",
                                                          "ops", "rdma3.py")):
        continue
    hcfg = tmg.SolverConfig(omega=w3, compat_error=False, collect_node_stats=False,
                            trigger_batch="auto", max_trigger_sweeps=2000, halo=halo)
    hprog = tmg.compile_program3(tmg.v_cycle(n3, n_min=8, steps=-1, coarse_option=0, coarsen=3),
                                 p3, hcfg, device="cuda", policy=zpol)
    hu0, hf0 = hprog.init()
    res[f"trigger_vcycle3_auto_513_8z_{halo}_wall"] = walls(lambda: hprog(hu0, hf0), runs=2)
print(json.dumps({"root": sys.argv[1], **{k: round(v, 4) for k, v in res.items()}}), flush=True)

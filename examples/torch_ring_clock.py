"""Where the tile-era ring trigger kernel (kernel 17 up to 7ca9eae) spends a
sweep, and the device times of that tree's rb-GS mode, on one CUDA card.

    python3 examples/torch_ring_clock.py ROOT

ROOT holds that tree (``multigrid_poisson_solver_tpu_torch`` with the tile
kernel in ``ops/csrc/rdma_trigger.cu``; an unpacked ``git archive
7ca9eae``). ``examples/torch_ring_clock.cu``, a copy of its kernel with
%globaltimer stamps, is built with nvcc for sm_90a against ROOT's headers and
run at 4097² on a ring of 8 row shards of the card, 98 sweeps (trigger 0,
cpu error, ω 0.8, random data from a seed); its iterate, error and sweeps
must equal ROOT's own kernel's. Per sweep (sweeps 2-98): the tile sweep, from
the first block's start to the last block's end of its tiles; the tail, from
there to the last block's exit from the all-to-all; the period, start to
start; and the means over blocks of a block's tile time and of its wait
after them. Then ROOT's timings: kernel 17 a sweep (CUDA events, 98 sweeps),
rb-GS with 2 sweeps + cpu error at 4097² (ms) and at 4097², 1025² and 257²
(device µs of a CUDA graph's replays), and its shard pass on the 8 shards of
4097² (8 launches on windows exchanged beforehand, device µs). Last line:
one JSON object of medians.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

from multigrid_poisson_solver_tpu_torch.ops import build, kernels as K, rdma  # noqa: E402
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS  # noqa: E402
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M, sharded as S  # noqa: E402

HERE = Path(__file__).resolve().parent
N, SWEEPS, OMEGA = 4097, 98, 0.8


def graph_us(fn, replays=20):
    """Device µs of one call of fn: a CUDA graph of the call, replayed."""
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


def timed(fn, reps=3, rounds=5):
    """Median over rounds of the mean device ms of reps calls (CUDA events)."""
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


def clock_lib():
    out = Path(ROOT) / "build" / "ring_clock" / "libring_clock.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    csrc = Path(ROOT) / "multigrid_poisson_solver_tpu_torch" / "ops" / "csrc"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(out),
           str(HERE / "torch_ring_clock.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint64
    lib.clock_rdma_trigger.argtypes = ([P] * 5 + [I, I] + [P] * 7 + [I, F, F, F, F, F, I, U]
                                       + [P, I, P, P])
    lib.clock_rdma_trigger.restype = I
    return lib


def split(lib, us, fs, h):
    """The stamped kernel on (us, fs): its outputs and the per-sweep split."""
    n, lay = fs.n, fs.layout
    row0s = [r0 for r0, _ in lay.rows] + [n]
    shards = len(row0s) - 1
    ws = rdma._workspace(fs.device, shards, n)
    blocks = [b[0] for b in fs.blocks]
    out = [torch.empty_like(b) for b in blocks]
    tmp = [torch.empty_like(b) for b in blocks]
    tiles = sum(build.load().mg_num_tiles_block(r1 - r0, n) for r0, r1 in lay.rows)
    partials = torch.empty(tiles, device="cuda")
    err = torch.empty(1, device="cuda")
    sweeps = torch.empty(1, dtype=torch.int32, device="cuda")
    stamps = torch.zeros(SWEEPS * 4096 * 3, dtype=torch.int64, device="cuda")
    nblocks = ctypes.c_int(0)
    rc = lib.clock_rdma_trigger(
        rdma._ptrs([b[0] for b in us.blocks]), rdma._ptrs(blocks), rdma._ptrs(out),
        rdma._ptrs(tmp), K._c_array(ctypes.c_int, row0s), shards, n, partials.data_ptr(),
        ws.halo.data_ptr(), ws.err.data_ptr(), ws.flags.data_ptr(), ws.count.data_ptr(),
        err.data_ptr(), sweeps.data_ptr(), K._ERR_CODES["cpu"], h * h, OMEGA, 1.0 / (h * h),
        K.shard_err_scale("cpu", n, h), 0.0, SWEEPS, ws.take(SWEEPS + 1), stamps.data_ptr(),
        SWEEPS, ctypes.byref(nblocks), torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"clock_rdma_trigger failed: CUDA error {rc}")
    torch.cuda.synchronize()
    b = nblocks.value
    st = stamps[:SWEEPS * b * 3].reshape(SWEEPS, b, 3).double().cpu() / 1e3   # µs
    rows = {"tile_sweep_us": [], "tail_us": [], "period_us": [], "block_tiles_us": [],
            "block_wait_us": []}
    for k in range(1, SWEEPS - 1):
        t0, t1, t2 = st[k, :, 0], st[k, :, 1], st[k, :, 2]
        rows["tile_sweep_us"].append(float(t1.max() - t0.min()))
        rows["tail_us"].append(float(t2.max() - t1.max()))
        rows["period_us"].append(float(st[k + 1, :, 0].min() - t0.min()))
        rows["block_tiles_us"].append(float((t1 - t0).mean()))
        rows["block_wait_us"].append(float((t2 - t1).mean()))
    res = {k: statistics.median(v) for k, v in rows.items()}
    res["blocks"] = b
    return (out, err, sweeps), res


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_ring_clock: needs a CUDA card")
    if not K.__file__.startswith(ROOT):
        sys.exit(f"imported {K.__file__}, not the tree under {ROOT}")
    build.build()
    build.load()
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    u, f = (torch.randn(N, N, generator=g, device="cuda") for _ in range(2))
    h = 1.0 / (N - 1)
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16)
    lay = S.layout_of(pol, N)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    (out, err, sweeps), res = split(clock_lib(), us, fs, h)
    gu, ge, gk = rdma.rdma_trigger(us, fs, h, OMEGA, True, 0.0, SWEEPS)
    same = (int(gk) == int(sweeps) and bool(torch.equal(ge.reshape(1), err))
            and all(bool(torch.equal(a[0], b)) for a, b in zip(gu.blocks, out)))
    if not same:
        sys.exit("the stamped kernel's iterate, error or sweeps differ from the tree's kernel")
    res = {"device": torch.cuda.get_device_name(0), **res}
    res["rdma_trigger_ms_a_sweep"] = timed(
        lambda: rdma.rdma_trigger(us, fs, h, OMEGA, True, 0.0, SWEEPS)) / SWEEPS
    res["rbgs2err_4097_ms"] = timed(lambda: K.fused_rbgs_err(u, f, h, 2, True), reps=10)
    for m in (4097, 1025, 257):
        um, fm = (torch.randn(m, m, generator=g, device="cuda") for _ in range(2))
        res[f"rbgs2err_{m}_graph_us"] = graph_us(
            lambda: K.fused_rbgs_err(um, fm, 1.0 / (m - 1), 2, True))
    ext = [(S.extend(us, i, 0, KS.HALO, 0), S.extend(fs, i, 0, KS.HALO, 0))
           for i in range(len(lay.rows))]
    geos = [K.ShardGeo(N, r0, 0, r1 - r0, N, KS.HALO, 0) for r0, r1 in lay.rows]
    res["rbgs_shard2cpu_4097_8_graph_us"] = graph_us(lambda: [
        K.fused_jacobi_shard(ue, fe, g_, h, 2, 1.0, False, "cpu", "rbgs")
        for (ue, fe), g_ in zip(ext, geos)])
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in res.items()}),
          flush=True)


if __name__ == "__main__":
    main()

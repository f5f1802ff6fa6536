"""The chains' (kernels 6 and 7) times beside their floor, on one CUDA card.

    python3 examples/torch_chain_floor.py [ROOT]

Builds ``examples/torch_chain_floor.cu`` with nvcc for sm_90a and times the
floor's units in device µs: one cluster barrier (8 blocks of 1024 threads,
the chains' tail), one grid barrier (297 cooperative blocks of 256 threads,
the wide launch at 1025²) and one launch (an empty kernel; 20 of them in a
CUDA graph). Then ROOT's chains (default: this checkout) on the main path's
ladder, 1025² → 9², 3 sweeps a level, sampling, from zero (descend) and 3
post-sweeps without an error (ascend), ω 0.8, random data from a seed: on
the tree's split and, where the tree has ``forced_chain_split``, on each
split (257, 129, 65, 0), the device µs of one call (a CUDA graph of one
call, replayed 20 times), the host µs of one call (100 calls enqueued) and
the kernels a call launched (``kernels.launches``). The floor of a chain on
the rule's split (257²) is its dependent barriers and launches times these
units: descend 2 launches, 1 grid barrier (1025² → 513²) and 7 cluster
barriers (one after the tail's first load, three at each of 257² and 129²:
before the second sweep, after the sweeps, after the restriction); ascend 2
launches, 1 grid barrier and 9 cluster barriers (at 257² and 129² one
before each of the 3 sweeps and one after the level, and one after 65²,
whose result the blocks of 129² read). Last line: one JSON object.
"""

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       Path(__file__).resolve().parent.parent)
sys.path.insert(0, ROOT)

from multigrid_poisson_solver_tpu_torch.ops import build, kernels as K  # noqa: E402

HERE = Path(__file__).resolve().parent
# (launches, grid barriers, cluster barriers) of each chain on split 257²
FLOOR_COUNTS = {"descend": (2, 1, 7), "ascend": (2, 1, 9)}


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


def host_us(fn, calls=100):
    """Host µs to enqueue one call of fn."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / calls


def unit_costs():
    out = Path(ROOT) / "build" / "chain_floor" / "libchain_floor.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(HERE / "torch_chain_floor.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_cluster_syncs.argtypes = [I, P]
    lib.probe_grid_syncs.argtypes = [I, I, P]
    lib.probe_empty.argtypes = [P]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def barrier_us(launch, iters=2000):
        t = [graph_us(lambda: launch(k), replays=5) for k in (0, iters)]
        return (t[1] - t[0]) / iters

    return {"cluster_sync_us": barrier_us(lambda k: lib.probe_cluster_syncs(k, stream())),
            "grid_sync_us": barrier_us(lambda k: lib.probe_grid_syncs(297, k, stream())),
            "launch_us": graph_us(lambda: [lib.probe_empty(stream()) for _ in range(20)],
                                  replays=10) / 20}


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_chain_floor: needs a CUDA card")
    if not K.__file__.startswith(ROOT):
        sys.exit(f"imported {K.__file__}, not the tree under {ROOT}")
    build.build()
    build.load()
    result = {"device": torch.cuda.get_device_name(0), **unit_costs()}
    for name, (launches, grid, cluster) in FLOOR_COUNTS.items():
        result[f"{name}_floor_us"] = (launches * result["launch_us"]
                                      + grid * result["grid_sync_us"]
                                      + cluster * result["cluster_sync_us"])
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    sizes = [1025]
    while sizes[-1] > 9:
        sizes.append((sizes[-1] + 1) // 2)
    sizes = tuple(sizes)
    steps, h0 = (3,) * (len(sizes) - 1), 1.0 / 1024
    fq = torch.randn(1025, 1025, generator=g, device="cuda")
    u_list, f_list = K.chain_descend(None, fq, sizes, h0, steps, 0.8, "sampling", True)
    uc = torch.randn(9, 9, generator=g, device="cuda")
    calls = {"descend": lambda: K.chain_descend(None, fq, sizes, h0, steps, 0.8, "sampling",
                                                True),
             "ascend": lambda: K.chain_ascend(u_list, [fq] + f_list[:-1], uc, sizes, h0, steps,
                                              0.8, True, False)}
    splits = [None] + ([257, 129, 65, 0] if hasattr(K, "forced_chain_split") else [])
    for split in splits:
        tag = "rule" if split is None else f"split{split}"
        with K.forced_chain_split(split) if split is not None else contextlib.nullcontext():
            for name, fn in calls.items():
                K.reset_launch_counts()
                fn()
                result[f"{name}_{tag}_kernels"] = K.launches[f"chain_{name}"]
                result[f"{name}_{tag}_graph_us"] = graph_us(fn)
                result[f"{name}_{tag}_host_us"] = host_us(fn)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

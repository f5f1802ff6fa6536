"""Time the legs (kernels 3 and 4) of a bf16 and of an fp32 state on each
route, around the size rule's 1.5 M-cell crossover (``legs_take_wave``).

    python3 examples/torch_bf16_leg_routes.py [N ...]

Sizes default to 1025 1281 1449 2049. For each size, dtype and route (the
tile kernel, the wavefront, forced with ``forced_leg_route``): the descend
leg (3 sweeps, sampling, no error) and the ascend leg (3 sweeps, no error)
in device µs a call, from CUDA graph replays of 10 calls (median of 7
replays), with the route the size rule picks. Both routes give the same
bits; the script checks that too. Prints the card's name and power limit
first.
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from multigrid_poisson_solver_tpu_torch.ops import build, kernels as K  # noqa: E402

CALLS, REPLAYS = 10, 7
# the size rule's crossover in cells (legs_take_wave's min_cells: wave2.cuh,
# descend_bf16.cu, ascend_bf16.cu)
WAVE_MIN_CELLS = {(torch.bfloat16, "descend"): 5 << 20, (torch.bfloat16, "ascend"): 5 << 19,
                  (torch.float32, "descend"): 3 << 19, (torch.float32, "ascend"): 3 << 19}


def graph_us(fn):
    """Device µs a call of ``fn`` from CUDA graph replays."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(CALLS):
            fn()
    g.replay()
    times = []
    for _ in range(REPLAYS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b) / CALLS)
    return statistics.median(times)


def main(argv=None):
    sizes = [int(a) for a in (argv or sys.argv[1:])] or [1025, 1281, 1449, 2049]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    build.build()
    build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in sizes:
        m, h = (n + 1) // 2, 1.0 / (n - 1)
        for dtype in (torch.bfloat16, torch.float32):
            u, f = (torch.randn(n, n, device="cuda", generator=gen).to(dtype) for _ in range(2))
            uc = torch.randn(m, m, device="cuda", generator=gen).to(dtype)
            legs = {"descend": lambda: K.fused_descend(u, f, h, 3, 0.8, "sampling"),
                    "ascend": lambda: K.fused_ascend(u, f, uc, h, 3, 0.8)}
            for name, fn in legs.items():
                us, outs = {}, {}
                for route in ("tile", "wave"):
                    with K.forced_leg_route(route):
                        outs[route] = fn()[0].clone()
                        us[route] = graph_us(fn)
                same = torch.equal(outs["tile"], outs["wave"])
                rule = "wave" if n * n >= WAVE_MIN_CELLS[dtype, name] else "tile"
                print(f"{n}² {str(dtype)[6:]} {name}: tile {us['tile']:.2f} µs, wave "
                      f"{us['wave']:.2f} µs, the rule's route {rule}; routes bit-identical: "
                      f"{same}", flush=True)
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

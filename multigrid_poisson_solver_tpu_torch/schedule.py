"""Cycle schedules: a typed Python API plus a Cycle.txt-compatible parser.

Port of ``multigrid_poisson_solver_tpu/schedule.py``; the module is pure
Python, so the port is the same code (the native C++ parser is not ported).

The reference drives its solver with a whitespace-token cycle file
(grammar: the reference README.md:43-128; parser inlined in main(),
MG_solver_CPU.cpp:70-146 with per-node option reads at :171-189, :307,
:331-344). This module resolves that token stream — including the full
``con_step × con_N`` option matrix and the error-trigger mode — into a flat
list of typed instructions, which is also the schedule representation users
build programmatically (``v_cycle``/``w_cycle``/``fmg`` generators).

Node semantics (README.md:93-101):
  -1  smooth at the current level, then restrict (descend)
   0  exact coarse solve (reads ``target_error option`` from the stream)
   1  prolongate to the parent level, add the correction, then smooth (ascend)
   2  end of program

Step semantics per node:
  step  > 0  fixed number of smoothing sweeps
  step == -1 error-trigger: smooth one sweep at a time while
             |err_k − err_{k−1}| > trigger (reference hardcodes
             TRIGGER = 0.01, MG_solver_CPU.cpp:99)
  step == 0  on descend: FMG descent — the reference leaves this branch as
             "Full Multigrid Method TODO" (MG_solver_CPU.cpp:296-299, a
             silent no-op); here it is implemented properly: skip smoothing
             and restrict the level's full RHS F (not the residual) to the
             next level. On ascend: skip post-smoothing.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Union

from .grid import level_sizes

TRIGGER_DEFAULT = 0.01


@dataclasses.dataclass(frozen=True)
class Descend:
    """Smooth the current level, then restrict down to a grid of size next_n.

    steps > 0: fixed sweeps; steps == -1: error-trigger; steps == 0: FMG
    descent (restrict the RHS itself, no smoothing).
    """

    next_n: int
    steps: int


@dataclasses.dataclass(frozen=True)
class CoarseSolve:
    """Exact solve at the current (coarsest) level.

    option 0: dense direct solve; 1: red-black GS to target_error (fp64);
    2: red-black GS in fp32 (doExactSolver options, MG_solver_CPU.cpp:627-638
    and MG_solver_GPU.cu:1284-1301).
    """

    target_error: float
    option: int = 1


@dataclasses.dataclass(frozen=True)
class Ascend:
    """Prolongate to the parent level, add the correction, then smooth.

    steps semantics as in Descend (0 = skip post-smoothing).
    """

    steps: int


Instruction = Union[Descend, CoarseSolve, Ascend]


@dataclasses.dataclass(frozen=True)
class CycleProgram:
    """A fully resolved multigrid schedule over a fixed physical domain."""

    length: float
    min_x: float
    min_y: float
    n_max: int
    instructions: tuple[Instruction, ...]

    def validate(self) -> None:
        """Static sanity checks the reference never performs (it would segfault)."""
        depth = 1
        n = self.n_max
        stack = [n]
        for i, ins in enumerate(self.instructions):
            if isinstance(ins, Descend):
                if ins.next_n < 3:
                    raise ValueError(f"instruction {i}: next_n={ins.next_n} below minimum grid 3")
                if ins.next_n >= stack[-1]:
                    raise ValueError(
                        f"instruction {i}: next_n={ins.next_n} does not coarsen n={stack[-1]}")
                stack.append(ins.next_n)
                depth += 1
            elif isinstance(ins, Ascend):
                if depth <= 1:
                    raise ValueError(f"instruction {i}: Ascend with no coarser level on the stack")
                stack.pop()
                depth -= 1
        # (ending mid-hierarchy is legal in the reference; the final report just
        # uses whatever level is current)


def _tokens(text: str) -> Iterator[str]:
    return iter(text.split())


def parse_cycle_file(text: str) -> CycleProgram:
    """Parse the reference's Cycle.txt grammar into a CycleProgram.

    Resolves the con_step × con_N option matrix (README.md:103-128): which
    extra tokens each node reads, and how per-level grid sizes are generated
    (con_N 1: halve, 2: decrement, 0: explicit per node).
    """
    tok = _tokens(text)

    def next_tok(what):
        try:
            return next(tok)
        except StopIteration:
            raise ValueError(f"cycle file ended while reading {what}") from None

    length = float(next_tok("L"))
    min_x = float(next_tok("min_x"))
    min_y = float(next_tok("min_y"))
    con_step = int(next_tok("con_step"))
    con_n = int(next_tok("con_N"))
    n_max = int(next_tok("N_max"))
    n_min = int(next_tok("N_min"))

    # con_N 1 and 2 are the reference's rules (halve / decrement,
    # README.md:80-86); 3 is this framework's odd-halve extension (2^k+1
    # aligned hierarchies for full-weighting restriction); 0 reads next_N
    # per node. Anything else is a clean error (the native parser,
    # native/mg_runtime.cpp::mg_parse_cycle, enforces the same set).
    if con_n not in (0, 1, 2, 3):
        raise ValueError(
            f"unknown con_N {con_n}; expected 0 (explicit next_N per node), "
            f"1 (halve), 2 (decrement), or 3 (odd-halve extension)")
    n_array = level_sizes(n_max, n_min, con_n) if con_n != 0 else None
    level = 0  # index into n_array (the reference's len_flag)

    instructions: list[Instruction] = []
    for node_tok in tok:
        node = int(node_tok)
        if node == 2:
            break
        if node == -1:
            if con_step == 0:
                steps = int(next_tok("step"))
            else:
                steps = con_step
            if con_n == 0:
                next_n = int(next_tok("next_N"))
            else:
                level += 1
                if level >= len(n_array):
                    raise ValueError(
                        f"schedule descends below the coarsest generated level "
                        f"(N_max={n_max}, N_min={n_min}, rule con_N={con_n} "
                        f"gives {len(n_array)} levels)")
                next_n = n_array[level]
            instructions.append(Descend(next_n=next_n, steps=steps))
        elif node == 0:
            target_error = float(next_tok("target_error"))
            option = int(next_tok("option"))
            instructions.append(CoarseSolve(target_error=target_error, option=option))
        elif node == 1:
            if con_step == 0:
                steps = int(next_tok("step"))
            else:
                steps = con_step
            if con_n != 0:
                level -= 1
            instructions.append(Ascend(steps=steps))
        else:
            raise ValueError(f"unknown node {node}; expected -1, 0, 1, or 2")

    program = CycleProgram(
        length=length, min_x=min_x, min_y=min_y, n_max=n_max,
        instructions=tuple(instructions),
    )
    program.validate()
    return program


def parse_cycle_path(path) -> CycleProgram:
    with open(path) as fh:
        return parse_cycle_file(fh.read())


# --- Programmatic schedule generators ----------------------------------------

def _geometry(n_max: int, n_min: int, coarsen: int) -> list[int]:
    sizes = level_sizes(n_max, n_min, coarsen)
    if len(sizes) < 2:
        raise ValueError(f"need at least 2 levels; N_max={n_max}, N_min={n_min} give {sizes}")
    return sizes


def v_cycle(
    n_max: int,
    n_min: int = 8,
    steps: int = 3,
    coarse_target: float = 1e-7,
    coarse_option: int = 1,
    length: float = 1.0,
    min_x: float = 0.0,
    min_y: float = 0.0,
    coarsen: int = 1,
) -> CycleProgram:
    """Single V-cycle: descend to the coarsest level, solve, ascend back."""
    sizes = _geometry(n_max, n_min, coarsen)
    ins: list[Instruction] = [Descend(next_n=m, steps=steps) for m in sizes[1:]]
    ins.append(CoarseSolve(target_error=coarse_target, option=coarse_option))
    ins.extend(Ascend(steps=steps) for _ in sizes[1:])
    return CycleProgram(length, min_x, min_y, n_max, tuple(ins))


def w_cycle(
    n_max: int,
    n_min: int = 8,
    steps: int = 3,
    coarse_target: float = 1e-8,
    coarse_option: int = 1,
    length: float = 1.0,
    min_x: float = 0.0,
    min_y: float = 0.0,
    coarsen: int = 1,
) -> CycleProgram:
    """Recursive W-cycle (two coarse-level visits per level)."""
    sizes = _geometry(n_max, n_min, coarsen)

    def visit(level: int) -> list[Instruction]:
        if level == len(sizes) - 1:
            return [CoarseSolve(target_error=coarse_target, option=coarse_option)]
        body = [Descend(next_n=sizes[level + 1], steps=steps)]
        body += visit(level + 1)
        body.append(Ascend(steps=steps))
        body.append(Descend(next_n=sizes[level + 1], steps=steps))
        body += visit(level + 1)
        body.append(Ascend(steps=steps))
        return body

    # top level descends once; the double-visit happens below it (matching the
    # shape of the bundled Wcycle.txt schedule)
    ins = [Descend(next_n=sizes[1], steps=steps)] + visit(1) + [Ascend(steps=steps)]
    return CycleProgram(length, min_x, min_y, n_max, tuple(ins))


def fmg(
    n_max: int,
    n_min: int = 8,
    steps: int = 3,
    coarse_target: float = 1e-8,
    coarse_option: int = 1,
    length: float = 1.0,
    min_x: float = 0.0,
    min_y: float = 0.0,
    coarsen: int = 1,
) -> CycleProgram:
    """Full multigrid (nested iteration) — the schedule the reference's TODO
    branch (MG_solver_CPU.cpp:296-299) was meant to enable.

    FMG descent (steps=0: restrict the RHS itself, no smoothing) to the
    coarsest level, exact solve, then on each ascent: prolongate the solution
    as the initial guess and run one full V-cycle rooted at that level. One
    pass lands at the discretization-error floor.
    """
    sizes = _geometry(n_max, n_min, coarsen)
    ins: list[Instruction] = [Descend(next_n=m, steps=0) for m in sizes[1:]]
    ins.append(CoarseSolve(target_error=coarse_target, option=coarse_option))
    for level in range(len(sizes) - 2, -1, -1):
        ins.append(Ascend(steps=steps))
        # V-cycle rooted at `level` to solve that level before refining further
        ins.extend(Descend(next_n=m, steps=steps) for m in sizes[level + 1:])
        ins.append(CoarseSolve(target_error=coarse_target, option=coarse_option))
        ins.extend(Ascend(steps=steps) for _ in sizes[level + 1:])
    return CycleProgram(length, min_x, min_y, n_max, tuple(ins))


def repeat(program: CycleProgram, times: int) -> CycleProgram:
    """Chain a cycle ``times`` times; warm-restart semantics make iterations
    converge (LinkedList init flag, linkedlist.h:38-41 + MG_solver_CPU.cpp:209-214)."""
    return dataclasses.replace(program, instructions=program.instructions * times)


def to_cycle_file(program: CycleProgram) -> str:
    """Serialize a CycleProgram back to the reference's Cycle.txt grammar
    (con_step=0, con_N=0 form: every node carries explicit step/next_N tokens)."""
    lines = [
        f"{program.length} {program.min_x} {program.min_y}",
        "0 0",
        f"{program.n_max} 1",
    ]
    for ins in program.instructions:
        if isinstance(ins, Descend):
            lines.append("-1")
            lines.append(f"{ins.steps} {ins.next_n}")
        elif isinstance(ins, CoarseSolve):
            lines.append("0")
            lines.append(f"{ins.target_error:.17g} {ins.option}")
        elif isinstance(ins, Ascend):
            lines.append("1")
            lines.append(f"{ins.steps}")
    lines.append("2")
    return "\n".join(lines) + "\n"

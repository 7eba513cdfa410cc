"""Closed-form analysis from the paper's Table 2 / §3.4.

Symbols (Table 1): L layers, M_w / M_a per-layer weight/activation memory,
V stages per device, B micro-batches, P pipeline size, D DP size.

The port's copy of ``repro/core/analysis.py`` (pure Python), held equal
to it by tests/test_torch_autogen.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MethodAnalysis:
    bubble_units: float        # pipeline bubbles, in per-mb task units
    weight_mem: float
    act_mem: float
    n_param_comm: float        # parameter all-gathers per step (x = 0)


def analyze(
    method: str,
    *,
    L: int,
    P: int,
    V: int,
    B: int,
    U: int | None = None,
    D: int = 1,
    M_w: float = 1.0,
    M_a: float = 1.0,
) -> MethodAnalysis:
    U = U or B
    if method == "gpipe":
        return MethodAnalysis(2 * (P - 1), L * M_w / P, B * L * M_a / P, 0)
    if method == "1f1b":
        return MethodAnalysis(2 * (P - 1), L * M_w / P, L * M_a, 0)
    if method == "fs-1f1b":
        # sharded base + a per-layer double gather buffer (Table 2: "M_w")
        return MethodAnalysis(2 * (P - 1), L * M_w / (P * D) + 2 * M_w,
                              L * M_a, 2 * B * L / P)
    if method == "interleaved":
        return MethodAnalysis(
            2 * (P - 1) / V, L * M_w / P,
            L * M_a * (1 + (P - 1) / (V * P)), 0,
        )
    if method == "bfs":
        return MethodAnalysis(2 * (P - 1) / V, L * M_w / P, B * L * M_a / P, 0)
    if method == "fs-bfs":
        return MethodAnalysis(
            2 * (P - 1) / V, L * M_w / (P * D) + 2 * L * M_w / (P * V),
            B * L * M_a / P, L * (2 * V - 1) / (P * V) * 1,
        )
    if method == "zeropp":
        bub = 0.0 if U >= 2 * P - 1 else B * (2 * P - 1 - U) / U
        return MethodAnalysis(
            bub, L * M_w / P, min(B, 2 * P - 1) * L * M_a / P, 0,
        )
    if method == "fs-zeropp":
        bub = 0.0 if U >= 2 * P - 1 else B * (2 * P - 1 - U) / U
        # §3.4: Max Allocation = L·M_w/(P·D) + L·M_w/(P·V) + MIN(B,U)·L·M_a/P
        return MethodAnalysis(
            bub,
            L * M_w / (P * D) + L * M_w / (P * V),
            min(B, U) * L * M_a / P,
            n_allgather(B=B, L=L, V=V, U=U, P=P),
        )
    if method == "fs-autogen":
        # full-depth §4 auto-generation: W postponement crosses unit
        # boundaries, so the whole batch's activations/(x,dy) stashes
        # stay live — the O(B) bound the unit-gated variant closes.
        a = analyze("fs-zeropp", L=L, P=P, V=V, B=B, U=B, D=D, M_w=M_w,
                    M_a=M_a)
        return MethodAnalysis(0.0, a.weight_mem, B * L * M_a / P,
                              a.n_param_comm)
    if method == "fs-autogen-gated":
        # unit-gated §4: insertions confined to each unit's live window,
        # so memory matches fs-zeropp's O(U) allocation; bubbles land
        # between zero (U >= 2P-1) and the zeropp bound, where inside
        # the window the heuristic fills what greedy W-fill leaves.
        return analyze("fs-zeropp", L=L, P=P, V=V, B=B, U=U, D=D,
                       M_w=M_w, M_a=M_a)
    raise ValueError(method)


def n_allgather(*, B: int, L: int, V: int, U: int, P: int) -> float:
    """§3.4: #AllGather = B·L·(2V−1)/(U·P·V)."""
    return B * L * (2 * V - 1) / (U * P * V)


def optimal_active_microbatches(P: int) -> int:
    """§3.4: near-zero bubbles need U ≥ 2P−1 active micro-batches."""
    return 2 * P - 1


def zeropp_max_alloc(*, L, P, D, V, B, U, M_w=1.0, M_a=1.0) -> float:
    return (L * M_w / (P * D) + L * M_w / (P * V)
            + min(B, U) * L * M_a / P)

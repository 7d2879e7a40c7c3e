"""The operations and bytes the algorithms need, counted from the
configuration and the data, never from the program's layout: padded
slots, materialized intermediates and re-reads do not count, so that a
change of layout cannot move the yardstick.

Each ``*_bound_s`` is the least time the chip could take: the larger of
the operations over the bf16 peak and the bytes over the HBM rate.
"""

from __future__ import annotations

from benchmark.lib import peaks

#: the least bytes one rating can cross as: a 3-byte opposing index and
#: a 1-byte value code (the tightest wire form a half-step could read)
RATING_BYTES = 4
F32 = 4


def als_flops_per_alternation(n_ratings: int, n_users: int, n_items: int,
                              rank: int, cg_iters: int) -> float:
    """Both half-steps of ALS-WR: per rating and side the Gramian's
    ``2 K^2`` and the rhs's ``2 K``, and per row of each side the CG's
    ``cg_iters + 1`` matvecs of ``2 K^2``."""
    K = float(rank)
    per_side = float(n_ratings) * (2.0 * K * K + 2.0 * K)
    solves = (cg_iters + 1) * 2.0 * K * K * float(n_users + n_items)
    return 2.0 * per_side + solves


def als_bytes_per_alternation(n_ratings: int, n_users: int, n_items: int,
                              rank: int) -> float:
    """Both half-steps: the ratings read once per half-step, and each
    f32 factor table read once (as the opposing side) and written once
    (as the solved side)."""
    tables = float(n_users + n_items) * rank * F32
    return 2.0 * float(n_ratings) * RATING_BYTES + 2.0 * tables


def als_bound_s(n_ratings, n_users, n_items, rank, cg_iters) -> float:
    return max(
        als_flops_per_alternation(n_ratings, n_users, n_items, rank,
                                  cg_iters) / peaks.BF16_FLOPS,
        als_bytes_per_alternation(n_ratings, n_users, n_items, rank)
        / peaks.HBM_BYTES_PER_S)

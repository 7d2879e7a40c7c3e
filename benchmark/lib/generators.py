"""The one generator of the benchmark's inputs: it reads a traffic mix
(``benchmark/traffic/<mix>.json``) and a configuration's sizes and makes
the data from ``--seed``. The same seed gives the same inputs; every
seed gives the same sizes and the same distributions, so seeds change
which rows come, not how much work they are.

``ratings`` makes explicit ratings to a dataset's published statistics:

- each user's count of ratings is a quantile of ``min + lognormal``
  whose median is the published median, capped at the published
  maximum, with the lognormal's spread fitted so that the counts sum to
  ``n_ratings`` (the published mean); one count a user, the same set on
  every seed, dealt to the user ids by a seeded permutation;
- each item's expected count follows its popularity rank ``r`` (from 0)
  as ``top * exp(-(r / scale) ** shape)``, a stretched exponential that
  reads the published most-rated count at rank 0, the published median
  at the middle rank, and sums to ``n_ratings``; dealt to the item ids
  by a seeded permutation;
- each user's items are a sample without replacement, by systematic
  sampling with inclusion probabilities ``min(1, c_u w_i)`` (a user
  rates every item whose probability reaches 1, the rest in proportion
  to ``w``), so that no (user, item) pair repeats; ``w`` is fitted so
  that every item's expected count is its target;
- the values have a planted low-rank structure plus noise, mapped by
  their quantiles onto the published histogram of rating values.

The pairs, the values and the factors are drawn on the device, from a
``torch.Generator`` there, in a few large calls; only the fits of the
count curves, a few thousand numbers, run on the host.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

#: the fits stop here (relative error of an expected count)
FIT_TOL = 1e-4
FIT_ROUNDS = 200
#: ratings a block when the planted values are made, and the most of
#: them the quantiles of the values are read from
CHUNK = 1 << 22
SAMPLE = 1 << 20


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (``tags`` name the
    stream), so that streams never share numbers."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), *map(int, tags)])
    return int(ss.generate_state(1, dtype=np.uint64)[0]) & ((1 << 63) - 1)


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *tags))


def _bisect(f, lo: float, hi: float, rounds: int = 60) -> float:
    """The root of increasing ``f`` in ``[lo, hi]``."""
    if not f(lo) <= 0.0 <= f(hi):
        raise ValueError(f"no root in [{lo}, {hi}]")
    for _ in range(rounds):
        mid = 0.5 * (lo + hi)
        if f(mid) < 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def integerize(x: np.ndarray, total: int, floor: int) -> np.ndarray:
    """Whole counts, each at least ``floor``, summing to ``total``, by
    largest remainders from ``x`` scaled to ``total``."""
    x = np.maximum(x * (total / x.sum()), floor)
    out = np.floor(x).astype(np.int64)
    short = int(total - out.sum())
    if short < 0:
        raise ValueError("the counts' floor exceeds the total")
    out[np.argsort(out - x, kind="stable")[:short]] += 1
    return out


def user_counts(n_users: int, n_ratings: int, spec: dict) -> np.ndarray:
    """Ratings of each user, in increasing order: ``min + exp(mu + s z)``
    at the ``n_users`` mid-quantiles ``z``, capped at ``max``; ``mu``
    puts the median at ``median``, ``s`` makes the mean
    ``n_ratings / n_users``."""
    from scipy.special import ndtri

    lo, med, cap = int(spec["min"]), float(spec["median"]), int(spec["max"])
    z = ndtri((np.arange(n_users) + 0.5) / n_users)
    mu = math.log(med - lo)

    def counts(s):
        return np.minimum(lo + np.exp(mu + s * z), cap)

    s = _bisect(lambda s: counts(s).mean() - n_ratings / n_users, 1e-3, 6.0)
    return integerize(counts(s), n_ratings, lo)


def item_targets(n_items: int, n_ratings: int, spec: dict) -> np.ndarray:
    """Expected ratings of each item by popularity rank, decreasing:
    ``top * exp(-(r / scale) ** shape)``, ``scale`` set by the median
    anchor and ``shape`` by the total."""
    top, med = float(spec["top"]), float(spec["median"])
    r = np.arange(n_items, dtype=np.float64)
    mid = (n_items - 1) / 2.0
    drop = math.log(top / med)

    def curve(shape):
        return top * np.exp(-(r / (mid / drop ** (1.0 / shape))) ** shape)

    shape = _bisect(lambda c: curve(c).sum() - n_ratings, 0.05, 3.0)
    return integerize(curve(shape), n_ratings, int(spec.get("min", 1)))


def _capped_plan(w: np.ndarray, ns: np.ndarray):
    """For each count ``n`` of ``ns``, the ``k`` items (the first, ``w``
    decreasing) a user of ``n`` ratings rates surely, and the scale ``c``
    of the rest's inclusion probabilities ``c w_i`` (each below 1)."""
    cw = np.concatenate([[0.0], np.cumsum(w)])
    total = cw[-1]
    lo = np.zeros(len(ns), np.int64)
    hi = np.minimum(ns, len(w) - 1).astype(np.int64)
    while (lo < hi).any():
        mid = (lo + hi) // 2
        ok = (ns - mid) * w[mid] <= total - cw[mid]
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + 1)
    return lo, (ns - lo) / (total - cw[lo]), cw


def fit_weights(targets: np.ndarray, ns: np.ndarray, users: np.ndarray
                ) -> np.ndarray:
    """Item weights (decreasing, as ``targets``) under which the users'
    samples give every item its target count in expectation; ``ns`` are
    the distinct user counts and ``users`` how many users have each."""
    w = targets.astype(np.float64)
    items = np.arange(len(w))
    for _ in range(FIT_ROUNDS):
        k, c, _ = _capped_plan(w, ns)
        order = np.argsort(k, kind="stable")
        ks = k[order]
        sure = np.concatenate([np.cumsum(users[order][::-1])[::-1], [0]])
        prop = np.concatenate([[0.0], np.cumsum((users * c)[order])])
        j = np.searchsorted(ks, items, side="right")
        expected = sure[j] + prop[j] * w
        if np.abs(expected / targets - 1.0).max() < FIT_TOL:
            return w
        w = np.minimum.accumulate(w * targets / expected)
    raise ValueError("item weights did not fit their targets")


def _gen(seed: int, tag: int, device):
    import torch

    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


def pairs(n_users: int, n_items: int, n_ratings: int, mix: dict,
          seed: int, device="cpu"):
    """``(user, item)`` of ``n_ratings`` distinct pairs, shuffled, as
    int64 tensors on ``device`` (drawn there)."""
    import torch

    nu = user_counts(n_users, n_ratings, mix["users"])
    targets = item_targets(n_items, n_ratings, mix["items"])
    if nu.max() > n_items or targets.max() > n_users:
        raise ValueError("a user rates more items than there are, or an "
                         "item more users")
    ns, users = np.unique(nu, return_counts=True)
    w = fit_weights(targets, ns, users)
    k, c, cw = _capped_plan(w, ns)
    group = np.searchsorted(ns, nu)

    def t(a):
        return torch.as_tensor(a, device=device)

    kk, cc, cw, m = t(k[group]), t(c[group]), t(cw), t(nu - k[group])
    rank = torch.arange(n_users, device=device)
    sure_u = torch.repeat_interleave(rank, kk)
    sure_i = (torch.arange(len(sure_u), device=device)
              - torch.repeat_interleave(torch.cumsum(kk, 0) - kk, kk))
    sys_u = torch.repeat_interleave(rank, m)
    step = (torch.arange(len(sys_u), device=device)
            - torch.repeat_interleave(torch.cumsum(m, 0) - m, m))
    g = _gen(seed, 1, device)
    start = torch.rand(n_users, generator=g, device=device,
                       dtype=torch.float64)
    at = cw[kk][sys_u] + (start[sys_u] + step) / cc[sys_u]
    sys_i = torch.searchsorted(cw[1:], at, right=True).clamp_max(n_items - 1)
    del at, step
    user_id = torch.randperm(n_users, generator=g, device=device)
    item_id = torch.randperm(n_items, generator=g, device=device)
    uu = user_id[torch.cat([sure_u, sys_u])]
    ii = item_id[torch.cat([sure_i, sys_i])]
    order = torch.randperm(n_ratings, generator=g, device=device)
    return uu[order], ii[order]


def ratings(sizes: dict, mix: dict, seed: int, device="cpu"
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(user, item, rating)`` of ``mix["n_ratings"]`` distinct pairs
    over ``sizes["n_users"]`` x ``sizes["n_items"]``, drawn on
    ``device`` and handed back in host memory; ratings float32."""
    import torch

    if mix.get("generator") != "ratings":
        raise ValueError(f"mix {mix.get('name')!r} is not a ratings mix")
    n, n_users, n_items = (int(mix["n_ratings"]), int(sizes["n_users"]),
                           int(sizes["n_items"]))
    uu, ii = pairs(n_users, n_items, n, mix, seed, device)
    g = _gen(seed, 2, device)
    r = int(mix["planted_rank"])
    U = torch.randn((n_users, r), generator=g, device=device)
    V = torch.randn((n_items, r), generator=g, device=device)
    raw = torch.randn(n, generator=g, device=device) * float(mix["noise"])
    for s in range(0, n, CHUNK):
        raw[s:s + CHUNK] += (U[uu[s:s + CHUNK]] * V[ii[s:s + CHUNK]]).sum(
            1) / math.sqrt(r)
    levels = torch.tensor(mix["values"]["levels"], dtype=torch.float32,
                          device=device)
    counts = np.asarray(mix["values"]["counts"], np.float64)
    share = torch.tensor(np.cumsum(counts)[:-1] / counts.sum(),
                         dtype=torch.float32, device=device)
    edges = torch.quantile(raw[::max(1, n // SAMPLE)][:SAMPLE], share)
    vals = levels[torch.bucketize(raw, edges)]
    return uu.cpu().numpy(), ii.cpu().numpy(), vals.cpu().numpy()


def holdout_mask(n: int, mix: dict) -> np.ndarray:
    """True for the held-out ratings: every ``holdout_every``-th."""
    return np.arange(n) % int(mix["holdout_every"]) == 0


def normal_tables(shapes: Dict[str, Tuple[int, int]], seed: int, tag: int,
                  device) -> Dict[str, "torch.Tensor"]:
    """float32 tables ``N(0, 1/width)`` on ``device``, one ``randn`` call
    a table from one generator there, in the order of ``shapes``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, tag))
    out = {}
    for name, (rows, width) in shapes.items():
        out[name] = torch.randn((rows, width), generator=gen, device=device,
                                dtype=torch.float32)
        out[name].mul_(1.0 / math.sqrt(width))
    return out

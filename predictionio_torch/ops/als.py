"""Alternating least squares on one card.

Counterpart of ``predictionio_tpu/ops/als.py`` (ref: MLlib ALS, which
the recommendation template calls as ``ALS.train``). Each half-step
solves ALL users (or items) as one batched normal-equation problem over
the segmented layout (``ops/ragged.py``):

  1. gather the opposing factors of each fixed-length virtual row and
     form its partial Gramian ``A_r = Yg^T Yg`` and rhs ``b_r = Yg^T r``
     (a loop over row blocks bounds device memory);
  2. segment-sum the row partials into their groups (Gramians are
     additive, so a group split across rows recombines);
  3. regularize (ALS-WR ``reg * n_u * I`` for explicit feedback,
     Hu-Koren-Volinsky ``Y^T Y + reg * I`` for implicit) and solve each
     K x K system by Jacobi-preconditioned CG warm-started from the
     previous factors, or by ``torch.linalg.solve`` (``solver="direct"``),
     a loop over group blocks.

The JAX package runs this as XLA, not Pallas (a fused gather+Gramian
kernel and a CG kernel were both measured there and removed), so the
port's half-step is PyTorch ops: gathers, ``torch.bmm``, ``index_add_``.
Precision follows the JAX package: the gather and Gramian inputs are
``compute_dtype`` (bf16 by default), every product sums in f32, the row
partials are stored in f32, and the CG matvec reads A rounded to
``cg_dtype`` with the recurrences in f32.

One difference of the port: ``index_add_`` on a CUDA device sums with
float atomics, so the order of a group's partials, and with it the last
bits of the factors, varies from run to run (the tests state the
tolerance).

Not ported here (ROADMAP.md, queue 1): the binned-layout cache and the
native binned lane (item 2(b)), the chunked double-buffered transfer
(item 2(b)), grid training (item 4), the streaming fold-in solve (item
5), the gather roof probe (item 3), the observability hooks (item 10)
and the sharded half-step (item 12).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_torch.ops.ragged import (SegmentedGroups,
                                           build_segmented_groups)
from predictionio_torch.parallel.context import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """The JAX package's ALS config, less its two loop-shape fields,
    which choose nothing in eager PyTorch: ``cg_unroll`` (the CG
    recurrence is a Python loop either way) and ``map_batch`` (the loops
    step by one row block and one group block)."""

    rank: int = 32
    iterations: int = 10
    reg: float = 0.1          # lambda
    implicit: bool = False
    alpha: float = 1.0        # implicit confidence scale, c = 1 + alpha*r
    block_size: int = 4096    # rows / groups taken at once by the loops
    seed: int = 7             # initial factors (torch.Generator stream)
    solver: str = "cg"        # "cg" | "direct" (torch.linalg.solve)
    cg_iters: int = 6         # CG steps; the solve warm-starts from the
                              # previous iteration's factors, so a few do
    cg_dtype: str = "bfloat16"  # A as the CG matvec reads it (f32 sums
                                # and recurrences)
    cg_precond: str = "jacobi"  # "jacobi" | "none": M = diag(A), taken
                                # in f32; ALS-WR's reg * n_u shift makes
                                # group scales vary widely
    compute_dtype: str = "bfloat16"  # gather/Gramian input dtype; the
                                     # sums are f32
    seg_len: object = "auto"  # virtual-row length (int), or "auto": sized
                              # from the group-size histogram


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(name: str) -> torch.dtype:
    if str(name) not in _DTYPES:
        raise ValueError(f"dtype {name!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[str(name)]


def als_row_cost_slots(rank: int) -> float:
    """Per-row overhead, in slots, for the auto seg-len sweep: the
    [rows, K, K] partial-Gramian round trip against a slot's gather.
    It shapes the physical layout, so every lane derives it from rank
    this one way (as the JAX package does: the layouts stay equal)."""
    return max(8.0, rank * rank / 300.0)


def _build_side(
    group_idx: np.ndarray,
    item_idx: np.ndarray,
    vals: np.ndarray,
    n_groups: int,
    cfg: ALSConfig,
    n_shards: int,
    max_len: Optional[int],
) -> SegmentedGroups:
    """One side's segmented layout, both axes padded to block multiples."""
    return build_segmented_groups(
        group_idx, item_idx, vals, n_groups, seg_len=cfg.seg_len,
        max_len=max_len, n_shards=n_shards, block_size=cfg.block_size,
        row_cost_slots=als_row_cost_slots(cfg.rank),
    )


def _batched_cg(A: torch.Tensor, b: torch.Tensor, iters: int,
                x0: Optional[torch.Tensor] = None,
                matvec_dtype: torch.dtype = torch.float32,
                precond: str = "none") -> torch.Tensor:
    """Batched conjugate gradient for SPD K x K systems ``A [B, K, K]``,
    ``b [B, K]``; ``x0`` warm-starts it.

    The matvec reads A and the vector rounded to ``matvec_dtype`` and
    sums in f32, as the JAX package's bf16 ``einsum`` with
    ``preferred_element_type=f32`` does. ``torch.bmm`` of bf16 tensors
    returns bf16, so the rounded operands go in as f32: a product of two
    bf16 values is exact in f32. The scalar recurrences stay f32.

    ``precond="jacobi"`` preconditions with M = diag(A), taken from the
    f32 A before the matvec's rounding: the reg * n_u shift spans orders
    of magnitude, and bf16 would quantize the equalization."""
    Am = A.to(matvec_dtype).float()

    def matvec(v):
        return torch.bmm(Am, v.to(matvec_dtype).float().unsqueeze(-1)
                         ).squeeze(-1)

    if precond == "jacobi":
        Minv = 1.0 / (torch.diagonal(A, dim1=-2, dim2=-1) + 1e-20)
    elif precond == "none":
        Minv = None
    else:
        # a typo must not silently run unpreconditioned: the cg_iters=6
        # default holds only with Jacobi
        raise ValueError(f"unknown cg_precond {precond!r} "
                         "(expected 'jacobi' or 'none')")

    def prec(r):
        return r if Minv is None else Minv * r

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = prec(r)
    p = z
    rs = (r * z).sum(-1)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rs / ((p * Ap).sum(-1) + 1e-20)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = prec(r)
        rs1 = (r * z).sum(-1)
        p = z + (rs1 / (rs + 1e-20))[:, None] * p
        rs = rs1
    return x


#: uint8 value code of a padded slot (compress_side); the mask derives
#: as ``code != PAD_CODE``
PAD_CODE = 255


class HalfStep:
    """One side's half-step (the JAX package's ``_solve_shard`` and
    ``_solve_groups``), bound to that side's blocks.

    Called as ``(Y, X_prev, idx, val, mask, seg, counts)``, or in the
    compressed layout (``val_affine=(a, b)``) as ``(Y, X_prev, idx,
    codes, seg, counts)``: a slot's value decodes as ``a + b * code``
    and its mask as ``code != PAD_CODE``. Pad slots decode to
    ``a + 255 b``, which is harmless only because the mask zeroes their
    gathered rows and multiplies the implicit rhs. Returns the new
    ``[groups, K]`` factors. The three stages are methods, so that a
    caller can time them one by one."""

    def __init__(self, cfg: ALSConfig, row_block: int, group_block: int,
                 groups_loc: int, val_affine=None):
        self.rank = cfg.rank
        self.reg = float(cfg.reg)
        self.implicit = cfg.implicit
        self.alpha = float(cfg.alpha)
        self.solver = cfg.solver
        self.cg_iters = cfg.cg_iters
        self.cg_dtype = _dtype(cfg.cg_dtype)
        self.cg_precond = cfg.cg_precond
        self.cdt = _dtype(cfg.compute_dtype)
        self.row_block = row_block
        self.group_block = group_block
        self.groups_loc = groups_loc
        self.val_affine = (None if val_affine is None else
                           (float(val_affine[0]), float(val_affine[1])))

    def __call__(self, Y, X_prev, idx, val, *rest):
        if self.val_affine is None:
            mask, seg, counts = rest
        else:
            mask, (seg, counts) = None, rest
        Yc = Y.to(self.cdt)
        Ar, br = self.partials(Yc, idx, val, mask)
        A, b = self.segment_sum(Ar, br, seg)
        del Ar, br
        return self.solve(A, b, X_prev, counts, Yc)

    def partials(self, Yc, idx, val, mask):
        """Stage 1: per-row partial Gramians ``[R, K, K]`` and rhs
        ``[R, K]``, f32, from the opposing factors ``Yc`` (already in
        ``compute_dtype``)."""
        R, L = idx.shape
        K = self.rank
        cdt = self.cdt
        Ar = torch.empty((R, K, K), dtype=torch.float32, device=idx.device)
        br = torch.empty((R, K), dtype=torch.float32, device=idx.device)
        for s in range(0, R, self.row_block):
            e = s + self.row_block
            idx_b = idx[s:e]
            if self.val_affine is None:
                val_b = val[s:e]
                mask_b = mask[s:e]
            else:
                code_b = val[s:e]
                a, b = self.val_affine
                val_b = a + b * code_b.float()
                mask_b = code_b != PAD_CODE
            maskc = mask_b.to(cdt)
            Yg = (Yc.index_select(0, idx_b.reshape(-1)).view(*idx_b.shape, K)
                  * maskc[..., None])         # [B, L, K], pad slots zeroed
            # cdt values, products summed in f32: a bmm of bf16 tensors
            # returns bf16, and bf16 partials diverge (a popular item sums
            # thousands of them), so the rounded operands go in as f32,
            # where a product of two bf16 values is exact
            Ygf = Yg.float()
            YgT = Ygf.transpose(1, 2)
            if self.implicit:
                # alpha * Yg^T diag(r) Yg and Yg^T (1 + alpha r)
                w = val_b.to(cdt).float()
                torch.bmm(YgT, Ygf * w[..., None], out=Ar[s:e])
                Ar[s:e].mul_(self.alpha)
                rhs = ((1.0 + self.alpha * val_b)
                       * maskc.to(val_b.dtype)).to(cdt).float()
            else:
                torch.bmm(YgT, Ygf, out=Ar[s:e])
                rhs = val_b.to(cdt).float()
            br[s:e] = torch.bmm(YgT, rhs.unsqueeze(-1)).squeeze(-1)
        return Ar, br

    def segment_sum(self, Ar, br, seg):
        """Stage 2: row partials summed into their groups. On a CUDA
        device ``index_add_`` adds with float atomics, in an order that
        varies from run to run."""
        G, K = self.groups_loc, self.rank
        A = torch.zeros((G, K, K), dtype=torch.float32, device=Ar.device)
        b = torch.zeros((G, K), dtype=torch.float32, device=br.device)
        return A.index_add_(0, seg, Ar), b.index_add_(0, seg, br)

    def solve(self, A, b, X_prev, counts, Yc):
        """Stage 3: regularize and solve each group's system; groups with
        no ratings get exact zeros (the iterative solve would only drive
        the random start toward 0; the reference's unseen users have no
        factors at all)."""
        K = self.rank
        eye = torch.eye(K, dtype=torch.float32, device=A.device)
        if self.implicit:
            Ycf = Yc.float()
            YtY = Ycf.T @ Ycf
        out = torch.empty((self.groups_loc, K), dtype=torch.float32,
                          device=A.device)
        for s in range(0, self.groups_loc, self.group_block):
            e = s + self.group_block
            cnt_b = counts[s:e]
            if self.implicit:
                A_b = A[s:e] + YtY + self.reg * eye
            else:
                # ALS-WR: reg * n_u * I; empty groups stay nonsingular
                n_u = cnt_b.float().clamp_min(1.0)
                A_b = A[s:e] + (self.reg * n_u)[:, None, None] * eye
            if self.solver == "cg":
                x = _batched_cg(A_b, b[s:e], self.cg_iters, x0=X_prev[s:e],
                                matvec_dtype=self.cg_dtype,
                                precond=self.cg_precond)
            elif self.solver == "direct":
                x = torch.linalg.solve(A_b, b[s:e].unsqueeze(-1)).squeeze(-1)
            else:
                raise ValueError(f"unknown solver {self.solver!r} "
                                 "(expected 'cg' or 'direct')")
            out[s:e] = torch.where((cnt_b > 0)[:, None], x, 0.0)
        return out


def make_half_step(cfg: ALSConfig, row_block: int, group_block: int,
                   groups_loc: int, val_affine=None) -> HalfStep:
    """One half-step over a side's layout (the JAX package's
    ``make_half_step`` on one device). ``val_affine`` switches it to the
    compressed layout: no mask stream, values decoded from codes."""
    return HalfStep(cfg, row_block, group_block, groups_loc, val_affine)


def _init_factors(gen: torch.Generator, n_groups: int, n_real: int,
                  rank: int) -> torch.Tensor:
    """Scaled-normal factors drawn on the host from ``gen`` (so every
    device starts from the same numbers), padded rows zeroed: pad rows
    must never influence a solve."""
    X = torch.randn((n_groups, rank), generator=gen) * (1.0 / math.sqrt(rank))
    X[n_real:] = 0.0
    return X


@dataclasses.dataclass
class ALSFactors:
    user_factors: np.ndarray  # [n_users, K] float32
    item_factors: np.ndarray  # [n_items, K] float32


@dataclasses.dataclass
class SideLayout:
    """One side's device-bound arrays in transfer-compressed form.

    - When the ratings form an exact affine ladder of at most 255
      distinct values (explicit half-star ratings do), the val and mask
      streams collapse into one uint8 code (``a + b * code`` decodes it,
      code 255 marks a padded slot); other value sets stay f32 + mask.
    - The gather indexes cross as lo-uint16, plus hi-uint8 only when
      the opposing vocabulary exceeds 65,535 (vocabularies are below
      2^24), and are recombined to int32 once on the device."""

    idx_lo: np.ndarray            # [R, L] uint16 (low 16 index bits)
    idx_hi: Optional[np.ndarray]  # [R, L] uint8, None when vocab < 2^16
    val: np.ndarray               # [R, L] uint8 codes | float32
    mask: Optional[np.ndarray]    # [R, L] uint8, None when val is coded
    seg: np.ndarray               # [R] int32
    counts: np.ndarray            # [G] int32
    affine: Optional[tuple]       # (a, b): value = a + b*code
    row_block: int
    group_block: int
    groups_per_shard: int
    n_shards: int

    @property
    def slot_bytes(self) -> int:
        return (2 + (1 if self.idx_hi is not None else 0)
                + self.val.dtype.itemsize
                + (1 if self.mask is not None else 0))

    @property
    def transfer_bytes(self) -> int:
        n = (self.idx_lo.nbytes + self.val.nbytes + self.seg.nbytes
             + self.counts.nbytes)
        if self.idx_hi is not None:
            n += self.idx_hi.nbytes
        if self.mask is not None:
            n += self.mask.nbytes
        return n


def _split_idx(idx: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """int32 gather indexes -> wire streams (lo uint16, hi uint8|None)."""
    mx = int(idx.max(initial=0))
    if mx >= (1 << 24):
        # a real error, not an assert: a silent truncation would gather
        # wrong rows and train wrong factors without a symptom
        raise ValueError(f"vocab {mx} exceeds the 24-bit index wire "
                         "format (widen idx_hi before raising this cap)")
    lo = (idx & 0xFFFF).astype(np.uint16)
    if mx < (1 << 16):
        return lo, None
    return lo, (idx >> 16).astype(np.uint8)


def compress_side(sg: SegmentedGroups) -> SideLayout:
    """Shrink one side's arrays for the wire (see SideLayout).

    Value coding engages only when the distinct values form an exact
    affine ladder (``uniq[k] == a + b*k``), which the device decodes
    with one multiply-add instead of a table lookup. Non-affine value
    sets (and NaN, which joins no ladder) stay float32 + mask."""
    idx_lo, idx_hi = _split_idx(sg.idx)
    # cheap distinct-count probe (the first 256k elements) before the
    # full unique
    probe = np.unique(sg.val.reshape(-1)[:1 << 18])
    if len(probe) <= PAD_CODE:
        # pads are coded 255 regardless, so their 0.0 filler must not
        # join the codebook (it would break the ladder of any rating
        # scale that does not start at 0)
        uniq = np.unique(sg.val[sg.mask != 0])
        n = len(uniq)
        affine = None
        if n == 1:
            affine = (float(uniq[0]), 0.0)
        elif 2 <= n <= PAD_CODE:
            a, b = float(uniq[0]), float(uniq[1] - uniq[0])
            if b != 0.0 and np.array_equal(
                    uniq, np.float32(a) + np.float32(b)
                    * np.arange(n, dtype=np.float32)):
                affine = (a, b)
        if affine is not None:
            codes = np.searchsorted(
                uniq, sg.val).clip(0, n - 1).astype(np.uint8)
            codes[sg.mask == 0] = PAD_CODE
            return SideLayout(
                idx_lo=idx_lo, idx_hi=idx_hi, val=codes, mask=None,
                seg=sg.seg, counts=sg.counts, affine=affine,
                row_block=sg.row_block, group_block=sg.group_block,
                groups_per_shard=sg.groups_per_shard, n_shards=sg.n_shards)
    return SideLayout(
        idx_lo=idx_lo, idx_hi=idx_hi, val=sg.val,
        mask=sg.mask.astype(np.uint8), seg=sg.seg,
        counts=sg.counts, affine=None,
        row_block=sg.row_block, group_block=sg.group_block,
        groups_per_shard=sg.groups_per_shard, n_shards=sg.n_shards)


def build_compressed_side(
    group_idx: np.ndarray,
    item_idx: np.ndarray,
    vals: np.ndarray,
    n_groups: int,
    cfg: ALSConfig,
    n_shards: int,
    max_len: Optional[int],
) -> SideLayout:
    """One side's compressed layout from COO: the segmented layout, then
    ``compress_side`` (the JAX package's two-stage route; its one-pass
    native builder gives the same bits and comes with ROADMAP.md item
    2(b))."""
    sg = _build_side(group_idx, item_idx, vals, n_groups, cfg, n_shards,
                     max_len)
    return compress_side(sg)


@dataclasses.dataclass
class DeviceSide:
    """One side's arrays on the device and the half-step bound to them;
    called as ``side(opposing, own_prev)`` it returns the side's new
    ``[n_groups, K]`` factors."""

    step: HalfStep
    idx: torch.Tensor              # [R, L] int32 gather indexes
    val: torch.Tensor              # [R, L] uint8 codes | float32
    mask: Optional[torch.Tensor]   # [R, L] uint8, None when val is coded
    seg: torch.Tensor              # [R] int32 group of each row
    counts: torch.Tensor           # [G] int32 ratings of each group
    n_groups: int

    def args(self) -> tuple:
        """The arrays in the order the half-step takes them."""
        if self.mask is None:
            return self.idx, self.val, self.seg, self.counts
        return self.idx, self.val, self.mask, self.seg, self.counts

    def __call__(self, opposing, own_prev):
        return self.step(opposing, own_prev, *self.args())


class ALSTrainer:
    """Prepared ALS run: data binned and placed on the device, the two
    half-steps bound to their layouts. Keeps the one-time costs (host
    binning, the transfer, first-call set-up) apart from the alternations,
    so a caller can time them separately. Runs on ``device``: ``None``
    means ``cuda:0`` and raises without CUDA.
    """

    def __init__(
        self,
        user_coo: Tuple[np.ndarray, np.ndarray, np.ndarray],
        n_users: int,
        n_items: int,
        cfg: ALSConfig,
        device: DeviceLike = None,
        max_ratings_per_user: Optional[int] = None,
        max_ratings_per_item: Optional[int] = None,
        cache_key: Optional[str] = None,
    ):
        if cache_key is not None:
            raise ValueError(
                "the binned-layout cache is not ported to predictionio_torch "
                "(ROADMAP.md, queue 1 item 2(b)); pass cache_key=None")
        self.cfg = cfg
        self.device = resolve_device(device)
        u_idx, i_idx, vals = user_coo
        self.n_users, self.n_items = n_users, n_items
        t0 = time.perf_counter()
        user_side = build_compressed_side(
            u_idx, i_idx, vals, n_users, cfg, 1, max_ratings_per_user)
        item_side = build_compressed_side(
            i_idx, u_idx, vals, n_items, cfg, 1, max_ratings_per_item)
        #: host seconds spent binning both sides
        self.bin_sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._user = self._put_side(user_side)
        self._item = self._put_side(item_side)
        self.wait_device()
        #: seconds of the host -> device puts and the index recombine
        self.put_sec = time.perf_counter() - t0
        self.transfer_bytes = (user_side.transfer_bytes
                               + item_side.transfer_bytes)
        self._slot_bytes = (user_side.slot_bytes, item_side.slot_bytes)

        gen = torch.Generator().manual_seed(cfg.seed)
        #: the padded factor tables on the device; set them to start
        #: from other factors
        self.X = _init_factors(gen, self._user.n_groups, self.n_users,
                               cfg.rank).to(self.device)
        self.Y = _init_factors(gen, self._item.n_groups, self.n_items,
                               cfg.rank).to(self.device)

    def _put_side(self, side: SideLayout) -> DeviceSide:
        """The wire arrays to the device, once each; the index streams
        recombined to int32 there. uint16 goes as int16 and is widened
        with ``& 0xFFFF``: the cast every device has."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        idx = put(side.idx_lo.view(np.int16)).to(torch.int32) & 0xFFFF
        if side.idx_hi is not None:
            idx = idx | (put(side.idx_hi).to(torch.int32) << 16)
        step = make_half_step(self.cfg, side.row_block, side.group_block,
                              side.groups_per_shard, val_affine=side.affine)
        return DeviceSide(
            step=step, idx=idx, val=put(side.val),
            mask=None if side.mask is None else put(side.mask),
            seg=put(side.seg), counts=put(side.counts),
            n_groups=side.groups_per_shard)

    def sides(self) -> Tuple[DeviceSide, DeviceSide]:
        """The user side (solves X against Y), then the item side."""
        return self._user, self._item

    def layout(self) -> dict:
        """The device layout's shapes: virtual rows, slots per row and
        groups (padded) of each side, and the bytes that crossed."""
        return {"user_rows": int(self._user.idx.shape[0]),
                "item_rows": int(self._item.idx.shape[0]),
                "seg_len": [int(self._user.idx.shape[1]),
                            int(self._item.idx.shape[1])],
                "user_groups": self._user.n_groups,
                "item_groups": self._item.n_groups,
                "transfer_bytes": self.transfer_bytes}

    def _alternate(self, X, Y, n: int):
        for _ in range(n):
            X = self._user(Y, X)
            Y = self._item(X, Y)
        return X, Y

    def wait_device(self) -> "ALSTrainer":
        """Block until the device has finished all work issued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def compile(self) -> "ALSTrainer":
        """One warm alternation on copies of the factors, so that
        first-call costs (library handles, allocator growth) stay out of
        a timed run; the initial factors are left as they were."""
        t0 = time.perf_counter()
        self._alternate(self.X.clone(), self.Y.clone(), 1)
        self.wait_device()
        #: seconds of the warm alternation
        self.compile_sec = time.perf_counter() - t0
        return self

    def step_n(self, iterations: Optional[int] = None) -> None:
        """Run n alternations (user half-step, then item), synced once at
        the end; the factors stay on the device (``factors()`` fetches
        them)."""
        n = iterations if iterations is not None else self.cfg.iterations
        self.X, self.Y = self._alternate(self.X, self.Y, n)
        self.wait_device()

    def run(self, iterations: Optional[int] = None) -> ALSFactors:
        self.step_n(iterations)
        return self.factors()

    def factors(self) -> ALSFactors:
        return ALSFactors(
            user_factors=self.X[: self.n_users].cpu().numpy(),
            item_factors=self.Y[: self.n_items].cpu().numpy(),
        )

    def work_model(self) -> dict:
        """Analytic FLOP and byte counts per alternation (both
        half-steps), from the padded shapes on the device; padded slots
        count, since they are gathered and multiplied like real ones.

        The bytes are the dominant streams: the gathered opposing
        factors, the materialized [B, L, K] block (one write and one
        read), the idx/val/mask reads, the per-row partial Gramians (f32
        write and segment-sum read), the CG's re-reads of A (cg_dtype)
        and the solved factors. It leaves out intermediates, so a rate
        derived from it is a lower bound."""
        K = self.cfg.rank
        cs = _dtype(self.cfg.compute_dtype).itemsize
        cg_b = _dtype(self.cfg.cg_dtype).itemsize
        cg_iters = self.cfg.cg_iters if self.cfg.solver == "cg" else 0
        flops = 0.0
        bytes_ = 0.0
        for side, slot_b in zip(self.sides(), self._slot_bytes):
            idx, n_groups = side.idx, side.n_groups
            S = float(idx.shape[0]) * float(idx.shape[1])  # slots incl. pad
            G = float(n_groups)
            flops += 2.0 * S * K * K          # partial Gramians
            flops += 2.0 * S * K              # rhs
            flops += (cg_iters + 1) * 2.0 * G * K * K  # CG matvecs
            bytes_ += S * K * cs              # factor gather read
            bytes_ += 2.0 * S * K * cs        # materialized Yg write+read
            bytes_ += S * slot_b              # idx/val[/mask] input reads
            bytes_ += 2.0 * float(idx.shape[0]) * K * K * 4  # partials w+r
            bytes_ += (cg_iters + 1) * G * K * K * cg_b      # CG A re-reads
            bytes_ += G * K * 4               # solved factors write
        return {"flops_per_iter": flops, "hbm_bytes_per_iter": bytes_}


def als_train(
    user_coo: Tuple[np.ndarray, np.ndarray, np.ndarray],
    n_users: int,
    n_items: int,
    cfg: ALSConfig,
    device: DeviceLike = None,
    max_ratings_per_user: Optional[int] = None,
    max_ratings_per_item: Optional[int] = None,
    cache_key: Optional[str] = None,
) -> ALSFactors:
    """One-call train from COO (user_idx, item_idx, rating) triples."""
    return ALSTrainer(
        user_coo, n_users, n_items, cfg, device=device,
        max_ratings_per_user=max_ratings_per_user,
        max_ratings_per_item=max_ratings_per_item,
        cache_key=cache_key,
    ).run()


def predict_rmse(factors: ALSFactors, coo) -> float:
    """Host-side RMSE over COO ratings (evaluation metric helper)."""
    u, i, r = coo
    pred = np.einsum(
        "nk,nk->n", factors.user_factors[np.asarray(u)],
        factors.item_factors[np.asarray(i)])
    return float(np.sqrt(np.mean((pred - np.asarray(r)) ** 2)))

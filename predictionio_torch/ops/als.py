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

The trainer takes its layout three ways: binned here from COO (the
native one-pass builder at scale, ``ops/ragged.py``), prebuilt by the
event log's fused scan+bin (``ALSTrainer.from_sides``), or loaded from
the layout cache (``ops/bincache.py``) under ``layout_cache_key``.

Grid training (``als_grid_train``, ``ALSGridTrainer``) trains the
candidates of a hyperparameter sweep at once, folded into the batch
dimension of each half-step (``GridHalfStep``). The streaming lane's
``fold_in_solve`` solves a handful of touched groups against fixed
opposing factors with the same Gramian and CG.

Sharded over a mesh (``ALSTrainer(..., mesh=)``, one device per
process, ``parallel/mesh.py``), the group axis splits over the mesh's
``data`` axis, as the JAX package's ``shard_map`` half-step does: every
rank bins the full COO with ``n_shards`` shards, puts only its
``rows_per_shard`` rows and ``groups_per_shard`` groups on its device,
solves its groups against the replicated opposing factors, and an
all-gather over the ``data`` group rebuilds the padded ``[groups_per_shard
* n_shards, K]`` factor table on every rank (the JAX package's
``out_specs=P("data", None)`` followed by the next step's ``P()``). The
transfer bytes and the work model are then per rank.

The trainer carries the JAX trainer's observability hooks: the
data-path stages, the MFU accounting and the memory ledger. Not ported
here (ROADMAP.md, queue 1): the chunked double-buffered transfer and the
gather roof probe (item 3).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_torch.data.storage import pack_vocab, unpack_vocab
from predictionio_torch.obs import memacct, perfacct
from predictionio_torch.ops import bincache
from predictionio_torch.ops.ragged import (SegmentedGroups,
                                           build_compressed_segmented,
                                           build_segmented_groups)
from predictionio_torch.parallel.context import DeviceLike, resolve_device
from predictionio_torch.parallel.mesh import (axis_group, axis_rank,
                                              axis_size, mesh_size)
from predictionio_torch.parallel.multihost import all_gather_rows


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


def _bmv(M: torch.Tensor, v: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Batched matrix-vector product ``M [B, m, n] @ v [B, n]`` ->
    ``[B, m]``, one call per group when the batch holds ``groups`` equal
    groups (a grid's candidates). cuBLAS picks its batched
    matrix-vector kernel by the batch count, so one call over G
    candidates' systems rounds otherwise than a train of one candidate
    (measured on an H100); a call per candidate gives a grid candidate
    the bits of its sequential train."""
    if groups == 1:
        return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)
    out = torch.empty((M.shape[0], M.shape[1], 1), dtype=M.dtype,
                      device=M.device)
    B = M.shape[0] // groups
    for s in range(0, M.shape[0], B):
        torch.bmm(M[s:s + B], v[s:s + B].unsqueeze(-1), out=out[s:s + B])
    return out.squeeze(-1)


def _batched_cg(A: torch.Tensor, b: torch.Tensor, iters: int,
                x0: Optional[torch.Tensor] = None,
                matvec_dtype: torch.dtype = torch.float32,
                precond: str = "none",
                active_steps: Optional[torch.Tensor] = None,
                groups: int = 1) -> torch.Tensor:
    """Batched conjugate gradient for SPD K x K systems ``A [B, K, K]``,
    ``b [B, K]``; ``x0`` warm-starts it.

    The matvec reads A and the vector rounded to ``matvec_dtype`` and
    sums in f32, as the JAX package's bf16 ``einsum`` with
    ``preferred_element_type=f32`` does. ``torch.bmm`` of bf16 tensors
    returns bf16, so the rounded operands go in as f32: a product of two
    bf16 values is exact in f32. The scalar recurrences stay f32.

    ``precond="jacobi"`` preconditions with M = diag(A), taken from the
    f32 A before the matvec's rounding: the reg * n_u shift spans orders
    of magnitude, and bf16 would quantize the equalization.

    ``active_steps`` (``[B]`` ints) gives each system a step budget, as
    the grid's candidates need: steps past a system's budget are
    computed, but its ``x``, ``r``, ``p`` and ``rs`` stay frozen, so a
    system with budget 4 ends where a 4-step solve ends. ``groups``: the
    systems are that many equal groups, whose matvecs go one call each
    (``_bmv``)."""
    Am = A.to(matvec_dtype).float()

    def matvec(v):
        return _bmv(Am, v.to(matvec_dtype).float(), groups)

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
    for k in range(iters):
        Ap = matvec(p)
        alpha = rs / ((p * Ap).sum(-1) + 1e-20)
        x1 = x + alpha[:, None] * p
        r1 = r - alpha[:, None] * Ap
        z = prec(r1)
        rs1 = (r1 * z).sum(-1)
        p1 = z + (rs1 / (rs + 1e-20))[:, None] * p
        if active_steps is not None:
            on = k < active_steps
            x1 = torch.where(on[:, None], x1, x)
            r1 = torch.where(on[:, None], r1, r)
            p1 = torch.where(on[:, None], p1, p)
            rs1 = torch.where(on, rs1, rs)
        x, r, p, rs = x1, r1, p1, rs1
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
            br[s:e] = _bmv(YgT, rhs)
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
    """Scaled-normal factors for the ``n_real`` real rows, drawn on the
    host from ``gen`` (so every device and every rank starts from the
    same numbers, whatever the padding), and ``n_groups - n_real``
    padded rows of zeros: pad rows must never influence a solve."""
    X = torch.zeros((n_groups, rank))
    X[:n_real] = (torch.randn((n_real, rank), generator=gen)
                  * (1.0 / math.sqrt(rank)))
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
    def kept_entries(self) -> int:
        return int(self.counts.sum())

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

    def to_arrays(self, prefix: str) -> dict:
        """The arrays under the layout cache's names."""
        out = {f"{prefix}idx_lo": self.idx_lo, f"{prefix}val": self.val,
               f"{prefix}seg": self.seg, f"{prefix}counts": self.counts}
        if self.idx_hi is not None:
            out[f"{prefix}idx_hi"] = self.idx_hi
        if self.mask is not None:
            out[f"{prefix}mask"] = self.mask
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, prefix: str,
                    meta: dict) -> "SideLayout":
        affine = meta.get(f"{prefix}affine")
        return cls(
            idx_lo=arrays[f"{prefix}idx_lo"],
            idx_hi=arrays.get(f"{prefix}idx_hi"),
            val=arrays[f"{prefix}val"], mask=arrays.get(f"{prefix}mask"),
            seg=arrays[f"{prefix}seg"], counts=arrays[f"{prefix}counts"],
            affine=tuple(affine) if affine is not None else None,
            row_block=int(meta[f"{prefix}row_block"]),
            group_block=int(meta[f"{prefix}group_block"]),
            groups_per_shard=int(meta[f"{prefix}groups_per_shard"]),
            n_shards=int(meta["n_shards"]))

    def meta(self, prefix: str) -> dict:
        """The scalars under the layout cache's names."""
        return {f"{prefix}row_block": self.row_block,
                f"{prefix}group_block": self.group_block,
                f"{prefix}groups_per_shard": self.groups_per_shard,
                f"{prefix}affine": (list(self.affine)
                                    if self.affine is not None else None)}


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


def side_layout_from_binned(bs) -> SideLayout:
    """``data.storage.BinnedSide`` (what the native builders make) -> the
    trainer's ``SideLayout``: the same arrays, no copies."""
    return SideLayout(
        idx_lo=bs.idx_lo, idx_hi=bs.idx_hi, val=bs.val, mask=bs.mask,
        seg=bs.seg, counts=bs.counts,
        affine=tuple(bs.affine) if bs.affine is not None else None,
        row_block=bs.row_block, group_block=bs.group_block,
        groups_per_shard=bs.groups_per_shard, n_shards=bs.n_shards)


def build_compressed_side(
    group_idx: np.ndarray,
    item_idx: np.ndarray,
    vals: np.ndarray,
    n_groups: int,
    cfg: ALSConfig,
    n_shards: int,
    max_len: Optional[int],
) -> SideLayout:
    """One side's compressed layout from COO: in one native pass
    (``ragged.build_compressed_segmented``) at or above the native
    cutover, else the segmented layout and then ``compress_side``. Both
    routes give the same bits."""
    bs = build_compressed_segmented(
        group_idx, item_idx, vals, n_groups, seg_len=cfg.seg_len,
        max_len=max_len, n_shards=n_shards, block_size=cfg.block_size,
        row_cost_slots=als_row_cost_slots(cfg.rank))
    if bs is not None:
        return side_layout_from_binned(bs)
    return compress_side(_build_side(group_idx, item_idx, vals, n_groups,
                                     cfg, n_shards, max_len))


def data_shards(mesh) -> int:
    """Shards of the group axis: the mesh's ``data`` size, or 1 where
    the mesh is None or of size 1 (the unsharded path)."""
    return axis_size(mesh, "data") if mesh_size(mesh) > 1 else 1


def layout_cache_key(cache_key: str, cfg: ALSConfig, n_shards: int,
                     max_ratings_per_user: Optional[int] = None,
                     max_ratings_per_item: Optional[int] = None) -> str:
    """The layout cache's key for an ALS segmented layout: the data
    fingerprint ``cache_key`` and every knob that shapes the layout. The
    JAX package derives it the same way and the layouts are equal, so an
    entry written by either package, or by either lane (COO or binned),
    serves the others."""
    return bincache.layout_key(
        cache_key, "als-segmented",
        {"seg_len": cfg.seg_len, "block_size": cfg.block_size,
         "rank": cfg.rank, "n_shards": n_shards,
         "max_u": max_ratings_per_user, "max_i": max_ratings_per_item})


class LayoutCacheMiss(LookupError):
    """No cached layout for the key, and no COO to bin instead."""


@dataclasses.dataclass
class CachedLayout:
    """A layout cache entry: both sides (views over the entry's file
    mapping), their vocabularies when the binned lane saved them, and
    how long the load took."""

    user_side: SideLayout
    item_side: SideLayout
    n_users: int
    n_items: int
    total_entries: int
    vocabs: Optional[Tuple[List[str], List[str]]]
    load_sec: float


def load_layout(key: str) -> Optional[CachedLayout]:
    """The entry under ``key`` (a ``layout_cache_key``), or None."""
    t0 = time.perf_counter()
    cached = bincache.load(key)
    if cached is None:
        return None
    arrays, meta = cached
    vocabs = None
    if "u_vocab_bytes" in arrays:
        vocabs = (unpack_vocab(arrays["u_vocab_bytes"],
                               arrays["u_vocab_offs"]),
                  unpack_vocab(arrays["i_vocab_bytes"],
                               arrays["i_vocab_offs"]))
    return CachedLayout(
        user_side=SideLayout.from_arrays(arrays, "u_", meta),
        item_side=SideLayout.from_arrays(arrays, "i_", meta),
        n_users=int(meta["n_users"]), n_items=int(meta["n_items"]),
        total_entries=int(meta["total_entries"]), vocabs=vocabs,
        load_sec=time.perf_counter() - t0)


def save_layout(key: str, user_side: SideLayout, item_side: SideLayout,
                n_users: int, n_items: int, total_entries: int,
                vocabs: Optional[Tuple[Sequence[str], Sequence[str]]] = None
                ) -> None:
    """Store both sides (and, from the binned lane, the vocabularies
    the layout's rows index) under ``key``, in the JAX package's
    names."""
    arrays = {**user_side.to_arrays("u_"), **item_side.to_arrays("i_")}
    if vocabs is not None:
        for prefix, vocab in zip(("u_", "i_"), vocabs):
            raw, offsets = pack_vocab(vocab)
            arrays[f"{prefix}vocab_bytes"] = np.frombuffer(raw, np.uint8)
            arrays[f"{prefix}vocab_offs"] = offsets
    bincache.save(key, arrays, {
        "n_users": int(n_users), "n_items": int(n_items),
        "n_shards": user_side.n_shards, "total_entries": int(total_entries),
        **user_side.meta("u_"), **item_side.meta("i_")})


@dataclasses.dataclass
class DeviceSide:
    """One side's arrays on the device and the half-step bound to them;
    called as ``side(opposing, own_prev)`` it returns the side's new
    ``[n_groups * n_shards, K]`` factors. Sharded, the arrays are this
    rank's shard (``shard`` of ``n_shards`` along the mesh's ``data``
    axis, whose process group is ``group``): it solves its ``n_groups``
    groups from its rows of ``own_prev`` and all-gathers the table."""

    step: HalfStep
    idx: torch.Tensor              # [R, L] int32 gather indexes
    val: torch.Tensor              # [R, L] uint8 codes | float32
    mask: Optional[torch.Tensor]   # [R, L] uint8, None when val is coded
    seg: torch.Tensor              # [R] int32 group of each row
    counts: torch.Tensor           # [G] int32 ratings of each group
    n_groups: int                  # groups on this rank
    n_shards: int = 1
    shard: int = 0
    group: Any = None

    def args(self) -> tuple:
        """The arrays in the order the half-step takes them."""
        if self.mask is None:
            return self.idx, self.val, self.seg, self.counts
        return self.idx, self.val, self.mask, self.seg, self.counts

    def __call__(self, opposing, own_prev):
        if self.n_shards == 1:
            return self.step(opposing, own_prev, *self.args())
        g0 = self.shard * self.n_groups
        local = self.step(opposing, own_prev[g0:g0 + self.n_groups],
                          *self.args())
        return all_gather_rows(local, self.group)


class ALSTrainer:
    """Prepared ALS run: data binned and placed on the device, the two
    half-steps bound to their layouts. Keeps the one-time costs (host
    binning or the cache load, the transfer, first-call set-up) apart
    from the alternations, so a caller can time them separately. Runs
    on ``device``: ``None`` means ``cuda:0`` and raises without CUDA.

    Made from COO triples (``ALSTrainer(...)``) or from prebuilt sides
    (``ALSTrainer.from_sides``); both go through one set-up path.

    ``mesh`` (``parallel.mesh.create_mesh``) of more than one rank
    shards the group axis over its ``data`` axis (the module docstring
    says how); every rank of the axis must make the trainer and run it
    alike. ``None`` or a mesh of size 1 is the unsharded path."""

    def __init__(
        self,
        user_coo: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        n_users: Optional[int],
        n_items: Optional[int],
        cfg: ALSConfig,
        device: DeviceLike = None,
        max_ratings_per_user: Optional[int] = None,
        max_ratings_per_item: Optional[int] = None,
        cache_key: Optional[str] = None,
        mesh=None,
    ):
        """``cache_key`` (a data fingerprint) turns on the layout cache:
        under ``layout_cache_key(cache_key, ...)`` a hit loads both
        sides, and ``user_coo``/``n_users``/``n_items`` may then be
        None; a miss bins the COO and saves the layout. With no entry
        and no COO, raises LayoutCacheMiss."""
        key = None
        cached = None
        n_shards = data_shards(mesh)
        if cache_key is not None:
            key = layout_cache_key(cache_key, cfg, n_shards,
                                   max_ratings_per_user, max_ratings_per_item)
            cached = load_layout(key)
        if cached is not None:
            self._setup_cached(cached, cfg, device, mesh)
            return
        if user_coo is None:
            raise LayoutCacheMiss(f"no cached layout for key {cache_key!r} "
                                  "and no COO to bin")
        u_idx, i_idx, vals = user_coo
        t0 = time.perf_counter()
        user_side = build_compressed_side(
            u_idx, i_idx, vals, n_users, cfg, n_shards, max_ratings_per_user)
        item_side = build_compressed_side(
            i_idx, u_idx, vals, n_items, cfg, n_shards, max_ratings_per_item)
        bin_sec = time.perf_counter() - t0
        if key is not None:
            save_layout(key, user_side, item_side, n_users, n_items,
                        len(vals))
        self._setup(user_side, item_side, n_users, n_items, len(vals), cfg,
                    device, mesh)
        #: host seconds spent binning both sides
        self.bin_sec = bin_sec
        perfacct.LEDGER.note_stage("bin", bin_sec)

    @classmethod
    def from_sides(cls, user_side: SideLayout, item_side: SideLayout,
                   n_users: int, n_items: int, total_entries: int,
                   cfg: ALSConfig, device: DeviceLike = None, mesh=None
                   ) -> "ALSTrainer":
        """A trainer from prebuilt compressed sides: the event log's
        fused scan+bin (``side_layout_from_binned``) or a cache entry.
        The arrays (zero-copy views over native buffers or a cache
        file's mapping) go to the device as they are; sharded, the sides
        must have been binned with the mesh's ``data`` size as
        ``n_shards``."""
        self = cls.__new__(cls)
        self._setup(user_side, item_side, n_users, n_items, total_entries,
                    cfg, device, mesh)
        return self

    @classmethod
    def from_cache(cls, cached: CachedLayout, cfg: ALSConfig,
                   device: DeviceLike = None, mesh=None) -> "ALSTrainer":
        """A trainer from a layout cache entry (``load_layout``)."""
        self = cls.__new__(cls)
        self._setup_cached(cached, cfg, device, mesh)
        return self

    def _setup_cached(self, cached: CachedLayout, cfg: ALSConfig,
                      device: DeviceLike, mesh) -> None:
        self._setup(cached.user_side, cached.item_side, cached.n_users,
                    cached.n_items, cached.total_entries, cfg, device, mesh)
        self.cache_hit = True
        self.load_sec = cached.load_sec

    def _setup(self, user_side: SideLayout, item_side: SideLayout,
               n_users: int, n_items: int, total_entries: int,
               cfg: ALSConfig, device: DeviceLike, mesh) -> None:
        n_shards = data_shards(mesh)
        for side in (user_side, item_side):
            if side.n_shards != n_shards:
                raise ValueError(
                    f"a layout binned for {side.n_shards} shard(s) on a "
                    f"mesh whose data axis has {n_shards}")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: the mesh the group axis shards over (None: unsharded)
        self.mesh = mesh
        self._group = axis_group(mesh, "data")
        self._shard = axis_rank(mesh, "data")
        self.n_users, self.n_items = n_users, n_items
        self.total_entries = total_entries
        #: host seconds of binning and of a cache load (0 where none ran)
        self.bin_sec = 0.0
        self.load_sec = 0.0
        #: whether the layout came from the layout cache
        self.cache_hit = False
        t0 = time.perf_counter()
        self._user = self._put_side(user_side)
        self._item = self._put_side(item_side)
        self.wait_device()
        #: seconds of the host -> device puts and the index recombine
        self.put_sec = time.perf_counter() - t0
        #: bytes this rank put on its device (its shard of each side)
        self.transfer_bytes = (user_side.transfer_bytes
                               + item_side.transfer_bytes) // n_shards
        self._slot_bytes = (user_side.slot_bytes, item_side.slot_bytes)
        # the data-path ledger's transfer stage, and the device-memory
        # ledger's train_data footprint (swept when the trainer goes)
        perfacct.LEDGER.note_stage("transfer", self.put_sec)
        memacct.LEDGER.register(self, "als", "train_data",
                                int(self.transfer_bytes))
        #: the MFU/roofline accountant, made on the first timed run
        self._acct: Optional[perfacct.StepAccountant] = None

        gen = torch.Generator().manual_seed(cfg.seed)
        #: the padded factor tables on the device (every group of every
        #: shard, on every rank); set them to start from other factors
        self.X = _init_factors(gen, self._user.n_groups * n_shards,
                               self.n_users, cfg.rank).to(self.device)
        self.Y = _init_factors(gen, self._item.n_groups * n_shards,
                               self.n_items, cfg.rank).to(self.device)

    def _put_side(self, side: SideLayout) -> DeviceSide:
        """The wire arrays to the device, once each, straight from the
        host arrays (native buffers or a cache file's read-only mapping
        included: no host copy); the index streams recombined to int32
        there. uint16 goes as int16 and is widened with ``& 0xFFFF``: the
        cast every device has. Sharded, only this rank's rows and groups
        go."""
        n_shards = side.n_shards
        rows = side.idx_lo.shape[0] // n_shards
        groups = side.groups_per_shard
        r0, g0 = self._shard * rows, self._shard * groups

        def put(a, per_shard=rows, start=r0):
            if n_shards > 1:
                a = a[start:start + per_shard]
            with warnings.catch_warnings():
                # a cache entry's views are read-only; nothing writes to
                # the layout's tensors
                warnings.filterwarnings(
                    "ignore", message="The given NumPy array is not writable")
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)

        idx = put(side.idx_lo.view(np.int16)).to(torch.int32) & 0xFFFF
        if side.idx_hi is not None:
            idx = idx | (put(side.idx_hi).to(torch.int32) << 16)
        step = make_half_step(self.cfg, side.row_block, side.group_block,
                              groups, val_affine=side.affine)
        return DeviceSide(
            step=step, idx=idx, val=put(side.val),
            mask=None if side.mask is None else put(side.mask),
            seg=put(side.seg), counts=put(side.counts, groups, g0),
            n_groups=groups, n_shards=n_shards, shard=self._shard,
            group=self._group)

    def sides(self) -> Tuple[DeviceSide, DeviceSide]:
        """The user side (solves X against Y), then the item side."""
        return self._user, self._item

    def layout(self) -> dict:
        """The device layout's shapes: virtual rows, slots per row and
        groups (padded) of each side on this rank, and the bytes that
        crossed to it."""
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
        perfacct.LEDGER.note_stage("compile", self.compile_sec)
        return self

    def step_n(self, iterations: Optional[int] = None) -> None:
        """Run n alternations (user half-step, then item), synced once at
        the end; the factors stay on the device (``factors()`` fetches
        them)."""
        n = iterations if iterations is not None else self.cfg.iterations
        t0 = time.perf_counter()
        self.X, self.Y = self._alternate(self.X, self.Y, n)
        self.wait_device()
        seconds = time.perf_counter() - t0
        # live MFU/roofline gauges (obs/perfacct.py) on the analytic
        # work_model, and the train peak (obs/memacct.py): the layout
        # plus both factor tables twice (the JAX trainer's estimate)
        if self._acct is None:
            wm = self.work_model()
            self._acct = perfacct.StepAccountant(
                "als", wm["flops_per_iter"], wm["hbm_bytes_per_iter"],
                device=self.device)
            memacct.note_train_peak(
                "als", int(self.transfer_bytes) + 2 * (
                    self.X.numel() * self.X.element_size()
                    + self.Y.numel() * self.Y.element_size()),
                source="analytic")
        self._acct.observe(seconds, steps=n)

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
        half-steps), from the padded shapes on the device (this rank's
        shard, when sharded); padded slots count, since they are
        gathered and multiplied like real ones.

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
    mesh=None,
) -> ALSFactors:
    """One-call train from COO (user_idx, item_idx, rating) triples;
    ``cache_key`` and ``mesh`` as for ``ALSTrainer``."""
    return ALSTrainer(
        user_coo, n_users, n_items, cfg, device=device,
        max_ratings_per_user=max_ratings_per_user,
        max_ratings_per_item=max_ratings_per_item,
        cache_key=cache_key, mesh=mesh,
    ).run()


class GridHalfStep(HalfStep):
    """The half-steps of G candidates that differ only in ``reg``,
    ``alpha`` and the CG budget, over one side's uncompressed layout, at
    once: the candidates ride the batch dimension, so a grid alternation
    launches about what one train's does. Called as ``(Y, X_prev, idx,
    val, mask, seg, counts)`` with ``Y [G, n_opposing, K]`` and ``X_prev
    [G, groups, K]``; returns ``[G, groups, K]``.

    Per row block, the G opposing tables are gathered as one flat
    ``[G * n, K]`` table (candidate g's indexes offset by ``g * n``),
    the G blocks of Gramians come from one ``bmm``, and one
    ``index_add_`` sums them into ``[G * groups, K, K]`` (segment ids
    offset by ``g * groups``) at once, so no ``[G, R, K, K]`` stack of
    row partials is kept. The solve batches ``G * group_block`` systems,
    with ALS-WR's shift ``reg[g] * n_u`` (or, implicit, ``Y_g^T Y_g +
    reg[g] I``) per system and each candidate's CG budget as
    ``active_steps``. The matrix-vector products (the rhs, the CG
    matvec) go one call per candidate (``_bmv``)."""

    def __init__(self, cfg: ALSConfig, row_block: int, group_block: int,
                 groups_loc: int, regs: torch.Tensor, alphas: torch.Tensor,
                 cg_active: Optional[torch.Tensor]):
        super().__init__(cfg, row_block, group_block, groups_loc)
        self.G = int(regs.shape[0])
        self.regs = regs            # [G] f32
        self.alphas = alphas        # [G] f32
        self.cg_active = cg_active  # [G] int32, None: every budget is
                                    # cfg.cg_iters

    def __call__(self, Y, X_prev, idx, val, mask, seg, counts):
        Yc = Y.to(self.cdt)
        A, b = self.partial_sums(Yc, idx, val, mask, seg)
        return self.solve(A, b, X_prev, counts, Yc)

    def partial_sums(self, Yc, idx, val, mask, seg):
        """Stages 1 and 2 for every candidate: ``A [G, groups, K, K]``
        and ``b [G, groups, K]``, f32, from the opposing factors ``Yc``
        (``[G, n, K]`` in ``compute_dtype``)."""
        G, K, groups = self.G, self.rank, self.groups_loc
        cdt = self.cdt
        R, L = idx.shape
        flat = Yc.reshape(-1, K)
        g = torch.arange(G, dtype=idx.dtype, device=idx.device)
        idx_off = (g * Yc.shape[1]).view(G, 1, 1)
        seg_off = (g * groups).view(G, 1)
        A = torch.zeros((G * groups, K, K), dtype=torch.float32,
                        device=idx.device)
        b = torch.zeros((G * groups, K), dtype=torch.float32,
                        device=idx.device)
        for s in range(0, R, self.row_block):
            e = min(s + self.row_block, R)
            B = e - s
            val_b = val[s:e]
            maskc = mask[s:e].to(cdt)
            Yg = (flat.index_select(0, (idx[s:e] + idx_off).reshape(-1))
                  .view(G, B, L, K) * maskc[..., None])
            Ygf = Yg.float().view(G * B, L, K)
            YgT = Ygf.transpose(1, 2)
            if self.implicit:
                w = val_b.to(cdt).float()
                Ar = torch.bmm(YgT, Ygf * w.repeat(G, 1)[..., None])
                Ar.view(G, B, K, K).mul_(self.alphas.view(G, 1, 1, 1))
                rhs = ((1.0 + self.alphas.view(G, 1, 1) * val_b)
                       * maskc.to(val_b.dtype)).to(cdt).float()
            else:
                Ar = torch.bmm(YgT, Ygf)
                rhs = val_b.to(cdt).float().expand(G, B, L)
            br = _bmv(YgT, rhs.reshape(G * B, L), G)
            segs = (seg[s:e] + seg_off).reshape(-1)
            A.index_add_(0, segs, Ar)
            b.index_add_(0, segs, br)
        return A.view(G, groups, K, K), b.view(G, groups, K)

    def solve(self, A, b, X_prev, counts, Yc):
        """Stage 3 for every candidate, ``G * group_block`` systems at a
        time; groups with no ratings get exact zeros."""
        G, K = self.G, self.rank
        eye = torch.eye(K, dtype=torch.float32, device=A.device)
        if self.implicit:
            # one product per candidate, as a single train forms it
            Ycf = Yc.float()
            YtY = torch.stack([Ycf[g].T @ Ycf[g] for g in range(G)])
        out = torch.empty((G, self.groups_loc, K), dtype=torch.float32,
                          device=A.device)
        for s in range(0, self.groups_loc, self.group_block):
            e = min(s + self.group_block, self.groups_loc)
            B = e - s
            cnt_b = counts[s:e]
            if self.implicit:
                A_b = (A[:, s:e] + YtY[:, None]
                       + self.regs.view(G, 1, 1, 1) * eye)
            else:
                # ALS-WR: reg[g] * n_u * I; empty groups stay nonsingular
                n_u = cnt_b.float().clamp_min(1.0)
                A_b = A[:, s:e] + (self.regs.view(G, 1) * n_u
                                   ).view(G, B, 1, 1) * eye
            A_b = A_b.reshape(G * B, K, K)
            b_b = b[:, s:e].reshape(G * B, K)
            if self.solver == "cg":
                active = (None if self.cg_active is None
                          else self.cg_active.repeat_interleave(B))
                x = _batched_cg(A_b, b_b, self.cg_iters,
                                x0=X_prev[:, s:e].reshape(G * B, K),
                                matvec_dtype=self.cg_dtype,
                                precond=self.cg_precond,
                                active_steps=active, groups=G)
            elif self.solver == "direct":
                x = torch.linalg.solve(A_b, b_b.unsqueeze(-1)).squeeze(-1)
            else:
                raise ValueError(f"unknown solver {self.solver!r} "
                                 "(expected 'cg' or 'direct')")
            out[:, s:e] = torch.where((cnt_b > 0)[None, :, None],
                                      x.view(G, B, K), 0.0)
        return out


class ALSGridTrainer:
    """Every candidate of a hyperparameter grid trained at once on one
    device (the JAX package's vmapped ``als_grid_train``). The candidates
    share the config but ``reg``, ``alpha``, and the iteration and CG
    step budgets; the layout is built and placed once (uncapped, in the
    uncompressed form), the factors grow a leading grid axis ``[G, n,
    K]``, and each alternation runs the G solves together
    (``GridHalfStep``). The alternations run to the largest budget;
    past its own, a candidate's ``X`` and ``Y`` stay frozen.

    Candidate g starts from the factors a sequential ``ALSTrainer`` of
    the same config draws (X, then Y, from one ``torch.Generator``
    seeded with ``cfg.seed``), tiled G times, and does its sequential
    train's arithmetic: on the CPU it ends with the same bits. On a card
    ``index_add_`` sums a group's row partials with float atomics, so
    where a group has more than two the order, and the last bits, vary
    from run to run in either path: the two agree to a tolerance there
    (the tests state it), and bit for bit elsewhere. Set ``X`` / ``Y``
    (``[G, groups, K]``) to start from other factors."""

    def __init__(self, user_coo: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 n_users: int, n_items: int, cfg: ALSConfig,
                 regs: Sequence[float],
                 alphas: Optional[Sequence[float]] = None,
                 iterations: Optional[Sequence[int]] = None,
                 cg_iters: Optional[Sequence[int]] = None,
                 device: DeviceLike = None):
        regs = np.asarray(regs, np.float32)
        G = len(regs)
        alphas = (np.full(G, cfg.alpha, np.float32) if alphas is None
                  else np.asarray(alphas, np.float32))
        iters_arr = (np.full(G, cfg.iterations, np.int64) if iterations is None
                     else np.asarray(iterations, np.int64))
        cg_arr = (np.full(G, cfg.cg_iters, np.int64) if cg_iters is None
                  else np.asarray(cg_iters, np.int64))
        # a real error, not an assert: a shorter list would train wrong
        # candidates without a symptom
        for name, arr in (("alphas", alphas), ("iterations", iters_arr),
                          ("cg_iters", cg_arr)):
            if len(arr) != G:
                raise ValueError(
                    f"als_grid_train: `{name}` has {len(arr)} entries but "
                    f"`regs` defines {G} grid candidates — every "
                    "per-candidate list must match len(regs)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_users, self.n_items = n_users, n_items
        self.G = G
        #: each candidate's iteration budget (host copy)
        self.iterations = iters_arr
        max_cg = int(cg_arr.max(initial=0))
        t0 = time.perf_counter()
        u_idx, i_idx, vals = user_coo
        by_user = _build_side(u_idx, i_idx, vals, n_users, cfg, 1, None)
        by_item = _build_side(i_idx, u_idx, vals, n_items, cfg, 1, None)
        #: host seconds spent binning both sides
        self.bin_sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = self.device
        step_cfg = dataclasses.replace(cfg, cg_iters=max_cg)
        regs_t = torch.tensor(regs, device=dev)
        alphas_t = torch.tensor(alphas, device=dev)
        # budgets equal to the run's steps freeze nothing: no where()s
        cg_active = (None if np.all(cg_arr == max_cg) else
                     torch.tensor(cg_arr, dtype=torch.int32, device=dev))
        self._user, self._item = (
            DeviceSide(
                step=GridHalfStep(step_cfg, side.row_block, side.group_block,
                                  side.groups_per_shard, regs_t, alphas_t,
                                  cg_active),
                idx=torch.from_numpy(side.idx).to(dev),
                val=torch.from_numpy(side.val).to(dev),
                mask=torch.from_numpy(side.mask).to(dev),
                seg=torch.from_numpy(side.seg).to(dev),
                counts=torch.from_numpy(side.counts).to(dev),
                n_groups=side.groups_per_shard)
            for side in (by_user, by_item))
        self.wait_device()
        #: seconds of the host -> device puts
        self.put_sec = time.perf_counter() - t0
        gen = torch.Generator().manual_seed(cfg.seed)
        #: the padded factor tables of every candidate, [G, groups, K]
        self.X = _init_factors(gen, self._user.n_groups, n_users,
                               cfg.rank).repeat(G, 1, 1).to(dev)
        self.Y = _init_factors(gen, self._item.n_groups, n_items,
                               cfg.rank).repeat(G, 1, 1).to(dev)

    def sides(self) -> Tuple[DeviceSide, DeviceSide]:
        """The user side (solves X against Y), then the item side."""
        return self._user, self._item

    def wait_device(self) -> "ALSGridTrainer":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _alternate(self, X, Y, steps: range):
        for t in steps:
            X1 = self._user(Y, X)
            Y1 = self._item(X1, Y)
            on = t < self.iterations
            if on.all():
                X, Y = X1, Y1
            else:
                # past its budget a candidate's factors stay as they were
                keep = torch.from_numpy(on).to(self.device).view(-1, 1, 1)
                X = torch.where(keep, X1, X)
                Y = torch.where(keep, Y1, Y)
        return X, Y

    def compile(self) -> "ALSGridTrainer":
        """One warm alternation on copies of the factors (first-call
        costs out of a timed run); the initial factors are left as they
        were."""
        t0 = time.perf_counter()
        self._alternate(self.X.clone(), self.Y.clone(), range(1))
        self.wait_device()
        self.compile_sec = time.perf_counter() - t0
        return self

    def step_n(self) -> None:
        """Alternate to the largest iteration budget, synced once at the
        end; the factors stay on the device."""
        self.X, self.Y = self._alternate(
            self.X, self.Y, range(int(self.iterations.max(initial=0))))
        self.wait_device()

    def run(self) -> List[ALSFactors]:
        """``step_n``, then one ``ALSFactors`` per candidate, in order."""
        self.step_n()
        Xh, Yh = self.X.cpu().numpy(), self.Y.cpu().numpy()
        return [ALSFactors(user_factors=Xh[g, :self.n_users],
                           item_factors=Yh[g, :self.n_items])
                for g in range(self.G)]


def als_grid_train(
    user_coo: Tuple[np.ndarray, np.ndarray, np.ndarray],
    n_users: int,
    n_items: int,
    cfg: ALSConfig,
    regs: Sequence[float],
    alphas: Optional[Sequence[float]] = None,
    iterations: Optional[Sequence[int]] = None,
    cg_iters: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> List[ALSFactors]:
    """Train every grid candidate at once (``ALSGridTrainer``): beyond
    ``regs``, candidates may differ in ``alphas`` (implicit confidence)
    and in their ``iterations`` and ``cg_iters`` budgets. Returns one
    ALSFactors per candidate, in order."""
    return ALSGridTrainer(user_coo, n_users, n_items, cfg, regs,
                          alphas=alphas, iterations=iterations,
                          cg_iters=cg_iters, device=device).run()


# ---------------------------------------------------------------------------
# streaming fold-in: solve a handful of touched groups against the FIXED
# opposing factors (the classic implicit/explicit ALS fold-in, one exact
# half-step for the touched rows) with the train's Gramian and CG
# ---------------------------------------------------------------------------

#: fold-in CG floor: the full train warm-starts from the last
#: iteration's factors so 6 steps suffice; a fold-in may solve COLD
#: groups (new users), which need ~16 Jacobi-CG steps at K=64
FOLD_IN_CG_ITERS = 16


def fold_in_solve(
    Y,
    rows: "List[Tuple[np.ndarray, np.ndarray]]",
    cfg: ALSConfig,
    x0: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Solve ``len(rows)`` groups' factors against fixed opposing
    factors ``Y`` [n_opposing, K] (numpy or a tensor) on ``device``
    (the card unless the caller asks for the CPU).

    ``rows[i] = (opp_idx, values)``: group i's COMPLETE rating set
    (opposing-side row indices and ratings). For a new user this is
    its delta events, and the solve is the exact conditional ALS
    optimum given Y; for an existing user the caller supplies the full
    history, so the fold-in matches a half-step of the full train.
    ``x0`` [B, K] warm-starts the CG from the groups' current factors
    (zeros for new groups); a group with no rows keeps ``x0``.

    Everything runs in float32, as in the JAX package. The groups are
    padded to the longest one with masked slots, which add nothing to
    the sums; the JAX package's further padding to pow2 buckets only
    bounds its compile cache. ``cfg.solver`` picks Jacobi CG with
    ``max(cfg.cg_iters, FOLD_IN_CG_ITERS)`` steps or a direct solve.
    Returns the solved [B, K] float32 factors."""
    B = len(rows)
    if B == 0:
        return np.zeros((0, cfg.rank), np.float32)
    device = resolve_device(device)
    L = max(1, max(len(idx) for idx, _ in rows))
    idx = np.zeros((B, L), np.int64)
    val = np.zeros((B, L), np.float32)
    mask = np.zeros((B, L), np.float32)
    counts = np.zeros(B, np.float32)
    for i, (gi, gv) in enumerate(rows):
        n = len(gi)
        idx[i, :n] = gi
        val[i, :n] = gv
        mask[i, :n] = 1.0
        counts[i] = n
    x0_arr = np.zeros((B, cfg.rank), np.float32)
    if x0 is not None:
        x0_arr[:] = np.asarray(x0, np.float32)

    def put(a):
        return torch.as_tensor(a, device=device)

    Yt = torch.as_tensor(Y, dtype=torch.float32, device=device)
    maskf, valt, cnt, x0t = put(mask), put(val), put(counts), put(x0_arr)
    Yg = Yt[put(idx)] * maskf[..., None]             # [B, L, K], pads zeroed
    eye = torch.eye(cfg.rank, dtype=torch.float32, device=device)
    if cfg.implicit:
        A = cfg.alpha * torch.bmm(Yg.transpose(1, 2), Yg * valt[..., None])
        b = _bmv(Yg.transpose(1, 2), (1.0 + cfg.alpha * valt) * maskf)
        A = A + Yt.T @ Yt + cfg.reg * eye
    else:
        A = torch.bmm(Yg.transpose(1, 2), Yg)
        b = _bmv(Yg.transpose(1, 2), valt)
        A = A + (cfg.reg * torch.clamp(cnt, min=1.0))[:, None, None] * eye
    if cfg.solver == "cg":
        x = _batched_cg(A, b, max(cfg.cg_iters, FOLD_IN_CG_ITERS), x0=x0t,
                        matvec_dtype=torch.float32, precond="jacobi")
    else:
        x = torch.linalg.solve(A, b)
    # an empty group keeps its warm start: a zero-rating solve would
    # drag an existing factor toward zero
    return torch.where((cnt > 0)[:, None], x, x0t).cpu().numpy()


def predict_rmse(factors: ALSFactors, coo) -> float:
    """Host-side RMSE over COO ratings (evaluation metric helper)."""
    u, i, r = coo
    pred = np.einsum(
        "nk,nk->n", factors.user_factors[np.asarray(u)],
        factors.item_factors[np.asarray(i)])
    return float(np.sqrt(np.mean((pred - np.asarray(r)) ** 2)))

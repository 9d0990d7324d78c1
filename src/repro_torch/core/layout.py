"""Set*VNLayout semantics (paper §IV-F, Tab. III, Fig. 5/6).

A layout places a logical 2-rank tensor into a physical ``D x AW`` buffer:

  1. split each rank into two levels:  K = K_L1 * K_L0,  N = N_L1 * N_L0,
     with the innermost *reduction* factor pinned to the VN size
     (K_L0 = vn_size), leaving three free ranks {K_L1, N_L0, N_L1};
  2. order those three ranks with one of 3! = 6 permutations (3-bit code);
  3. flatten VNs to a 1-D index L in that order and fold row-major into the
     D x AW buffer: a VN occupies ``vn_size`` consecutive rows at one column:

        slot  = L // AW,  col = L % AW
        element e of the VN lives at (slot * vn_size + e, col).

The identity of the three free ranks differs per operand (Tab. III) but the
permutation structure is shared; we canonicalise the rank tuple as

    (red_L1, nr_L0, nr_L1)

i.e. (K_L1, N_L0, N_L1) for W_VN, (J_L1, M_L0, M_L1) for I_VN and
(Q_L1, P_L0, P_L1) for O_VN.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import isa

# Tab. III: 3-bit code -> permutation (outermost..innermost) over the
# canonical rank tuple indices (0 = red_L1, 1 = nr_L0, 2 = nr_L1).
ORDER_TABLE: dict[int, tuple[int, int, int]] = {
    0b000: (0, 1, 2),
    0b001: (0, 2, 1),
    0b010: (1, 0, 2),
    0b011: (1, 2, 0),
    0b100: (2, 0, 1),
    0b101: (2, 1, 0),
}


@dataclasses.dataclass(frozen=True)
class VNLayout:
    """A concrete, bound layout for one operand in one buffer."""

    order: int          # Tab. III permutation id
    nr_l0: int          # level-0 factor of the non-reduction rank (<= AW)
    nr_l1: int          # level-1 factor of the non-reduction rank
    red_l1: int         # level-1 factor of the reduction rank (# VN rows)
    vn_size: int
    aw: int             # physical buffer width

    def __post_init__(self):
        if self.order not in ORDER_TABLE:
            raise ValueError(f"reserved order code {self.order}")
        for f in (self.nr_l0, self.nr_l1, self.red_l1, self.vn_size):
            if f < 1:
                raise ValueError("partition factors must be >= 1")

    # -- logical -> flattened VN index -------------------------------------
    @property
    def nr_extent(self) -> int:
        return self.nr_l0 * self.nr_l1

    @property
    def num_vns(self) -> int:
        return self.red_l1 * self.nr_extent

    @property
    def rows_needed(self) -> int:
        """Buffer rows consumed."""
        return math.ceil(self.num_vns / self.aw) * self.vn_size

    def flatten(self, r, c):
        """VN (r = reduction-tile index, c = non-reduction index) -> L.

        Accepts scalars or numpy arrays.  c is split as
        c = nr_l1_idx * nr_l0 + nr_l0_idx  (paper §IV-F.3).
        """
        rv = (r, np.mod(c, self.nr_l0), c // self.nr_l0)   # (red_L1, nr_L0, nr_L1)
        extents = (self.red_l1, self.nr_l0, self.nr_l1)
        p0, p1, p2 = ORDER_TABLE[self.order]
        return (rv[p0] * extents[p1] * extents[p2]
                + rv[p1] * extents[p2]
                + rv[p2])

    def unflatten(self, l):
        """Inverse of flatten: L -> (r, c)."""
        extents = (self.red_l1, self.nr_l0, self.nr_l1)
        p0, p1, p2 = ORDER_TABLE[self.order]
        v0 = l // (extents[p1] * extents[p2])
        rem = np.mod(l, extents[p1] * extents[p2])
        v1 = rem // extents[p2]
        v2 = np.mod(rem, extents[p2])
        rv = [None, None, None]
        rv[p0], rv[p1], rv[p2] = v0, v1, v2
        r = rv[0]
        c = rv[2] * self.nr_l0 + rv[1]
        return r, c

    # -- flattened VN index -> physical address -----------------------------
    def address(self, r, c):
        """VN (r, c) -> (first_row, col) in the D x AW buffer."""
        l = self.flatten(r, c)
        return (l // self.aw) * self.vn_size, np.mod(l, self.aw)

    # -- instruction form ----------------------------------------------------
    def to_instruction(self, operand: str) -> isa.SetLayoutBase:
        cls = {"W": isa.SetWVNLayout, "I": isa.SetIVNLayout,
               "O": isa.SetOVNLayout}[operand]
        return cls(order=self.order, nr_l0=self.nr_l0, nr_l1=self.nr_l1,
                   red_l1=self.red_l1)


def layout_for(operand_rows: int, operand_cols: int, vn_size: int, aw: int,
               order: int = 0, nr_l0: int | None = None) -> VNLayout:
    """Construct a layout covering a VN array of (rows=red tiles, cols=free).

    ``nr_l0`` defaults to min(cols, aw) (paper caps level-0 non-reduction
    factors at AW since larger values are performance-equivalent).
    """
    if nr_l0 is None:
        nr_l0 = min(operand_cols, aw)
    nr_l0 = max(1, min(nr_l0, aw))
    nr_l1 = math.ceil(operand_cols / nr_l0)
    return VNLayout(order=order, nr_l0=nr_l0, nr_l1=nr_l1,
                    red_l1=operand_rows, vn_size=vn_size, aw=aw)


# ---------------------------------------------------------------------------
# Buffer images (host-side reference placement used by the machine + tests)
# ---------------------------------------------------------------------------

def place(vns: np.ndarray, layout: VNLayout, depth: int) -> np.ndarray:
    """Materialise a buffer image from a VN array [rows, cols, vn_size].

    Returns a float/int array of shape (depth, aw); unused space is zero.
    Raises if the layout does not fit.
    """
    rows, cols, vn = vns.shape
    if vn != layout.vn_size:
        raise ValueError("vn_size mismatch")
    if rows > layout.red_l1 or cols > layout.nr_extent:
        raise ValueError("VN array exceeds layout extents")
    if layout.rows_needed > depth:
        raise ValueError(
            f"layout needs {layout.rows_needed} rows > buffer depth {depth}")
    buf = np.zeros((depth, layout.aw), dtype=vns.dtype)
    r_idx, c_idx = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    first_row, col = layout.address(r_idx, c_idx)
    for e in range(vn):
        buf[first_row + e, col] = vns[r_idx, c_idx, e]
    return buf


def gather(buf: np.ndarray, layout: VNLayout, r, c) -> np.ndarray:
    """Read VN(r, c) back from a buffer image -> [..., vn_size].

    Out-of-extent (r, c) return zeros (paper: implicit zero padding).
    """
    r = np.asarray(r)
    c = np.asarray(c)
    valid = (r >= 0) & (r < layout.red_l1) & (c >= 0) & (c < layout.nr_extent)
    rs = np.where(valid, r, 0)
    cs = np.where(valid, c, 0)
    first_row, col = layout.address(rs, cs)
    out = np.stack([buf[first_row + e, col] for e in range(layout.vn_size)],
                   axis=-1)
    return np.where(valid[..., None], out, 0)

"""H-sharded execution of the conv stages with halo exchanges: what GSPMD
inserts for `spatial_sharded` (`vspbfr_tpu/parallel/mesh.py:106`).

Rank r of the n ranks of the model axis holds rows [r H/n, (r + 1) H/n)
of every NHWC map whose resolution H is sharded (`Spatial.sharded`: at
least `MIN_ROWS` rows a shard). Before an op that reads neighbouring rows
it takes the rows it needs from its neighbours (`Spatial.window`: zeros
above and below the image, real rows between shards) and runs the op on
its rows alone, with no H padding; it computes only its own output rows.
The maps are square, so a map's global resolution is its width and its
layout follows from it: local rows at a sharded resolution, all rows
below. Where the ops meet the context (`spatial=`):

- 3x3 styled / equal convs (K1, K1e; `ops/modulated_conv.py`,
  `models/layers.py`): the window of `pad` rows each side, pads ((0, 0),
  (pad, pad));
- SMART's four dilations in one K2 launch: the window of 8 rows (the
  largest dilation) each side, every branch at its own 'same' padding on
  the H/n + 16 rows, the middle H/n rows kept. K2 takes one symmetric pad
  a branch, so this needs no kernel change (per-branch H pads would) and
  costs 16 rows of the 32-256 a shard holds at the SMART resolutions;
- the up-conv with its blur: below 128 output channels the subpixel
  composed conv on K1 and K3's interleave (`up_conv_blur_unpacked`) on
  the window of the composed kernel's reach, its 2H/n output rows; from
  128 the transposed conv + blur (`rows_op`, 2 rows each side), as
  unsharded;
- the blurred stride-2 down-conv: the window of the composed kernel's
  reach, its H/(2n) output rows (gathered where the output is below the
  threshold);
- the FIR 2x upsample of the ToRGB skip (`upsample2d`, `rows_op`): a
  window of 1 row, the middle 2H/n output rows kept.

1x1 convs and the K6 / K7 epilogues need no halo; their noise is the
shard's rows of the global draw (`Spatial.noise`). Below the threshold a
map is whole on every rank and computed replicated (the 4-16 px decoder
levels at n = 4; GSPMD may do the same).

Every tensor a sharded stage takes holds the rank's batch rows (the data
axis of a 2-D mesh); the noise a layer draws is the global batch's draw
cut to them, so the ranks reproduce the unsharded run's draws. Explicit
noise maps are this batch's whole maps. Only forward runs sharded (the
decode and restore stages of serving); an exchange on a tensor that needs
a gradient raises. Under gloo CUDA strips go through the host; a failed
exchange raises within the process group's timeout.
"""

from __future__ import annotations

import torch

from vspbfr_tpu_torch.parallel.mesh import AxisGroup

# a map is H-sharded when each shard holds at least this many rows: the
# largest halo (K2's dilation 8), so a window reaches one neighbour only
MIN_ROWS = 8


class _One:
    """The trivial exchange of a one-rank axis."""

    rank, size = 0, 1

    def all_gather(self, t):
        return [t]


class Spatial:
    """One rank's view of the H-sharded stages: `rows` exchanges along the
    model axis (rank, size, all_gather: an `AxisGroup`, or a stand-in),
    `batch` along the data axis (the rank's batch rows are its index's
    share of the global batch)."""

    def __init__(self, rows, batch=None):
        self.rows_group = rows
        self.batch_group = batch or _One()
        self.rank, self.n = rows.rank, rows.size
        self.exchanges = 0      # halo exchanges and gathers run

    @classmethod
    def from_mesh(cls, mesh) -> "Spatial":
        """This rank's context on a mesh from `parallel.create_mesh_2d`:
        rows over its "model" axis, the batch over its "data" axis."""
        return cls(AxisGroup.of(mesh, "model"),
                   AxisGroup.of(mesh, "data")
                   if "data" in mesh.mesh_dim_names else None)

    # -- layouts ------------------------------------------------------------

    def sharded(self, res: int) -> bool:
        """Whether maps of resolution res are H-sharded."""
        return self.n > 1 and res % self.n == 0 and res // self.n >= MIN_ROWS

    def own_rows(self, res: int) -> slice:
        h = res // self.n
        return slice(self.rank * h, (self.rank + 1) * h)

    def _check(self, x: torch.Tensor) -> int:
        """x's global resolution (its width), after checking that x holds
        the rows its layout says."""
        res = x.shape[2]
        want = res // self.n if self.sharded(res) else res
        if x.shape[1] != want:
            raise ValueError(f"spatial: a map of width {res} holds "
                             f"{x.shape[1]} rows, its layout {want}")
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError("spatial sharding runs forward only")
        return res

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """A map given whole (or already as local rows) in its layout: its
        own rows where its resolution is sharded."""
        res = x.shape[2]
        if self.sharded(res) and x.shape[1] == res:
            return x[:, self.own_rows(res)]
        return x

    def batch_rows(self, global_batch: int) -> slice:
        per = global_batch // self.batch_group.size
        return slice(self.batch_group.rank * per,
                     (self.batch_group.rank + 1) * per)

    # -- exchanges ----------------------------------------------------------

    def window(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """Rows [r h - top, (r + 1) h + bottom) of the map x (h = H / n),
        zeros outside the image: from the neighbours' edge strips where x
        is sharded, by slicing where it is whole."""
        res = self._check(x)
        h = res // self.n
        lo, hi = self.rank * h - top, (self.rank + 1) * h + bottom
        if not self.sharded(res):
            part = x[:, max(lo, 0):min(hi, res)]
            return self._pad_rows(part, max(-lo, 0), max(hi - res, 0))
        if top == 0 and bottom == 0:
            return x
        if top > h or bottom > h:
            raise ValueError(f"spatial: a halo of {top} / {bottom} rows on "
                             f"shards of {h}")
        self.exchanges += 1
        # each rank sends the rows its neighbours need: its first `bottom`
        # (the bottom halo of rank - 1) and its last `top` (the top halo
        # of rank + 1)
        parts = self.rows_group.all_gather(
            torch.cat([x[:, :bottom], x[:, h - top:]], dim=1))
        above = (parts[self.rank - 1][:, bottom:] if self.rank > 0
                 else x.new_zeros((x.shape[0], top) + x.shape[2:]))
        below = (parts[self.rank + 1][:, :bottom] if self.rank < self.n - 1
                 else x.new_zeros((x.shape[0], bottom) + x.shape[2:]))
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def _pad_rows(x, top, bottom):
        if top == 0 and bottom == 0:
            return x
        zeros = [x.new_zeros((x.shape[0], n) + x.shape[2:])
                 for n in (top, bottom)]
        return torch.cat([zeros[0], x, zeros[1]], dim=1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map from the ranks' equal row blocks (x itself where
        it is whole already)."""
        if x.shape[1] == x.shape[2]:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError("spatial sharding runs forward only")
        self.exchanges += 1
        return torch.cat(self.rows_group.all_gather(x), dim=1)

    def settle(self, x: torch.Tensor) -> torch.Tensor:
        """An op's output on this rank's rows in its resolution's layout:
        gathered where that resolution is not sharded."""
        return x if self.sharded(x.shape[2]) else self.gather(x)

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from the data axis' ranks."""
        if self.batch_group.size == 1:
            return x
        return torch.cat(self.batch_group.all_gather(x), dim=0)

    # -- ops ------------------------------------------------------------------

    def rows_op(self, x: torch.Tensor, fn, reach: int,
                up: int = 1) -> torch.Tensor:
        """fn (a shift-equivariant op whose output row y reads input rows
        within `reach` of y / up, with `up`x the rows out) on this rank's
        rows: fn on the window of `reach` rows, the middle up * H/n output
        rows kept. The result is in the output resolution's layout."""
        res = self._check(x)
        if not self.sharded(res * up):
            return fn(x)
        h = res // self.n
        out = fn(self.window(x, reach, reach))
        return out[:, up * reach:up * (reach + h)].contiguous()

    def noise(self, shape, noise, draw) -> torch.Tensor:
        """The noise of an output of `shape` (this batch's rows, whole H):
        given maps are this batch's whole maps; else `draw(global shape)`
        (the unsharded run's draw of the global batch) cut to this batch's
        rows. Both in the output's layout."""
        b, res = shape[0], shape[1]
        if noise is None:
            g = self.batch_group
            noise = draw((b * g.size,) + tuple(shape[1:]))[
                g.rank * b:(g.rank + 1) * b]
        if self.sharded(res):
            noise = noise[:, self.own_rows(res)]
        return noise

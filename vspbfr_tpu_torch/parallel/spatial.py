"""H-sharded execution of the conv stages with halo exchanges: what GSPMD
inserts for `spatial_sharded` (`vspbfr_tpu/parallel/mesh.py:106`), in the
forward and in the backward.

The layout rule. A map's resolution r is that of the image it holds: an
unpacked map (B, H, r, C) has width r, a space-to-depth packed one (B, h,
r/2, 4C) (`ops/packed.py`) width r/2, and the caller says which
(`packed=`; the maps are square in their own grid). Whether r is sharded
depends on r alone (`Spatial.sharded`: r/n even and at least `MIN_ROWS`
image rows a shard), so the packed and the unpacked maps of one
resolution agree (the ToRGB skip across the packing boundary, the decoder
features RestoreNet reads). Rank k of the n ranks of the model axis then
holds image rows [k r/n, (k + 1) r/n): rows [k r/n, (k + 1) r/n) of an
unpacked map, packed rows [k r/(2n), (k + 1) r/(2n)) of a packed one (r/n
is even). Every count of rows an op gives (a window's halo, a shard's
rows, `rows_op`'s reach, `noise`'s block) is in the map's own rows: image
rows unpacked, packed rows packed. Before an op that reads neighbouring
rows a rank takes the rows it needs from its neighbours (`Spatial.window`:
zeros above and below the image, real rows between shards) and runs the
op on its rows alone, with no H padding; it computes only its own output
rows. Below the threshold a map is whole: all its rows on every rank.
Where the ops meet the context (`spatial=`):

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
  unsharded. The style scales the window, so from a whole input every
  use of the layer's style is on this rank's rows;
- the blurred stride-2 down-conv: the window of the composed kernel's
  reach, its H/(2n) output rows, its epilogue on those rows, then
  gathered where the output is below the threshold;
- the FIR 2x upsample of the ToRGB skip (`upsample2d`, `rows_op`): a
  window of 1 row, the middle 2H/n output rows kept;
- the packed forms (`ops/packed.py`), in packed rows: each assembled
  kernel's H pads (top, bottom) become the window's rows, with no H
  padding (stride 1, the up-convs and the upsample from an unpacked or a
  packed input, the down-conv to an unpacked output; the stride-2
  packed-to-packed down-conv takes (top, bottom - 1), so that its h/2
  outputs read the h + 2 rows from the shard's first row on, stride
  aligned), all of them 1 row each side; an even dilation d (SMART's d4
  and d8 branches, grouped K2) the window of d/2 rows, each branch at its
  own symmetric padding, the middle rows kept: at most 4 packed rows,
  which the threshold's 8 image rows (4 packed) cover.

1x1 convs and the K6 / K7 epilogues need no halo; their noise is the
shard's rows of the global draw (`Spatial.noise`). Below the threshold a
map is whole on every rank and computed replicated (the 4-16 px decoder
levels at n = 4; GSPMD may do the same).

Gradients keep GSPMD's invariant: a sharded map's gradient holds its own
rows; a replicated tensor's gradient is whole and equal on every rank of
the model axis. So each exchange has its reverse in the backward:
`window` sends each halo strip's gradient back to the rank that owns
those rows, which adds it into its first or last rows (the zero rows
outside the image drop out); `gather` keeps this rank's rows; `own` and
`window` on a whole map (slices of a replicated tensor) all-gather the
rows' gradients and add them up. A replicated tensor that enters an op on
this rank's rows gets only this rank's part of its gradient, which the
model axis sums (Megatron's identity forward / all-reduce backward):

- a layer that runs on sharded rows (`Spatial.layer`) does all its work
  on rows, so every parameter gradient it produces is a part: a
  model-sharded parameter's part is reduce-scattered in its gather's
  backward (`model_axis.partial_gradients`), the replicated parameters'
  parts are summed after the backward in one flattened all-reduce a
  dtype (`sum_partial_grads`, from `TrainState.apply_gradients`);
- the style codes those layers read pass `summed` once a forward, so
  their parts are summed in one all-reduce, not one a layer.

The packed layout reverses through the same Functions, counted in packed
rows: a packed window's strips are packed rows, so their gradients go
back into the owner's first or last packed rows (the assembled kernels'
windows, 1 row each side; the stride-2 packed-to-packed down-conv's
lopsided (top, bottom - 1) window sends `top` rows up and `bottom - 1`
down; grouped K2's window of d/2 rows, whose outer output rows `rows_op`
drops, so those rows' gradients enter as zeros, sends d/2 rows each
way); `own` / `window` on a whole packed map add the ranks' blocks of
packed rows; `settle(packed=True)` keeps this rank's packed rows of the
whole gradient. `noise(packed=True)` exchanges nothing: it cuts rows of
maps that the trainers draw before the step and hand in, so a
rematerialised decode (`torch.utils.checkpoint`) cuts the same rows
again.

The backward exchanges are once differentiable: R1's double backward
runs through D on whole images, never through a halo, and a double
backward through an exchange raises.

Every tensor a sharded stage takes holds the rank's batch rows (the data
axis of a 2-D mesh); the noise a layer draws is the global batch's draw
cut to them, so the ranks reproduce the unsharded run's draws. Explicit
noise maps are this batch's whole maps. Under gloo CUDA strips go through
the host; a failed exchange raises within the process group's timeout.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
from torch.autograd.function import once_differentiable

from vspbfr_tpu_torch.parallel.mesh import AxisGroup, flat_collective
from vspbfr_tpu_torch.parallel.model_axis import partial_gradients

# a resolution is H-sharded when each shard holds at least this many image
# rows: the largest halo (K2's dilation 8 unpacked; 4 packed rows, grouped
# K2's d8 branch at dilation 4), so a window reaches one neighbour only
MIN_ROWS = 8


class _One:
    """The trivial exchange of a one-rank axis."""

    rank, size = 0, 1

    def all_gather(self, t):
        return [t]


class _Window(torch.autograd.Function):
    """Rows [r h - top, (r + 1) h + bottom) of a sharded map from the
    neighbours' edge strips; the backward sends the strips' gradients
    back."""

    @staticmethod
    def forward(ctx, x, sp, top, bottom):
        ctx.sp, ctx.top, ctx.bottom = sp, top, bottom
        return sp._halo(x, top, bottom)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return ctx.sp._halo_back(g, ctx.top, ctx.bottom), None, None, None


class _WholeRows(torch.autograd.Function):
    """Rows [r step - top, r step + step + bottom) of a replicated map,
    zeros outside it; the backward adds every rank's rows' gradient into
    the whole map's."""

    @staticmethod
    def forward(ctx, x, sp, step, top, bottom):
        ctx.sp, ctx.step, ctx.top, ctx.res = sp, step, top, x.shape[1]
        lo = sp.rank * step - top
        hi = lo + step + top + bottom
        part = x[:, max(lo, 0):min(hi, x.shape[1])]
        return sp._pad_rows(part, max(-lo, 0), max(hi - x.shape[1], 0))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        sp, step, top = ctx.sp, ctx.step, ctx.top
        sp.exchanges += 1
        parts = sp.rows_group.all_gather(g)
        rows = g.shape[1]
        full = g.new_zeros((g.shape[0], max(top + ctx.res,
                                            (sp.n - 1) * step + rows))
                           + g.shape[2:])
        for r, p in enumerate(parts):
            full[:, r * step:r * step + rows] += p
        return full[:, top:top + ctx.res], None, None, None, None


class _Gather(torch.autograd.Function):
    """The whole map from the ranks' row blocks; the backward keeps this
    rank's rows of the (whole, equal) gradient."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp, ctx.h = sp, x.shape[1]
        return torch.cat(sp.rows_group.all_gather(x), dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        r, h = ctx.sp.rank, ctx.h
        return g[:, r * h:(r + 1) * h].contiguous(), None


class _Summed(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the model
    axis."""

    @staticmethod
    def forward(ctx, t, sp):
        ctx.sp = sp
        return t.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ctx.sp.grad_sums += 1
        return ctx.sp.rows_group.all_reduce(g), None


class Spatial:
    """One rank's view of the H-sharded stages: `rows` exchanges along the
    model axis (rank, size, all_gather and, for gradients, all_reduce: an
    `AxisGroup`, or a stand-in), `batch` along the data axis (the rank's
    batch rows are its index's share of the global batch)."""

    def __init__(self, rows, batch=None):
        self.rows_group = rows
        self.batch_group = batch or _One()
        self.rank, self.n = rows.rank, rows.size
        self.exchanges = 0      # halo exchanges and gathers, both passes
        self.grad_sums = 0      # model-axis sums of replicated gradients
        self._partial = weakref.WeakSet()   # the layers that ran on rows

    @classmethod
    def from_mesh(cls, mesh) -> "Spatial":
        """This rank's context on a mesh from `parallel.create_mesh_2d`:
        rows over its "model" axis, the batch over its "data" axis."""
        return cls(AxisGroup.of(mesh, "model"),
                   AxisGroup.of(mesh, "data")
                   if "data" in mesh.mesh_dim_names else None)

    # -- layouts ------------------------------------------------------------

    def sharded(self, res: int) -> bool:
        """Whether maps of resolution res (image rows) are H-sharded, in
        either layout: r/n even (a packed map splits into equal blocks of
        packed rows) and at least `MIN_ROWS`."""
        return (self.n > 1 and res % (2 * self.n) == 0
                and res // self.n >= MIN_ROWS)

    @staticmethod
    def res_of(x: torch.Tensor, packed: bool = False) -> int:
        """The resolution of the map x: its width, twice that packed."""
        return x.shape[2] * (2 if packed else 1)

    def step(self, res: int, packed: bool = False) -> int:
        """A shard's rows of a map at res in its own rows: r/n, or r/(2n)
        packed (the block a window of a whole map is cut around)."""
        rows = res // 2 if packed else res
        if rows % self.n:
            raise ValueError(f"spatial: {rows} rows do not split over "
                             f"{self.n} ranks")
        return rows // self.n

    def own_rows(self, res: int, packed: bool = False) -> slice:
        h = self.step(res, packed)
        return slice(self.rank * h, (self.rank + 1) * h)

    def _check(self, x: torch.Tensor, packed: bool = False) -> int:
        """x's resolution (`res_of`), after checking that x holds the rows
        its layout says."""
        res = self.res_of(x, packed)
        want = (self.step(res, packed) if self.sharded(res)
                else x.shape[2])
        if x.shape[1] != want:
            raise ValueError(f"spatial: a map of width {x.shape[2]} "
                             f"(packed {packed}) holds {x.shape[1]} rows, "
                             f"its layout {want}")
        return res

    def own(self, x: torch.Tensor, packed: bool = False) -> torch.Tensor:
        """A map given whole (or already as local rows) in its layout: its
        own rows where its resolution is sharded."""
        res = self.res_of(x, packed)
        if self.sharded(res) and x.shape[1] == x.shape[2]:
            return _WholeRows.apply(x, self, self.step(res, packed), 0, 0)
        return x

    def batch_rows(self, global_batch: int) -> slice:
        per = global_batch // self.batch_group.size
        return slice(self.batch_group.rank * per,
                     (self.batch_group.rank + 1) * per)

    # -- exchanges ----------------------------------------------------------

    def window(self, x: torch.Tensor, top: int, bottom: int,
               packed: bool = False) -> torch.Tensor:
        """Rows [k h - top, (k + 1) h + bottom) of the map x (h its
        `step`, all in x's own rows), zeros outside the image: from the
        neighbours' edge strips where x is sharded, by slicing where it is
        whole."""
        res = self._check(x, packed)
        h = self.step(res, packed)
        if not self.sharded(res):
            return _WholeRows.apply(x, self, h, top, bottom)
        if top == 0 and bottom == 0:
            return x
        if top > h or bottom > h:
            raise ValueError(f"spatial: a halo of {top} / {bottom} rows on "
                             f"shards of {h}")
        return _Window.apply(x, self, top, bottom)

    def _halo(self, x, top, bottom):
        """The forward exchange: each rank sends the rows its neighbours
        need, its first `bottom` (the bottom halo of rank - 1) and its last
        `top` (the top halo of rank + 1)."""
        h = x.shape[1]
        self.exchanges += 1
        parts = self.rows_group.all_gather(
            torch.cat([x[:, :bottom], x[:, h - top:]], dim=1))
        above = (parts[self.rank - 1][:, bottom:] if self.rank > 0
                 else x.new_zeros((x.shape[0], top) + x.shape[2:]))
        below = (parts[self.rank + 1][:, :bottom] if self.rank < self.n - 1
                 else x.new_zeros((x.shape[0], bottom) + x.shape[2:]))
        return torch.cat([above, x, below], dim=1)

    def _halo_back(self, g, top, bottom):
        """The reverse exchange: each rank sends its top halo's gradient
        to rank - 1 (its last `top` rows) and its bottom halo's to rank + 1
        (its first `bottom` rows), and adds what it receives."""
        h = g.shape[1] - top - bottom
        self.exchanges += 1
        parts = self.rows_group.all_gather(
            torch.cat([g[:, :top], g[:, top + h:]], dim=1))
        dx = g[:, top:top + h].clone()
        if self.rank > 0:
            dx[:, :bottom] += parts[self.rank - 1][:, top:]
        if self.rank < self.n - 1:
            dx[:, h - top:] += parts[self.rank + 1][:, :top]
        return dx

    @staticmethod
    def _pad_rows(x, top, bottom):
        if top == 0 and bottom == 0:
            return x
        zeros = [x.new_zeros((x.shape[0], n) + x.shape[2:])
                 for n in (top, bottom)]
        return torch.cat([zeros[0], x, zeros[1]], dim=1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map from the ranks' equal row blocks (x itself where
        it is whole already: square in its own grid, either layout)."""
        if x.shape[1] == x.shape[2]:
            return x
        self.exchanges += 1
        return _Gather.apply(x, self)

    def settle(self, x: torch.Tensor, packed: bool = False) -> torch.Tensor:
        """An op's output on this rank's rows in its resolution's layout:
        gathered where that resolution is not sharded."""
        return x if self.sharded(self.res_of(x, packed)) else self.gather(x)

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from the data axis' ranks (forward only: the
        serving path)."""
        if self.batch_group.size == 1:
            return x
        return torch.cat(self.batch_group.all_gather(x), dim=0)

    # -- gradients of replicated tensors -------------------------------------

    def summed(self, t: torch.Tensor) -> torch.Tensor:
        """t, whose gradient is summed over the model axis in the backward:
        the style codes that the layers on sharded rows read (each rank's
        gradient is its rows' part). Whole layers read t itself."""
        if self.n == 1 or not t.requires_grad:
            return t
        return _Summed.apply(t, self)

    @contextlib.contextmanager
    def layer(self, module, *resolutions):
        """Run `module` (a layer whose input and output have these
        resolutions) in its layout: where any of them is sharded the layer
        runs on this rank's rows, so its parameters' gradients are this
        rank's parts: its model-sharded parameters' are reduce-scattered in
        their gathers' backward, its replicated ones' are summed by
        `sum_partial_grads`. Yields whether it runs on rows."""
        if not any(self.sharded(r) for r in resolutions):
            yield False
            return
        self._partial.add(module)
        with partial_gradients(module):
            yield True

    @torch.no_grad()
    def sum_partial_grads(self, module: torch.nn.Module) -> None:
        """After the backward: `.grad` of each replicated parameter of the
        layers of `module` that ran on rows <- its sum over the model axis,
        in one flattened all-reduce a dtype (a missing gradient counts as
        zeros, as `TrainState` takes it)."""
        if self.n == 1:
            return
        params: dict = {}
        for m in module.modules():
            if m in self._partial:
                for name, p in m.named_parameters():
                    if "parametrizations." not in name:
                        params.setdefault(id(p), p)
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)

        def summed(flat):
            self.grad_sums += 1
            return self.rows_group.all_reduce(flat)

        flat_collective([p.grad for p in params.values()], summed)

    # -- ops ------------------------------------------------------------------

    def rows_op(self, x: torch.Tensor, fn, reach: int, up: int = 1,
                packed: bool = False) -> torch.Tensor:
        """fn (a shift-equivariant op whose output row y reads input rows
        within `reach` of y / up, with `up`x the rows out, x and the output
        in one layout: `packed`, the rows its own) on this rank's rows: fn
        on the window of `reach` rows, the middle up * h output rows kept
        (h the shard's rows). The result is in the output resolution's
        layout."""
        res = self._check(x, packed)
        if not self.sharded(res * up):
            return fn(x)
        h = self.step(res, packed)
        out = fn(self.window(x, reach, reach, packed))
        return out[:, up * reach:up * (reach + h)].contiguous()

    def noise(self, shape, noise, draw, rows: int | None = None,
              packed: bool = False):
        """The noise of an output of `shape` (this batch's rows, whole H;
        packed: (B, r/2, r/2, 4), one value a phase): given maps are this
        batch's whole maps; else `draw(global shape)` (the unsharded run's
        draw of the global batch) cut to this batch's rows. Both in the
        output's layout, or with `rows` (an op on this rank's rows whose
        output resolution is whole: a down-conv before `settle`) this
        rank's block of that many rows, in the output's own rows."""
        b = shape[0]
        res = shape[1] * (2 if packed else 1)
        if noise is None:
            g = self.batch_group
            noise = draw((b * g.size,) + tuple(shape[1:]))[
                g.rank * b:(g.rank + 1) * b]
        elif tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise {tuple(noise.shape)} for an output "
                             f"{tuple(shape)}, packed {packed}")
        if self.sharded(res):
            return noise[:, self.own_rows(res, packed)]
        if rows is not None and rows < shape[1]:
            return noise[:, self.rank * rows:(self.rank + 1) * rows]
        return noise

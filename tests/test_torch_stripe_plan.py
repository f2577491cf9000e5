"""The launch plan of K9 / K10 (`ops.stripe_conv.stripe_plan`), on the CPU.

The plan is a pure function of the shapes, pads, tile rows, pointer
alignment and the card's multiprocessor count, and `csrc/stripe_conv.cu`
reads it field for field (`Plan`) and refuses one that breaks its rules. So
its rules are pinned here without a card, at every shape the `cli.profile`
entries and the card tests launch: shared memory within a block's 227 KB,
TMA boxes no wider than 256, 1024-byte stripe buffers, the TMA producer
exactly where TMA can read the tensors, tiles whose pixels are a multiple of
every h_t, one block a multiprocessor, and the field order of the C struct.
"""

import importlib
import re

import pytest

torch = pytest.importorskip("torch")

from vspbfr_tpu_torch.cli import profile  # noqa: E402
from vspbfr_tpu_torch.ops import _build  # noqa: E402

tsc = importlib.import_module("vspbfr_tpu_torch.ops.stripe_conv")

P1, P0 = ((1, 1), (1, 1)), ((0, 0), (0, 0))
# (x shape, w shape (KH, KW, Ci, Co), pads, h_t or None for K9's rows)
ENTRY_CASES = [(xs, ws, pads, None) for xs, ws, pads in profile.STRIPE_SHAPES]
_IX, _IW = profile.INKPAD_SHAPE, (3, 3, profile.INKPAD_SHAPE[3],
                                  profile.INKPAD_CO)
ENTRY_CASES += [
    (_IX, _IW, P1, profile.INKPAD_ROWS),
    # `legacy`: the padded copy, no pads
    ((_IX[0], _IX[1] + 2, _IX[2] + 2, _IX[3]), _IW, P0, profile.INKPAD_ROWS),
]
# tests/test_torch_cuda.py's K9 and K10 shapes
CARD_CASES = [
    ((2, 7, 9, 5), (3, 3, 5, 12), P1, None),
    ((1, 13, 21, 24), (3, 3, 24, 70), P1, None),
    ((2, 10, 11, 40), (2, 2, 40, 9), ((0, 1), (0, 1)), None),
    ((1, 6, 5, 8), (3, 3, 8, 20), ((0, 2), (2, 0)), None),
    ((2, 5, 7, 16), (1, 1, 16, 3), P0, None),
    ((1, 19, 33, 136), (3, 3, 136, 130), P1, None),
    ((1, 21, 19, 264), (3, 3, 264, 300), P1, None),
    ((1, 18, 20, 192), (2, 2, 192, 96), ((0, 1), (0, 1)), None),
    ((4, 96, 96, 128), (3, 3, 128, 128), P1, None),
    ((1, 8, 8, 16), (9, 9, 16, 8), ((4, 4), (4, 4)), None),
    ((2, 20, 9, 24), (3, 3, 24, 40), P1, 4),
    ((1, 37, 13, 6), (3, 3, 6, 16), P1, 16),
    ((1, 16, 16, 64), (3, 3, 64, 64), P1, 1),
    ((2, 34, 40, 136), (3, 3, 136, 264), P1, 8),
]
SMS = 132   # the H100's multiprocessors


def _case_id(case):
    xs, ws, pads, h_t = case
    return f"x{'x'.join(map(str, xs))}-w{ws[0]}x{ws[1]}to{ws[3]}-ht{h_t}"


# f32 stages every tap's weights: the 9x9 case is refused there
# (test_plan_refuses_what_exceeds_a_block)
PLAN_CASES = [pytest.param(c, bf16, id=f"{_case_id(c)}-{dt}")
              for c in ENTRY_CASES + CARD_CASES
              for bf16, dt in ((True, "bf16"), (False, "f32"))
              if bf16 or c[1][:2] != (9, 9)]


@pytest.mark.parametrize("case,bf16", PLAN_CASES)
def test_plan_fits_a_block(case, bf16):
    xs, ws, pads, h_t = case
    g = tsc.stripe_plan(bf16, xs, ws, pads, h_t, sms=SMS)
    kh, kw, _, co = ws
    assert g["TH"] * g["TW"] == g["M"]
    if h_t is not None:
        assert g["TH"] == h_t and g["M"] % h_t == 0
    assert (g["SH"], g["SW"]) == (g["TH"] + kh - 1, g["TW"] + kw - 1)
    assert g["tiles_x"] * g["TW"] >= g["OW"] > (g["tiles_x"] - 1) * g["TW"]
    assert g["tiles_y"] * g["TH"] >= g["OH"] > (g["tiles_y"] - 1) * g["TH"]
    assert g["co_tiles"] * g["N"] >= co > (g["co_tiles"] - 1) * g["N"]
    assert g["smem"] <= tsc.SMEM_LIMIT
    if bf16:
        assert (g["M"], g["N"]) in tsc.BF16_TILES
        assert g["stripe_bytes"] % 1024 == 0
        assert g["stripe_bytes"] >= g["SH"] * g["SW"] * tsc.ROW_BYTES
        assert g["w_bytes"] == g["N"] * tsc.ROW_BYTES
        assert g["stripe_stages"] >= 2
        assert tsc.MIN_W_STAGES <= g["w_stages"] <= tsc.MAX_W_STAGES
        assert g["smem"] >= (1024 + g["stripe_stages"] * g["stripe_bytes"]
                             + g["w_stages"] * g["w_bytes"] + tsc.EPI_BYTES
                             + 16 * (g["stripe_stages"] + g["w_stages"]))
        if g["producer"]:
            assert max(g["SH"], g["SW"]) <= tsc.BOX_LIMIT
    else:
        assert (g["M"], g["N"]) == tsc.F32_TILE


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("ci", [5, 6, 8, 24, 64, 136])
@pytest.mark.parametrize("aligned", [True, False])
def test_producer_is_tma_exactly_where_tma_reads(ci, aligned, bf16):
    """bf16: TMA when a pixel's channels are a multiple of 16 bytes and both
    pointers are 16-byte aligned, else plain loads into the same ring (f32:
    cp.async under the same rule)."""
    g = tsc.stripe_plan(bf16, (1, 12, 12, ci), (3, 3, ci, 16), P1,
                        aligned=aligned)
    itemsize = 2 if bf16 else 4
    assert g["producer"] == int((ci * itemsize) % 16 == 0 and aligned)


@pytest.mark.parametrize("co,h_t,tile", [
    (3, None, (256, 64)), (64, None, (256, 64)), (70, None, (256, 128)),
    (128, None, (256, 128)), (130, None, (128, 256)), (512, None, (128, 256)),
    (64, 16, (256, 64)), (256, 16, (128, 256)),
    (64, 1, (128, 128)), (256, 1, (128, 128)),
])
def test_bf16_tile_is_the_narrowest_that_holds_co(co, h_t, tile):
    """The first tile whose N holds Co (all of it up to 256), unless its
    stripe does not fit: one-row tiles (h_t 1) take 128 x 128."""
    g = tsc.stripe_plan(True, (4, 64, 300, 64), (3, 3, 64, co), P1, h_t)
    assert (g["M"], g["N"]) == tile


@pytest.mark.parametrize("h_t", [2 ** k for k in range(8)])
def test_every_h_t_divides_every_tile(h_t):
    assert h_t <= tsc.MAX_H_T
    for m, _ in tsc.BF16_TILES + (tsc.F32_TILE,):
        assert m % h_t == 0


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("xs", [(1, 16, 16, 64), (4, 256, 256, 64)])
def test_grid_is_one_block_a_multiprocessor_at_most(xs, bf16):
    """bf16 with `sms`: that many blocks at most, each taking tiles `grid`
    apart; without, and in f32, one block a tile."""
    ws = (3, 3, xs[3], 64)
    for sms in (None, SMS):
        g = tsc.stripe_plan(bf16, xs, ws, P1, sms=sms)
        tiles = xs[0] * g["tiles_y"] * g["tiles_x"] * g["co_tiles"]
        want = min(tiles, sms) if bf16 and sms else tiles
        assert g["grid"] == want


def test_plan_fields_are_the_kernels_struct():
    """PLAN_FIELDS is `struct Plan` of csrc/stripe_conv.cu, in order."""
    src = (_build.CSRC / "stripe_conv.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\w+", re.sub(r"\bint\b", " ", body))
    assert tuple(names) == tsc.PLAN_FIELDS
    count = re.search(r"kPlanFields = (\d+);", src).group(1)
    assert int(count) == len(tsc.PLAN_FIELDS)


@pytest.mark.parametrize("bf16,k,fits", [
    (True, 9, True),      # weights stream one tap at a time
    (True, 17, False),    # two stripes exceed a block with any tile
    (False, 9, False),    # f32 stages every tap's weights
])
def test_plan_refuses_what_exceeds_a_block(bf16, k, fits):
    xs, ws, pads = (1, 8, 8, 16), (k, k, 16, 8), ((k // 2,) * 2,) * 2
    if fits:
        assert tsc.stripe_plan(bf16, xs, ws, pads)["smem"] <= tsc.SMEM_LIMIT
    else:
        with pytest.raises(RuntimeError):
            tsc.stripe_plan(bf16, xs, ws, pads)

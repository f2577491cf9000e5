"""The launch plan of K5 (`ops.smart.smart_plan`), on the CPU.

The plan is a pure function of the shapes, the dtype and the card's
multiprocessor count, and `csrc/smart_fused.cu` reads it field for field
(`Plan`) and refuses one its kind was not built for. So its rules are pinned
here without a card, at every `cli.profile` SMART shape in both dtypes and
at every shape the card tests launch: the branch tile and the largest
stage within a block's 227 KB, the bodies' pixels and columns of each kind
as the C source declares them, the halo recompute at 512 px C64, enough
blocks at every SMART shape, each block's share of the branch and output
channels, and the field order of the C struct.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from vspbfr_tpu_torch.cli import profile  # noqa: E402
from vspbfr_tpu_torch.ops import _build  # noqa: E402
from vspbfr_tpu_torch.ops import smart  # noqa: E402

SMS = 132   # the H100's multiprocessors
SRC = (_build.CSRC / "smart_fused.cu").read_text()
# (B, H, W, C, Cb, Co): the profiler's SMART shapes at b4, then the card
# tests' SMART_CASES (tests/test_torch_cuda.py) and their forced clusters
ENTRY_CASES = [(profile.BATCH, h, h, c, c // 4, c)
               for h, c in profile.SMART_SHAPES]
CARD_CASES = [
    (2, 4, 4, 16, 4, 16), (2, 8, 8, 32, 8, 32), (1, 9, 13, 12, 3, 10),
    (2, 16, 16, 8, 2, 8), (1, 12, 10, 64, 16, 70), (1, 6, 6, 256, 64, 256),
    (1, 33, 17, 64, 16, 64), (2, 19, 21, 96, 24, 40), (1, 5, 7, 32, 8, 32),
    (1, 12, 12, 512, 128, 512), (1, 20, 20, 128, 32, 136),
    (2, 11, 19, 40, 16, 70),
]
PLAN_CASES = [pytest.param(c, bf16, id=f"{'x'.join(map(str, c))}-{dt}")
              for c in ENTRY_CASES + CARD_CASES
              for bf16, dt in ((True, "bf16"), (False, "f32"))]


def _body(spec: str) -> tuple[int, int]:
    """(pixels, columns) of a conv_tile.cuh tile config `Mma<WN, NT8, MT>`
    or `Fma<LPG, G, PX>`."""
    name = spec[:3]
    a, b, c = map(int, re.findall(r"\d+", spec))
    if name == "Mma":   # WN, NT8, MT; WM = 8 / WN
        return (8 // a) * c * 16, a * b * 8
    return c * 256 // a, a * b * 4   # LPG, G, PX


def _kinds() -> dict:
    """The C source's kinds: {(bf16, kind): (TH, TW, branch body, fusion
    body)}, each body as (pixels, columns)."""
    out = {}
    for dt, k, body in re.findall(
            r"struct Kind<(__nv_bfloat16|float), (\d)> \{(.*?)\};", SRC,
            re.S):
        br = re.search(r"using Br = (\w+<[\d, ]+>)", body).group(1)
        fu = re.search(r"using Fu = (\w+<[\d, ]+>)", body).group(1)
        th, tw = map(int, re.search(r"TH = (\d+), TW = (\d+)",
                                    body).groups())
        out[(dt == "__nv_bfloat16", int(k))] = (th, tw, _body(br), _body(fu))
    return out


@pytest.mark.parametrize("case,bf16", PLAN_CASES)
def test_plan_fits_a_block(case, bf16):
    b, h, w, c, cb, co = case
    g = smart.smart_plan(bf16, b, h, w, c, cb, co, sms=SMS)
    th, tw, (bm, bn), (fm, fn) = _kinds()[(bf16, g["kind"])]
    assert (g["TH"], g["TW"], g["seg"]) == (th, tw, bn)
    assert (th + 2) * (tw + 2) <= bm and th * tw == fm
    assert fn == smart.FUSION_N
    assert g["tiles_x"] * tw >= w > (g["tiles_x"] - 1) * tw
    assert g["tiles_y"] * th >= h > (g["tiles_y"] - 1) * th
    ck = 32 if bf16 else 16
    assert g["slabs"] * ck >= 4 * cb > (g["slabs"] - 1) * ck
    assert g["buf_bytes"] == g["slabs"] * (th + 2) * (tw + 2) * smart.X_ROW
    itemsize = 2 if bf16 else 4
    stripe = (th + 18) * (tw + 18) * smart.X_ROW
    branch = stripe + 9 * ck * (bn * itemsize + 16) + ck * 4
    fusion = 9 * ck * (fn * itemsize + 16)
    assert g["stage_bytes"] == max(branch, fusion)
    assert g["buf_bytes"] + g["stage_bytes"] <= g["smem"] == 232_448
    assert g["cluster"] in smart.CLUSTERS and 4 * cb % g["cluster"] == 0
    assert g["co_split"] % 8 == 0
    assert g["co_split"] * g["cluster"] >= co
    assert (g["co_split"] - 8) * g["cluster"] < co
    assert g["blocks"] == b * g["tiles_x"] * g["tiles_y"] * g["cluster"]
    assert g["halo"] == (th + 2) * (tw + 2) / (th * tw)


def test_halo_recompute_at_512px_c64_bf16():
    """A 16x16 tile: 18^2 / 16^2 = 1.27x the branch work."""
    g = smart.smart_plan(True, 4, 512, 512, 64, 16, 64)
    assert (g["TH"], g["TW"]) == (16, 16) and g["halo"] <= 1.3


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("side,c", profile.SMART_SHAPES)
def test_enough_blocks_at_every_smart_shape(side, c, bf16):
    """b4: at least one block a multiprocessor at 32 px and above, at
    least 32 at 4 and 8 px (a cluster of 8 a tile)."""
    g = smart.smart_plan(bf16, 4, side, side, c, c // 4, c, sms=SMS)
    if side >= 32:
        assert g["blocks"] >= SMS
    if side <= 8:
        assert g["blocks"] >= 32


def test_cluster_is_the_fewest_blocks_that_fill_the_card():
    # 512 px C64: 4096 tiles, one block each
    assert smart.smart_plan(True, 4, 512, 512, 64, 16, 64)["cluster"] == 1
    # 32 px C512 bf16: 64 tiles; 2 a tile give 128 < 132
    assert smart.smart_plan(True, 4, 32, 32, 512, 128, 512)["cluster"] == 4
    # Cb 3: 4Cb = 12 splits in 1, 2 or 4 only
    assert smart.smart_plan(True, 1, 9, 13, 12, 3, 10)["cluster"] == 4


@pytest.mark.parametrize("cluster", smart.CLUSTERS)
def test_a_given_cluster_is_kept(cluster):
    g = smart.smart_plan(True, 2, 11, 19, 40, 16, 70, cluster=cluster)
    assert g["cluster"] == cluster
    assert g["co_split"] == 8 * -(-70 // (8 * cluster))


def test_plan_refuses_what_exceeds_a_block_or_splits_unevenly():
    with pytest.raises(ValueError, match="shared memory"):
        smart.smart_plan(True, 1, 8, 8, 256, 256, 256)
    with pytest.raises(ValueError, match="shared memory"):
        smart.smart_plan(False, 1, 8, 8, 512, 256, 512)
    with pytest.raises(ValueError, match="cluster"):
        smart.smart_plan(True, 1, 9, 13, 12, 3, 10, cluster=8)


def test_plan_fields_are_the_kernels_struct():
    """PLAN_FIELDS is `struct Plan` of csrc/smart_fused.cu, in order."""
    body = re.search(r"struct Plan \{(.*?)\};", SRC, re.S).group(1)
    names = re.findall(r"\w+", re.sub(r"\bint\b", " ", body))
    assert tuple(names) == smart.PLAN_FIELDS
    count = re.search(r"kPlanFields = (\d+);", SRC).group(1)
    assert int(count) == len(smart.PLAN_FIELDS)


def test_kinds_are_the_kernels():
    """KINDS (tile, branch columns) is the C source's `Kind` list."""
    kinds = _kinds()
    assert sorted(kinds) == sorted((bf16, k) for bf16 in (True, False)
                                   for k in range(len(smart.KINDS[bf16])))
    for (bf16, k), (th, tw, (_, bn), _) in kinds.items():
        assert smart.KINDS[bf16][k] == (th, tw, bn)

"""The launch plans of the port's Hopper kernels, on the CPU: pure
functions of the shapes (``fused_matmul.launch_plan``,
``chunk_prefill_attn.launch_plan``, ``slstm_cell.launch_plan``,
``decode_layer.matvec_plan``, ``decode_attn.launch_plan``,
``mlstm_chunk.launch_plan``) that decide the kernel variant, the split
of the reduction over blocks, the grid, what stays on chip and the
scratch.  Checked here: the blocks cover every output element exactly
once, the splits cover the reduction exactly once and in a fixed order,
shared memory fits, and the grid fills the card where the shape allows
it.  Also the tensor-map cache's keys, with a stand-in encoder.
"""
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import chunk_prefill_attn as cpa
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import decode_layer as dl
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import mlstm_chunk as ml
from repro_torch.kernels import slstm_cell as sc

SMS = 132

MATMUL_SHAPES = [
    (64, 16, 2048, 256),
    # (m, t, d, f): every row count of the variants, D not a multiple of the
    # 64-deep k-step, F not a multiple of the 128-wide tile
    *[(3, t, 200, 200) for t in (1, 8, 16, 17, 64, 127, 128, 129, 257)],
    (4, 4, 2048, 5632), (32, 128, 768, 3072), (2, 4, 2048, 2816), (16, 128, 768, 1536),
    (89, 128, 128, 384), (397, 4, 64, 128), (10, 128, 256, 2504), (1, 13, 520, 136), (1, 1, 8, 8),
    (3, 77, 768, 3072), (2, 5, 20, 77), (3, 4, 64, 77),
]


def _covered(split_ranges, n, parts):
    got = [0] * n
    for a, b in split_ranges(n, parts):
        assert a < b, (n, parts)
        for i in range(a, b):
            got[i] += 1
    return got


def _matmul_tiles(p, m, t, f):
    """(split, (instance, row block, column block)) of every tile each
    block of the plan's grid computes."""
    gx, gy, gz = p.grid
    if p.variant == "wide":
        # block b walks tiles b, b + gx, ... in (m, row, column) order,
        # columns fastest
        ft, rt = math.ceil(f / p.cols), math.ceil(t / p.rows)
        for b in range(gx):
            for i in range(b, m * rt * ft, gx):
                yield 0, (i // (ft * rt), i // ft % rt, i % ft)
    elif p.variant == "skinny":
        for mm, bx, sp in itertools.product(range(gz), range(gx), range(gy)):
            yield sp, (mm, 0, bx)
    else:
        for mm, by, bx in itertools.product(range(gz), range(gy), range(gx)):
            yield 0, (mm, by, bx)


@pytest.mark.parametrize("m,t,d,f", MATMUL_SHAPES)
def test_fused_matmul_plan_covers_outputs_once(m, t, d, f):
    """Each (instance, row, column) of the output lies in exactly one
    block tile per split, and the splits walk D's k-steps exactly once."""
    p = fm.launch_plan(m, t, d, f, "bfloat16", SMS)
    hits = np.zeros((p.split, m, t, f), np.int32)
    for sp, (mm, by, bx) in _matmul_tiles(p, m, t, f):
        hits[sp, mm, by * p.rows:(by + 1) * p.rows, bx * p.cols:(bx + 1) * p.cols] += 1
    assert (hits == 1).all()
    steps = math.ceil(d / fm.HK) if p.variant != "simt" else 1
    assert _covered(fm.split_ranges, steps, p.split) == [1] * steps


@pytest.mark.parametrize("m,t,d,f", MATMUL_SHAPES)
def test_fused_matmul_plan_variant(m, t, d, f):
    """Aligned bf16 takes wgmma: skinny at t <= 16 (N of 8 or 16), else wide
    (a 128-row tile covers a t <= 128 instance, so w is read once; 256
    columns unless those tiles would leave over half the SMs idle).  f32
    and rows not 16-byte aligned take the FMA / element-wise kernel.  A
    skinny split, a cluster of at most 8 blocks of at least 4 k-steps,
    stops once 4 instances' blocks reach a quarter of an H100's SMs,
    whatever the call's instance count."""
    p = fm.launch_plan(m, t, d, f, "bfloat16", SMS)
    if d % 8 or f % 8:
        assert p.variant == "simt"
    elif t <= 16:
        assert p.variant == "skinny" and p.rows == (8 if t <= 8 else 16) and p.cols == 128
        tiles, steps = 4 * math.ceil(f / 128), math.ceil(d / fm.HK)
        assert 1 <= p.split <= min(fm.MAX_SPLIT, steps)
        assert p.split == fm.skinny_split(d, f)
        assert p.split == 1 or tiles * (p.split - 1) < SMS / 4
        assert (tiles * p.split >= SMS / 4 or p.split == fm.MAX_SPLIT
                or p.split == max(1, steps // fm.MIN_SPLIT_STEPS))
    else:
        assert p.variant == "wide" and p.split == 1 and p.rows == 128
        narrow, wide = (m * math.ceil(t / 128) * math.ceil(f / c) for c in (128, 256))
        assert p.cols == (256 if wide >= SMS / 2 else 128)
        assert p.grid == (min(wide if p.cols == 256 else narrow, SMS), 1, 1)
    assert fm.launch_plan(m, t, d, f, "float32", SMS).variant == "simt"


def test_fused_matmul_plan_serving_shapes():
    """The serving shape: 176 tiles, no split; a 2x2 rank's block: 44
    tiles, no split either (a quarter of the SMs is 33); two tiles split D
    as far as their 9 k-steps allow; the BERT shape and its 2x2 rank's
    block: 384 and 96 tiles of 256 columns; T = 77 at 3 instances: 72 of
    128 (36 of 256 would leave 96 SMs idle)."""
    assert fm.launch_plan(4, 4, 2048, 5632).grid == (44, 1, 4)
    assert fm.launch_plan(2, 4, 2048, 2816).grid == (22, 1, 2)
    assert fm.launch_plan(1, 13, 520, 136).split == 2
    assert fm.launch_plan(32, 128, 768, 3072).grid == (132, 1, 1)
    assert fm.launch_plan(32, 128, 768, 3072).cols == 256
    assert fm.launch_plan(16, 128, 768, 1536).cols == 256
    assert fm.launch_plan(3, 77, 768, 3072).grid == (72, 1, 1)


def test_fused_matmul_plan_wide_cols_read_m():
    """The wide path's column tile is the one layout that reads the
    instance count (a tile's width, not the order of a row's sums): at f =
    1024 and t = 32, one or two instances take 128 columns and 64 take 256,
    the two sides the card's lane check holds bit for bit
    (``test_torch_cuda.test_fused_matmul_row_alone_equals_its_row``)."""
    assert [fm.launch_plan(n, 32, 2048, 1024).cols for n in (1, 2, 64)] == [128, 128, 256]
    assert {fm.launch_plan(n, 32, 2048, 1024).split for n in (1, 2, 64)} == {1}


CHUNK_SHAPES = [
    # (lanes, c, h, kvh, hd, s_cache): tinyllama's serve shape, hymba's two
    # groups, the CUDA tests' shapes
    (4, 32, 32, 4, 64, 1024), (4, 32, 25, 5, 64, 1152), (4, 32, 25, 5, 64, 1536),
    (4, 32, 8, 2, 8, 1024), (4, 32, 8, 2, 128, 1024), (2, 8, 4, 2, 8, 16),
    (4, 2, 4, 4, 8, 24), (1, 5, 3, 1, 8, 13), (4, 32, 8, 2, 64, 200), (16, 32, 32, 4, 64, 1024),
]


@pytest.mark.parametrize("lanes,c,h,kvh,hd,sc", CHUNK_SHAPES)
def test_chunk_plan_splits_cover_keys_once(lanes, c, h, kvh, hd, sc):
    """The splits of each (lane, kv head, row block) walk the key tiles
    of [0, S + C) exactly once, each split at least one tile; the grid's
    first axis holds every row block's splits (a cluster each)."""
    p = cpa.launch_plan(lanes, c, h, kvh, hd, sc, "bfloat16")
    assert p.tiles == math.ceil((sc + c) / cpa.KEYS)
    assert 1 <= p.splits <= min(p.tiles, cpa.MAX_SPLITS)
    keys = [0] * (sc + c)
    for a, b in cpa.split_ranges(p.tiles, p.splits):
        assert a < b
        for j in range(a * cpa.KEYS, min(sc + c, b * cpa.KEYS)):
            keys[j] += 1
    assert keys == [1] * (sc + c)
    cg = c * (h // kvh)
    assert p.grid == (math.ceil(cg / cpa.ROWS) * p.splits, kvh, lanes)


@pytest.mark.parametrize("lanes,c,h,kvh,hd,sc", CHUNK_SHAPES)
def test_chunk_plan_fills_card(lanes, c, h, kvh, hd, sc):
    """bf16: the fewest splits that give one lane the blocks of two waves
    of an H100 over 4 lanes, unless every tile has its own split already
    or the cluster is at its 8; f32 never splits."""
    p = cpa.launch_plan(lanes, c, h, kvh, hd, sc, "bfloat16")
    per_lane = math.prod(p.grid) // lanes
    assert (per_lane >= 2 * SMS / 4 or p.splits == p.tiles
            or p.splits == cpa.MAX_SPLITS)
    if p.splits > 1:
        assert per_lane // p.splits * (p.splits - 1) < 2 * SMS / 4
    assert cpa.launch_plan(lanes, c, h, kvh, hd, sc, "float32").splits == 1


def test_chunk_plan_serving_shapes():
    """tinyllama's 4-lane chunk call: 64 blocks before the split (under
    half of the 132 SMs), 320 after; hymba's: 60, then 300."""
    assert cpa.launch_plan(4, 32, 32, 4, 64, 1024).grid == (20, 4, 4)
    assert cpa.launch_plan(4, 32, 25, 5, 64, 1152).grid == (15, 5, 4)


# ---------------------------------------------------------------------------
# the decode attention's plan: the slots' split over a cluster
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 129, 1536])
@pytest.mark.parametrize("g", [1, 5, 16])
def test_decode_attn_plan_ranges_cover_slots_once(s, g):
    """The splits' slot ranges cover [0, S) exactly once and in order, each
    non-empty and starting on a 64-slot tile; at most 8 splits, one per
    tile at most; the grid is (splits, kv heads, lanes)."""
    kvh = 5
    for dtype in ("bfloat16", "float32"):
        p = da.launch_plan(16, s, g * kvh, kvh, 64, dtype)
        assert p.tiles == math.ceil(s / da.TILE)
        assert 1 <= p.splits <= min(p.tiles, da.MAX_SPLITS) and len(p.ranges) == p.splits
        slots = []
        for a, b in p.ranges:
            assert a < b and a % da.TILE == 0
            slots += range(a, b)
        assert slots == list(range(s))
        assert p.grid == (p.splits, kvh, 16)


@pytest.mark.parametrize("s", [1, 129, 1536])
def test_decode_attn_split_slots_cover_the_valid_prefix_once(s):
    """For every kv_len the splits' ranges cover [0, kv_len) exactly once
    and in order, in whole 64-slot tiles (the last clipped to kv_len), and
    the busiest split holds at most ceil(tiles / splits) tiles."""
    splits = da.launch_plan(16, s, 25, 5, 64).splits
    for kv_len in sorted({1, 2, 63, 64, 65, 128, 129, 191, 192, 193, 672, s} & set(range(1, s + 1))):
        ranges = da.split_slots(kv_len, splits)
        assert len(ranges) == splits
        slots = []
        for a, b in ranges:
            assert a <= b and (a == b or a % da.TILE == 0)
            slots += range(a, b)
        assert slots == list(range(kv_len))
        n = math.ceil(kv_len / da.TILE)
        assert max(math.ceil((b - a) / da.TILE) for a, b in ranges) == math.ceil(n / splits)


@pytest.mark.parametrize("s", [1, 64, 129, 1536, 4096])
def test_decode_attn_plan_split_count_reads_no_lane_count(s):
    """A lane's output depends on its own q, k, v, kv_len and S only: the
    split count is the same for any M, B (so for K=1 and K=8 steps and any
    TP rank's block of heads) and either dtype."""
    plans = {(m, b, h, kvh, dt): da.launch_plan(m * b, s, h, kvh, 64, dt)
             for m in (1, 2, 4, 8) for b in (1, 4, 16)
             for h, kvh in ((25, 5), (5, 1), (1, 1), (16, 1))
             for dt in ("bfloat16", "float32")}
    assert len({(p.splits, p.ranges) for p in plans.values()}) == 1


def test_decode_attn_plan_serving_shapes():
    """hymba-1.5b's serve (16 lanes, S 1536): clusters of 8 over its 5 kv
    heads, and the same for each TP plan's rank block (None: 25 / 5 heads,
    "kv": 5 / 1, "expand": 1 / 1); at the served lengths (kv_len 144-672)
    no split holds more than 2 of the 64-slot tiles."""
    for h, kvh in ((25, 5), (5, 1), (1, 1)):
        p = da.launch_plan(16, 1536, h, kvh, 64)
        assert p.splits == 8 and p.grid == (8, kvh, 16)
        assert p.ranges == tuple((192 * i, 192 * (i + 1)) for i in range(8))
    assert max(b - a for n in range(144, 673) for a, b in da.split_slots(n, 8)) == 2 * da.TILE


@pytest.mark.parametrize("h,kvh,hd", [(17, 1, 64), (25, 5, 136), (4, 2, 12), (5, 2, 64)])
def test_decode_attn_plan_refuses_what_the_kernel_does_not_take(h, kvh, hd):
    with pytest.raises(ValueError):
        da.launch_plan(4, 300, h, kvh, hd)


# ---------------------------------------------------------------------------
# the chunkwise mLSTM's plan: pass 1 over (lane, chunk), pass 2's blocks of C
# ---------------------------------------------------------------------------

MLSTM_SHAPES = [
    # (lanes, S, hd, chunk): xlstm-1.3b's profiler shape, the multi-chunk
    # A/B shape, xlstm-1.3b's reference chunk 128 (one and two chunks), the
    # CUDA tests' shapes
    (64, 32, 1024, 32), (16, 256, 1024, 64), (16, 256, 1024, 128), (4, 128, 1024, 128),
    (2, 128, 512, 128), (4, 256, 128, 64), (1, 24, 64, 12), (1, 8, 64, 4), (8, 40, 64, 8),
    (4, 32, 1024, 32), (6, 24, 64, 12), (3, 384, 512, 96), (1, 300, 128, 100), (2, 64, 192, 32),
]


@pytest.mark.parametrize("lanes,s,hd,cs", MLSTM_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlstm_plan_blocks_cover_c_once(lanes, s, hd, cs, dtype):
    """Pass 2: each element of a lane's C (and so each strip's columns and
    each CTA's rows) belongs to exactly one CTA of the grid (hd / rows,
    hd / strip, lanes), in blocks the warps split evenly; pass 1: its
    cluster's CTAs cover hd once in whole pieces, one grid row per chunk."""
    p = ml.launch_plan(lanes, s, hd, cs, dtype)
    assert p.grid2 == (hd // p.rows, p.groups, lanes) and p.grid2[0] <= ml.MAX_CLUSTER
    assert p.groups == hd // p.strip or not p.resident
    owner = np.zeros((hd, hd), dtype=int)
    for r in range(p.grid2[0]):
        for g in range(p.groups):
            for y in range(g, hd // p.strip, p.groups):      # CTA (r, g)'s strips
                owner[r * p.rows:(r + 1) * p.rows, y * p.strip:(y + 1) * p.strip] += 1
    assert (owner == 1).all()
    assert p.rows in (64, 128) and (p.rows // 16) in (4, 8)
    assert p.grid1 == (p.kcluster, s // cs, lanes) and p.kcluster <= ml.MAX_CLUSTER
    share = hd // p.kcluster
    assert share * p.kcluster == hd and share % ml.TILES[dtype][0] == 0
    assert p.resident == (s // cs > 1)


@pytest.mark.parametrize("lanes,s,hd,cs", MLSTM_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlstm_plan_fits_shared_memory(lanes, s, hd, cs, dtype):
    """Both passes' CTAs stay within the 227 KB a block may use, with the
    sums the kernel carves; the record holds w and the gates."""
    p = ml.launch_plan(lanes, s, hd, cs, dtype)
    assert (p.smem1, p.smem2) == ml.smem_bytes(cs, hd, p.rows, p.resident, dtype)
    assert max(p.smem1, p.smem2) <= 227 * 1024
    csp = 16 * math.ceil(cs / 16)
    assert p.record == csp * csp + 4 * csp + 4


def test_mlstm_plan_chunk_128_and_serving_shapes():
    """xlstm-1.3b's reference chunk (128) runs, in one chunk and over two;
    the profiler's one chunk of 32 at hd 1024: pass 1 a cluster of 8 per
    lane, pass 2 one CTA per block of 128 rows walking its 16 strips (512
    CTAs, two waves' worth of 132 SMs already); the multi-chunk A/B shape
    keeps C over clusters of 8."""
    assert ml.launch_plan(16, 256, 1024, 128).grid2 == (8, 16, 16)
    assert not ml.launch_plan(16, 128, 1024, 128).resident
    p = ml.launch_plan(64, 32, 1024, 32)
    assert not p.resident and p.grid1 == (8, 1, 64) and p.grid2 == (8, 1, 64)
    assert ml.launch_plan(4, 32, 1024, 32).grid2 == (8, 9, 4)      # 2 x 132 / 32 blocks
    p = ml.launch_plan(16, 256, 1024, 64)
    assert p.resident and p.grid1 == (8, 4, 16) and p.grid2 == (8, 16, 16)


@pytest.mark.parametrize("lanes,s,hd,cs", [(4, 258, 1024, 129), (4, 256, 96, 64),
                                           (4, 100, 128, 64), (70000, 32, 64, 32),
                                           (2, 256, 2048, 128), (2, 64, 576, 32)])
def test_mlstm_plan_refuses_what_the_kernel_does_not_take(lanes, s, hd, cs):
    with pytest.raises(ValueError):
        ml.launch_plan(lanes, s, hd, cs)


# ---------------------------------------------------------------------------
# the sLSTM cell's plan: where r lives during a call
# ---------------------------------------------------------------------------

SLSTM_SHAPES = [
    # (m, b, s, h, hd, r dtype): xlstm-1.3b's prefill and decode, f32 and
    # bf16 r; the CUDA tests' shapes; a wide head
    (4, 1, 32, 4, 512, "float32"), (4, 4, 1, 4, 512, "float32"),
    (4, 1, 32, 4, 512, "bfloat16"), (4, 4, 1, 4, 512, "bfloat16"),
    (1, 6, 5, 2, 512, "float32"), (2, 2, 3, 2, 512, "bfloat16"), (16, 4, 32, 4, 512, "float32"),
    (2, 1, 1, 2, 32, "float32"), (1, 6, 5, 1, 96, "bfloat16"), (2, 4, 32, 4, 128, "float32"),
    (1, 1, 8, 1, 32, "bfloat16"), (2, 1, 8, 1, 1024, "float32"), (2, 3, 4, 2, 256, "float32"),
]


def _slstm_thread_rows(p, hd):
    """The rows each thread group kg sums, in the kernel's order:
    registers, shared memory, then stage by stage."""
    kg_n = 256 // (hd // p.cluster)
    k_stream = p.reg_rows + p.smem_rows
    out = {}
    for kg in range(kg_n):
        rows = [kg + kg_n * i for i in range(p.nrr)]
        rows += list(range(p.reg_rows + kg, k_stream, kg_n))
        for k0 in range(k_stream, hd, max(p.stage_rows, 1)):
            nr = min(p.stage_rows, hd - k0)
            first = (kg - k0 % kg_n) % kg_n
            rows += [k0 + k for k in range(first, nr, kg_n)]
        out[kg] = rows
    return out


@pytest.mark.parametrize("m,b,s,h,hd,rdt", SLSTM_SHAPES)
def test_slstm_plan_covers_r_once(m, b, s, h, hd, rdt):
    """Registers, shared memory and the streamed stages cover each of a
    CTA's hd rows exactly once, and every thread group sums its rows in
    increasing order whatever the plan (so the result does not depend on
    it); the ring only exists where rows stream."""
    p = sc.launch_plan(m, b, s, h, hd, rdt)
    assert p.reg_rows + p.smem_rows + p.stream_rows == hd
    assert min(p.reg_rows, p.smem_rows, p.stream_rows) >= 0
    rows = _slstm_thread_rows(p, hd)
    flat = sorted(k for r in rows.values() for k in r)
    assert flat == list(range(hd))
    kg_n = len(rows)
    for kg, r in rows.items():
        assert r == list(range(kg, hd, kg_n))
    assert (p.stream_rows > 0) == (p.stage_rows > 0)
    assert p.grid == (m * h * p.cluster,) and p.cluster in (sc.CLUSTER, sc.CLUSTER_WIDE)


@pytest.mark.parametrize("m,b,s,h,hd,rdt", SLSTM_SHAPES)
def test_slstm_plan_fits_shared_memory(m, b, s, h, hd, rdt):
    """A block's shared memory stays within the 227 KB a block may use,
    and matches the kernel's formula; streamed pieces are 16-byte bulk
    copies; decode streams everything it does not hold whole."""
    p = sc.launch_plan(m, b, s, h, hd, rdt)
    rsz = 4 if rdt == "float32" else 2
    assert p.smem_bytes <= 227 * 1024
    assert p.smem_bytes == sc.smem_bytes(b, hd, rsz, p.lanes, p.smem_rows, p.stage_rows, p.stages,
                                         p.cluster)
    if p.stream_rows:
        assert (hd // p.cluster * rsz) % 16 == 0 and p.stage_rows <= 256
        assert (p.stage_rows * hd // p.cluster * rsz) % 128 == 0
    # the wide cluster only where it holds a prefill's r whole
    assert p.cluster == sc.CLUSTER or (s > 1 and p.stream_rows == 0)
    if s == 1 and p.stream_rows:
        assert p.stream_rows == hd and p.nrr == 0
    assert p.lanes == (1 if b == 1 else 4)


def test_slstm_plan_serving_shapes():
    """xlstm-1.3b (hd 512, 4 heads, M = 4): prefill with f32 r takes
    clusters of 16, whose CTAs hold their 256 KB of r whole (128 rows in
    registers, 384 in shared memory): nothing streams; with bf16 r a
    cluster of 8 holds it whole; decode streams all 512 rows through 2
    stages of 32 KB, in under half an SM's shared memory.  With 6 lanes a
    prefill's state leaves no room for r whole at 16, and a cluster of 8
    streams ~260 rows each step through 3 stages of 16 rows."""
    p = sc.launch_plan(4, 1, 32, 4, 512, "float32")
    assert (p.cluster, p.nrr, p.reg_rows, p.smem_rows, p.stream_rows) == (16, 16, 128, 384, 0)
    p = sc.launch_plan(4, 1, 32, 4, 512, "bfloat16")
    assert (p.cluster, p.reg_rows, p.smem_rows, p.stream_rows) == (8, 192, 320, 0)
    p = sc.launch_plan(1, 6, 5, 2, 512, "float32")
    assert (p.cluster, p.nrr, p.reg_rows, p.stage_rows, p.stages) == (8, 28, 112, 16, 3)
    assert p.stream_rows == 400 - p.smem_rows > 0
    p = sc.launch_plan(4, 4, 1, 4, 512, "float32")
    assert (p.reg_rows, p.smem_rows, p.stream_rows, p.stages, p.stage_rows) == (0, 0, 512, 2, 32)
    assert p.stream_bytes_per_step == 64 * 2 ** 20 and p.smem_bytes <= 113 * 1024


# ---------------------------------------------------------------------------
# the decode layer's wgmma matvecs
# ---------------------------------------------------------------------------

MATVEC_SHAPES = [
    # (m, b, k, n, pair): tinyllama-1.1b's QKV, out, gate/up and down at
    # M = 4 and a data rank's M = 2; a TP=2 and a TP=4 rank's; qwen1.5's
    # TP=2 rank; the CUDA tests' shapes
    (4, 4, 2048, (2048, 256, 256), False), (4, 4, 2048, 2048, False),
    (4, 4, 2048, 5632, True), (4, 4, 5632, 2048, False),
    (2, 4, 2048, (2048, 256, 256), False), (2, 4, 5632, 2048, False), (2, 4, 2048, 5632, True),
    (4, 4, 2048, (1024, 128, 128), False), (4, 4, 1024, 2048, False),
    (4, 4, 2048, 2816, True), (4, 4, 2816, 2048, False),
    (4, 4, 2048, (512, 64, 64), False), (4, 4, 1408, 2048, False), (4, 4, 2048, 1408, True),
    (2, 3, 1024, (512, 512, 512), False), (2, 3, 512, 1024, False),
    (2, 3, 512, (256, 128, 128), False), (2, 12, 512, 384, True), (1, 4, 200, (256, 64, 64), False),
    (3, 16, 256, 512, True), (3, 16, 5632, 2048, False), (2, 3, 64, (64, 32, 32), False),
]


@pytest.mark.parametrize("m,b,k,n,pair", MATVEC_SHAPES)
def test_matvec_plan_covers_outputs_once(m, b, k, n, pair):
    """The blocks' 128-column tiles cover each segment's columns exactly
    once per split, the splits walk k's 64-deep steps exactly once in
    order (the kernel's ranges), and a block fits its shared memory."""
    p = dl.matvec_plan(m, b, k, n, "bfloat16", pair)
    assert p.variant == "tc" and p.rows == (8 if b <= 8 else 16)
    segs = (n,) if isinstance(n, int) else n
    tiles = [math.ceil(w / p.tile) for w in segs]
    assert p.grid == (sum(tiles), p.split, m)
    for w, t in zip(segs, tiles):
        hits = np.zeros(w, np.int32)
        for i in range(t):
            hits[i * p.tile:(i + 1) * p.tile] += 1
        assert (hits == 1).all()
    steps = math.ceil(k / dl.TC_HK)
    ranges = fm.split_ranges(steps, p.split)
    assert ranges == sorted(ranges) and _covered(fm.split_ranges, steps, p.split) == [1] * steps
    assert all(b_ - a >= 1 for a, b_ in ranges)
    assert p.smem == dl.tc_smem(p.rows, math.ceil(steps / p.split), pair) <= dl.MAX_SMEM


@pytest.mark.parametrize("m,b,k,n,pair", MATVEC_SHAPES)
def test_matvec_plan_split_rule(m, b, k, n, pair):
    """A split only where 4 instances' blocks fill under half of an H100's
    SMs, each split at least 4 steps (unless 16 lanes' shared memory
    forced more), at most a cluster of 8; f32 keeps the lanes matvec, and
    17 lanes take two lane groups with the same split."""
    p = dl.matvec_plan(m, b, k, n, "bfloat16", pair)
    tiles, steps = p.grid[0], math.ceil(k / dl.TC_HK)
    assert 1 <= p.split <= min(dl.TC_MAX_SPLIT, steps)
    if p.split > 1 and dl.tc_smem(16, math.ceil(steps / (p.split - 1)), pair) <= dl.MAX_SMEM:
        assert tiles * 4 * (p.split - 1) < SMS / 2 and steps // p.split >= dl.TC_MIN_SPLIT_STEPS
    assert dl.matvec_plan(m, b, k, n, "float32", pair).variant == "simt"
    p17 = dl.matvec_plan(m, 17, k, n, "bfloat16", pair)
    assert (p17.variant, p17.groups, p17.split) == ("tc", 2, p.split)


def test_matvec_plan_serving_shapes():
    """tinyllama-1.1b at M = 4, B = 4: QKV 80 blocks and gate/up 176 run
    whole, out and down (64 tiles) split in 2; a TP=2 rank's QKV (40
    tiles) splits in 2; a 2x1 data rank (M = 2) splits out and down in 2
    as well, so its lanes' sums equal one device's at M = 4.  Every
    product takes N = 8."""
    plans = dl.layer_plans(4, 4, 2048, 32, 4, 64, 5632)
    assert {k: (p.split, p.grid) for k, p in plans.items()} == {
        "qkv": (1, (20, 1, 4)), "out": (2, (16, 2, 4)), "gate_up": (1, (44, 1, 4)),
        "down": (2, (16, 2, 4))}
    assert dl.layer_plans(4, 4, 2048, 16, 2, 64, 2816)["qkv"].split == 2
    rank = dl.layer_plans(2, 4, 2048, 32, 4, 64, 5632)
    assert rank["out"].split == rank["down"].split == 2
    assert all(p.rows == 8 for p in plans.values())
    assert dl.layer_plans(4, 4, 2048, 32, 4, 64, 5632, "float32") is None


# ---------------------------------------------------------------------------
# the tensor-map cache of the TMA kernels
# ---------------------------------------------------------------------------


def _fake_maps(limit=4096):
    calls = []

    def encode(out, ptr, dt, n0, n1, n2, b0, b1, swizzle):
        calls.append((ptr, dt, n0, n1, n2, b0, b1, swizzle))
        return 0

    return build.TensorMaps(encode=encode, limit=limit), calls


def test_tensor_maps_encode_each_weight_once():
    """The same weight, or a new view of it, hits; another box, another
    tensor or another shape at the same address encodes anew; the
    encoder gets the dtype code and the (n0, n1, n2) extents, contiguous
    last; f32 in dense boxes (the sLSTM's r) is a map of its own."""
    maps, calls = _fake_maps()
    w = torch.zeros(3, 5, 8, dtype=torch.bfloat16)
    a = maps.get(w, 64)
    assert maps.get(w, 64) == a and maps.get(w[:], 64) == a
    assert calls == [(w.data_ptr(), 1, 8, 5, 3, 64, 64, 1)] and maps.encodes == 1
    assert maps.get(w, 8) != a and maps.encodes == 2
    assert maps.get(w.view(3, 8, 5), 64) != a and maps.encodes == 3
    v = torch.zeros(5, 8, dtype=torch.bfloat16)
    maps.get(v, 64)
    assert calls[-1] == (v.data_ptr(), 1, 8, 5, 1, 64, 64, 1) and maps.encodes == 4
    r = torch.zeros(16, 64, 64)
    maps.get(r, 8, b0=8, swizzle=False)
    assert calls[-1] == (r.data_ptr(), 0, 64, 64, 16, 8, 8, 0) and maps.encodes == 5
    assert maps.get(r, 8, b0=8, swizzle=False) == maps.get(r, 8, b0=8, swizzle=False)
    assert maps.encodes == 5


def test_tensor_maps_key_reads_everything_the_encoding_does():
    """The key holds the device, pointer, shape, strides, dtype, box and
    swizzle: the fields a map encodes."""
    w = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    k = build.TensorMaps.key(w, 64)
    assert k == (torch.device("cpu"), w.data_ptr(), (2, 4, 8), (32, 8, 1), torch.bfloat16, 64,
                 64, True)
    assert build.TensorMaps.key(w, 64, 32) != k
    assert build.TensorMaps.key(w, 64, swizzle=False) != k
    assert build.TensorMaps.key(w.view(torch.float16), 64) != k
    assert build.TensorMaps.key(w[:, :2], 64) != k
    assert build.TensorMaps.key(w, 32) != k


def test_tensor_maps_refuse_what_no_map_describes_and_stay_bounded():
    maps, calls = _fake_maps(limit=2)
    with pytest.raises(ValueError):
        maps.get(torch.zeros(4, 8, 2, dtype=torch.bfloat16).transpose(1, 2), 64)
    with pytest.raises(ValueError):
        maps.get(torch.zeros(4, 8, dtype=torch.float16), 64)
    ws = [torch.zeros(2, 8, 8, dtype=torch.bfloat16) for _ in range(3)]
    for w in ws:
        maps.get(w, 64)
    assert maps.encodes == 3 and len(maps._maps) == 1
    maps.get(ws[2], 64)
    assert maps.encodes == 3


# ---------------------------------------------------------------------------
# a lane's sums never depend on who shares its call
# ---------------------------------------------------------------------------

SPLIT_M, SPLIT_B, SPLIT_SMS = (1, 2, 4, 8, 32), (1, 4, 8, 16), (66, 114, 132)


@pytest.mark.parametrize("case", [
    # (d, h, kvh, hd, ff): tinyllama-1.1b, its TP=2 rank, olmoe-1b-7b's
    # attention, hymba's, a small layer of the CUDA tests
    (2048, 32, 4, 64, 5632), (2048, 16, 2, 64, 2816), (2048, 16, 16, 128, 1024),
    (1600, 25, 5, 64, 5504), (512, 8, 2, 64, 384)])
def test_plan_splits_read_no_lane_or_sm_count(case):
    """The split counts of the decode layer's products, the chunk
    attention and the skinny merged matmul are one number per weight /
    key shape across instance counts m in {1, 2, 4, 8, 32}, lanes b in
    {1, 4, 8, 16} (the wgmma N of 8 and of 16) and SM counts {66, 114,
    132}: the order in which one output's partial sums are added cannot
    change with them.  (Earlier pins: a 2x1 data rank at M = 2 split
    tinyllama's out and down in 3 where M = 4 split them in 2.)"""
    d, h, kvh, hd, ff = case
    layer = {(m, b): {k: p.split for k, p in dl.layer_plans(m, b, d, h, kvh, hd, ff).items()}
             for m in SPLIT_M for b in SPLIT_B}
    assert len({tuple(sorted(v.items())) for v in layer.values()}) == 1, layer
    for c, s_cache in ((32, 1024), (32, 200), (8, 16)):
        splits = {cpa.launch_plan(m * b, c, h, kvh, hd, s_cache).splits
                  for m in SPLIT_M for b in SPLIT_B}
        assert len(splits) == 1, (c, s_cache, splits)
    for k, n in ((d, ff), (ff, d), (d, h * hd), (d, 1024), (1024, d)):
        splits = {fm.launch_plan(m, t, k, n, "bfloat16", sms).split
                  for m in SPLIT_M for t in SPLIT_B for sms in SPLIT_SMS}
        assert splits == {fm.skinny_split(k, n)}, (k, n, splits)


def test_matvec_plan_lanes_matvec_starts_past_16_lanes():
    """Past 16 lanes a bf16 product stays on the wgmma path, in
    ceil(b / 16) groups of at most 16 lanes (wgmma N 16) with the split
    that N 8 and N 16 share, so a lane's sums run in one order at any lane
    count; f32 keeps the lanes matvec.  For every product of tinyllama's
    layer and at b in {17, 24, 32, 64}.  (Until the lane groups, b > 16
    fell back to the lanes matvec, which sums in another order.)"""
    shape = (2048, 32, 4, 64, 5632)
    base = {k: p.split for k, p in dl.layer_plans(4, 16, *shape).items()}
    for b in (17, 24, 32, 64):
        plans = dl.layer_plans(4, b, *shape)
        assert plans is not None, b
        for name, p in plans.items():
            assert (p.variant, p.rows, p.groups) == ("tc", 16, math.ceil(b / 16)), (name, b)
            assert p.grid[1:] == (base[name], 4 * p.groups) and p.split == base[name]
        assert dl.attn_plans(4, b, 2048, 32, 4, 64) is not None
        assert dl.ffn_plans(4, b, 2048, 5632) is not None
        assert dl.matvec_plan(4, b, 2048, 2048).variant == "tc"
        assert dl.matvec_plan(4, b, 2048, 2048, "float32").variant == "simt"
        assert dl.layer_plans(4, b, *shape, dtype="float32") is None

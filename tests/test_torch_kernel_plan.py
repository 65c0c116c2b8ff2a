"""The launch plans of the merged-matmul and chunk-attention kernels, on
the CPU: pure functions of the shapes (``fused_matmul.launch_plan``,
``chunk_prefill_attn.launch_plan``) that decide the kernel variant, the
split of the reduction over blocks, the grid and the scratch.  Checked
here: the blocks cover every output element exactly once, the splits
cover the reduction exactly once, and the grid fills the card where the
shape allows it.
"""
import itertools
import math

import numpy as np
import pytest

from repro_torch.kernels import chunk_prefill_attn as cpa
from repro_torch.kernels import fused_matmul as fm

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
    stops once the blocks reach a quarter of the SMs."""
    p = fm.launch_plan(m, t, d, f, "bfloat16", SMS)
    if d % 8 or f % 8:
        assert p.variant == "simt"
    elif t <= 16:
        assert p.variant == "skinny" and p.rows == (8 if t <= 8 else 16) and p.cols == 128
        tiles, steps = m * math.ceil(f / 128), math.ceil(d / fm.HK)
        assert 1 <= p.split <= min(fm.MAX_SPLIT, steps)
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
    p = cpa.launch_plan(lanes, c, h, kvh, hd, sc, "bfloat16", SMS)
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
    """bf16: the fewest splits that make two waves of blocks, unless every
    tile has its own split already or the cluster is at its 8; f32 never
    splits."""
    p = cpa.launch_plan(lanes, c, h, kvh, hd, sc, "bfloat16", SMS)
    assert (math.prod(p.grid) >= 2 * SMS or p.splits == p.tiles
            or p.splits == cpa.MAX_SPLITS)
    if p.splits > 1:
        assert math.prod(p.grid) // p.splits * (p.splits - 1) < 2 * SMS
    assert cpa.launch_plan(lanes, c, h, kvh, hd, sc, "float32", SMS).splits == 1


def test_chunk_plan_serving_shapes():
    """tinyllama's 4-lane chunk call: 64 blocks before the split (under
    half of the 132 SMs), 320 after; hymba's: 60, then 300."""
    assert cpa.launch_plan(4, 32, 32, 4, 64, 1024).grid == (20, 4, 4)
    assert cpa.launch_plan(4, 32, 25, 5, 64, 1152).grid == (15, 5, 4)

"""K7, the depthwise 7x7 convolution: how the wrapper plans a call
(``_dw_plan``: the kernel function, the register block, the tile, the
stages, the persistent grid), on the CPU; a model of the TMA kernel's tile
walk (the blocks' ranges of tiles, the halo boxes with zeros outside x, the
warps' output boxes) against the plain version, on the CPU; and both kernel
functions against the plain version, on the card.

``tests/test_torch_vision_kernels.py`` holds the plain version against the
JAX function and its gradients. The kernels run only on the card (marker
``cuda``; without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_dwconv.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops import dwconv
from cambrian_tpu_torch.ops.dwconv import (DW_CHANNELS, DW_INSTANCES, DW_OLD, DW_STAGES,
                                           DW_TMA, DwPlan, _dw_plan)

SMS = 132
SMEM_PER_SM = 233472           # the H100's 228 KB, of which each block reserves 1 KB


def _occupancy(rows, cols, warps, tile_h, tile_w, stages, elem=2):
    """A stand-in for the card's occupancy: 128 registers a thread, and the
    shared memory a launch takes (csrc/dwconv.cu tma_smem_bytes)."""
    box = 32 * (tile_w + 6) * (tile_h + 6) * elem
    smem = 6400 + warps * rows * cols * 32 * elem + stages * (-(-box // 128) * 128)
    return min(65536 // (128 * 32 * warps), SMEM_PER_SM // (smem + 1024))


def _strides(b, h, w, c):
    return (h * w * c, w * c, c, 1)


# the depthwise convolutions of one Cambrian-8B request (ConvNeXt-XXL at 1024
# px, chip_smoke.py phase 10) and the training batch: (B, H, W, C) ->
# (rows, cols a thread, warps_h, warps_w, stages, blocks, tiles) in bf16
SITES = {
    "stage1_256x256x384": ((1, 256, 256, 384), (4, 4, 2, 4, 3, 264, 6144)),
    "stage2_128x128x768": ((1, 128, 128, 768), (4, 4, 2, 4, 3, 264, 3072)),
    "stage3_64x64x1536": ((1, 64, 64, 1536), (4, 4, 2, 4, 3, 264, 1536)),
    "stage4_32x32x3072": ((1, 32, 32, 3072), (4, 4, 2, 4, 3, 264, 768)),
    "train_b8_64x64x1536": ((8, 64, 64, 1536), (4, 4, 2, 4, 3, 264, 12288)),
}


def _block_tiles(plan, k):
    """The tiles block k takes: the kernel's [k T / G, (k + 1) T / G)."""
    return range(k * plan.tiles // plan.blocks, (k + 1) * plan.tiles // plan.blocks)


def _tile_coords(plan, t, b, h, w):
    """(channel slice, batch, tile row, tile column) of tile t, in the
    kernel's order: slice, batch, tile row, tile column."""
    tiles_h, tiles_w = -(-h // plan.tile_h), -(-w // plan.tile_w)
    per_slice = b * tiles_h * tiles_w
    slice_, r = divmod(t, per_slice)
    bi, r = divmod(r, tiles_h * tiles_w)
    ty, tx = divmod(r, tiles_w)
    return slice_, bi, ty, tx


@pytest.mark.parametrize("site", list(SITES))
def test_plan_at_the_site_shapes(site):
    (b, h, w, c), want = SITES[site]
    plan = _dw_plan(b, h, w, c, torch.bfloat16, _strides(b, h, w, c), True, SMS, _occupancy)
    assert plan == DwPlan(DW_TMA, *want)
    assert (plan.rows, plan.cols) in DW_INSTANCES and plan.stages in DW_STAGES
    assert plan.warps_h * plan.warps_w in (4, 8)
    assert plan.tiles == -(-c // DW_CHANNELS) * b * -(-h // plan.tile_h) * -(-w // plan.tile_w)
    # a persistent grid: every block resident at once, each with a tile
    fits = _occupancy(plan.rows, plan.cols, plan.warps_h * plan.warps_w, plan.tile_h,
                      plan.tile_w, plan.stages)
    assert plan.blocks <= SMS * fits and plan.blocks <= plan.tiles
    # the blocks' shares differ by at most one tile; a block's run crosses
    # at most one slice boundary (its weights load at most twice)
    shares = {len(_block_tiles(plan, k)) for k in range(plan.blocks)}
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    per_slice = plan.tiles // -(-c // DW_CHANNELS)
    for k in range(plan.blocks):
        tiles = _block_tiles(plan, k)
        assert len({t // per_slice for t in tiles}) <= 2


@pytest.mark.parametrize("shape,dtype,strides,aligned", [
    ((1, 13, 11, 90), torch.bfloat16, None, True),       # 180 bytes a position
    ((1, 13, 11, 90), torch.float32, None, True),        # 360 bytes
    ((1, 64, 64, 1536), torch.bfloat16, (64 * 64 * 1536, 1536, 64 * 1536, 1), True),
    ((1, 64, 64, 1536), torch.bfloat16, None, False),    # a base off 16 bytes
    ((1, 64, 64, 1536), torch.float16, None, True),
], ids=["c90_bf16", "c90_fp32", "transposed", "unaligned", "fp16"])
def test_plan_routes_the_rest_to_the_first_kernel(shape, dtype, strides, aligned):
    b, h, w, c = shape
    plan = _dw_plan(b, h, w, c, dtype, strides or _strides(*shape), aligned, SMS, _occupancy)
    tiles = b * -(-c // 32) * -(-h // 8) * -(-w // 16)
    assert plan == DwPlan(DW_OLD, 1, 16, 8, 1, 1, tiles, tiles)
    assert (plan.tile_h, plan.tile_w) == (8, 16)


@pytest.mark.parametrize("forced,want", [
    (dict(warps_h=2, warps_w=2), (4, 4, 2, 2, 3, 528, 3072)),
    (dict(warps_h=1, warps_w=8), (4, 4, 1, 8, 3, 264, 1536)),
    (dict(stages=2, blocks=100), (4, 4, 2, 4, 2, 100, 1536)),
    (dict(warps_h=1, warps_w=4, stages=3, blocks=300), (4, 4, 1, 4, 3, 300, 3072)),
], ids=["warps_2x2", "warps_1x8", "stages_blocks", "all"])
def test_plan_forces_settings(forced, want):
    b, h, w, c = 1, 64, 64, 1536
    plan = _dw_plan(b, h, w, c, torch.bfloat16, _strides(b, h, w, c), True, SMS, _occupancy,
                    **forced)
    assert plan == DwPlan(DW_TMA, *want)


def test_plan_without_a_shape_that_fits_takes_the_first_kernel():
    """A card on which no block shape fits an SM (occupancy 0) plans the
    first port's kernel, which needs no dynamic shared memory."""
    plan = _dw_plan(1, 64, 64, 1536, torch.bfloat16, _strides(1, 64, 64, 1536), True, SMS,
                    lambda *a: 0)
    assert plan == DwPlan(DW_OLD, 1, 16, 8, 1, 1, 48 * 8 * 4, 48 * 8 * 4)


def test_instances_match_the_source():
    """csrc/dwconv.cu instantiates dwconv7x7_tma_kernel at the register
    blocks of DW_INSTANCES, in the same order."""
    path = os.path.join(os.path.dirname(dwconv.__file__), "..", "csrc", "dwconv.cu")
    with open(path) as f:
        src = f.read()
    table = re.search(r"#define DW_TMA_INSTANCES\(X\)(.*)", src).group(1)
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", table))
    assert pairs == DW_INSTANCES


def _advance(pos, b, tiles_h, tiles_w):
    """The kernel's next tile position along a block's range: column, row,
    batch, then slice (it counts; it does not divide)."""
    sl, bi, ty, tx = pos
    tx += 1
    if tx == tiles_w:
        tx, ty = 0, ty + 1
        if ty == tiles_h:
            ty, bi = 0, bi + 1
            if bi == b:
                bi, sl = 0, sl + 1
    return sl, bi, ty, tx


def _walk_model(x, wt, bias, plan):
    """The TMA kernel's walk in plain PyTorch on the CPU: every block's
    tiles (their positions counted along the block's range, as the kernel
    counts them, and checked against the tile index), each tile's input as
    the TMA box at (c0, w0 - 3, h0 - 3, b) of 32 x (tile_w + 6) x (tile_h +
    6) with zeros at every coordinate outside x,
    the taps summed in fp32 dy outer, dx inner (as the plain version sums
    them), the bias added, and each warp's rows x cols box stored where it
    lies inside the output. Returns the output and how often each output
    element was written."""
    b, h, w, c = x.shape
    th, tw = plan.tile_h, plan.tile_w
    out = torch.zeros(x.shape, dtype=x.dtype)
    writes = torch.zeros(x.shape, dtype=torch.int32)
    w32, b32 = wt.float(), bias.float()
    hs, ws, cs = (torch.arange(n) for n in (th + 6, tw + 6, DW_CHANNELS))
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    for k in range(plan.blocks):
        pos = _tile_coords(plan, _block_tiles(plan, k)[0], b, h, w)
        for t in _block_tiles(plan, k):
            assert pos == _tile_coords(plan, t, b, h, w)
            sl, bi, ty, tx = pos
            pos = _advance(pos, b, tiles_h, tiles_w)
            c0, h0, w0 = sl * DW_CHANNELS, ty * th, tx * tw
            # the box: coordinates, and zeros at those outside x
            hh, ww, cc = hs + h0 - 3, ws + w0 - 3, cs + c0
            inside = (((hh >= 0) & (hh < h))[:, None, None] & ((ww >= 0) & (ww < w))[None, :, None]
                      & (cc < c)[None, None, :])
            box = torch.zeros((th + 6, tw + 6, DW_CHANNELS))
            gathered = x[bi][hh.clamp(0, h - 1)][:, ww.clamp(0, w - 1)][:, :, cc.clamp(0, c - 1)]
            box[inside] = gathered.float()[inside]
            assert int(inside.sum()) == (
                int(((hh >= 0) & (hh < h)).sum()) * int(((ww >= 0) & (ww < w)).sum())
                * int((cc < c).sum()))
            wk = torch.zeros((7, 7, DW_CHANNELS))
            bk = torch.zeros(DW_CHANNELS)
            live = cc < c
            wk[:, :, live] = w32[:, :, cc[live]]
            bk[live] = b32[cc[live]]
            acc = torch.zeros((th, tw, DW_CHANNELS))
            for dy in range(7):
                for dx in range(7):
                    acc = acc + box[dy:dy + th, dx:dx + tw] * wk[dy, dx]
            tile = (acc + bk).to(x.dtype)
            # each warp's output box, clipped to the tensor as TMA clips it
            for wr in range(plan.warps_h):
                for wc in range(plan.warps_w):
                    r0, o0 = h0 + wr * plan.rows, w0 + wc * plan.cols
                    rs = slice(r0, min(r0 + plan.rows, h))
                    os_ = slice(o0, min(o0 + plan.cols, w))
                    cl = slice(c0, min(c0 + DW_CHANNELS, c))
                    n_r, n_o, n_c = rs.stop - rs.start, os_.stop - os_.start, cl.stop - cl.start
                    if n_r <= 0 or n_o <= 0 or n_c <= 0:
                        continue
                    part = tile[wr * plan.rows:wr * plan.rows + n_r,
                                wc * plan.cols:wc * plan.cols + n_o, :n_c]
                    out[bi, rs, os_, cl] = part
                    writes[bi, rs, os_, cl] += 1
    return out, writes


@pytest.mark.parametrize("shape,dtype,forced", [
    ((2, 13, 19, 40), torch.float32, dict(warps_h=2, warps_w=4)),
    ((1, 21, 37, 72), torch.bfloat16, dict(warps_h=4, warps_w=1)),
    ((3, 9, 10, 24), torch.bfloat16, dict(warps_h=1, warps_w=8, blocks=5)),
    ((1, 30, 23, 104), torch.float32, dict()),
], ids=["fp32_2x13x19x40", "bf16_21x37x72", "bf16_b3_blocks5", "fp32_planned"])
def test_tile_walk_covers_every_output_once(shape, dtype, forced):
    """H, W and C divide none of the tiles: every output is written exactly
    once, and the walk gives the plain version's result bit for bit."""
    b, h, w, c = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    wt = torch.from_numpy(rng.standard_normal((7, 7, c)).astype(np.float32) * 0.2)
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    plan = _dw_plan(b, h, w, c, dtype, _strides(*shape), True, SMS, _occupancy, **forced)
    assert plan.function == DW_TMA
    assert h % plan.tile_h or w % plan.tile_w or c % DW_CHANNELS
    out, writes = _walk_model(x, wt, bias, plan)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(out, dwconv.depthwise_conv7x7_reference(x, wt, bias))


def test_wrapper_on_a_permuted_bf16_weight_view():
    """The ConvNeXt weight [C, 1, 7, 7] read in place as [7, 7, C] (bf16, a
    channel stride of 49) gives what a contiguous fp32 copy gives, and the
    kernel's operands take it and the bias in place, without a copy."""
    rng = np.random.default_rng(3)
    c = 48
    x = torch.from_numpy(rng.standard_normal((1, 11, 9, c)).astype(np.float32)).bfloat16()
    conv_w = torch.from_numpy(rng.standard_normal((c, 1, 7, 7)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).bfloat16()
    view = conv_w[:, 0].permute(1, 2, 0)
    assert view.stride() == (7, 1, 49)
    got = dwconv.depthwise_conv7x7(x, view, bias)
    want = dwconv.depthwise_conv7x7(x, view.float().contiguous(), bias.float())
    assert torch.equal(got, want)
    for t in (view, bias, view.float()):
        p = dwconv._param(t)
        assert p.data_ptr() == t.data_ptr() and p.stride() == t.stride() and p.dtype == t.dtype
    half = view.half()
    assert dwconv._param(half).dtype == torch.float32


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(device, shape, dtype, seed=0):
    """bf16 or fp32 x, a ConvNeXt-style bf16 weight view and bias, made with
    numpy from a seed, and the plain version on the fp32-upcast inputs."""
    rng = np.random.default_rng(seed + sum(shape))
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
    conv_w = torch.from_numpy(rng.standard_normal((c, 1, 7, 7)).astype(np.float32) * 0.2)
    w = conv_w.to(device, torch.bfloat16)[:, 0].permute(1, 2, 0)
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(device, torch.bfloat16)
    want = dwconv.depthwise_conv7x7_reference(x.float(), w.float(), bias.float())
    return x, w, bias, want


def _held(out, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-4) * max(1.0, float(want.abs().max()))
    err = float((out.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


# settings forced on the card: three block shapes, every stage count
FORCED = [dict(warps_h=warps_h, warps_w=warps_w, stages=stages)
          for warps_h, warps_w in ((2, 4), (4, 2), (1, 4)) for stages in DW_STAGES]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 32, 32, 3072), (2, 13, 19, 40), (1, 37, 70, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_forced_settings_match_plain_on_card(cuda_device, dtype, shape):
    """Every forced setting whose blocks fit an SM runs the TMA kernel and
    matches plain; one that does not fit would plan the first port's
    kernel."""
    x, w, bias, want = _card_case(cuda_device, shape, dtype)
    code = 1 if dtype == torch.bfloat16 else 0
    (rows, cols), = DW_INSTANCES
    ran = 0
    for forced in FORCED:
        fits = dwconv._occupancy(cuda_device, code, rows, cols,
                                 forced["warps_h"] * forced["warps_w"],
                                 rows * forced["warps_h"], cols * forced["warps_w"],
                                 forced["stages"])
        plan = _dw_plan(*shape, dtype, x.stride(), True, dwconv._sms(cuda_device),
                        lambda *a: dwconv._occupancy(cuda_device, code, *a), **forced)
        assert plan.function == (DW_TMA if fits else DW_OLD), (forced, fits)
        if fits:
            _held(dwconv._dwconv_kernel(x, w, bias, plan), want, dtype)
            ran += 1
    assert ran >= len(FORCED) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["transposed", "unaligned", "forced"])
def test_first_kernel_route_on_card(cuda_device, case):
    shape = (1, 30, 41, 64)
    x, w, bias, want = _card_case(cuda_device, shape, torch.bfloat16)
    route = None
    if case == "transposed":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "unaligned":
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        x = store[1:].view(shape).copy_(x)
    else:
        route = DW_OLD
    counts = dwconv.depthwise_conv7x7.function_launches
    before = counts.get(DW_OLD, 0)
    out = dwconv._dwconv_kernel(x, w, bias, route)
    assert counts.get(DW_OLD, 0) == before + 1
    _held(out, want, torch.bfloat16)


@pytest.mark.cuda
def test_permuted_bf16_weight_matches_contiguous_fp32_on_card(cuda_device):
    x, w, bias, _ = _card_case(cuda_device, (1, 64, 64, 1536), torch.bfloat16)
    got = dwconv.depthwise_conv7x7(x, w, bias)
    want = dwconv.depthwise_conv7x7(x, w.float().contiguous(), bias.float())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_c_entry_refuses_more_blocks_than_tiles(cuda_device):
    shape = (1, 16, 16, 64)
    x, w, bias, _ = _card_case(cuda_device, shape, torch.bfloat16)
    plan = _dw_plan(*shape, torch.bfloat16, x.stride(), True, dwconv._sms(cuda_device),
                    lambda *a: dwconv._occupancy(cuda_device, 1, *a))
    with pytest.raises(RuntimeError, match="launch failed"):
        dwconv._dwconv_kernel(x, w, bias, plan._replace(blocks=plan.tiles + 1))

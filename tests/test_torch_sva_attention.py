"""K5, the SVA windowed cross-attention: how the wrapper plans a call
(``_sva_plan``: the kernel function, the lanes a key row, the heads a unit,
the ring's stages, the persistent grid and its balance), on the CPU; a model
of the TMA kernel's split and order (the blocks' units, the lane groups, the
per-group dot products, the reductions over the groups) against the plain
version, on the CPU; and both kernel functions against the plain version,
on the card.

``tests/test_torch_vision_kernels.py`` holds the plain version against the
JAX function and its gradients. The kernels run only on the card (marker
``cuda``; without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_sva_attention.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops import sva_attention
from cambrian_tpu_torch.ops.attention import NEG_INF
from cambrian_tpu_torch.ops.sva_attention import (SVA_INSTANCES, SVA_LANES, SVA_OLD, SVA_SHARE,
                                                  SVA_STAGES, SVA_TMA, SvaPlan, _sva_plan)

SMS = 132
SMEM_PER_SM = 233472           # the H100's 228 KB, of which each block reserves 1 KB


def _occupancy(lanes, window, heads, w, d, stages, elem=2):
    """A stand-in for the card's occupancy: 96 registers a thread (the 8B
    site's instance takes 88), 32 blocks and 64 warps an SM, and the shared
    memory a launch takes (csrc/sva_attention.cu tma_layout)."""
    smem = sva_attention.sva_smem_bytes(heads, w, d, elem, stages)
    threads = (heads + 1) * 32
    return min(32, 2048 // threads, 65536 // (96 * threads), SMEM_PER_SM // (smem + 1024))


def _occupancy_of(elem):
    return lambda *a: _occupancy(*a, elem=elem)


def _strides(b, n_q, w, h, d):
    """Contiguous q [b, n_q, h, d] and k, v [b, n_q, w, h, d]."""
    kv = (n_q * w * h * d, w * h * d, h * d, d, 1)
    return (n_q * h * d, h * d, d, 1), kv, kv


def _block_units(plan, k):
    """The units block k takes: the kernel's [k U / G, (k + 1) U / G)."""
    return range(k * plan.units // plan.blocks, (k + 1) * plan.units // plan.blocks)


# (B, Q, W, H, D) of the 8B site (connector and decoder alike, 13 calls a
# request) and its training batch -> (lanes, heads, stages, blocks_per_sm,
# blocks, units) in bf16
SITES = {
    "8b_site": ((1, 576, 19, 16, 64), (8, 4, 2, 3, 396, 2304)),
    "train_b8": ((8, 576, 19, 16, 64), (8, 4, 2, 4, 528, 18432)),
}


@pytest.mark.parametrize("site", list(SITES))
def test_plan_at_the_site_shapes(site):
    (b, n_q, w, h, d), want = SITES[site]
    plan = _sva_plan(b, n_q, h, w, d, torch.bfloat16, _strides(b, n_q, w, h, d), True, SMS,
                     _occupancy)
    assert plan.function == SVA_TMA
    assert (plan.lanes, plan.heads, plan.stages, plan.blocks_per_sm, plan.blocks,
            plan.units) == want
    assert plan.lanes in SVA_LANES and plan.stages in SVA_STAGES
    # a unit is one query and `heads` heads, within TMA's 256-element box side
    assert plan.units == b * n_q * h // plan.heads and plan.heads * d <= 256
    # a persistent grid: every block resident at once, within the SMs
    assert plan.blocks == plan.blocks_per_sm * SMS
    assert plan.window == 32 and plan.window >= w
    assert plan.blocks_per_sm <= _occupancy(plan.lanes, plan.window, plan.heads, w, d,
                                            plan.stages)
    # the busiest SM (its blocks, each with the largest share) takes at most
    # 6% more units than the mean, as the plan states
    shares = [len(_block_units(plan, k)) for k in range(plan.blocks)]
    assert sum(shares) == plan.units and max(shares) - min(shares) <= 1
    busiest = plan.blocks_per_sm * max(shares)
    assert plan.share == pytest.approx(busiest / (plan.units / SMS))
    assert plan.share <= SVA_SHARE
    # at least 32 KB in flight an SM while it computes
    unit_bytes = (1 + 2 * w) * plan.heads * d * 2
    assert plan.in_flight == plan.blocks_per_sm * (plan.stages - 1) * unit_bytes
    assert plan.in_flight >= 32 << 10


@pytest.mark.parametrize("d,dtype,lanes", [
    (64, torch.bfloat16, 8), (72, torch.bfloat16, 16), (128, torch.bfloat16, 16),
    (32, torch.bfloat16, 8), (64, torch.float32, 16), (72, torch.float32, 32),
    (128, torch.float32, 32), (16, torch.float32, 8),
], ids=lambda v: str(v).replace("torch.", ""))
def test_plan_rounds_lanes_up_to_a_power_of_two(d, dtype, lanes):
    """A key row's 16-byte pieces, a lane each, rounded up to a power of two
    of at least 8: where the pieces do not divide 32 (9 at bf16 D = 72, 18 at
    fp32 D = 72) the spare lanes idle; the TMA kernel takes those cases, and
    no case goes to the first port's kernel for its lane count."""
    b, n_q, w, h = 2, 70, 19, 3
    elem = 2 if dtype == torch.bfloat16 else 4
    plan = _sva_plan(b, n_q, h, w, d, dtype, _strides(b, n_q, w, h, d), True, SMS,
                     _occupancy_of(elem))
    assert plan.function == SVA_TMA and plan.lanes == lanes
    assert d * elem // 16 <= lanes


def _transposed(b, n_q, w, h, d):
    """k as a [b, n_q, w, h, d] view of [b, n_q, h, w, d] storage."""
    return (n_q * w * h * d, w * h * d, d, w * d, 1)


@pytest.mark.parametrize("case", ["k_heads_apart", "v_heads_apart", "k_rows_padded",
                                  "q_rows_padded_odd", "q_batch_gap", "unaligned", "d_bf16_60",
                                  "d_fp32_6", "fp16"])
def test_plan_routes_the_rest_to_the_first_kernel(case):
    b, n_q, w, h, d = 2, 64, 19, 4, 64
    dtype, aligned = torch.bfloat16, True
    q_s, k_s, v_s = _strides(b, n_q, w, h, d)
    if case == "k_heads_apart":
        k_s = _transposed(b, n_q, w, h, d)
    elif case == "v_heads_apart":
        v_s = _transposed(b, n_q, w, h, d)
    elif case == "k_rows_padded":
        # key rows of h d + 8 elements: the window is not one dense block
        r = h * d + 8
        k_s = (n_q * w * r, w * r, r, d, 1)
    elif case == "q_rows_padded_odd":
        # q rows of h d + 3 elements: 518 bytes, not a multiple of 16
        r = h * d + 3
        q_s = (n_q * r, r, d, 1)
    elif case == "q_batch_gap":
        # q's batches not one row stride apart from its queries
        q_s = (n_q * h * d + 8, h * d, d, 1)
    elif case == "unaligned":
        aligned = False
    elif case == "d_bf16_60":
        d = 60                         # 120 bytes a row
        q_s, k_s, v_s = _strides(b, n_q, w, h, d)
    elif case == "d_fp32_6":
        d, dtype = 6, torch.float32    # 24 bytes a row
        q_s, k_s, v_s = _strides(b, n_q, w, h, d)
    else:
        dtype = torch.float16
    plan = _sva_plan(b, n_q, h, w, d, dtype, (q_s, k_s, v_s), aligned, SMS, _occupancy)
    items = b * n_q * h
    assert plan == SvaPlan(SVA_OLD, 32, 64, 1, 1, 0, -(-items // 4), items, 0.0, 0)


def test_plan_takes_padded_q_rows_and_any_stride_of_a_single_batch():
    """q rows padded to a 16-byte multiple (q sliced from a wider
    projection) make one row stride, and an axis of size 1 may have any
    stride: the TMA kernel."""
    b, n_q, w, h, d = 1, 64, 19, 4, 64
    _, k_s, v_s = _strides(b, n_q, w, h, d)
    r = 3 * h * d
    q_s = (n_q * r, r, d, 1)
    k_s = (12345,) + k_s[1:]           # B = 1: its stride is never walked
    plan = _sva_plan(b, n_q, h, w, d, torch.bfloat16, (q_s, k_s, v_s), True, SMS, _occupancy)
    assert plan.function == SVA_TMA
    assert sva_attention._tma_rows(b, n_q, h, w, d, 2, (q_s, k_s, v_s)) == (r, h * d, h * d)


@pytest.mark.parametrize("w,d", [(65, 64), (19, 136)])
def test_plan_raises_past_the_limits(w, d):
    """W > 64 and D > 128 raise on either route, as the wrapper always did."""
    b, n_q, h = 1, 8, 2
    with pytest.raises(ValueError, match="keys a window and head_dim"):
        _sva_plan(b, n_q, h, w, d, torch.bfloat16, _strides(b, n_q, w, h, d), True, SMS,
                  _occupancy)
    with pytest.raises(ValueError, match="keys a window and head_dim"):
        sva_attention._sva_old_plan(b, n_q, h, w, d)


@pytest.mark.parametrize("forced,want", [
    (dict(heads=2), (8, 2, 2, 7, 924, 4608)),
    (dict(heads=1, stages=2), (8, 1, 2, 10, 1320, 9216)),
    (dict(stages=4, blocks_per_sm=2), (8, 4, 4, 2, 264, 2304)),
    (dict(heads=4, stages=2, blocks_per_sm=1), (8, 4, 2, 1, 132, 2304)),
], ids=["heads2", "heads1_stages2", "stages4_bps2", "all"])
def test_plan_forces_settings(forced, want):
    b, n_q, w, h, d = 1, 576, 19, 16, 64
    plan = _sva_plan(b, n_q, h, w, d, torch.bfloat16, _strides(b, n_q, w, h, d), True, SMS,
                     _occupancy, **forced)
    assert plan.function == SVA_TMA
    assert (plan.lanes, plan.heads, plan.stages, plan.blocks_per_sm, plan.blocks,
            plan.units) == want


@pytest.mark.parametrize("forced", [dict(heads=3), dict(heads=16), dict(blocks_per_sm=99)],
                         ids=["heads_not_dividing", "heads_past_the_box", "blocks_past_the_sm"])
def test_forced_settings_that_cannot_run_take_the_first_kernel(forced):
    b, n_q, w, h, d = 1, 576, 19, 16, 64
    plan = _sva_plan(b, n_q, h, w, d, torch.bfloat16, _strides(b, n_q, w, h, d), True, SMS,
                     _occupancy, **forced)
    assert plan.function == SVA_OLD


def test_instances_match_the_source():
    """csrc/sva_attention.cu lists the (lanes, window class) pairs of
    SVA_INSTANCES, in the same order, and every lane count and class the
    plan gives is among them, within the 8 x element size lanes its dtype
    is built at."""
    path = os.path.join(os.path.dirname(sva_attention.__file__), "..", "csrc",
                        "sva_attention.cu")
    with open(path) as f:
        src = f.read()
    table = re.search(r"#define SVA_TMA_INSTANCES\(X\)(.*)", src).group(1)
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", table))
    assert pairs == SVA_INSTANCES
    for d, elem in ((8, 2), (64, 2), (72, 2), (128, 2), (4, 4), (64, 4), (72, 4), (128, 4)):
        for w in (1, 19, 32, 33, 64):
            plan = _sva_plan(1, 8, 2, w, d, torch.bfloat16 if elem == 2 else torch.float32,
                             _strides(1, 8, w, 2, d), True, SMS, _occupancy_of(elem))
            assert plan.function == SVA_TMA and (plan.lanes, plan.window) in SVA_INSTANCES
            assert plan.lanes <= 8 * elem


# -- a model of the TMA kernel's split and order -----------------------------------

def _butterfly(x, dim, offsets, op):
    """Each index i of ``dim`` combined with i ^ off, for off in ``offsets``
    in turn: the kernel's xor shuffles."""
    idx = torch.arange(x.shape[dim])
    for off in offsets:
        x = op(x, x.index_select(dim, idx ^ off))
    return x


def _kernel_model(q, k, v, mask, scale, plan, elem):
    """The TMA kernel's arithmetic on fp32 q [B, Q, H, D], k, v [B, Q, W, H,
    D] in plain PyTorch, split and ordered as the kernel splits and orders
    it for an element of ``elem`` bytes: units of a query and plan.heads
    heads, walked block by block; lanes in groups of plan.lanes, a lane a
    16-byte piece of a row (elem-byte elements), a group a key a pass; each
    lane's products over its piece, then the xor shuffles within the group;
    the max and the sum over a lane's passes, then across the groups; each
    lane's PV over its group's keys, then the xor shuffles across the
    groups, and group 0's sums times 1 / sum. Returns the output and how
    often each (b, q, h) was computed."""
    b, n_q, h, d = q.shape
    w = k.shape[2]
    lr, e_n = plan.lanes, 16 // elem
    kp = 32 // lr
    chunks = d * elem // 16
    passes = -(-w // kp)
    groups = h // plan.heads
    # the blocks' units, in the kernel's order: each (b, q, h) once
    seen = torch.zeros((b * n_q, h), dtype=torch.int32)
    for blk in range(plan.blocks):
        for u in _block_units(plan, blk):
            row, g0 = divmod(u, groups)
            seen[row, g0 * plan.heads:(g0 + 1) * plan.heads] += 1
    # pieces: [..., lane in group, element], spare lanes hold zeros
    def pieces(t):
        t = t.reshape(*t.shape[:-1], chunks, e_n)
        pad = torch.zeros((*t.shape[:-2], lr - chunks, e_n))
        return torch.cat([t, pad], -2)

    qp = pieces(q)                                       # [B, Q, H, LR, E]
    kp_, vp = pieces(k), pieces(v)                       # [B, Q, W, H, LR, E]
    if mask is None:
        keep = torch.ones((b, n_q, h, w), dtype=torch.bool)
    else:
        keep = mask[:, :, None, :] if mask.dim() == 3 else mask
        keep = keep.expand(b, n_q, h, w)
    logit = torch.full((b, n_q, h, passes, kp), -float("inf"))
    for p in range(passes):
        for g in range(kp):
            wi = p * kp + g
            if wi >= w:
                continue
            part = torch.zeros((b, n_q, h, lr))
            for e in range(e_n):
                part = part + qp[..., e] * kp_[:, :, wi, :, :, e]
            part = _butterfly(part, -1, [lr >> s for s in range(1, lr.bit_length())],
                              torch.add)
            assert torch.equal(part, part[..., :1].expand_as(part))   # one value a group
            logit[..., p, g] = torch.where(keep[..., wi], part[..., 0] * scale,
                                           torch.tensor(NEG_INF))
    mx = logit[..., 0, :]
    for p in range(1, passes):
        mx = torch.maximum(mx, logit[..., p, :])
    mx = _butterfly(mx, -1, [1 << s for s in range(kp.bit_length() - 1)], torch.maximum)
    ex = torch.exp(logit - mx[..., None, :])
    total = torch.zeros((b, n_q, h, kp))
    for p in range(passes):
        total = total + ex[..., p, :]
    total = _butterfly(total, -1, [1 << s for s in range(kp.bit_length() - 1)], torch.add)
    acc = torch.zeros((b, n_q, h, kp, lr, e_n))
    for p in range(passes):
        for g in range(kp):
            wi = p * kp + g
            if wi < w:
                acc[..., g, :, :] = acc[..., g, :, :] + ex[..., p, g, None, None] * vp[:, :, wi]
    acc = _butterfly(acc, -3, [1 << s for s in range(kp.bit_length() - 1)], torch.add)
    out = acc[..., 0, :chunks, :] * (1.0 / total[..., 0])[..., None, None]
    return out.reshape(b, n_q, h, d), seen.reshape(b, n_q, h)


def _inputs(seed, b, n_q, w, h, d, kind):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, n_q, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, n_q, w, h, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, n_q, w, h, d)).astype(np.float32))
    mask = None
    if kind == "3d":
        mask = torch.from_numpy(rng.random((b, n_q, w)) > 0.3)
    elif kind == "4d":
        mask = torch.from_numpy(rng.random((b, n_q, h, w)) > 0.3)
    elif kind == "dead":
        mask = torch.from_numpy(rng.random((b, n_q, w)) > 0.3)
        mask[:, ::7] = False            # every 7th query sees no key: uniform weights
    return q, k, v, mask


# (B, Q, W, H, D, mask, element bytes of the split): W of 19, 22 and 64, none
# a multiple of the keys a warp takes but 64; D of 64, 72 and 128; every mask
# kind; the bf16 split (2-byte pieces) and the fp32 split
MODEL_CASES = [
    (1, 40, 19, 16, 64, "3d", 2), (2, 23, 22, 3, 72, "4d", 2), (1, 17, 64, 2, 128, "dead", 2),
    (2, 30, 19, 4, 64, "none", 4), (1, 21, 22, 6, 72, "dead", 4),
    (2, 9, 64, 3, 128, "3d", 4), (1, 13, 19, 8, 128, "4d", 2), (3, 11, 21, 2, 72, "none", 2),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_model_covers_every_head_once_and_matches_plain(case):
    b, n_q, w, h, d, kind, elem = case
    q, k, v, mask = _inputs(sum(case[:5]), b, n_q, w, h, d, kind)
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    plan = _sva_plan(b, n_q, h, w, d, dtype, _strides(b, n_q, w, h, d), True, SMS,
                     _occupancy_of(elem))
    assert plan.function == SVA_TMA
    scale = d ** -0.5
    out, seen = _kernel_model(q, k, v, mask, scale, plan, elem)
    assert torch.equal(seen, torch.ones_like(seen))
    want = sva_attention.fused_windowed_cross_attention_reference(q, k, v, mask, scale)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    if kind == "dead":
        np.testing.assert_allclose(out[:, ::7].numpy(), v[:, ::7].mean(2).numpy(), atol=1e-5)


@pytest.mark.parametrize("d,elem", [(64, 2), (72, 2), (128, 2), (32, 2), (64, 4), (72, 4),
                                    (128, 4), (16, 4)])
@pytest.mark.parametrize("w", [19, 64])
def test_shared_reads_are_free_of_bank_conflicts(d, elem, w):
    """Every quarter warp's 16-byte shared-memory reads of a pass (a K or V
    row piece a lane, at the kernel's offsets in a stage: key w's row at w x
    heads x D x elem bytes, rows past W clamped to W - 1, warp j's head at j x
    D x elem, a spare lane's piece clamped to the last) touch each 16-byte
    bank group at one address at most (lanes on one address share it), at
    every warp of the unit and every head count the plan may give."""
    lr = max(8, 1 << (d * elem // 16 - 1).bit_length())
    assert lr in SVA_LANES
    pieces, kp = d * elem // 16, 32 // lr
    for heads in (1, 2, 3, 4, 8):
        if heads * d > 256:
            continue
        pitch = heads * d * elem
        for warp in range(heads):
            for p in range(-(-w // kp)):
                for quarter in range(4):
                    banks = {}
                    for lane in range(8 * quarter, 8 * quarter + 8):
                        grp, sub = divmod(lane, lr)
                        key = min(p * kp + grp, w - 1)
                        addr = key * pitch + warp * d * elem + min(sub, pieces - 1) * 16
                        banks.setdefault(addr // 16 % 8, set()).add(addr)
                    assert all(len(a) == 1 for a in banks.values()), (heads, warp, p, quarter)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(device, b, n_q, w, h, d, kind, dtype):
    q, k, v, mask = _inputs(b + n_q + w + h + d, b, n_q, w, h, d, kind)
    q, k, v = (t.to(device, dtype) for t in (q, k, v))
    mask = None if mask is None else mask.to(device)
    want = sva_attention.fused_windowed_cross_attention_reference(
        q.float(), k.float(), v.float(), mask)
    return q, k, v, mask, want


def _held(out, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-4) * max(1.0, float(want.abs().max()))
    err = float((out.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


def _card_plan(device, q, k, v, **forced):
    b, n_q, h, d = q.shape
    code = 1 if q.dtype == torch.bfloat16 else 0
    return _sva_plan(b, n_q, h, k.shape[2], d, q.dtype, (q.stride(), k.stride(), v.stride()),
                     True, sva_attention._sms(device),
                     lambda *a: sva_attention._occupancy(device, code, *a), **forced)


FORCED = [dict(heads=heads, stages=stages, blocks_per_sm=bps)
          for heads in (1, 2, 4) for stages in (2, 4) for bps in (1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_forced_settings_match_plain_on_card(cuda_device, dtype):
    """The 8B site's shape under every forced unit, stage count and blocks
    an SM that fits: the TMA kernel, within tolerance of plain."""
    q, k, v, mask, want = _card_case(cuda_device, 1, 576, 19, 16, 64, "3d", dtype)
    counts = sva_attention.fused_windowed_cross_attention.function_launches
    ran = 0
    for forced in FORCED:
        plan = _card_plan(cuda_device, q, k, v, **forced)
        if plan.function != SVA_TMA:
            continue
        before = counts.get(SVA_TMA, 0)
        _held(sva_attention._sva_kernel(q, k, v, mask, 64 ** -0.5, plan), want, dtype)
        assert counts[SVA_TMA] == before + 1
        ran += 1
    assert ran >= len(FORCED) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["transposed", "unaligned", "forced", "fp32_d72"])
def test_routes_on_card(cuda_device, case):
    """Operands a tensor map cannot address, and the old route forced, run
    the first port's kernel; fp32 at D = 72 (18 pieces a row, 32 lanes) runs
    the TMA kernel. Each within tolerance of plain."""
    dtype, d, route, want_fn = torch.bfloat16, 64, None, SVA_OLD
    if case == "fp32_d72":
        dtype, d, want_fn = torch.float32, 72, SVA_TMA
    q, k, v, mask, want = _card_case(cuda_device, 2, 70, 22, 3, d, "4d", dtype)
    if case == "transposed":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "unaligned":
        store = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
        q = store[1:].view(q.shape).copy_(q)
    elif case == "forced":
        route = SVA_OLD
    counts = sva_attention.fused_windowed_cross_attention.function_launches
    before = counts.get(want_fn, 0)
    out = sva_attention._sva_kernel(q, k, v, mask, d ** -0.5, route)
    assert counts.get(want_fn, 0) == before + 1
    _held(out, want, dtype)


@pytest.mark.cuda
def test_mask_views_are_read_in_place_on_card(cuda_device):
    """A [B, Q, W] mask sliced from a wider one and a [B, Q, H, W] mask
    broadcast along H (stride 0) give what their contiguous copies give."""
    q, k, v, _, _ = _card_case(cuda_device, 1, 576, 19, 16, 64, "none", torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    wide = torch.rand((1, 576, 38), generator=g, device=cuda_device) > 0.3
    sliced = wide[:, :, ::2]
    broadcast = sliced[:, :, None, :].expand(1, 576, 16, 19)
    fn = sva_attention.fused_windowed_cross_attention
    for m in (sliced, broadcast):
        got = fn(q, k, v, m)
        torch.cuda.synchronize()
        assert torch.equal(got, fn(q, k, v, m.contiguous()))


@pytest.mark.cuda
def test_c_entry_refuses_what_the_kernel_cannot_take(cuda_device):
    """A plan the kernel cannot run (heads that do not divide H, more blocks
    than units) is refused and raises; the next launch runs."""
    q, k, v, mask, want = _card_case(cuda_device, 1, 64, 19, 16, 64, "3d", torch.bfloat16)
    plan = _card_plan(cuda_device, q, k, v)
    for bad in (plan._replace(heads=3), plan._replace(blocks=plan.units + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            sva_attention._sva_kernel(q, k, v, mask, 64 ** -0.5, bad)
    _held(sva_attention._sva_kernel(q, k, v, mask, 64 ** -0.5, plan), want, torch.bfloat16)

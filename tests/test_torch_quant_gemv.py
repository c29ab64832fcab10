"""The bf16 decode GEMV of K3 (int8), K4 (int4) and K4b/K4c (int4, scale on
the weights) at M = 1 (``gemv_m1_kernel``) and M = 2..8 (``gemv_m8_kernel``,
the continuous-batching decode): how the wrapper plans a call
(``_gemv_plan``: the route, the slab, the cluster, the K split), a model of
mode 2's dequantization bit by bit, and a model of ``gemv_m8_kernel``
register by register, on the CPU; both kernels against the plain version,
on the card.

``tests/test_torch_quant.py`` holds the plain versions against the JAX
functions and the Pallas kernels, and the first port's kernels on the card.
The kernels run only on the card (marker ``cuda``; without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_quant_gemv.py``).
"""

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops import quant
from cambrian_tpu_torch.ops.quant import (GEMV_CLUSTERS, GEMV_MAX_WARPS, GemvPlan, _gemv_fits,
                                          _gemv_plan, _gemv_route)

BF16 = torch.bfloat16
INT8, INT4, INT4_SOW = 0, 1, 2

# the decoder projections of LLaMA-3-8B, (K, N), and each one's plan by mode:
# (slab, cluster, warps, rows a block, rows a warp) in stored rows (int4: K/2);
# mode 2 takes 128-byte slabs (its m16n8k16 products span 8 lanes' columns)
SHAPES = {
    "q_proj": ((4096, 4096), {INT8: (64, 8, 4, 512, 128), INT4: (64, 4, 4, 512, 128),
                              INT4_SOW: (128, 8, 4, 256, 64)}),
    "k_proj": ((4096, 1024), {INT8: (64, 8, 4, 512, 128), INT4: (64, 8, 4, 256, 64),
                              INT4_SOW: (128, 8, 4, 256, 64)}),
    "v_proj": ((4096, 1024), {INT8: (64, 8, 4, 512, 128), INT4: (64, 8, 4, 256, 64),
                              INT4_SOW: (128, 8, 4, 256, 64)}),
    "o_proj": ((4096, 4096), {INT8: (64, 8, 4, 512, 128), INT4: (64, 4, 4, 512, 128),
                              INT4_SOW: (128, 8, 4, 256, 64)}),
    "gate_proj": ((4096, 14336), {INT8: (128, 4, 4, 1024, 256), INT4: (128, 4, 4, 512, 128),
                                  INT4_SOW: (128, 4, 4, 512, 128)}),
    "up_proj": ((4096, 14336), {INT8: (128, 4, 4, 1024, 256), INT4: (128, 4, 4, 512, 128),
                                INT4_SOW: (128, 4, 4, 512, 128)}),
    "down_proj": ((14336, 4096), {INT8: (64, 8, 4, 1792, 448), INT4: (64, 4, 4, 1792, 448),
                                  INT4_SOW: (128, 4, 4, 1792, 448)}),
}
# blocks on the card (slabs x cluster) for each plan above
BLOCKS = {"q_proj": (512, 256, 256), "k_proj": (128, 128, 64), "v_proj": (128, 128, 64),
          "o_proj": (512, 256, 256), "gate_proj": (448, 448, 448), "up_proj": (448, 448, 448),
          "down_proj": (512, 256, 128)}
MODES = [INT8, INT4, INT4_SOW]
MODE_IDS = ["int8", "int4", "int4_sow"]


def _rows(mode, k):
    return k if mode == INT8 else k // 2


def _group(mode, k):
    return 1 if mode == INT8 else quant.int4_group(k)


def _plan_of(mode, k, n, group=None, m=1, **kw):
    group = _group(mode, k) if group is None else group
    return _gemv_plan(mode, BF16, m, n, k, group, 0, 0, **kw)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("site", list(SHAPES))
def test_plan_at_the_8b_shapes(site, mode):
    (k, n), plans = SHAPES[site]
    plan = _plan_of(mode, k, n)
    assert plan == GemvPlan(*plans[mode])
    blocks = -(-n // plan.slab) * plan.cluster
    assert blocks == BLOCKS[site][mode]
    rows = _rows(mode, k)
    # the blocks of a cluster split all of K, each its own share
    assert (plan.cluster - 1) * plan.rows_per_block < rows <= plan.cluster * plan.rows_per_block
    # two blocks an SM where N and K allow it; no block below 32 KB unless
    # that would leave an SM without one
    per_block = rows * plan.slab // plan.cluster
    larger = None if plan.cluster == 8 else _plan_of(mode, k, n, slab=plan.slab,
                                                      cluster=2 * plan.cluster)
    assert (blocks >= quant.GEMV_BLOCKS_PER_SM * quant.H100_SMS or larger is None
            or per_block < 2 * quant.GEMV_MIN_BLOCK_BYTES)
    assert per_block >= quant.GEMV_MIN_BLOCK_BYTES or blocks // 2 < quant.H100_SMS
    assert plan.warps <= quant.GEMV_WARPS


def _warp_ranges(mode, k, plan):
    """[start, end) of the stored rows of each (rank, warp), as the kernel
    walks them."""
    rows = _rows(mode, k)
    out = []
    for rank in range(plan.cluster):
        for w in range(plan.warps):
            w0 = rank * plan.rows_per_block + w * plan.rows_per_warp
            w1 = min(w0 + plan.rows_per_warp, rows)
            if w1 > w0:
                out.append((w0, w1))
    return out


# (K, N, group) of int4 weights: every split of K falls on a scale group's
# boundary (a group of 128 rows is 64 packed rows)
@pytest.mark.parametrize("mode", [INT4, INT4_SOW], ids=["int4", "int4_sow"])
@pytest.mark.parametrize("k,n,group", [
    (4096, 4096, 128), (14336, 4096, 128), (4096, 1024, 128), (4096, 14336, 128),
    (4096, 4096, 256), (8192, 1024, 512), (4224, 1024, 128), (640, 256, 128), (4096, 1024, 4096),
], ids=lambda v: str(v))
def test_int4_split_on_group_boundaries(k, n, group, mode):
    plan = _plan_of(mode, k, n, group)
    assert plan is not None
    assert mode == INT4 or plan.slab == quant.GEMV_MMA_SLAB
    unit = 64 if group == k else group // 2
    for w0, w1 in _warp_ranges(mode, k, plan):
        assert w0 % unit == 0 and (w1 % unit == 0 or w1 == k // 2)
    if group < k:
        assert plan.rows_per_warp % (group // 2) == 0
        assert plan.rows_per_block % (group // 2) == 0


# (mode, K, N): K of int8 in whole 16-byte runs of x, of int4 in whole groups
COVER_CASES = [(mode, k, n) for mode in (INT8, INT4, INT4_SOW)
               for k, n in [(4096, 4096), (14336, 4096), (4096, 1024), (4224, 1040), (256, 16),
                            (512, 4112), (14336, 14336)]] + [(INT8, 4104, 1024), (INT8, 136, 64)]


@pytest.mark.parametrize("mode,k,n", COVER_CASES, ids=lambda v: str(v))
def test_plan_covers_every_row_once(mode, k, n):
    """The warps' ranges tile the stored rows: no row is read twice or left
    out, and the kernel would take the shape."""
    plan = _plan_of(mode, k, n)
    assert plan is not None and _gemv_fits(mode, n, k, _group(mode, k), plan)
    covered = np.zeros(_rows(mode, k), dtype=np.int64)
    for w0, w1 in _warp_ranges(mode, k, plan):
        covered[w0:w1] += 1
    assert (covered == 1).all()


def _kernel_int4_sums(x, q4, s4, k, n, plan):
    """The kernel's int4 arithmetic in fp32, lane by lane: each lane's rows of
    a group give sum x (136 + q) and sum x, the group's partial is their
    difference (136 sum x), times the group's scale."""
    vals = quant._unpack_int4(q4).numpy().astype(np.float32) + np.float32(136)
    xf = x.float().numpy()[0]
    scale = s4.numpy()
    step = 32 // (plan.slab // 16)
    acc = np.zeros(n, dtype=np.float32)
    for w0, w1 in _warp_ranges(INT4, k, plan):
        for g0 in range(w0, w1, 64):                      # a group: 64 packed rows
            for j in range(step):                         # the lane's rows
                part = np.zeros(n, dtype=np.float32)
                xsum = np.float32(0)
                for r in range(g0 + j, g0 + 64, step):
                    x0, x1 = xf[2 * r], xf[2 * r + 1]
                    xsum = np.float32(xsum + np.float32(x0 + x1))
                    part = (part + x0 * vals[2 * r]).astype(np.float32)
                    part = (part + x1 * vals[2 * r + 1]).astype(np.float32)
                acc = (acc + (part - np.float32(136) * xsum) * scale[2 * g0 // 128]).astype(
                    np.float32)
    return acc


@pytest.mark.parametrize("k,n", [(1024, 64), (4096, 256)])
def test_int4_sums_less_136_sum_x_match_plain(k, n):
    """K4 at M = 1 widens each nibble to fp32 136 + q by a byte permute and
    takes 136 sum x off each group's partial: within the output's bf16
    rounding of the plain version, and exact for a one-hot x."""
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
    q4, s4 = quant.quantize_int4(w)
    plan = _plan_of(INT4, k, n)
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32)).to(BF16)
    want = quant.int4_matmul_reference(x.float(), q4, s4)[0].numpy()
    got = _kernel_int4_sums(x, q4, s4, k, n, plan)
    tol = 2 ** -7 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    for kk in (0, 1, k // 2 + 1, k - 1):
        one_hot = torch.zeros((1, k), dtype=BF16)
        one_hot[0, kk] = 1
        got = _kernel_int4_sums(one_hot, q4, torch.ones_like(s4), k, n, plan)
        assert np.array_equal(got, quant._unpack_int4(q4)[kk].numpy().astype(np.float32))


# operands the kernels do not take: the first port's gemv_kernel (None); mode
# 2 in bf16 takes gemv_m1_kernel at M = 1 and gemv_m8_kernel at M = 2..8, in
# fp32 gemv_kernel; at M = 2..8 rows of x whose stride is not a multiple of 8
# elements (not every row 16-byte aligned) take gemv_kernel
@pytest.mark.parametrize("args", [
    dict(mode=INT8, dtype=torch.float32),
    dict(mode=INT4, dtype=torch.float32),
    dict(mode=INT8, m=2, ldx=4100), dict(mode=INT4, m=3, ldx=4097), dict(mode=INT8, m=8, ldx=4196),
    dict(mode=INT4, m=5, ldx=4098),
    dict(mode=INT4_SOW, m=2, ldx=4100), dict(mode=INT4_SOW, m=8, n=4096, ldx=4100),
    dict(mode=INT4_SOW, dtype=torch.float32),
    dict(mode=INT8, n=20), dict(mode=INT8, n=72), dict(mode=INT8, n=100),
    dict(mode=INT4, n=20), dict(mode=INT4, n=72), dict(mode=INT4, n=100),
    dict(mode=INT8, x_ptr=8), dict(mode=INT4, x_ptr=2), dict(mode=INT8, w_ptr=4),
    dict(mode=INT4, w_ptr=8), dict(mode=INT4, s_ptr=4),
    dict(mode=INT4, k=96, group=96), dict(mode=INT4, k=130, group=130),
    dict(mode=INT8, k=130), dict(mode=INT4, k=4096, group=64),
], ids=["int8_fp32", "int4_fp32", "int8_m2", "int4_m3", "int8_m8", "int4_m5", "mode2",
        "mode2_n4096", "mode2_fp32", "int8_n20", "int8_n72", "int8_n100", "int4_n20", "int4_n72",
        "int4_n100", "int8_x_off", "int4_x_off", "int8_w_off", "int4_w_off", "int4_scale_off",
        "int4_k96_one_group", "int4_k130_one_group", "int8_k130", "int4_group64"])
def test_routes_to_gemv_kernel(args):
    a = dict(dtype=BF16, m=1, n=1024, k=4096, group=128, x_ptr=0, w_ptr=0, s_ptr=0)
    a.update(args)
    if a["mode"] == INT8 and "group" not in args:
        a["group"] = 1
    assert _gemv_plan(a["mode"], a["dtype"], a["m"], a["n"], a["k"], a["group"], a["x_ptr"],
                      a["w_ptr"], s_ptr=a["s_ptr"], ldx=a.get("ldx")) is None


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("k,n,sms", [(4096, 4096, 132), (4096, 1024, 132), (14336, 4096, 132),
                                     (4096, 14336, 132), (4096, 16, 132), (256, 1024, 132),
                                     (1024, 64, 132), (4096, 4096, 114), (4096, 1024, 16),
                                     (14336, 128, 132), (8192, 4096, 132)],
                         ids=lambda v: str(v))
def test_cluster_within_its_limit(mode, k, n, sms):
    plan = _plan_of(mode, k, n, sms=sms)
    assert plan is not None
    assert plan.cluster in GEMV_CLUSTERS and max(GEMV_CLUSTERS) == 8
    assert 1 <= plan.warps <= GEMV_MAX_WARPS
    assert plan.slab % plan.cluster == 0      # each rank finishes slab / cluster columns
    assert _gemv_fits(mode, n, k, _group(mode, k), plan)


def test_forced_settings_of_the_sweep():
    for slab in (64, 128):
        for cluster in GEMV_CLUSTERS:
            plan = _plan_of(INT8, 4096, 4096, slab=slab, cluster=cluster)
            assert (plan.slab, plan.cluster) == (slab, cluster)
            assert plan.rows_per_block * cluster == 4096
    assert _plan_of(INT8, 4096, 4096, cluster=2, warps=4).warps == 4
    assert _plan_of(INT4, 4096, 1024, cluster=8).cluster == 8
    # a split the kernel refuses (a rank without rows) is no plan
    assert _plan_of(INT4, 256, 1024, cluster=8) is None
    # mode 2 takes 128-byte slabs only
    assert _plan_of(INT4_SOW, 4096, 4096, slab=64, cluster=4) is None
    assert _plan_of(INT4_SOW, 4096, 4096, cluster=2, warps=2)[:3] == (128, 2, 2)


def test_forced_route_values():
    ptrs, sms = (0, 0, 0), 132
    plan = _gemv_route(None, INT8, BF16, 1, 4096, 4096, 1, ptrs, sms)
    assert plan == GemvPlan(*SHAPES["q_proj"][1][INT8])
    # the first port's kernel, forced
    assert _gemv_route("gemv_kernel", INT8, BF16, 1, 4096, 4096, 1, ptrs, sms) is None
    assert _gemv_route("gemv_kernel", INT4, BF16, 4, 4096, 4096, 128, ptrs, sms) is None
    with pytest.raises(ValueError, match="M <= 8"):
        _gemv_route("gemv_kernel", INT8, BF16, 9, 4096, 4096, 1, ptrs, sms)
    # a given plan, passed on as it is (the C side checks its shape)
    forced = GemvPlan(64, 2, 8, 2048, 256)
    assert _gemv_route(forced, INT8, BF16, 1, 4096, 4096, 1, ptrs, sms) is forced
    odd = GemvPlan(128, 3, 8, 100, 7)
    assert _gemv_route(odd, INT4, BF16, 1, 4096, 4096, 128, ptrs, sms) is odd
    # ... but never for operands the kernel does not take (at M = 2..8: rows
    # of x a stride off a multiple of 8 elements)
    for args, ldx in [((INT8, torch.float32, 1, 4096, 4096, 1, ptrs), None),
                      ((INT8, BF16, 2, 4096, 4096, 1, ptrs), 4100),
                      ((INT4_SOW, BF16, 2, 4096, 4096, 128, ptrs), 4097),
                      ((INT8, BF16, 1, 100, 4096, 1, ptrs), None),
                      ((INT8, BF16, 1, 4096, 4096, 1, (2, 0, 0)), None)]:
        with pytest.raises(ValueError, match="does not take"):
            _gemv_route(forced, *args, sms, ldx)
    with pytest.raises(ValueError, match="_route must be"):
        _gemv_route("gemv_m1_kernel", INT8, BF16, 1, 4096, 4096, 1, ptrs, sms)


def test_cpu_wrappers_take_the_route_keyword():
    """On the CPU the plain version runs whatever the route."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32)).to(BF16)
    q8, s8 = quant.quantize_int8(w)
    q4, s4 = quant.quantize_int4(w)
    for route in (None, "gemv_kernel", GemvPlan(64, 2, 8, 512, 64)):
        assert torch.equal(quant.int8_matmul(x, q8, s8, _route=route),
                           quant.int8_matmul_reference(x, q8, s8))
        assert torch.equal(quant.int4_matmul(x, q4, s4, _route=route),
                           quant.int4_matmul_reference(x, q4, s4))
        assert torch.equal(quant.int4_matmul_scale_on_weights(x, q4, s4, _route=route),
                           quant.int4_matmul_reference(x, q4, s4, scale_on_weights=True))


def _byte_perm(x, y, sel):
    """PTX prmt (CUDA __byte_perm) on uint32 arrays: byte i of the result is
    byte (sel >> 4 i) & 7 of the eight bytes of x (0-3) and y (4-7)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _bf16_bits(bits):
    """uint16 bit patterns as a bf16 tensor."""
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16)


def test_mode2_dequantization_bit_for_bit():
    """gemv_m1_kernel<2>'s dequantization, step by step on the bit patterns,
    for every packed int4 byte: int4_pairs' byte permutes and HSUB2 give q
    exactly. HMUL2 by the bf16 scale is modelled here by torch's bf16
    multiply, over scales from the smallest subnormal to the largest finite,
    of both signs, so this checks the model's single rounding; that the
    card's HMUL2 rounds the same is held by
    test_every_value_exact_through_m1_on_card."""
    b = np.arange(256, dtype=np.uint32)
    w = b | (b << 8) | (b << 16) | (b << 24)                   # byte b in every column
    l = (w & 0x0F0F0F0F) ^ 0x08080808                          # q + 8 of row 2r
    h = ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808                   # q + 8 of row 2r + 1
    z01 = _byte_perm(l, h, 0x5140)
    pair = _byte_perm(z01, np.full_like(z01, 0x43), 0x4140)    # column 0: (row 2r, row 2r + 1)
    lo = _bf16_bits(pair & 0xFFFF)
    hi = _bf16_bits(pair >> 16)
    bias = torch.tensor(136.0, dtype=torch.bfloat16)
    q_lo, q_hi = lo - bias, hi - bias                          # HSUB2: exact
    want_q = quant._unpack_int4(torch.from_numpy(b.astype(np.uint8).view(np.int8))[None, :])
    assert torch.equal(q_lo.float(), want_q[0].float()) and torch.equal(q_hi.float(),
                                                                        want_q[1].float())
    scales = torch.tensor([2.0 ** -133, 3 * 2.0 ** -133, 2.0 ** -127, 1e-38, 2.0 ** -126, 1e-20,
                           0.02 / 7, 0.1234, 1.0, 3.0, 1e10, 1e30, 2.0 ** 120, 1e37, 1.7e38,
                           3.3895e38])
    scales = torch.cat([scales, -scales]).to(torch.bfloat16)
    for s in scales:
        for got_q, wq in ((q_lo, want_q[0]), (q_hi, want_q[1])):
            got = got_q * s                                    # HMUL2: one rounding
            want = wq.to(torch.bfloat16) * s
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), float(s)


# -- M = 2..8: gemv_m8_kernel's plan, route and order of sums ---------------------

M8_ROWS = [2, 4, 8]
# the plan at every M = 2..8 by mode (x's rows change only its shared memory)
M8_SHAPES = {
    "q_proj": {INT8: (64, 8, 4, 512, 128), INT4: (64, 4, 4, 512, 128),
               INT4_SOW: (64, 4, 4, 512, 128)},
    "k_proj": {INT8: (64, 8, 4, 512, 128), INT4: (64, 8, 4, 256, 64),
               INT4_SOW: (64, 8, 4, 256, 64)},
    "v_proj": {INT8: (64, 8, 4, 512, 128), INT4: (64, 8, 4, 256, 64),
               INT4_SOW: (64, 8, 4, 256, 64)},
    "o_proj": {INT8: (64, 8, 4, 512, 128), INT4: (64, 4, 4, 512, 128),
               INT4_SOW: (64, 4, 4, 512, 128)},
    "gate_proj": {INT8: (128, 4, 4, 1024, 256), INT4: (128, 4, 4, 512, 128),
                  INT4_SOW: (128, 4, 4, 512, 128)},
    "up_proj": {INT8: (128, 4, 4, 1024, 256), INT4: (128, 4, 4, 512, 128),
                INT4_SOW: (128, 4, 4, 512, 128)},
    "down_proj": {INT8: (64, 8, 4, 1792, 448), INT4: (64, 4, 4, 1792, 448),
                  INT4_SOW: (64, 4, 4, 1792, 448)},
}


@pytest.mark.parametrize("m", M8_ROWS)
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("site", list(SHAPES))
def test_m8_plan_at_the_8b_shapes(site, mode, m):
    """Every bf16 call at M = 2..8 on an 8B projection takes gemv_m8_kernel:
    its plan, every stored row covered once, x's stage and the sums within
    the shared memory the C side allows, 128 or more blocks (4x and more
    gemv_kernel's 32 at N = 1024)."""
    (k, n), _ = SHAPES[site]
    plan = _plan_of(mode, k, n, m=m)
    assert plan == GemvPlan(*M8_SHAPES[site][mode])
    assert quant._route_function(plan, m) == "gemv_m8_kernel"
    assert _gemv_fits(mode, n, k, _group(mode, k), plan, m)
    covered = np.zeros(_rows(mode, k), dtype=np.int64)
    for w0, w1 in _warp_ranges(mode, k, plan):
        covered[w0:w1] += 1
    assert (covered == 1).all()
    smem = quant._gemv_m8_smem(mode, k, _group(mode, k), plan, m)
    assert smem <= quant.GEMV_M8_SMEM_BYTES
    # x's stage: m rows of the block's K rows as bf16, padded a row
    xk = plan.rows_per_block * (1 if mode == INT8 else 2)
    assert m * xk * 2 <= smem
    assert -(-n // plan.slab) * plan.cluster >= 128


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("site", list(SHAPES))
def test_m1_plans_unchanged_by_the_m8_rule(site, mode):
    """M = 1 keeps gemv_m1_kernel's plans (test_plan_at_the_8b_shapes): the
    M argument of the plan reaches only the M = 2..8 kernel."""
    (k, n), plans = SHAPES[site]
    assert _plan_of(mode, k, n) == GemvPlan(*plans[mode])
    assert quant._gemv_shape(mode, n, k, _group(mode, k), quant.H100_SMS) == GemvPlan(
        *plans[mode])
    assert quant._route_function(_plan_of(mode, k, n), 1) == "gemv_m1_kernel"


def test_m8_smem_opts_in_above_48kb():
    """M = 8 at down_proj in int4 stages 72,832 bytes: above the 48 KB
    default, within the limit the C side and the plan share; a cluster of 2
    there would need more and is no plan."""
    plan = _plan_of(INT4, 14336, 4096, m=8)
    assert 48 << 10 < quant._gemv_m8_smem(INT4, 14336, 128, plan, 8) <= quant.GEMV_M8_SMEM_BYTES
    assert _plan_of(INT4, 14336, 4096, m=8, cluster=2) is None
    assert _plan_of(INT4, 14336, 4096, m=2, cluster=2) is not None


# (case, mode, M, dtype, ldx, x offset in elements): what M = 2..8 routes where
M8_ROUTES = [
    ("bf16_m2", INT8, 2, BF16, None, 0, "gemv_m8_kernel"),
    ("bf16_m3_int4", INT4, 3, BF16, None, 0, "gemv_m8_kernel"),
    ("bf16_m8_sow", INT4_SOW, 8, BF16, None, 0, "gemv_m8_kernel"),
    ("row_view", INT8, 4, BF16, 4096 + 64, 0, "gemv_m8_kernel"),
    ("fp32", INT8, 4, torch.float32, None, 0, "gemv_kernel"),
    ("fp32_int4", INT4, 4, torch.float32, None, 0, "gemv_kernel"),
    ("unaligned_x", INT8, 4, BF16, None, 4, "gemv_kernel"),
    ("unaligned_x_sow", INT4_SOW, 4, BF16, None, 2, "gemv_kernel"),
    ("odd_stride", INT8, 4, BF16, 4100, 0, "gemv_kernel"),
    ("odd_stride_int4", INT4, 5, BF16, 4097, 0, "gemv_kernel"),
    ("m9", INT8, 9, BF16, None, 0, "gemm"),
    ("m9_int4", INT4, 9, BF16, None, 0, "gemm"),
]


@pytest.mark.parametrize("case,mode,m,dtype,ldx,off,want", M8_ROUTES,
                         ids=[c[0] for c in M8_ROUTES])
def test_m8_routes(case, mode, m, dtype, ldx, off, want):
    k, n = 4096, 1024
    group = _group(mode, k)
    x_ptr = off * (2 if dtype == BF16 else 4)
    plan = _gemv_plan(mode, dtype, m, n, k, group, x_ptr, 0, ldx=ldx)
    assert quant._route_function(plan, m) == want
    assert (plan is None) == (want != "gemv_m8_kernel")


# -- a model of gemv_m8_kernel, register by register, on the CPU

def _bf16_pair(p):
    """A uint32 array of bf16 pairs as (low, high) fp32 arrays, exactly."""
    p = p.astype(np.uint32)
    return (p << 16).view(np.float32), (p & np.uint32(0xFFFF0000)).view(np.float32)


def _pair_bits(lo, hi):
    """bf16-exact fp32 arrays (low, high) as a uint32 array of bf16 pairs."""
    lo = np.asarray(lo, np.float32).view(np.uint32)
    hi = np.asarray(hi, np.float32).view(np.uint32)
    assert not (lo & 0xFFFF).any() and not (hi & 0xFFFF).any()
    return (lo >> 16) | (hi & np.uint32(0xFFFF0000))


def _int8x2_to_bf16(p):
    """int8x2_to_bf16: bytes 0 and 2 as a bf16 pair (HSUB2, exact)."""
    alo, ahi = _bf16_pair((p & np.uint32(0x007F007F)) | np.uint32(0x43004300))
    blo, bhi = _bf16_pair((p & np.uint32(0x00800080)) | np.uint32(0x43004300))
    return _pair_bits(alo - blo, ahi - bhi)


def _int4_pairs(w):
    """int4_pairs: a word of 4 packed bytes as 4 bf16 pairs (q of row 2r,
    q of row 2r + 1), columns 0..3."""
    l = (w & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    h = ((w >> 4) & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    z01, z23 = _byte_perm(l, h, 0x5140), _byte_perm(l, h, 0x7362)
    c43 = np.full_like(w, 0x43)
    out = []
    for z, sel in ((z01, 0x4140), (z01, 0x4342), (z23, 0x4140), (z23, 0x4342)):
        lo, hi = _bf16_pair(_byte_perm(z, c43, sel))
        out.append(_pair_bits(lo - 136, hi - 136))
    return out


def _bf16_mul(p, s_pair):
    """HMUL2 of bf16 pairs: each product rounded once to bf16."""
    lo, hi = _bf16_pair(p)
    slo, shi = _bf16_pair(s_pair)
    r = [(torch.from_numpy(a).to(BF16) * torch.from_numpy(b).to(BF16)).float().numpy()
         for a, b in ((lo, slo), (hi, shi))]
    return _pair_bits(*r)


def _m8_model(mode, x, q, s, plan):
    """gemv_m8_kernel's arithmetic, lane by lane: each lane's loads (rows
    by its t, bytes by its g), its A fragments as the kernel builds them
    (byte permutes, the bf16 readings, mode 2's HMUL2), x's B fragments from
    the stage, the m16n8k16 product laid out as PTX lays out its fragments
    (products exact, each tile's sum rounded to fp32 once), mode 1's group
    scaling, the stores of C by column and row of x, and the cluster's sums
    in rank and warp order; bf16 out [M, N]."""
    m_rows, k = x.shape
    n = q.shape[1]
    mt, w = quant._gemv_rows(m_rows), plan.slab // 8
    rows = _rows(mode, k)
    tile_loads, tile_rows = (4, 16) if mode == INT8 else (2, 8)
    loads = quant.GEMV_M8_BATCH_BYTES // w
    batch = loads // tile_loads * tile_rows
    group = k if mode == INT8 else k // s.shape[0]
    group_batches = rows if group == k else group // 2 // batch
    qb = q.numpy().view(np.uint8)
    xk = np.zeros((mt, plan.cluster * plan.rows_per_block * (1 if mode == INT8 else 2) + 16),
                  np.float32)
    xk[:m_rows, :k] = x.float().numpy()
    sc = s.numpy().astype(np.float32)
    sb = s.to(BF16).float().numpy()
    g = np.arange(8)[:, None]
    t = np.arange(4)[None, :]
    out = np.zeros((m_rows, n), np.float32)
    for slab0 in range(0, n, plan.slab):
        col = slab0 + w * g                                    # [8, 1]
        parts = []                                             # [MT, slab] of each (rank, warp)
        for rank in range(plan.cluster):
            b0 = rank * plan.rows_per_block
            for warp in range(plan.warps):
                w0 = b0 + warp * plan.rows_per_warp
                w1 = min(w0 + plan.rows_per_warp, rows)
                acc = np.zeros((w // 2, 16, 8), np.float32)    # C of each column pair
                part = np.zeros_like(acc)
                gb = 0
                for rb in range(w0, w1, batch):
                    grp = 2 * rb // group if mode != INT8 else 0
                    for i in range(loads // tile_loads):
                        base = rb + i * tile_rows
                        regs = []
                        for j in range(tile_loads):
                            r = base + (2 * t + (j & 1) + 8 * (j >> 1) if mode == INT8
                                        else t + 4 * j)  # [1, 4]
                            cols = col[:, :, None] + np.arange(w)[None, None, :]
                            ok = (r < w1)[:, :, None] & (cols < n)
                            byts = np.where(ok, qb[np.minimum(r, rows - 1)[:, :, None],
                                                   np.minimum(cols, n - 1)], 0)
                            byts = np.broadcast_to(byts, (8, 4, w)).astype(np.uint32)
                            regs.append(byts[..., 0::4] | byts[..., 1::4] << 8
                                        | byts[..., 2::4] << 16 | byts[..., 3::4] << 24)
                        tau = (base - b0) // tile_rows
                        kk = 2 * b0 // (2 if mode == INT8 else 1) + 16 * tau
                        kk = b0 * (1 if mode == INT8 else 2) + 16 * tau
                        bmat = np.zeros((16, 8), np.float32)           # B: [k][n]
                        bmat[:, :mt] = xk[:mt, kk:kk + 16].T
                        for qw in range(w // 4):
                            if mode == INT8:
                                l0, l1, l2, l3 = (r_[..., qw] for r_ in regs)
                            else:
                                p0 = _int4_pairs(regs[0][..., qw])
                                p1 = _int4_pairs(regs[1][..., qw])
                                if mode == INT4_SOW:
                                    for c in range(4):
                                        sv = sb[grp, np.minimum(col + 4 * qw + c, n - 1)]
                                        sp = _pair_bits(sv, sv)
                                        p0[c] = _bf16_mul(p0[c], np.broadcast_to(sp, (8, 4)))
                                        p1[c] = _bf16_mul(p1[c], np.broadcast_to(sp, (8, 4)))
                            for h in range(2):
                                if mode == INT8:
                                    sel0 = 2 * h | (4 + 2 * h) << 8
                                    sel1 = (2 * h + 1) | (5 + 2 * h) << 8
                                    a = [_int8x2_to_bf16(_byte_perm(l0, l1, sel0)),
                                         _int8x2_to_bf16(_byte_perm(l0, l1, sel1)),
                                         _int8x2_to_bf16(_byte_perm(l2, l3, sel0)),
                                         _int8x2_to_bf16(_byte_perm(l2, l3, sel1))]
                                else:
                                    a = [p0[2 * h], p0[2 * h + 1], p1[2 * h], p1[2 * h + 1]]
                                # PTX m16n8k16 A: a0 (g, 2t..), a1 (g + 8, 2t..),
                                # a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
                                amat = np.zeros((16, 16), np.float32)
                                for reg, (dr, dk) in zip(a, ((0, 0), (8, 0), (0, 8), (8, 8))):
                                    lo, hi = _bf16_pair(reg)
                                    for gg in range(8):
                                        for tt in range(4):
                                            amat[gg + dr, 2 * tt + dk] = lo[gg, tt]
                                            amat[gg + dr, 2 * tt + dk + 1] = hi[gg, tt]
                                prod = (amat.astype(np.float64) @ bmat.astype(np.float64))
                                tgt = part if mode == INT4 else acc
                                tgt[2 * qw + h] = (tgt[2 * qw + h] + prod.astype(np.float32)
                                                   ).astype(np.float32)
                    if mode == INT4:
                        gb += 1
                        if gb == group_batches or rb + batch >= w1:
                            for p in range(w // 2):
                                cc = np.minimum(col[:, 0] + 2 * p, n - 1)
                                srow = np.concatenate([sc[grp, cc], sc[grp, np.minimum(cc + 1,
                                                                                   n - 1)]])
                                acc[p] = (acc[p] + part[p] * srow[:, None]).astype(np.float32)
                            part[:] = 0
                            gb = 0
                # C of pair p: row g -> column W g + 2p, row g + 8 -> W g + 2p + 1
                mine = np.zeros((mt, plan.slab), np.float32)
                for p in range(w // 2):
                    for gg in range(8):
                        mine[:, w * gg + 2 * p] = acc[p, gg, :mt]
                        mine[:, w * gg + 2 * p + 1] = acc[p, gg + 8, :mt]
                parts.append(mine)
        total = np.zeros((mt, plan.slab), np.float32)
        for part_ in parts:
            total = (total + part_).astype(np.float32)
        cols = slice(slab0, min(slab0 + plan.slab, n))
        live = total[:m_rows, :cols.stop - slab0]
        if mode == INT8:
            live = (live * sc[cols]).astype(np.float32)
        out[:, cols] = live
        assert not total[m_rows:].any()            # the zero-padded rows of MT
    return torch.from_numpy(out).to(BF16)


def _plain(mode, x, q, s):
    if mode == INT8:
        return quant.int8_matmul_reference(x.float(), q, s)
    return quant.int4_matmul_reference(x.float(), q, s, scale_on_weights=mode == INT4_SOW)


# (mode, M, K, N, group, forced plan settings): W = 16 and 8, MT = 2, 4, 8
# with zero-padded rows (M = 3, 5), mode 1 with two groups a warp, a group a
# warp and one group over K
MODEL_CASES = [
    (INT8, 2, 512, 128, 1, dict(cluster=2, warps=2)),
    (INT8, 3, 520, 64, 1, dict(cluster=2, warps=2)),
    (INT8, 8, 256, 128, 1, dict(slab=64, cluster=2)),
    (INT4, 4, 1024, 128, 128, dict(cluster=2, warps=2)),
    (INT4, 5, 1024, 64, 128, dict(cluster=2, warps=1)),
    (INT4, 4, 512, 128, 512, dict(cluster=2, warps=2)),
    (INT4_SOW, 4, 512, 128, 128, dict(cluster=2, warps=2)),
    (INT4_SOW, 8, 512, 64, 256, dict(cluster=2)),
]


@pytest.mark.parametrize("mode,m,k,n,group,force", MODEL_CASES, ids=lambda v: str(v))
def test_m8_model_matches_plain(mode, m, k, n, group, force):
    """The model of the kernel's split and order of sums within the bf16
    tolerance of the plain version (2^-7 x max(1, |ref|max)), and exact
    where nothing rounds: integer x, unit scales."""
    x, q, s = _operands("cpu", mode, k, n, seed=k + n + m, m=m, group=group)
    g = 1 if mode == INT8 else k // s.shape[0]
    plan = _gemv_plan(mode, BF16, m, n, k, g, 0, 0, **force)
    assert plan is not None and plan.slab == force.get("slab", plan.slab)
    want = _plain(mode, x, q, s)
    got = _m8_model(mode, x, q, s, plan)
    tol = 2 ** -7 * max(1.0, float(want.abs().max()))
    assert float((got.float() - want).abs().max()) <= tol
    xi = torch.from_numpy(np.random.default_rng(1).integers(-3, 4, (m, k))).to(BF16)
    ones = torch.ones_like(s)
    exact = _m8_model(mode, xi, q, ones, plan)
    assert torch.equal(exact.float(), _plain(mode, xi, q, ones).to(BF16).float())


def test_c_entries_match_the_source():
    """The ctypes argument types of every C entry match its parameters in
    csrc/quant_matmul.cu (int, int64_t, pointers): a missing or extra
    argument would be read as garbage on the card."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(quant.__file__).resolve().parents[1] / "csrc" / "quant_matmul.cu").read_text()
    kinds = {"int": ctypes.c_int, "int64_t": ctypes.c_int64}
    for name, argtypes in quant.C_ENTRIES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]] for p in params]
        assert argtypes == want, name


def test_int8_pairs_bit_for_bit():
    """gemv_m8_kernel<0>'s A fragments: for every pair of int8 values in a
    column of two rows, the byte permute and int8x2_to_bf16 give the pair
    (row 2t, row 2t + 1) exactly, for each byte of the word."""
    v = np.arange(256, dtype=np.uint32)
    r0, r1 = np.meshgrid(v, v, indexing="ij")
    r0, r1 = r0.ravel(), r1.ravel()
    for c in range(4):
        w0 = r0 << (8 * c) | ((r0 + 1) % 256) << (8 * ((c + 1) % 4))
        w1 = r1 << (8 * c) | ((r1 + 7) % 256) << (8 * ((c + 1) % 4))
        lo, hi = _bf16_pair(_int8x2_to_bf16(_byte_perm(w0, w1, c | (4 + c) << 8)))
        assert np.array_equal(lo, r0.astype(np.uint8).view(np.int8).astype(np.float32))
        assert np.array_equal(hi, r1.astype(np.uint8).view(np.int8).astype(np.float32))


# -- the kernel, on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(device, mode, k, n, seed=0, m=1, integer=False, group=quant.INT4_GROUP):
    """bf16 x [m, k] and quantized weights of a [k, n] matrix (int4 in
    ``group``s), made with numpy from a seed; ``integer``: x of small
    integers and unit scales."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
    xs = rng.integers(-3, 4, (m, k)) if integer else rng.standard_normal((m, k))
    x = torch.from_numpy(xs.astype(np.float32)).to(device, BF16)
    q, s = quant.quantize_int8(w) if mode == INT8 else quant.quantize_int4(w, group)
    if integer:
        s = torch.ones_like(s)
    return x, q.to(device), s.to(device)


def _fn(mode):
    return (quant.int8_matmul, quant.int4_matmul, quant.int4_matmul_scale_on_weights)[mode]


def _held(out, x, q, s, mode):
    """Within 2^-7 x max(1, |ref|max) of the plain version on x upcast to fp32."""
    if mode == INT8:
        want = quant.int8_matmul_reference(x.float(), q, s)
    else:
        want = quant.int4_matmul_reference(x.float(), q, s, scale_on_weights=mode == INT4_SOW)
    assert out.shape == want.shape and out.dtype == BF16
    assert torch.isfinite(out).all()
    tol = 2 ** -7 * max(1.0, float(want.abs().max()))
    err = float((out.float() - want).abs().max())
    assert err <= tol, (err, tol)


def _kernels_run(calls, repeats=3):
    """The kernel functions that ``calls`` launch, by name, in one profiled
    run of ``repeats`` rounds (each called once before, so no launch inside
    loads a module; a trace of one call has come back without its kernel)."""
    from torch.profiler import ProfilerActivity, profile

    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            for call in calls:
                call()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("site", list(SHAPES))
def test_8b_shapes_match_plain_on_card(cuda_device, site, mode):
    (k, n), _ = SHAPES[site]
    x, q, s = _operands(cuda_device, mode, k, n, seed=k + n)
    before = _fn(mode).launches
    out = _fn(mode)(x, q, s)
    torch.cuda.synchronize()
    assert _fn(mode).launches == before + 1
    _held(out, x, q, s, mode)


@pytest.mark.cuda
def test_8b_shapes_run_gemv_m1_kernel_on_card(cuda_device):
    calls = {}
    for site, ((k, n), _) in SHAPES.items():
        for mode in MODES:
            x, q, s = _operands(cuda_device, mode, k, n)
            calls[(site, mode)] = (lambda x=x, q=q, s=s, mode=mode: _fn(mode)(x, q, s))
    names = _kernels_run(list(calls.values()))
    for mode in MODES:
        assert any(f"gemv_m1_kernel<{mode}>" in n for n in names), names
    assert not any("gemv_kernel<" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_every_value_exact_through_m1_on_card(cuda_device, mode):
    """A one-hot x selects one row of weights that holds every int8 value
    (every packed int4 byte) across its 256 columns; with scales of 1 the
    output is that row, exactly. Mode 2 takes bf16 scales from subnormal to
    1e37 instead, different in every column and group: its output is then
    bf16(q * bf16(scale)), which must equal the plain version's bit for bit
    (the card's HMUL2 rounds once, as the reference does). Rows at the
    start, inside and at the end of the blocks' and warps' shares."""
    k, n = 4096, 256
    rng = np.random.default_rng(0)
    stored = k if mode == INT8 else k // 2
    # each stored row a permutation of the 256 bytes
    b = np.stack([rng.permutation(256) for _ in range(stored)]).astype(np.uint8)
    q = torch.from_numpy(b.view(np.int8)).to(cuda_device)
    s = torch.ones(n if mode == INT8 else (k // 128, n), device=cuda_device)
    if mode == INT4_SOW:
        # 8 |s| stays finite: a column of inf would make 0 * inf a NaN
        sv = torch.tensor([2.0 ** -133, 3 * 2.0 ** -133, 2.0 ** -127, 1e-38, 2.0 ** -126, 1e-20,
                           0.02 / 7, 0.1234, 1.0, 3.0, 1e10, 1e30, 2.0 ** 120, 1e37])
        sv = torch.cat([sv, -sv])
        pick = (torch.arange(k // 128)[:, None] * 5 + torch.arange(n)[None, :]) % len(sv)
        s = sv[pick].to(cuda_device)
    plan = _plan_of(mode, k, n)
    rows = sorted({0, 1, plan.rows_per_warp - 1, plan.rows_per_warp, plan.rows_per_block - 1,
                   plan.rows_per_block, stored // 2 + 3, stored - 1})
    vals = q.float() if mode == INT8 else quant._unpack_int4(q).float()
    for r in rows:
        for kk in ([r] if mode == INT8 else [2 * r, 2 * r + 1]):
            x = torch.zeros((1, k), device=cuda_device, dtype=BF16)
            x[0, kk] = 1
            out = _fn(mode)(x, q, s)
            torch.cuda.synchronize()
            if mode == INT4_SOW:
                want = quant.int4_matmul_reference(x, q, s, scale_on_weights=True)
                assert torch.equal(out, want), (r, kk)
            else:
                assert torch.equal(out[0].float(), vals[kk]), (r, kk)


# (mode, K, N): K ranges that split unevenly over the cluster or the warps
# (int8: K not a multiple of a batch; int4: 33 and 65 groups), and N at the
# edges of 64- and 128-byte slabs
EDGE_CASES = [(INT8, 4104, 1024), (INT8, 136, 64), (INT8, 8200, 4096)] + [
    (mode, k, n) for mode in MODES
    for k, n in [(4224, 1024), (8320, 4096), (640, 2048), (4096, 16), (4096, 48), (4096, 112),
                 (4096, 144), (4096, 1040), (4096, 4112), (1024, 14336 + 16)]]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,n", EDGE_CASES, ids=lambda v: str(v))
def test_uneven_splits_and_slab_edges_on_card(cuda_device, mode, k, n):
    x, q, s = _operands(cuda_device, mode, k, n, seed=k * n)
    plan = _plan_of(mode, k, n, group=None if mode == INT8 else k // s.shape[0])
    assert plan is not None
    out = _fn(mode)(x, q, s)
    torch.cuda.synchronize()
    _held(out, x, q, s, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_forced_plans_match_plain_on_card(cuda_device, mode):
    k, n = 4096, 4096
    x, q, s = _operands(cuda_device, mode, k, n)
    for slab in (64, 128) if mode != INT4_SOW else (quant.GEMV_MMA_SLAB,):
        for cluster in GEMV_CLUSTERS:
            for warps in (None, 2):
                plan = _plan_of(mode, k, n, slab=slab, cluster=cluster, warps=warps)
                assert plan is not None, (slab, cluster, warps)
                out = _fn(mode)(x, q, s, _route=plan)
                torch.cuda.synchronize()
                _held(out, x, q, s, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [INT8, INT4], ids=["int8", "int4"])
def test_unaligned_x_takes_gemv_kernel_on_card(cuda_device, mode):
    k, n = 4096, 1024
    x, q, s = _operands(cuda_device, mode, k, n)
    store = torch.empty(k + 1, dtype=BF16, device=cuda_device)
    xu = store[1:].view(1, k)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    names = _kernels_run([lambda: _fn(mode)(xu, q, s)])
    assert any("gemv_kernel<" in n for n in names), names
    assert not any("gemv_m1_kernel" in n for n in names), names
    _held(_fn(mode)(xu, q, s), xu, q, s, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_two_calls_bitwise_identical_on_card(cuda_device, mode):
    x, q, s = _operands(cuda_device, mode, 14336, 4096)
    a = _fn(mode)(x, q, s)
    b = _fn(mode)(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_refused_launch_shape_raises_on_card(cuda_device, mode):
    x, q, s = _operands(cuda_device, mode, 4096, 1024)
    good = _plan_of(mode, 4096, 1024)
    bad = [good._replace(cluster=3), good._replace(cluster=16), good._replace(slab=32),
           good._replace(warps=9, rows_per_block=9 * good.rows_per_warp),
           good._replace(rows_per_block=good.rows_per_block + 1),      # not warps x rows a warp
           good._replace(rows_per_warp=good.rows_per_warp + 1,
                         rows_per_block=good.warps * (good.rows_per_warp + 1)),  # off a unit
           good._replace(cluster=2),                                   # rows left over
           good._replace(cluster=8, warps=8, rows_per_warp=4096, rows_per_block=8 * 4096)]
    if mode == INT4_SOW:
        bad.append(good._replace(slab=64))                          # mode 2 takes 128 only
    before = _fn(mode).launches
    for plan in bad:
        with pytest.raises(RuntimeError, match="invalid argument"):
            _fn(mode)(x, q, s, _route=plan)
    assert _fn(mode).launches == before + len(bad)    # counted, never run
    _held(_fn(mode)(x, q, s, _route=good), x, q, s, mode)


# -- gemv_m8_kernel, on the card ---------------------------------------------------

def _routed(mode, call):
    """``call()``'s output and the kernel functions its wrapper counted."""
    fn = _fn(mode)
    before = dict(fn.function_launches)
    out = call()
    torch.cuda.synchronize()
    return out, {f: c - before.get(f, 0) for f, c in fn.function_launches.items()
                 if c != before.get(f, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("site", list(SHAPES))
def test_m8_8b_shapes_match_plain_on_card(cuda_device, site, mode, m):
    (k, n), _ = SHAPES[site]
    x, q, s = _operands(cuda_device, mode, k, n, m=m, seed=k + n + m)
    out, routes = _routed(mode, lambda: _fn(mode)(x, q, s))
    assert routes == {"gemv_m8_kernel": 1}
    _held(out, x, q, s, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_m8_exact_where_nothing_rounds_on_card(cuda_device, mode, m):
    """Integer x and unit scales: every product and partial sum is an
    integer below 2^24 (int8 at down_proj: |sum| <= 3 x 127 x 14336), exact
    in fp32 in any order, so the kernel's bf16 output equals the plain
    version's bit for bit."""
    for k, n in ((14336, 4096), (4096, 1024)):
        x, q, s = _operands(cuda_device, mode, k, n, m=m, seed=m, integer=True)
        out, routes = _routed(mode, lambda: _fn(mode)(x, q, s))
        assert routes == {"gemv_m8_kernel": 1}
        want = (quant.int8_matmul_reference(x.float(), q, s) if mode == INT8 else
                quant.int4_matmul_reference(x.float(), q, s, scale_on_weights=mode == INT4_SOW))
        assert torch.equal(out, want.to(BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_m8_two_calls_bitwise_identical_on_card(cuda_device, mode):
    x, q, s = _operands(cuda_device, mode, 14336, 4096, m=4)
    a = _fn(mode)(x, q, s)
    b = _fn(mode)(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_m8_row_view_of_a_wider_tensor_on_card(cuda_device, mode):
    """x as rows of a wider buffer (a row stride of K + 64 elements) runs
    gemv_m8_kernel and equals the contiguous call; a stride of K + 4
    (rows off the 16-byte alignment) runs gemv_kernel."""
    k, n, m = 4096, 1024, 4
    x, q, s = _operands(cuda_device, mode, k, n, m=m)
    for pad, want in ((64, "gemv_m8_kernel"), (4, "gemv_kernel")):
        wide = torch.zeros((m, k + pad), dtype=BF16, device=cuda_device)
        wide[:, :k] = x
        xv = wide[:, :k]
        assert xv.stride(0) == k + pad
        out, routes = _routed(mode, lambda: _fn(mode)(xv, q, s))
        assert routes == {want: 1}
        _held(out, xv, q, s, mode)
        if want == "gemv_m8_kernel":
            assert torch.equal(out, _fn(mode)(x, q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_m8_refused_launch_shape_raises_on_card(cuda_device, mode):
    x, q, s = _operands(cuda_device, mode, 4096, 1024, m=4)
    good = _plan_of(mode, 4096, 1024, m=4)
    bad = [good._replace(cluster=3), good._replace(slab=32),
           good._replace(warps=9, rows_per_block=9 * good.rows_per_warp),
           good._replace(rows_per_block=good.rows_per_block + 1),
           good._replace(cluster=2),                                   # rows left over
           good._replace(cluster=2, warps=8, rows_per_warp=4096, rows_per_block=8 * 4096)]
    before = _fn(mode).launches
    for plan in bad:
        with pytest.raises(RuntimeError, match="invalid argument"):
            _fn(mode)(x, q, s, _route=plan)
    assert _fn(mode).launches == before + len(bad)    # counted, never run
    out, routes = _routed(mode, lambda: _fn(mode)(x, q, s, _route=good))
    assert routes == {"gemv_m8_kernel": 1}
    _held(out, x, q, s, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_m8_forced_plans_match_plain_on_card(cuda_device, mode):
    """Both slabs (lanes of 16 and of 8 bytes) in every cluster size, and
    the first port's kernel forced, at q_proj and M = 4."""
    k, n, m = 4096, 4096, 4
    x, q, s = _operands(cuda_device, mode, k, n, m=m)
    for slab in (64, 128):
        for cluster in GEMV_CLUSTERS:
            plan = _plan_of(mode, k, n, m=m, slab=slab, cluster=cluster)
            assert plan is not None, (slab, cluster)
            out, routes = _routed(mode, lambda: _fn(mode)(x, q, s, _route=plan))
            assert routes == {"gemv_m8_kernel": 1}
            _held(out, x, q, s, mode)
    out, routes = _routed(mode, lambda: _fn(mode)(x, q, s, _route="gemv_kernel"))
    assert routes == {"gemv_kernel": 1}
    _held(out, x, q, s, mode)


@pytest.mark.cuda
def test_m4_runs_gemv_m8_kernel_alone_on_card(cuda_device):
    """By kernel name: the 8B shapes at M = 4 run gemv_m8_kernel<mode,4,W>
    (W from the plan's slab) and no gemv_kernel."""
    calls = []
    for site, ((k, n), _) in SHAPES.items():
        for mode in MODES:
            x, q, s = _operands(cuda_device, mode, k, n, m=4)
            calls.append(lambda x=x, q=q, s=s, mode=mode: _fn(mode)(x, q, s))
    names = _kernels_run(calls)
    for mode in MODES:
        assert any(f"gemv_m8_kernel<{mode}, 4," in n or f"gemv_m8_kernel<{mode},4," in n
                   for n in names), names
    assert not any("gemv_kernel<" in n for n in names), names

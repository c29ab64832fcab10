"""The bf16 M = 1 decode GEMV of K3 (int8), K4 (int4) and K4b/K4c (int4, scale
on the weights): how the wrapper plans a call (``_gemv_plan``: the route, the
slab, the cluster, the K split), and a model of mode 2's dequantization bit
by bit, on the CPU; ``gemv_m1_kernel`` against the plain version, on the
card.

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


def _plan_of(mode, k, n, group=None, **kw):
    group = _group(mode, k) if group is None else group
    return _gemv_plan(mode, BF16, 1, n, k, group, 0, 0, **kw)


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


# operands the kernel does not take: the first port's gemv_kernel (None); mode
# 2 at M = 1 in bf16 takes gemv_m1_kernel, at M = 2..8 or in fp32 gemv_kernel
@pytest.mark.parametrize("args", [
    dict(mode=INT8, dtype=torch.float32),
    dict(mode=INT4, dtype=torch.float32),
    dict(mode=INT8, m=2), dict(mode=INT4, m=3), dict(mode=INT8, m=8), dict(mode=INT4, m=5),
    dict(mode=INT4_SOW, m=2), dict(mode=INT4_SOW, m=8, n=4096),
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
                      a["w_ptr"], s_ptr=a["s_ptr"]) is None


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
    # ... but never for operands the kernel does not take
    for args in [(INT8, torch.float32, 1, 4096, 4096, 1, ptrs),
                 (INT8, BF16, 2, 4096, 4096, 1, ptrs),
                 (INT4_SOW, BF16, 2, 4096, 4096, 128, ptrs),
                 (INT8, BF16, 1, 100, 4096, 1, ptrs),
                 (INT8, BF16, 1, 4096, 4096, 1, (2, 0, 0))]:
        with pytest.raises(ValueError, match="does not take"):
            _gemv_route(forced, *args, sms)
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


# -- the kernel, on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(device, mode, k, n, seed=0):
    """bf16 x [1, k] and quantized weights of a [k, n] matrix, made with numpy
    from a seed."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32)).to(device, BF16)
    q, s = quant.quantize_int8(w) if mode == INT8 else quant.quantize_int4(w)
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

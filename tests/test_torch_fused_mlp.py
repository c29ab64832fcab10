"""K8, the fused GELU MLP: how the wrapper plans a call (``_plan``: the route,
the L2-sized hidden chunk, the output tiles' widths), on the CPU, and the
kernels against the plain version, on the card.

``tests/test_torch_vision_kernels.py`` holds the plain version against the
JAX function and the Pallas kernel body. The kernels run only on the card
(marker ``cuda``; without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_fused_mlp.py``).
"""

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops import fused_mlp
from cambrian_tpu_torch.ops.fused_mlp import HIDDEN_CHUNK_BYTES, Plan, _plan, _tile_cols

BF16_REL = 2 ** -7  # the output's rounding (2^-8 relative) on either side

# the drop-in sites of one Cambrian-8B request (chip_smoke.py phase 10):
# (M, C, H, C2) -> (chunk rows, chunks, up tile width, down tile width)
SITES = {
    "convnext_stage1": ((65536, 384, 1536, 384), (8192, 8, 256, 192)),
    "convnext_stage2": ((16384, 768, 3072, 768), (4096, 4, 256, 192)),
    "convnext_stage3": ((4096, 1536, 6144, 1536), (2048, 2, 256, 192)),
    "convnext_stage4": ((1024, 3072, 12288, 3072), (1024, 1, 256, 192)),
    "sva_mlp_1024": ((576, 1024, 1024, 1024), (576, 1, 64, 64)),
    "sva_mlp_4096": ((576, 1024, 1024, 4096), (576, 1, 64, 192)),
}


@pytest.mark.parametrize("site", list(SITES))
def test_plan_at_the_request_sites(site):
    (m, c, h, c2), (rows, chunks, bn_up, bn_down) = SITES[site]
    plan = _plan(m, c, h, c2, c)
    assert plan == Plan("wgmma", rows, chunks, bn_up, bn_down)
    assert rows * h * 2 <= HIDDEN_CHUNK_BYTES
    assert chunks * rows >= m > (chunks - 1) * rows


# (M, H) -> chunk rows, chunks: the budget's edge and the balance of chunks
@pytest.mark.parametrize("m,h,rows,chunks", [
    (HIDDEN_CHUNK_BYTES // (2 * 1536), 1536, 8192, 1),      # exactly the budget: one chunk
    (HIDDEN_CHUNK_BYTES // (2 * 1536) + 1, 1536, 4224, 2),  # one row over: two balanced chunks
    (8192 * 2 + 1, 1536, 5504, 3),                          # the fewest chunks, rounded to 128
    (1, 1536, 1, 1),
    (300, 200_000, 128, 3),                                 # a 128-row tile over the budget
], ids=["at_budget", "one_row_over", "three_chunks", "one_row", "huge_h"])
def test_plan_chunks_at_the_budget(m, h, rows, chunks):
    plan = _plan(m, 64, h, 64, 64)
    assert (plan.route, plan.chunk_rows, plan.chunks) == ("wgmma", rows, chunks)
    assert rows == m or rows % 128 == 0


# operands TMA cannot address take the mma.sync kernel; fp32 the SIMT one
@pytest.mark.parametrize("args,route", [
    (dict(c=48, h=192, c2=40, ldx=48), "wgmma"),
    (dict(c=100, h=192, c2=40, ldx=100), "mma_sync"),               # C % 8
    (dict(c=48, h=36, c2=40, ldx=48), "mma_sync"),                  # H % 8
    (dict(c=48, h=192, c2=3, ldx=48), "mma_sync"),                  # C2 % 8
    (dict(c=48, h=192, c2=40, ldx=49), "mma_sync"),                 # ldx % 8
    (dict(c=48, h=192, c2=40, ldx=64), "wgmma"),                    # ldx > C, aligned
    (dict(c=48, h=192, c2=40, ldx=48, ptrs=(2, 0, 0)), "mma_sync"),  # x's base
    (dict(c=48, h=192, c2=40, ldx=48, ptrs=(0, 8, 0)), "mma_sync"),  # W1^T's base
    (dict(c=48, h=192, c2=40, ldx=48, ptrs=(0, 0, 4)), "mma_sync"),  # W2^T's base
    (dict(c=48, h=192, c2=40, ldx=48, dtype=torch.float32), "simt"),
    (dict(c=100, h=36, c2=3, ldx=100, dtype=torch.float32), "simt"),
], ids=["aligned", "odd_c", "odd_h", "odd_c2", "ldx", "wide_ldx", "x_base", "w1_base",
        "w2_base", "fp32", "fp32_odd"])
def test_plan_route_by_the_tma_rule(args, route):
    plan = _plan(300, **args)
    assert plan.route == route
    if route != "wgmma":
        assert (plan.chunk_rows, plan.chunks) == (300, 1)


# (M, N, SMs) -> width: the fewest waves of columns, ties to the wider tile
@pytest.mark.parametrize("m,n,sms,bn", [
    (2048, 6144, 132, 256),   # 384 / 512 / 768 tiles: 3, 4, 6 waves, equal columns
    (2048, 1536, 132, 192),   # 128 tiles of 192: one wave
    (8192, 384, 132, 192),
    (576, 1024, 132, 64),     # 80 tiles of 64 fill more SMs than 40 of 128
    (576, 4096, 132, 192),
    (2048, 1536, 114, 256),   # a 114-SM card: 96 tiles of 256 in one wave, not 128 in two
], ids=["up_stage3", "down_stage3", "down_stage1", "sva_n1024", "sva_n4096", "sms114"])
def test_tile_width_by_waves(m, n, sms, bn):
    assert _tile_cols(m, n, sms) == bn


# -- the kernels, on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, m, c, h, c2, b1=True, b2=True, ldx=None, offset=0, seed=0):
    """bf16 x [m, c] (row stride ldx, starting `offset` elements into its
    storage) and nn.Linear-scaled weights, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    ldx = ldx or c
    store = torch.empty(offset + m * ldx, dtype=torch.bfloat16, device=device)
    x = store[offset:].view(m, ldx)[:, :c]
    x.copy_(torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32)))
    w1 = torch.from_numpy(rng.standard_normal((c, h)).astype(np.float32) / np.sqrt(c))
    w2 = torch.from_numpy(rng.standard_normal((h, c2)).astype(np.float32) / np.sqrt(h))
    bias1 = torch.from_numpy(rng.standard_normal(h).astype(np.float32) * 0.1) if b1 else None
    bias2 = torch.from_numpy(rng.standard_normal(c2).astype(np.float32) * 0.1) if b2 else None
    # nn.Linear's layout: the kernels read w.t() of an [out, in] weight in place
    w1 = w1.t().contiguous().to(device, torch.bfloat16).t()
    w2 = w2.t().contiguous().to(device, torch.bfloat16).t()
    return (x, w1, None if bias1 is None else bias1.to(device), w2,
            None if bias2 is None else bias2.to(device))


def _kernels_run(args):
    """The kernel functions a call launches, by name, from one profiled run of
    three calls. Call once before: a kernel's first launch loads its module,
    and a profiled run that did so, or of one call, has come back without one
    of its kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused_mlp.fused_mlp(*args)
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def _held(out, args):
    """Within 2^-7 x max(1, |ref|max) of the plain version on the inputs
    upcast to fp32."""
    x, w1, b1, w2, b2 = args
    want = fused_mlp.fused_mlp_reference(x.float(), w1.float(), b1, w2.float(), b2)
    assert out.shape == want.shape and out.dtype == x.dtype
    assert torch.isfinite(out).all()
    tol = BF16_REL * max(1.0, float(want.abs().max()))
    err = float((out.float() - want).abs().max())
    assert err <= tol, (err, tol)


# (M, C, H, C2, inputs) of the wgmma route
WGMMA_CASES = {
    "convnext_stage3": (4096, 1536, 6144, 1536, {}),
    "sva_mlp": (576, 1024, 1024, 4096, dict(b1=False, b2=False)),
    "chunk_boundary": (HIDDEN_CHUNK_BYTES // (2 * 1536) + 131, 384, 1536, 384, {}),
    "m_not_128": (645, 384, 1536, 384, {}),
    "m_below_tile": (77, 48, 192, 40, {}),
    "h_not_tile": (300, 256, 200, 256, {}),
    "c2_not_tile": (300, 256, 1024, 1000, {}),
    "b1_only": (300, 256, 512, 256, dict(b2=False)),
    "b2_only": (300, 256, 512, 256, dict(b1=False)),
    "ldx_gt_c": (300, 256, 1024, 256, dict(ldx=264)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_wgmma_route_matches_plain_on_card(cuda_device, case):
    m, c, h, c2, kw = WGMMA_CASES[case]
    args = _inputs(cuda_device, m, c, h, c2, **kw)
    x, w1t, w2t = args[0], args[1].t(), args[3].t()
    plan = _plan(m, c, h, c2, x.stride(0), (x.data_ptr(), w1t.data_ptr(), w2t.data_ptr()))
    assert plan.route == "wgmma"
    if case == "chunk_boundary":
        assert plan.chunks == 2
    before = fused_mlp.fused_mlp.launches
    out = fused_mlp.fused_mlp(*args)
    assert fused_mlp.fused_mlp.launches == before + 1       # calls, not CUDA launches
    names = _kernels_run(args)
    assert any("mlp_up_kernel" in n for n in names), names
    assert any("mlp_down_kernel" in n for n in names), names
    assert not any("fused_mlp_tc_kernel" in n for n in names), names
    _held(out, args)


@pytest.mark.cuda
def test_unaligned_operands_take_the_mma_sync_kernel_on_card(cuda_device):
    m, c, h, c2 = 576, 1024, 1024, 1024
    args = _inputs(cuda_device, m, c, h, c2, ldx=c + 1, offset=1)
    x = args[0]
    assert _plan(m, c, h, c2, x.stride(0), (x.data_ptr(), 0, 0)).route == "mma_sync"
    out = fused_mlp.fused_mlp(*args)
    names = _kernels_run(args)
    assert any("fused_mlp_tc_kernel" in n for n in names), names
    assert not any("mlp_up_kernel" in n or "mlp_down_kernel" in n for n in names), names
    _held(out, args)


@pytest.mark.cuda
def test_bf16_request_with_grad_raises_on_card(cuda_device):
    x, w1, b1, w2, b2 = _inputs(cuda_device, 256, 64, 256, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mlp.fused_mlp(x, w1.detach().requires_grad_(True), b1, w2, b2)

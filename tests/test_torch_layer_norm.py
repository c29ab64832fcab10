"""K6, the fused LayerNorm: how the wrapper plans a call (``_ln_plan``: the
kernel function, lanes a row, chunks a lane, the grid), on the CPU; a model of
the vector kernel's order of sums against the JAX ``fused_layer_norm`` (the
Pallas kernel in interpret mode), on the CPU; and the kernel functions
against the plain version, on the card.

``tests/test_torch_vision_kernels.py`` holds the plain version against the
JAX function and its gradients. The kernels run only on the card (marker
``cuda``; without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_layer_norm.py``).
"""

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops import norms
import os
import re

from cambrian_tpu_torch.ops.norms import LN_INSTANCES, LnPlan, _ln_plan

SMS = 132
BLOCKS_PER_SM = 8        # a stand-in for the card's occupancy


def _occupancy(lanes, chunks, warps):
    return BLOCKS_PER_SM


# the LayerNorm sites of one Cambrian-8B request (chip_smoke.py phase 10):
# (C, rows) -> (lanes, chunks a lane, warps a block, blocks) in bf16
SITES = {
    "convnext_stage1": ((384, 65536), (16, 3, 4, SMS * BLOCKS_PER_SM)),
    "convnext_stage2": ((768, 16384), (32, 3, 4, SMS * BLOCKS_PER_SM)),
    "convnext_stage3": ((1536, 4096), (32, 6, 4, 1024)),
    "convnext_stage4": ((3072, 1024), (32, 12, 2, 512)),
    "sva_1024x576": ((1024, 576), (32, 4, 2, 288)),
    "sva_1024x9216": ((1024, 9216), (32, 4, 4, SMS * BLOCKS_PER_SM)),
    "clip": ((1024, 577), (32, 4, 2, 289)),
    "siglip": ((1152, 729), (32, 5, 2, 365)),
    "dinov2": ((1536, 730), (32, 6, 2, 365)),
}


def _rows_visited(rows, plan):
    """The rows each warp of the vector kernel's grid-stride loop takes, in
    the kernel's indexing: warp w takes row groups w, w + W, ... (W the
    grid's warps), rows g * (32 / lanes) + sub of group g."""
    per = 32 // plan.lanes
    groups = -(-rows // per)
    n_warps = plan.blocks * plan.warps
    visits = []
    for w in range(n_warps):
        g = np.arange(w, groups, n_warps)
        r = (g[:, None] * per + np.arange(per)[None, :]).ravel()
        visits.append(r[r < rows])
    return visits


@pytest.mark.parametrize("site", list(SITES))
def test_plan_at_the_request_sites(site):
    (cols, rows), (lanes, chunks, warps, blocks) = SITES[site]
    plan = _ln_plan(rows, cols, torch.bfloat16, True, SMS, _occupancy)
    assert plan == LnPlan("layer_norm_vec_kernel", lanes, chunks, warps, blocks)
    # the row in the fewest chunks a lane; no slot empty where it splits evenly
    assert lanes * (chunks - 1) * 8 < cols <= lanes * chunks * 8
    assert cols == lanes * chunks * 8 or (cols // 8) % lanes
    visits = _rows_visited(rows, plan)
    seen = np.concatenate(visits)
    assert len(seen) == rows and np.array_equal(np.sort(seen), np.arange(rows))
    groups = -(-rows // (32 // lanes))
    assert plan.blocks <= SMS * BLOCKS_PER_SM          # every block resident at once
    if groups <= norms.LN_SMALL_GROUPS:
        # one row group a warp, and every SM gets a block
        assert plan.blocks * plan.warps >= groups and plan.blocks >= SMS
        assert max(len(v) for v in visits) <= 32 // lanes
    else:
        # the warps' shares differ by at most one row group
        shares = {len(v) // (32 // lanes) for v in visits}
        assert max(shares) - min(shares) <= 1


@pytest.mark.parametrize("cols,dtype,lanes,chunks", [
    (1000, torch.bfloat16, 32, 4),      # 125 chunks: no exact split, 3 slots empty
    (72, torch.bfloat16, 16, 1),        # 9 chunks
    (100, torch.float32, 32, 1),        # 25 chunks
    (4096, torch.bfloat16, 32, 16),     # the widest the vector kernel takes in bf16
    (2048, torch.float32, 32, 16),      # and in fp32
    (96, torch.bfloat16, 4, 3),         # 12 chunks: sub-warps of 4
    (384, torch.bfloat16, 16, 3),       # 48 chunks: sub-warps of 16
    (512, torch.bfloat16, 32, 2),       # 64 chunks: a whole warp
    (1152, torch.float32, 32, 9),       # 288 chunks
], ids=["c1000", "c72", "fp32_c100", "c4096", "fp32_c2048", "c96", "c384", "c512",
        "fp32_c1152"])
def test_plan_covers_rows_of_any_whole_chunks(cols, dtype, lanes, chunks):
    plan = _ln_plan(300, cols, dtype, True, SMS, _occupancy)
    assert (plan.function, plan.lanes, plan.chunks) == ("layer_norm_vec_kernel", lanes, chunks)
    per = 8 if dtype == torch.bfloat16 else 4
    assert (lanes, chunks) in LN_INSTANCES
    assert lanes * (chunks - 1) * per < cols <= lanes * chunks * per
    assert np.array_equal(np.sort(np.concatenate(_rows_visited(300, plan))), np.arange(300))


@pytest.mark.parametrize("cols,dtype,aligned", [
    (100, torch.bfloat16, True),        # C % 8
    (102, torch.float32, True),         # C % 4
    (1024, torch.bfloat16, False),      # a base off 16 bytes
    (5760, torch.bfloat16, True),       # 720 chunks: wider than 32 x 16
    (4100, torch.float32, True),
], ids=["odd_c_bf16", "odd_c_fp32", "unaligned", "too_wide_bf16", "too_wide_fp32"])
def test_plan_routes_the_rest_to_the_scalar_kernel(cols, dtype, aligned):
    plan = _ln_plan(577, cols, dtype, aligned, SMS, _occupancy)
    assert plan.function == "layer_norm_kernel"
    assert plan.warps == 8 and plan.blocks == -(-577 // 8)


@pytest.mark.parametrize("rows,cols,lanes,warps,want", [
    (576, 384, 16, 4, LnPlan("layer_norm_vec_kernel", 16, 3, 4, 72)),
    (576, 384, 32, 1, LnPlan("layer_norm_vec_kernel", 32, 2, 1, 576)),
    # 8 lanes of 16 chunks is not an instance: no vector plan
    (576, 1024, 8, 4, LnPlan("layer_norm_kernel", 32, 0, 8, 72)),
], ids=["sub_warp", "whole_warp", "not_instantiated"])
def test_plan_forces_lanes_and_warps(rows, cols, lanes, warps, want):
    assert _ln_plan(rows, cols, torch.bfloat16, True, SMS, _occupancy, lanes, warps) == want


def test_instances_are_the_shapes_the_plan_gives():
    """LN_INSTANCES holds exactly the (lanes, chunks a lane) pairs that the
    plan gives some row of whole chunks (1 to 32 x 16 of them), at any dtype."""
    given = set()
    for chunks in range(1, 32 * 16 + 1):
        for dtype, per in ((torch.bfloat16, 8), (torch.float32, 4)):
            plan = _ln_plan(100, chunks * per, dtype, True, SMS, _occupancy)
            assert plan.function == "layer_norm_vec_kernel", (chunks, dtype)
            given.add((plan.lanes, plan.chunks))
    assert given == set(LN_INSTANCES)
    assert len(LN_INSTANCES) == len(given)


def test_instances_match_the_source():
    """csrc/layer_norm.cu instantiates layer_norm_vec_kernel at the pairs of
    LN_INSTANCES, in the same order."""
    path = os.path.join(os.path.dirname(norms.__file__), "..", "csrc", "layer_norm.cu")
    with open(path) as f:
        src = f.read()
    table = re.search(r"#define LN_VEC_INSTANCES\(X\)((?:.*\\\n)*.*)", src).group(1)
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", table))
    assert pairs == LN_INSTANCES


def _fma32(a, b, c):
    """fmaf in fp32: the exact product and sum, rounded once (float64 holds
    the product of two fp32 exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _vector_kernel_model(x, w, b, eps, plan, per):
    """layer_norm_vec_kernel's arithmetic in fp32 on the CPU, in its order:
    each lane sums its chunks (chunk j * lanes + lane) element by element,
    the sub-warp adds the lanes' sums by a butterfly (xor offsets lanes/2 ..
    1), the same for the centred squares (fmaf), rsqrt, then fmaf(y, w, b)."""
    rows, cols = x.shape
    lanes, vpl = plan.lanes, plan.chunks
    slots = lanes * vpl * per
    pad = torch.zeros((rows, slots - cols))
    xs = torch.cat([x, pad], 1).reshape(rows, vpl, lanes, per)
    live = torch.cat([torch.ones(cols), torch.zeros(slots - cols)]).reshape(vpl, lanes, per)
    idx = torch.arange(lanes)

    def butterfly(v):
        off = lanes // 2
        while off:
            v = v + v[:, idx ^ off]
            off //= 2
        return v

    s = torch.zeros((rows, lanes))
    for j in range(vpl):
        for e in range(per):
            s = s + xs[:, j, :, e]
    mean = butterfly(s) / cols                          # [rows, lanes], equal along lanes
    ss = torch.zeros((rows, lanes))
    for j in range(vpl):
        for e in range(per):
            d = xs[:, j, :, e] - mean
            ss = torch.where(live[j, :, e].bool(), _fma32(d, d, ss), ss)
    inv = torch.rsqrt(butterfly(ss) / cols + eps)[:, :1]
    y = (x - mean[:, :1]) * inv
    return _fma32(y, w[None, :], b[None, :])


@pytest.mark.parametrize("cols", [384, 1024, 1152, 1536])
@pytest.mark.parametrize("layout", ["float32", "bfloat16"])
def test_vector_kernel_sum_order_matches_jax(cols, layout):
    """The model of the vector kernel, in the lane layout the plan gives fp32
    or bf16 rows (4 or 8 elements a chunk), on fp32 inputs, against the JAX
    ``fused_layer_norm`` (its Pallas kernel in interpret mode)."""
    import jax.numpy as jnp

    from cambrian_tpu.ops.norms import fused_layer_norm as jfused

    dtype = getattr(torch, layout)
    per = 8 if dtype == torch.bfloat16 else 4
    rows = 24
    plan = _ln_plan(rows, cols, dtype, True, SMS, _occupancy)
    assert plan.function == "layer_norm_vec_kernel"
    rng = np.random.default_rng(cols)
    xa = (rng.standard_normal((rows, cols)) * 3 + 1).astype(np.float32)
    wa = rng.standard_normal(cols).astype(np.float32)
    ba = rng.standard_normal(cols).astype(np.float32)
    want = np.asarray(jfused(jnp.asarray(xa), jnp.asarray(wa), jnp.asarray(ba), 1e-6,
                             interpret=True))
    got = _vector_kernel_model(torch.from_numpy(xa), torch.from_numpy(wa),
                               torch.from_numpy(ba), 1e-6, plan, per)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # and the plain version the wrapper takes on the CPU
    plain = norms.fused_layer_norm(torch.from_numpy(xa), torch.from_numpy(wa),
                                   torch.from_numpy(ba), 1e-6)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)


# -- the kernels, on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(device, rows, cols, dtype, offset=0):
    """x [rows, cols] starting ``offset`` elements into its storage, w, b and
    the plain version on the fp32-upcast inputs."""
    g = torch.Generator(device=device).manual_seed(rows + cols + offset)
    store = (torch.randn(rows * cols + offset, generator=g, device=device) * 3 + 1).to(dtype)
    x = store[offset:].view(rows, cols)
    w = torch.randn(cols, generator=g, device=device)
    b = torch.randn(cols, generator=g, device=device)
    return x, w, b, norms.fused_layer_norm_reference(x.float(), w, b, 1e-6)


def _run_counted(x, w, b):
    norms.fused_layer_norm.function_launches.clear()
    before = norms.fused_layer_norm.launches
    out = norms.fused_layer_norm(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert norms.fused_layer_norm.launches == before + 1
    return out, dict(norms.fused_layer_norm.function_launches)


def _held(out, want, dtype):
    assert torch.isfinite(out).all() and out.dtype == dtype
    rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    tol = rel * max(1.0, float(want.abs().max()))
    err = float((out.float() - want).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows,cols,function", [
    *[(r, c, "layer_norm_vec_kernel") for (c, r), _ in SITES.values()],
    (300, 1000, "layer_norm_vec_kernel"),       # 1000 bf16: 125 chunks, 3 slots empty
    (33, 72, "layer_norm_vec_kernel"),
], ids=[*SITES, "c1000", "c72"])
def test_kernel_matches_plain_on_card(cuda_device, dtype, rows, cols, function):
    x, w, b, want = _card_case(cuda_device, rows, cols, dtype)
    if dtype == torch.float32 and cols > 2048:
        function = "layer_norm_kernel"          # wider than 32 x 16 fp32 chunks
    out, counts = _run_counted(x, w, b)
    assert counts == {function: 1}
    _held(out, want, dtype)
    # the same bits on a second call (fixed order of sums)
    assert torch.equal(norms.fused_layer_norm(x, w, b, 1e-6), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows,cols,offset", [(577, 1024, 1), (300, 100, 0), (5, 5760, 0)],
                         ids=["unaligned_base", "odd_c", "too_wide"])
def test_scalar_route_on_card(cuda_device, dtype, rows, cols, offset):
    if dtype == torch.float32 and cols == 100:
        cols = 102                              # 100 fp32 is whole chunks
    x, w, b, want = _card_case(cuda_device, rows, cols, dtype, offset)
    out, counts = _run_counted(x, w, b)
    assert counts == {"layer_norm_kernel": 1}
    _held(out, want, dtype)


@pytest.mark.cuda
def test_c_entry_refuses_a_shape_the_plan_would_not_give(cuda_device):
    x, w, b, _ = _card_case(cuda_device, 576, 1024, torch.bfloat16)
    out = torch.empty_like(x)
    lib = norms._library()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr())
    for lanes, vpl, warps, blocks in [(32, 8, 2, 288),      # not the fewest chunks a lane
                                      (32, 4, 2, 289),      # a block without rows
                                      (32, 4, 8, 36),       # blocks of 8 warps
                                      (24, 4, 2, 288),      # lanes not instantiated
                                      (8, 16, 4, 36)]:      # a pair not instantiated
        err = lib.cambrian_layer_norm_vec(1, *ptrs, 576, 1024, 1e-6, lanes, vpl, warps, blocks,
                                          stream)
        assert err != 0, (lanes, vpl, warps, blocks)
    assert lib.cambrian_layer_norm_vec(1, *ptrs, 576, 1024, 1e-6, 32, 4, 2, 288, stream) == 0

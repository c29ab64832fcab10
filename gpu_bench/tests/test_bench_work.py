"""The work, roofline and MFU arithmetic on shapes worked by hand, and the
trace reduction on a made-up trace."""

from types import SimpleNamespace

import pytest

from gpu_bench.harness import readers
from gpu_bench.harness import trace as trace_mod
from gpu_bench.work import kernels, model

PEAKS = {"bf16_flops": 1000.0, "hbm_bytes_per_s": 100.0}


def test_causal_pairs():
    assert kernels.causal_pairs([1, 2, 4]) == 1 + 3 + 10


def test_attention_forward_work():
    # 10 pairs, 2 heads of 4: 4 x 10 x 2 x 4 operations; q and o 3 x 2 x 4
    # bf16 each, k and v 5 rows x 1 head x 4 bf16 each, fp32 statistics 3 x 2
    ops, io = kernels.attention_fwd(10, 2, 4, 3, 5, 1)
    assert ops == 320
    assert io == (2 * 3 * 2 * 4 + 2 * 5 * 1 * 4) * 2 + 3 * 2 * 4


def test_attention_backward_work():
    ops, io = kernels.attention_bwd(6, 1, 2, 4, 1)
    assert ops == 10 * 6 * 1 * 2
    # q, o, dO, dq like q and k, v, dk, dv like k, 4 x 1 x 2 bf16 each; lse fp32
    assert io == 8 * (4 * 1 * 2 * 2) + 4 * 1 * 4


def test_quant_gemv_work():
    ops, io = kernels.quant_gemv(8, 64, 32, 8)
    assert ops == 2 * 8 * 64 * 32
    assert io == 64 * 32 + 32 * 4 + 8 * 64 * 2 + 8 * 32 * 2
    _, io4 = kernels.quant_gemv(1, 256, 16, 4, group=128)
    assert io4 == 256 * 16 // 2 + 16 * 2 * 4 + 256 * 2 + 16 * 2


def test_roofline_is_the_larger_bound():
    assert kernels.roofline_seconds(1000.0, 50.0, 1000.0, 100.0) == 1.0
    assert kernels.roofline_seconds(10.0, 300.0, 1000.0, 100.0) == 3.0


def _tiny_cfg():
    tower = dict(kind="vit", image_size=4, patch=2, hidden=2, heads=1, mlp=3, class_token=False,
                 swiglu=False, blocks_run=1, tokens=4, out_dim=2)
    m = dict(vision_hidden_size=2, hidden_size=4, image_token_len=4, connector_depth=1,
             num_of_vision_sampler_layers=1, intermediate_size=5, num_attention_heads=2,
             num_key_value_heads=1, head_dim=2, num_hidden_layers=3, vocab_size=7)
    return {"model": m, "towers": [tower]}


def test_decoder_and_decode_flops():
    cfg = _tiny_cfg()
    # per layer: q and o 2 x (4 x 4), k and v 2 x (4 x 2), MLP 3 x 4 x 5; 2 a MAC
    assert model.decoder_token(cfg) == 2 * 3 * (2 * 16 + 2 * 8 + 60)
    assert model.attention_pairs(cfg, 10) == 4 * 3 * 2 * 2 * 10
    assert model.decode_token(cfg, 9) == model.decoder_token(cfg) + 4 * 3 * 2 * 2 * 10 + 2 * 4 * 7


def test_vit_flops():
    cfg = _tiny_cfg()
    # 4 patches of 2 x 2 x 3 inputs into 2 channels; a block over 4 tokens of width 2
    patch = 2 * 4 * 2 * 3 * 4
    block = 8 * 4 * 2 * 2 + 4 * 4 * 4 * 2 + 4 * 4 * 2 * 3
    assert model.towers(cfg) == patch + block


def test_mfu_and_roofline_readers():
    ctx = SimpleNamespace(peaks=PEAKS, trace=SimpleNamespace(window_ns=2e9))
    assert readers.mfu(ctx, 500.0) == pytest.approx(25.0)
    assert readers.mfu(ctx, 0.0) is None


class _Event:
    def __init__(self, name, dev, start, dur, corr, link=0):
        self._v = (name, dev, start, dur, corr, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _trace():
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    return trace_mod.Trace([
        _Event("bench.trace_window", cpu, 0, 1000, 1),
        _Event("bench.decode_step#0", cpu, 10, 100, 2),
        _Event("aten::mm", cpu, 20, 10, 3),
        _Event("bench.decode_step#1", cpu, 200, 100, 4),
        _Event("aten::mm", cpu, 210, 10, 5),
        _Event("gemv_m8_kernel<0,8,16>", gpu, 100, 300, 90, 3),
        _Event("elementwise", gpu, 500, 100, 91, 5),
        _Event("gemv_m8_kernel<0,8,16>", gpu, 600, 200, 92, 5),
    ])


def test_a_kernel_is_tied_to_the_call_that_launched_it():
    """The launch calls' correlation ids and the ops' ids are series of
    their own that overlap as numbers: the kernel (its own id 7, linked to
    op 3) goes to the span of its launch call 7, not to that of the op
    numbered 7 or of the call numbered 3."""
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    tr = trace_mod.Trace([
        _Event("bench.trace_window", cpu, 0, 1000, 1),
        _Event("bench.prefill#0", cpu, 10, 100, 2),
        _Event("aten::mm", cpu, 20, 10, 3),
        _Event("cuLaunchKernelEx", cpu, 22, 5, 7),
        _Event("gemm_wgmma_kernel<0,128>", gpu, 100, 300, 7, 3),
        _Event("bench.decode_step#0", cpu, 400, 100, 6),
        _Event("aten::add", cpu, 410, 10, 7),
        _Event("cudaLaunchKernel", cpu, 412, 5, 3),
    ])
    assert tr.kernels_under(["decode_step"], "gemm") == {}
    assert tr.kernels_under(["prefill"], "gemm") == {
        "bench.prefill#0": [("gemm_wgmma_kernel<0,128>", 300)]}
    assert tr.unlinked == 0 and tr.outside == 0


def test_trace_ties_kernels_to_spans_and_counts_idle():
    tr = _trace()
    assert tr.window_ns == 1000 and tr.busy_ns == 300 + 300
    per = tr.kernels_under(["decode_step"], "gemv_m8_kernel")
    assert per == {"bench.decode_step#0": [("gemv_m8_kernel<0,8,16>", 300)],
                   "bench.decode_step#1": [("gemv_m8_kernel<0,8,16>", 200)]}
    ctx = SimpleNamespace(trace=tr, log={}, peaks=PEAKS)
    assert readers.device_ms_per_span(ctx, "decode_step") == pytest.approx((300 + 300) / 2 / 1e6)
    assert readers.idle_share(ctx) == pytest.approx(40.0)
    # each span's work bounded at 100 ns of the 500 its K3 kernels took
    ctx.log = {"decode_step": {0: {}, 1: {}}}
    share = readers.roofline(ctx, ["decode_step"], "gemv_m8_kernel", lambda kind, work: 1e-7)
    assert share == pytest.approx(100.0 * 2e-7 / 5e-7)
    assert sum(v for _, v in tr.idle_gaps()) == pytest.approx(400 / 1e9)

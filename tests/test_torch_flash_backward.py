"""Parity of K2, the port's flash-attention backward
(cambrian_tpu_torch/ops/flash_attention.py), with the JAX package's: the
plain version ``flash_attention_bwd_reference`` (recomputing the row
statistics, or given the forward's log-sum-exp) against the Pallas kernel
``_flash_bwd_impl`` in interpret mode, and autograd through the port's CPU
``flash_attention`` against ``jax.grad`` through JAX ``flash_attention``, on
the CPU in fp32; the CUDA kernel against the plain version on the card, and a
tiny train step on the card against the CPU (marker ``cuda``).

JAX is imported inside the helpers, so that on a machine with a card and no
JAX ``python -m pytest --noconftest -m cuda tests/test_torch_flash_backward.py``
runs the kernel cases alone.
"""

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops.flash_attention import (
    _flash_fwd,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_lse_reference,
    flash_attention_reference,
)

TOL = 1e-5  # fp32 on the CPU: same math, summation order differs


def _inputs(b, s_q, s_k, h, kvh, d, seed, valid_len=None):
    """q, k, v, key validity, the forward output and its cotangent."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_q, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s_k, kvh, d), dtype=np.float32)
    v = rng.standard_normal((b, s_k, kvh, d), dtype=np.float32)
    do = rng.standard_normal((b, s_q, h, d), dtype=np.float32)
    lens = valid_len if valid_len is not None else [s_k] * b
    valid = np.arange(s_k)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, valid, do


def _jax_bwd(q, k, v, valid, o, do, causal, window, q_offset):
    """The Pallas backward in interpret mode on [B, S, H, D] inputs; K/V are
    repeated over each kv head's group, as the JAX decoder does, and the
    per-head dk/dv summed back over the group."""
    import jax.numpy as jnp

    from cambrian_tpu.ops.flash_attention import _flash_bwd_impl

    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    k = np.repeat(k, group, axis=2)
    v = np.repeat(v, group, axis=2)

    def flat(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d))

    def unflat(x, s):
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)

    dq, dk, dv = _flash_bwd_impl(
        flat(q), flat(k), flat(v), jnp.asarray(np.repeat(valid, h, axis=0)), flat(o), flat(do),
        d ** -0.5, causal, window, q_offset, block_q=128, interpret=True)
    dk = unflat(dk, s_k).reshape(b, s_k, kvh, group, d).sum(3)
    dv = unflat(dv, s_k).reshape(b, s_k, kvh, group, d).sum(3)
    return unflat(dq, s_q), dk, dv


CASES = {
    # name: (b, s_q, s_k, h, kvh, d, valid_len, causal, window, q_offset)
    "full": (2, 130, 130, 2, 2, 64, None, False, None, 0),
    "key_padding": (2, 64, 128, 2, 2, 64, [97, 128], False, None, 0),
    "causal": (2, 96, 96, 2, 2, 32, [96, 70], True, None, 0),
    "causal_offset": (2, 8, 128, 2, 2, 64, [128, 100], True, None, 120),
    "sliding_window": (1, 96, 96, 2, 2, 32, None, True, 16, 0),
    "gqa": (2, 70, 70, 4, 2, 32, [70, 50], True, None, 0),
    "head_dim_72": (1, 80, 80, 2, 2, 72, None, False, None, 0),
    # the head dimensions above 128 (the JAX backward pads D to 256 or 384):
    # causal with GQA and padding, and under a sliding window
    "head_dim_136_gqa": (2, 70, 70, 4, 2, 136, [70, 45], True, None, 0),
    "head_dim_192_window": (1, 96, 96, 2, 2, 192, None, True, 16, 0),
    "head_dim_256_gqa": (2, 70, 70, 4, 2, 256, [70, 45], True, None, 0),
    "head_dim_256_window": (1, 80, 96, 2, 1, 256, [90], True, 24, 16),
}


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_pallas_interpret(name):
    b, s_q, s_k, h, kvh, d, lens, causal, window, q_offset = CASES[name]
    q, k, v, valid, do = _inputs(b, s_q, s_k, h, kvh, d, seed=len(name), valid_len=lens)
    tq, tk, tv, tvalid, tdo = _t(q, k, v, valid, do)
    o = flash_attention_reference(tq, tk, tv, tvalid, causal, window, q_offset)
    got = flash_attention_bwd_reference(tq, tk, tv, tvalid, o, tdo, causal, window, q_offset)
    want = _jax_bwd(q, k, v, valid, o.numpy(), do, causal, window, q_offset)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES) + ["dead_rows"])
def test_plain_backward_given_statistic_matches_pallas_interpret(name):
    """Given the forward's row statistic (as K2 runs), p = exp(x - lse) with
    masked entries 0 is the JAX backward's whole-row recomputation; a row
    with no live key (lse = +inf) gives p = 0, dq = 0 and adds nothing."""
    if name == "dead_rows":
        b, s_q, s_k, h, kvh, d, lens, causal, window, q_offset = 2, 40, 40, 2, 2, 16, None, \
            True, None, 0
    else:
        b, s_q, s_k, h, kvh, d, lens, causal, window, q_offset = CASES[name]
    q, k, v, valid, do = _inputs(b, s_q, s_k, h, kvh, d, seed=len(name) + 3, valid_len=lens)
    if name == "dead_rows":
        valid[0, :10] = False
        valid[1] = False
    tq, tk, tv, tvalid, tdo = _t(q, k, v, valid, do)
    o = flash_attention_reference(tq, tk, tv, tvalid, causal, window, q_offset)
    lse = flash_attention_lse_reference(tq, tk, tvalid, causal, window, q_offset)
    got = flash_attention_bwd_reference(tq, tk, tv, tvalid, o, tdo, causal, window, q_offset,
                                        lse=lse)
    want = _jax_bwd(q, k, v, valid, o.numpy(), do, causal, window, q_offset)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL, err_msg=what)
    if name == "dead_rows":
        dq, dk, dv = got
        assert (dq[1] == 0).all() and (dq[0, :10] == 0).all()
        assert (dk[1] == 0).all() and (dv[1] == 0).all() and (dk[0, :10] == 0).all()


def test_dead_rows_backward_is_zero():
    # batch 1 has no valid key; in batch 0 the causal rows before the first
    # valid key (keys 0..9 invalid) have none either
    b, s, h, d = 2, 40, 2, 16
    q, k, v, _, do = _inputs(b, s, s, h, h, d, seed=7)
    valid = np.ones((b, s), bool)
    valid[0, :10] = False
    valid[1] = False
    tq, tk, tv, tvalid, tdo = _t(q, k, v, valid, do)
    o = flash_attention_reference(tq, tk, tv, tvalid, causal=True)
    dq, dk, dv = flash_attention_bwd_reference(tq, tk, tv, tvalid, o, tdo, causal=True)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    assert (dq[1] == 0).all() and (dq[0, :10] == 0).all()
    assert (dk[1] == 0).all() and (dv[1] == 0).all() and (dk[0, :10] == 0).all()
    assert dq[0, 10:].abs().max() > 0
    want = _jax_bwd(q, k, v, valid, o.numpy(), do, True, None, 0)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["causal_offset", "gqa", "key_padding", "sliding_window"])
def test_cpu_autograd_matches_jax_grad(name):
    """Autograd through the port's CPU ``flash_attention`` (the plain
    version) against ``jax.grad`` through JAX ``flash_attention`` (its XLA
    path on the CPU), for the loss sum(out * do)."""
    import jax
    import jax.numpy as jnp

    from cambrian_tpu.ops.flash_attention import flash_attention as j_flash

    b, s_q, s_k, h, kvh, d, lens, causal, window, q_offset = CASES[name]
    q, k, v, valid, do = _inputs(b, s_q, s_k, h, kvh, d, seed=len(name) + 1, valid_len=lens)
    group = h // kvh

    def j_loss(q, k, v):
        out = j_flash(q, jnp.repeat(k, group, axis=2), jnp.repeat(v, group, axis=2),
                      jnp.asarray(valid), causal=causal, sliding_window=window,
                      q_offset=q_offset)
        return jnp.sum(out * do)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tvalid, tdo = _t(q, k, v, valid, do)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    out = flash_attention(tq, tk, tv, tvalid, causal, window, q_offset)
    (out * tdo).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_wrapper_routes_cpu_tensors_to_plain():
    q, k, v, valid, do = _inputs(1, 20, 24, 4, 2, 8, seed=3, valid_len=[21])
    args = _t(q, k, v, valid)
    o = flash_attention_reference(*args, causal=True, q_offset=4)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*args, o, torch.from_numpy(do), causal=True, q_offset=4)
    assert flash_attention_bwd.launches == before
    want = flash_attention_bwd_reference(*args, o, torch.from_numpy(do), causal=True,
                                         q_offset=4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_wrapper_routes_cpu_tensors_with_statistic_to_plain():
    q, k, v, valid, do = _inputs(2, 30, 30, 4, 2, 8, seed=4, valid_len=[30, 11])
    args = _t(q, k, v, valid)
    o = flash_attention_reference(*args, causal=True, sliding_window=9)
    lse = flash_attention_lse_reference(args[0], args[1], args[3], True, 9)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    got = flash_attention_bwd(*args, o, torch.from_numpy(do), True, 9, lse=lse)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (f0, b0)
    want = flash_attention_bwd_reference(*args, o, torch.from_numpy(do), True, 9)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# (b, s_q, s_k, h, kvh, d, causal, window, q_offset, key mask): "pad" has
# dead causal rows at the start, padding at the end and a batch row with no
# valid key; "hole" a key tile (keys 64..127) with no valid key in the middle
KERNEL_CASES = {
    "siglip": (1, 729, 729, 16, 16, 72, False, None, 0, None),
    "clip": (1, 577, 577, 16, 16, 64, False, None, 0, None),
    "decoder_gqa": (2, 640, 640, 32, 8, 128, True, None, 0, "pad"),
    "window_offset": (2, 100, 180, 4, 2, 48, True, 33, 50, "pad"),
    "ragged": (3, 130, 70, 6, 3, 40, False, None, 0, "pad"),
    "dead_key_tile": (2, 300, 300, 4, 2, 64, True, None, 0, "hole"),
    "ragged_q": (3, 70, 200, 4, 4, 40, False, None, 0, "pad"),
    "d72_window": (2, 150, 150, 4, 2, 72, True, 40, 0, "hole"),
    "d96": (2, 130, 130, 4, 2, 96, True, None, 0, None),
    "d24_offset": (2, 40, 100, 2, 1, 24, True, None, 60, "pad"),
    # above 128 the dk/dv step is two launches (dV alone, dK alone) in bf16,
    # and the fp32 kernels take 32-row q tiles: Gemma-7B's training shape
    # cut in length (16 heads of 256, causal, padding), D = 192 under a
    # window with an empty key tile, and D = 136 (32-byte swizzle) ragged
    "gemma_d256": (2, 640, 640, 16, 16, 256, True, None, 0, "pad"),
    "d192_window_hole": (2, 150, 150, 4, 2, 192, True, 40, 0, "hole"),
    "d136_ragged": (3, 130, 70, 4, 2, 136, False, None, 0, "pad"),
}


def _card_inputs(device, dtype, b, s_q, s_k, h, kvh, d, mask):
    g = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    q, k, v, do = rand(b, s_q, h, d), rand(b, s_k, kvh, d), rand(b, s_k, kvh, d), rand(b, s_q, h, d)
    valid = torch.ones((b, s_k), dtype=torch.bool, device=device)
    if mask == "pad":
        valid[:, : s_k // 7] = False     # dead causal rows at the start
        valid[:, -s_k // 5:] = False     # padding at the end
        valid[-1] = False                # a batch row with no valid key
    elif mask == "hole":
        valid[:, 64:128] = False         # a whole key tile with no valid key
    return q, k, v, valid, do


def _card_tol(dtype, ref):
    # fp32: same math in another summation order; bf16: the output's
    # rounding (2^-8 relative) of values up to |ref|max
    rel = 1e-4 if dtype == torch.float32 else 2 ** -7
    return rel * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_backward_matches_plain_on_card(cuda_device, name, dtype):
    b, s_q, s_k, h, kvh, d, causal, window, q_offset, mask = KERNEL_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v, valid, do = _card_inputs(cuda_device, dt, b, s_q, s_k, h, kvh, d, mask)
    o, lse = _flash_fwd(q, k, v, valid, causal, window, q_offset, d ** -0.5, with_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, valid, o, do, causal, window, q_offset, lse=lse)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_reference(q.float(), k.float(), v.float(), valid, o.float(),
                                         do.float(), causal, window, q_offset)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dt and g.shape == w.shape, what
        assert torch.isfinite(g).all(), what
        torch.testing.assert_close(g.float(), w, atol=_card_tol(dt, w), rtol=0, msg=what)
    if mask == "pad":
        assert (got[0][-1] == 0).all() and (got[1][-1] == 0).all() and (got[2][-1] == 0).all()
    if mask == "hole":
        assert (got[1][:, 64:128] == 0).all() and (got[2][:, 64:128] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["d72_window", "decoder_gqa", "ragged", "gemma_d256"])
def test_backward_with_saved_statistic_matches_direct_call(cuda_device, name, dtype):
    """FlashAttentionFunction's backward (the statistic K1 wrote in the
    forward, saved) against ``flash_attention_bwd`` called without it (one
    more K1 launch writes it): the same kernels on the same inputs, so the
    same bits."""
    b, s_q, s_k, h, kvh, d, causal, window, q_offset, mask = KERNEL_CASES[name]
    q, k, v, valid, do = _card_inputs(cuda_device, getattr(torch, dtype), b, s_q, s_k, h, kvh,
                                      d, mask)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, valid, causal, window, q_offset)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) == (1, 1)
    got = flash_attention_bwd(q, k, v, valid, out.detach(), do, causal, window, q_offset)
    torch.cuda.synchronize()
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) == (2, 2)
    for leaf, g in zip(leaves, got):
        torch.testing.assert_close(leaf.grad, g, atol=0, rtol=0)


@pytest.mark.cuda
def test_autograd_on_card_matches_cpu(cuda_device):
    """FlashAttentionFunction: K1 forward and K2 backward on the card, fp32,
    against autograd through the plain version on the CPU."""
    b, s_q, s_k, h, kvh, d, causal, window, q_offset, mask = KERNEL_CASES["window_offset"]
    q, k, v, valid, do = _card_inputs(cuda_device, torch.float32, b, s_q, s_k, h, kvh, d, mask)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    cpu_leaves = [x.detach().cpu().requires_grad_(True) for x in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, valid, causal, window, q_offset)
    (out * do).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) == (1, 1)
    ref = flash_attention(*cpu_leaves, valid.cpu(), causal, window, q_offset)
    (ref * do.cpu()).sum().backward()
    for g, w in zip(leaves, cpu_leaves):
        torch.testing.assert_close(g.grad.cpu(), w.grad, atol=1e-4, rtol=0)


def _tiny_train_batches(cfg, towers, rng, n, b=2):
    """n packed micro-batches of b samples (the port's packing): an image
    marker, a masked prompt, right padding in the second sample."""
    from cambrian_tpu_torch import IGNORE_INDEX, IMAGE_TOKEN_INDEX, prepare_multimodal_data

    out = []
    for _ in range(n):
        ids = rng.integers(5, cfg.vocab_size, (b, 150)).astype(np.int64)
        ids[:, cfg.image_position] = IMAGE_TOKEN_INDEX
        labels = ids.copy()
        labels[:, :30] = IGNORE_INDEX
        mask = np.ones(ids.shape, bool)
        mask[1, 110:] = False
        ids[1, 110:] = 0
        labels[1, 110:] = IGNORE_INDEX
        pids, plab, pmask, ppos, aux = prepare_multimodal_data(
            ids, labels, mask, [(640, 360), (300, 500)][:b], cfg.image_token_len,
            cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
        images = [rng.standard_normal((b, 3, t.image_size, t.image_size), dtype=np.float32)
                  for t in towers]
        out.append(dict(input_ids=pids, labels=plab, attention_mask=pmask, position_ids=ppos,
                        aux_masks=list(aux), images=images))
    return out


@pytest.mark.cuda
def test_tiny_train_step_on_card_matches_cpu(cuda_device):
    """Stage 1 and stage 2 through ``make_train_step`` on the card (K1 and
    K2, fp32, TF32 off) against the plain path on the CPU, three steps each
    from the same weights: losses within 1e-4 relative, parameters within
    1e-4, K2 once per decoder layer and K1 once per tower block and twice
    per decoder layer (forward, remat recompute) per micro-batch."""
    from cambrian_tpu_torch import tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.train.optimizer import TrainConfig
    from cambrian_tpu_torch.train.train_step import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_debug(2).replace(tokenizer_model_max_length=192)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0), 0.05, dtype=torch.float32,
                           device="cpu")
    towers = CambrianForInference.from_state_dict(cfg, sd, torch.float32).towers
    batches = _tiny_train_batches(cfg, towers, np.random.default_rng(1), 3)
    tower_calls = sum(t.config.num_blocks_to_run for t in towers)
    for stage in (1, 2):
        tc = TrainConfig(learning_rate=1e-3, mm_vision_sampler_lr=5e-4, warmup_ratio=0.34,
                         total_steps=3, lr_scheduler_type="cosine", max_grad_norm=1.0,
                         tune_mm_mlp_adapter=stage == 1)
        runs = {}
        for dev in ("cpu", "cuda"):
            # a copy per device: training updates the parameters in place
            m = CambrianForInference.from_state_dict(
                cfg, {k: v.to(dev, copy=True) for k, v in sd.items()}, torch.float32)
            state = init_train_state(m.lm, m.towers, tc)
            step = make_train_step(m.lm, m.towers, freeze=tc)
            f0, b0 = flash_attention.launches, flash_attention_bwd.launches
            losses = []
            for batch in batches:
                tb = {k: [torch.from_numpy(x).to(dev) for x in v] if isinstance(v, list)
                      else torch.from_numpy(v).to(dev) for k, v in batch.items()}
                losses.append(float(step(state, tb)[1]["loss"]))
            launches = (flash_attention.launches - f0, flash_attention_bwd.launches - b0)
            runs[dev] = (losses, launches,
                         {k: p.detach().cpu() for k, p in m.lm.named_parameters()})
        assert runs["cpu"][1] == (0, 0)
        assert runs["cuda"][1] == (3 * (tower_calls + 2 * cfg.num_hidden_layers),
                                   3 * cfg.num_hidden_layers)
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
        for k, v in runs["cpu"][2].items():
            torch.testing.assert_close(runs["cuda"][2][k], v, atol=1e-4, rtol=0, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["gemma_d256", "lora"])
def test_tiny_gemma_and_lora_train_steps_on_card_match_cpu(cuda_device, variant):
    """Three stage-1 steps of a tiny Cambrian-Gemma at head_dim 256 (K2's
    widest, the fp32 kernels' 32-row tiles), and three LoRA steps of the
    tiny LLaMA Cambrian, on the card (K1/K2, fp32, TF32 off) against the
    CPU from the same weights and adapters: losses within 1e-4 relative,
    trained tensors within 1e-4, K2 once per decoder layer a micro-batch."""
    from cambrian_tpu_torch import tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.train import lora
    from cambrian_tpu_torch.train.optimizer import TrainConfig
    from cambrian_tpu_torch.train.train_step import (
        init_lora_train_state,
        init_train_state,
        make_lora_train_step,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_debug(2).replace(tokenizer_model_max_length=192)
    if variant == "gemma_d256":
        cfg = cfg.replace(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=256,
                          tie_word_embeddings=True, rms_norm_eps=1e-6, num_hidden_layers=2,
                          num_of_vision_sampler_layers=1)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0), 0.05, dtype=torch.float32,
                           device="cpu")
    towers = CambrianForInference.from_state_dict(cfg, sd, torch.float32).towers
    batches = _tiny_train_batches(cfg, towers, np.random.default_rng(1), 3)
    tc = TrainConfig(learning_rate=1e-3, mm_vision_sampler_lr=5e-4, warmup_ratio=0.34,
                     total_steps=3, lr_scheduler_type="cosine", max_grad_norm=1.0,
                     tune_mm_mlp_adapter=variant != "lora")
    runs = {}
    for dev in ("cpu", "cuda"):
        m = CambrianForInference.from_state_dict(
            cfg, {k: v.to(dev, copy=True) for k, v in sd.items()}, torch.float32)
        if variant == "lora":
            # the same adapters on both devices, b off zero
            made = lora.init_lora_params(m.lm, 4, torch.Generator().manual_seed(3))
            adapters = {k: {"a": ad["a"].to(dev), "b": torch.full_like(ad["b"], 0.01).to(dev)}
                        for k, ad in made.items()}
            state = init_lora_train_state(adapters, tc)
            step = make_lora_train_step(m.lm, m.towers, adapters, 8, 4)
            trained = lambda: {k: t.detach().cpu()  # noqa: E731
                               for k, t in lora.flat_adapters(adapters).items()}
        else:
            state = init_train_state(m.lm, m.towers, tc)
            step = make_train_step(m.lm, m.towers, freeze=tc)
            trained = lambda: {k: p.detach().cpu()  # noqa: E731
                               for k, p in m.lm.named_parameters()}
        b0 = flash_attention_bwd.launches
        losses = []
        for batch in batches:
            tb = {k: [torch.from_numpy(x).to(dev) for x in v] if isinstance(v, list)
                  else torch.from_numpy(v).to(dev) for k, v in batch.items()}
            losses.append(float(step(state, tb)[1]["loss"]))
        runs[dev] = (losses, flash_attention_bwd.launches - b0, trained())
    assert runs["cpu"][1] == 0 and runs["cuda"][1] == 3 * cfg.num_hidden_layers
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, v in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][k], v, atol=1e-4, rtol=0, msg=k)

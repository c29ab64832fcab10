"""The decoder families on the card (marker ``cuda``): a tiny Cambrian of
each family (Mistral with a window, Gemma at head_dim 256, Gemma with both
Gemma-2 softcaps, Cohere, Cohere with qk-norm) through ``generate`` on the
card against the same model on the CPU, fp32 with TF32 off, from the same
weights and a 159-slot prompt (the prefill takes K1 where the family
allows it): identical greedy tokens, first-token logits within 1e-3, and K1
launched once a tower block and once a decoder layer (the towers alone
under the attention softcap).

The file imports no JAX, so that on a machine with a card and no JAX
``python -m pytest --noconftest -m cuda tests/test_torch_families_on_card.py``
runs it.
"""

import numpy as np
import pytest
import torch

from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, tiny_debug
from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
from cambrian_tpu_torch.ops.flash_attention import flash_attention

FAMILIES = {
    "mistral_window": dict(model_type="mistral", sliding_window=24),
    "gemma_d256": dict(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=256,
                       tie_word_embeddings=True, rms_norm_eps=1e-6),
    "gemma_softcap": dict(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=48,
                          tie_word_embeddings=True, rms_norm_eps=1e-6,
                          attn_logit_softcapping=0.5, final_logit_softcapping=1.0),
    "cohere": dict(model_type="cohere", tie_word_embeddings=True, logit_scale=0.0625),
    "cohere_qk_norm": dict(model_type="cohere", tie_word_embeddings=True, logit_scale=0.0625,
                           use_qk_norm=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fp32_products(cuda_device):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiny_family_card_matches_cpu(cuda_device, fp32_products, family):
    cfg = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192, **FAMILIES[family])
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0), 0.05, dtype=torch.float32,
                           device="cpu")
    cpu = CambrianForInference.from_state_dict(cfg, sd, torch.float32, cache_dtype=torch.float32)
    gpu = CambrianForInference.from_state_dict(cfg, {k: v.to(cuda_device) for k, v in sd.items()},
                                               torch.float32, cache_dtype=torch.float32)
    rng = np.random.default_rng(len(family))
    ids = rng.integers(5, cfg.vocab_size, 140)
    ids[cfg.image_position] = IMAGE_TOKEN_INDEX
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
              for t in cpu.towers]
    kw = dict(images=images, image_sizes=[(640, 360)], max_new_tokens=8, eos_token_id=None)
    want = cpu.generate(ids, **kw)
    before = flash_attention.launches
    got = gpu.generate(ids, **kw)
    launches = flash_attention.launches - before
    decoder = 0 if cfg.attn_logit_softcapping else cfg.num_hidden_layers
    assert launches == sum(t.config.num_blocks_to_run for t in gpu.towers) + decoder
    np.testing.assert_array_equal(got, want)
    err = (gpu.engine.last_next_logits.cpu() - cpu.engine.last_next_logits).abs().max()
    assert float(err) < 1e-3

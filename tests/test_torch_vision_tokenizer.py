"""The port's ``initialize_vision_tokenizer`` against the JAX package's, on
the CPU: the image special tokens appended to a stand-in tokenizer, the new
rows of the embedding and of the untied LM head mean-initialised, and the
config's ``vocab_size``, for one, two and three new tokens, tied and untied."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cambrian_tpu.models.builder import initialize_vision_tokenizer as jinit
from cambrian_tpu.models.config import tiny_debug
from cambrian_tpu_torch.models.builder import initialize_vision_tokenizer
from cambrian_tpu_torch.models.config import CambrianConfig


class _Tokenizer:
    """What the function reads of a tokenizer: ``add_tokens`` adds the
    tokens it lacks and returns how many."""

    def __init__(self, vocab):
        self.vocab = list(vocab)

    def add_tokens(self, tokens, special_tokens=False):
        new = [t for t in tokens if t not in self.vocab]
        self.vocab.extend(new)
        return len(new)


# (mm_use_im_start_end, mm_use_im_patch_token) -> new tokens
FLAGS = {1: (False, True), 2: (True, False), 3: (True, True)}


def _weights(cfg, tied, grid, seed):
    """(JAX params tree, the port's state dict) of the embedding and head:
    on a grid of multiples of 1/8 (every fp32 sum exact, so any order of
    summation gives the same mean) or normal draws."""
    rng = np.random.default_rng(seed)
    shape = (cfg.vocab_size, cfg.hidden_size)
    draw = ((lambda: rng.integers(-16, 17, shape) / 8.0) if grid
            else (lambda: rng.standard_normal(shape)))
    embed = draw().astype(np.float32)
    tree = {"embed_tokens": {"embedding": jnp.asarray(embed)}}
    sd = {"embed_tokens.weight": torch.from_numpy(embed.copy()),
          "norm.weight": torch.ones(cfg.hidden_size)}
    if not tied:
        head = draw().astype(np.float32)
        tree["lm_head"] = {"kernel": jnp.asarray(head.T)}
        sd["lm_head.weight"] = torch.from_numpy(head.copy())
    return {"params": tree}, sd


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("num_new", [1, 2, 3])
def test_matches_jax(num_new, tied, grid):
    """The grown rows and ``vocab_size`` as JAX's: exactly on grid values;
    within fp32 rounding of the mean on normal draws (the two packages sum
    the rows in other orders)."""
    jcfg = tiny_debug().replace(tie_word_embeddings=tied)
    cfg = CambrianConfig.from_dict(jcfg.to_dict())
    params, sd = _weights(jcfg, tied, grid, seed=num_new)
    start_end, patch = FLAGS[num_new]
    base = ["<pad>", "<s>", "</s>"]
    jtok, ttok = _Tokenizer(base), _Tokenizer(base)
    jparams, jcfg2 = jinit(params, jtok, jcfg, start_end, patch)
    got, cfg2 = initialize_vision_tokenizer(sd, ttok, cfg, start_end, patch)
    assert ttok.vocab == jtok.vocab and len(ttok.vocab) == len(base) + num_new
    assert cfg2.vocab_size == jcfg2.vocab_size == jcfg.vocab_size + num_new
    tol = dict(rtol=0, atol=0) if grid else dict(rtol=1e-6, atol=1e-7)
    jtree = jparams["params"]
    want = {"embed_tokens.weight": np.asarray(jtree["embed_tokens"]["embedding"])}
    if not tied:
        want["lm_head.weight"] = np.asarray(jtree["lm_head"]["kernel"]).T
    assert set(got) == set(sd) and ("lm_head.weight" in got) == (not tied)
    for name, w in want.items():
        assert got[name].shape == (cfg2.vocab_size, cfg.hidden_size), name
        np.testing.assert_array_equal(got[name][:cfg.vocab_size].numpy(), sd[name].numpy())
        np.testing.assert_allclose(got[name].numpy(), w, err_msg=name, **tol)
        rows = got[name][cfg.vocab_size:]
        assert torch.equal(rows, rows[:1].expand_as(rows)), name
    assert got["norm.weight"] is sd["norm.weight"]


def test_prefixed_state_dict_and_no_new_token():
    """A full model's state dict (``lm.`` keys) grows the same way; a
    tokenizer that has the tokens already, or no flag, changes nothing."""
    cfg = CambrianConfig.from_dict(tiny_debug().to_dict())
    _, sd = _weights(cfg, False, True, seed=0)
    full = {f"lm.{k}": v for k, v in sd.items()}
    got, cfg2 = initialize_vision_tokenizer(full, _Tokenizer([]), cfg, True, False)
    assert cfg2.vocab_size == cfg.vocab_size + 2
    assert got["lm.embed_tokens.weight"].shape[0] == got["lm.lm_head.weight"].shape[0] == 514
    tok = _Tokenizer(["<im_start>", "<im_end>"])
    assert initialize_vision_tokenizer(sd, tok, cfg, True, False) == (sd, cfg)
    assert initialize_vision_tokenizer(sd, _Tokenizer([]), cfg) == (sd, cfg)

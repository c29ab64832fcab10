"""The serving comparison: the reference's full forward over each prompt
followed by the tokens the program served, and, at each served token, how
far that token's logit lies below the reference's best at that position.
Greedy serving puts first the token with the largest logit, so a sound
program's gaps stay within its rounding; a wrong token, cache row or
injected image block opens one wide.
"""

from typing import Dict, List, Optional, Sequence

import torch

from . import cambrian


def served_gaps(source: cambrian.Source, cfg: dict, requests: Sequence[Dict],
                quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each request (``ids`` the prompt with its image marker, ``pixels``
    one [1, 3, R, R] tensor a tower, ``served`` the served tokens), the gap
    [T] of each served token: max logit minus the served token's logit, from
    the logits of the slot before it."""
    # the towers once, over all the requests' images
    pixels = [torch.cat([r["pixels"][i] for r in requests]) for i in range(len(cfg["towers"]))]
    every = cambrian.encode(source, cfg["towers"], pixels)
    feats = [[f[j:j + 1] for f in every] for j in range(len(requests))]
    del every
    seqs = [torch.cat([r["ids"], r["served"][:-1]]) for r in requests]
    hidden = cambrian.hidden_states(source, cfg, seqs, feats, quant=quant)
    head = cambrian.head_weight(source, cfg)
    out = []
    for r, h in zip(requests, hidden):
        n = r["served"].numel()
        logits = h[-n:] @ head.T
        chosen = logits.gather(1, r["served"].long().to(logits.device)[:, None])[:, 0]
        out.append((logits.amax(1) - chosen).cpu())
    return out

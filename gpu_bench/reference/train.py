"""The training comparison's reference: a float32 connector-training step,
followed through the job's first steps.

Stage 1 of Cambrian-1 trains the connector alone (the SVA samplers, the
per-tower projections, the image projector, the queries, position tables
and newline); the towers and the decoder are frozen, and the gradient flows
back through the decoder to the in-decoder SVA layers. The loss is the
shifted next-token cross-entropy over the caption's tokens of the whole
batch; the optimizer is AdamW (decay on matrices only) after clipping by the
global gradient norm, with a linear warm-up and a cosine decay, one peak
rate a parameter group (Cambrian-1's stage-1 script: 1e-3, the SVA samplers
1e-4).
"""

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import cambrian

IGNORE = -100


def trainable(name: str, job: dict) -> bool:
    return any(k in name for k in job["trainable"])


def group_lr(name: str, job: dict) -> float:
    for key, lr in job["lr_groups"].items():
        if key in name:
            return lr
    return job["learning_rate"]


def schedule(job: dict, count: int, peak: float) -> float:
    """Linear warm-up over ``warmup_ratio`` of the job's steps, then cosine
    to 0."""
    total = job["total_steps"]
    warmup = int(job["warmup_ratio"] * total)
    if count < warmup:
        return peak * count / warmup
    decay = max(total, warmup + 1) - warmup
    return peak * 0.5 * (1 + math.cos(math.pi * min(count - warmup, decay) / decay))


def expand_labels(ids: torch.Tensor, labels: torch.Tensor, marker: int, block: int) -> torch.Tensor:
    """The labels of a sequence whose image marker becomes ``block`` slots,
    none of them labelled."""
    start = cambrian.image_start(ids, marker)
    fill = torch.full((block,), IGNORE, dtype=labels.dtype, device=labels.device)
    return torch.cat([labels[:start], fill, labels[start + 1:]])


def batch_step(source: cambrian.Source, cfg: dict, params: Dict[str, torch.Tensor],
               names: Sequence[str], batch: Sequence[dict], rounding=None):
    """(mean token loss, gradients of ``names``) of one batch: the summed
    token NLL over the count of labelled next tokens of every sample,
    differentiated one sample at a time so that one sample's graph is held
    at once."""
    m = cfg["model"]
    side = int(round(m["image_token_len"] ** 0.5))
    block = side * (side + 1)
    with torch.no_grad():
        pixels = [torch.cat([s["pixels"][i] for s in batch]) for i in range(len(cfg["towers"]))]
        towers = cambrian.encode(source, cfg["towers"], pixels, rounding)
        feats = [[t[b:b + 1] for t in towers] for b in range(len(batch))]
        del towers
    labels = [expand_labels(s["ids"], s["labels"], cfg["image_marker"], block)[1:] for s in batch]
    count = max(sum(int((lab != IGNORE).sum()) for lab in labels), 1)

    def rest_source(group):
        if group == "lm.rest":
            return cambrian.round_group(params, rounding)
        return source(group)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False)

    head = cambrian.head_weight(source, cfg, rounding)
    total = 0.0
    grads = [torch.zeros_like(params[k]) for k in names]
    for s, f, lab in zip(batch, feats, labels):
        h = cambrian.hidden_states(rest_source, cfg, [s["ids"]], [f], layer_fn=run,
                                   rounding=rounding)[0]
        keep = lab != IGNORE
        loss = F.cross_entropy(h[:-1][keep] @ head.T, lab[keep].long(), reduction="sum") / count
        for acc, g in zip(grads, torch.autograd.grad(loss, [params[k] for k in names])):
            acc += g
        total += float(loss.detach())
    return total, grads


def follow(source: cambrian.Source, cfg: dict, job: dict, batches: Sequence[Sequence[dict]],
           rounding=None) -> dict:
    """The job's first ``len(batches)`` steps from the seed's weights.
    Returns each step's loss, the first step's clipped gradient a trainable
    leaf, and each leaf's change after the steps."""
    rest = source("lm.rest")
    params = {k: v.clone() for k, v in rest.items()}
    names = [k for k in params if trainable(k, job)]
    for k in names:
        params[k].requires_grad_(True)
    start = {k: params[k].detach().clone() for k in names}
    mu = {k: torch.zeros_like(params[k]) for k in names}
    nu = {k: torch.zeros_like(params[k]) for k in names}
    b1, b2, eps = job["adam_b1"], job["adam_b2"], job["adam_eps"]
    losses: List[float] = []
    first_grads = {}
    for step, batch in enumerate(batches):
        loss, grads = batch_step(source, cfg, params, names, batch, rounding)
        losses.append(loss)
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
        scale = job["max_grad_norm"] / norm if norm >= job["max_grad_norm"] else 1.0
        grads = [g * scale for g in grads]
        if step == 0:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
        bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        with torch.no_grad():
            for k, g in zip(names, grads):
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                if params[k].dim() >= 2:
                    u = u + job["weight_decay"] * params[k]
                params[k] -= schedule(job, step, group_lr(k, job)) * u
    change = {k: (params[k].detach() - start[k]) for k in names}
    return {"losses": losses, "grads": first_grads, "change": change}

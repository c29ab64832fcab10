"""Weights made from the run's seed, on the device, group by group.

A group is one decoder layer (``lm.layers_7``), one vision tower
(``towers.2``), the token embeddings, the LM head, or the rest of the LM (the
connector). Each group draws from a generator of its own, seeded from
(seed, group name), with one ``normal_`` call per dtype over a flat buffer,
so that the reference can make any group again, alone, and get the same
values. Biases are zeros and 1-D norm weights and gammas ones, as freshly
initialised modules hold them; every other tensor is N(0, std) in the dtype
its parameter is served in.

A spec is (name, shape, dtype) for every tensor of the model's state dict,
read from the program's modules built on the meta device.
"""

import hashlib
import itertools
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], torch.dtype]
STD = 0.02


def group_of(name: str) -> str:
    """The group a state-dict key belongs to."""
    parts = name.split(".")
    if parts[0] == "towers":
        return ".".join(parts[:2])
    if parts[0] == "lm" and parts[1].startswith("layers_"):
        return ".".join(parts[:2])
    if parts[0] == "lm" and parts[1] in ("embed_tokens", "lm_head"):
        return ".".join(parts[:2])
    return "lm.rest"


def groups(specs: Sequence[Spec]) -> Dict[str, List[Spec]]:
    """Specs by group, in the order the groups first appear."""
    out: Dict[str, List[Spec]] = {}
    for spec in specs:
        out.setdefault(group_of(spec[0]), []).append(spec)
    return out


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "zeros"
    if len(shape) == 1 and (leaf == "weight" or "gamma" in leaf):
        return "ones"
    return "normal"


def make_group(seed: int, group: str, specs: Iterable[Spec], device,
               std: float = STD) -> Dict[str, torch.Tensor]:
    """The tensors of one group: one flat normal draw per dtype, cut into
    the group's random tensors in spec order."""
    specs = list(specs)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    out: Dict[str, torch.Tensor] = {}
    randoms = [s for s in specs if _kind(s[0], s[1]) == "normal"]
    by_dtype = itertools.groupby(sorted(randoms, key=lambda s: str(s[2])), key=lambda s: s[2])
    for dtype, members in by_dtype:
        members = list(members)
        total = sum(_numel(s[1]) for s in members)
        flat = torch.empty(total, dtype=dtype, device=device).normal_(0.0, std, generator=gen)
        offset = 0
        for name, shape, _ in members:
            n = _numel(shape)
            out[name] = flat[offset:offset + n].view(shape)
            offset += n
    for name, shape, dtype in specs:
        kind = _kind(name, shape)
        if kind == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return {name: out[name] for name, _, _ in specs}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n

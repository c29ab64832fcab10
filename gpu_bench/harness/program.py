"""The program under test, built from a configuration file and the seed's
weights, and the benchmark's spans around its calls.

The program is ``cambrian_tpu_torch``. The benchmark hands it the weights it
made from the seed (``weights.make_group``), as a checkpoint loader would;
what the program derives from them (the quantized projections) is its own.
Spans are ``record_function`` wrappers set on the instances at run time:
``bench.<kind>#<n>``, the n-th call of that kind, whose description (the
shapes of its work) goes to ``Spans.log[kind][n]``.
"""

import itertools
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from . import weights


def model_config(cfg_file: Dict, quantize: Optional[str] = "config"):
    """The program's config from the file's ``model`` numbers; ``quantize``
    overrides the file's weight format (the lower-precision control)."""
    from cambrian_tpu_torch.models.config import CambrianConfig

    c = CambrianConfig.from_dict(cfg_file["model"])
    if quantize != "config":
        c = c.replace(quantize=quantize)
    return c


def specs(config) -> List[weights.Spec]:
    """(name, shape, dtype) of every tensor of the unquantized model, read
    from its modules built on the meta device."""
    from cambrian_tpu_torch.models.builder import build_modules

    with torch.device("meta"):
        lm, towers = build_modules(config.replace(quantize=None), torch.bfloat16)
    out = [(f"lm.{k}", tuple(v.shape), v.dtype) for k, v in lm.state_dict().items()]
    for i, t in enumerate(towers):
        out += [(f"towers.{i}.{k}", tuple(v.shape), v.dtype) for k, v in t.state_dict().items()]
    return out


def check_towers(cfg_file: Dict, towers) -> None:
    """The program's towers are the ones the file describes."""
    for spec, t in zip(cfg_file["towers"], towers):
        c = t.config
        if t.image_size != spec["image_size"] or t.num_patches != spec["tokens"] \
                or t.hidden_size != spec["out_dim"]:
            raise RuntimeError(f"tower {t.name}: {t.image_size} px, {t.num_patches} tokens, "
                               f"width {t.hidden_size}; the configuration file says {spec}")
        depth = getattr(c, "num_blocks_to_run", None)
        if depth is not None and depth != spec["blocks_run"]:
            raise RuntimeError(f"tower {t.name} runs {depth} blocks, the file says "
                               f"{spec['blocks_run']}")


def build(cfg_file: Dict, seed: int, device, quantize: Optional[str] = "config"):
    """The program's ``CambrianForInference`` over the seed's weights, made on
    the device a group at a time; with a quantized config each decoder
    layer goes through the program's own quantizer as soon as it is made,
    as ``load_8bit`` does, so memory peaks near the quantized model's size."""
    from cambrian_tpu_torch.models.builder import CambrianForInference, quantize_decoder

    config = model_config(cfg_file, quantize)
    sd = {}
    for group, members in weights.groups(specs(config)).items():
        part = weights.make_group(seed, group, members, device)
        if config.quantize and group.startswith("lm.layers_"):
            part = quantize_decoder(part, config.quantize)
        sd.update(part)
    model = CambrianForInference.from_state_dict(config, sd, torch.bfloat16)
    del sd
    check_towers(cfg_file, model.towers)
    return model


class Spans:
    """``record_function`` spans set on instances, with a description of
    each call's work."""

    def __init__(self):
        self.log: Dict[str, Dict[int, dict]] = defaultdict(dict)
        self._count: Dict[str, itertools.count] = defaultdict(itertools.count)

    def wrap(self, obj, attr: str, kind: str,
             describe: Optional[Callable[..., dict]] = None) -> None:
        fn = getattr(obj, attr)
        from torch.profiler import record_function

        def spanned(*args, **kwargs):
            n = next(self._count[kind])
            self.log[kind][n] = describe(*args, **kwargs) if describe is not None else {}
            with record_function(f"bench.{kind}#{n}"):
                return fn(*args, **kwargs)

        setattr(obj, attr, spanned)


def serving_spans(model, engine) -> Spans:
    """Spans on the serving path: a chunk of the engine, its admissions, each
    prefill, each chunk of decode steps (with every active slot's cache
    depth and tokens due), each decode step, each request's encode."""
    spans = Spans()
    lm = engine.model

    def chunk_work(chunk, *args, **kwargs):
        slots = []
        for i, req in enumerate(engine.slot_request):
            if req is not None:
                due = min(chunk, req.config.max_new_tokens - len(req.tokens),
                          engine.max_len - int(engine.slot_len[i]))
                slots.append((int(engine.slot_len[i]), int(due)))
        return {"slots": slots}

    spans.wrap(engine, "step_chunk", "step_chunk")
    spans.wrap(engine, "_admit", "admit")
    spans.wrap(engine, "_decode_chunk", "decode_chunk", chunk_work)
    spans.wrap(lm, "prefill", "prefill", lambda ids, *a, **k: {"slots": int(ids.shape[1])})
    spans.wrap(lm, "decode_step", "decode_step")
    spans.wrap(model.engine, "encode_images", "encode", lambda images: {"images": 1})
    return spans

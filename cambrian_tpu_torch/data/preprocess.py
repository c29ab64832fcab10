"""Conversation preprocessors: prompt assembly + tokenization + per-round
label masking for supervised fine-tuning. The port's own copy of
cambrian_tpu/data/preprocess.py, which is framework-neutral (numpy).

Behavioral parity with the reference (train_fsdp.py:310-907): each template
family splits the rendered conversation into rounds and IGNORE_INDEXes
everything that is not an assistant reply, with template-specific token
offsets (documented inline). The tokenization-mismatch guard zeroes the whole
sample's labels and warns instead of crashing (train_fsdp.py:473-479).

All functions are per-batch, numpy-based (host-side input pipeline).
"""

import copy
import logging
from typing import Dict, List, Sequence

import numpy as np

from .. import conversation as conversation_lib
from ..constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
)
from ..mm_utils import tokenizer_image_token, tokenizer_image_token_llama3

logger = logging.getLogger(__name__)

# tokenizers >= 0.14 changed prefix-space handling; pinned True for the
# versions in this image (reference IS_TOKENIZER_GREATER_THAN_0_14)
IS_TOKENIZER_GREATER_THAN_0_14 = True


def set_default_conversation(version: str) -> None:
    """Select the active template (the reference mutates
    conversation_lib.default_conversation at train() start)."""
    conversation_lib.default_conversation = conversation_lib.conv_templates[version]


def preprocess_multimodal(sources, data_args) -> Sequence:
    """Normalize <image> placement to the start of the turn
    (train_fsdp.py:369-390)."""
    if not getattr(data_args, "is_multimodal", True):
        return sources
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                sentence["value"] = (
                    DEFAULT_IMAGE_TOKEN + "\n"
                    + sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                ).strip()
                if "mmtag" in conversation_lib.default_conversation.version:
                    sentence["value"] = sentence["value"].replace(
                        DEFAULT_IMAGE_TOKEN,
                        "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>",
                    )
            replace_token = DEFAULT_IMAGE_TOKEN
            if getattr(data_args, "mm_use_im_start_end", False):
                replace_token = DEFAULT_IM_START_TOKEN + replace_token + DEFAULT_IM_END_TOKEN
            sentence["value"] = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, replace_token)
    return sources


def _render_conversations(sources, conv) -> List[str]:
    """Shared prompt assembly across template families
    (train_fsdp.py:400-414 et al.)."""
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]  # drop a leading non-human turn
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], "roles must alternate human/gpt"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _tokenize_batch(conversations, tokenizer, has_image, llama3=False):
    tok = tokenizer_image_token_llama3 if llama3 else tokenizer_image_token
    if has_image:
        return [np.asarray(tok(p, tokenizer), dtype=np.int64) for p in conversations]
    out = []
    for p in conversations:
        ids = tokenizer(p).input_ids[: tokenizer.model_max_length]
        out.append(np.asarray(ids, dtype=np.int64))
    return out


def _mismatch_guard(target, cur_len, total_len, tokenizer, conversation):
    if cur_len < tokenizer.model_max_length and cur_len != total_len:
        target[:] = IGNORE_INDEX
        logger.warning(
            "tokenization mismatch: %d vs. %d (sample labels ignored)",
            cur_len, total_len,
        )


def preprocess_llama_3(sources, tokenizer, has_image=False) -> Dict:
    """LLAMA_3 masking (train_fsdp.py:392-484): rounds split on <|eot_id|>;
    system and user rounds fully masked; assistant rounds keep all but the
    3 header tokens."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    trailing = "<|start_header_id|>assistant<|end_header_id|>"
    conversations = [
        p[: -len(trailing)] if p.endswith(trailing) else p for p in conversations
    ]

    input_ids = _tokenize_batch(conversations, tokenizer, has_image, llama3=True)
    targets = [ids.copy() for ids in input_ids]
    sep = "<|eot_id|>"

    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum()) \
            if tokenizer.pad_token_id is not None else len(target)
        rounds = conversation.split(sep)
        cur_len = 0
        for i, round_text in enumerate(rounds):
            if round_text == "":
                break
            round_text += sep
            if i == 0:  # system
                round_len = len(tokenizer(round_text).input_ids)
                target[cur_len:cur_len + round_len] = IGNORE_INDEX
            elif i % 2 == 1:  # user
                if i == 1 and has_image:
                    round_len = len(tokenizer_image_token_llama3(round_text, tokenizer))
                else:
                    round_len = len(tokenizer(round_text).input_ids)
                target[cur_len:cur_len + round_len] = IGNORE_INDEX
            else:  # assistant: mask only the 3 header tokens
                round_len = len(tokenizer(round_text).input_ids)
                target[cur_len:cur_len + 3] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        _mismatch_guard(target, cur_len, total_len, tokenizer, conversation)

    return dict(input_ids=input_ids, labels=targets)


def _preprocess_two_part(sources, tokenizer, has_image, sep, sep2,
                         instruction_offset, legacy_adjust, style_assert=None):
    """Shared skeleton for LLAMA_2 / TWO(v1) masking: rounds split on sep2,
    instruction = everything before ``sep`` (+offset); reply supervised."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    input_ids = _tokenize_batch(conversations, tokenizer, has_image)
    targets = [ids.copy() for ids in input_ids]

    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum()) \
            if tokenizer.pad_token_id is not None else len(target)
        rounds = conversation.split(sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, round_text in enumerate(rounds):
            if round_text == "":
                break
            parts = round_text.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if has_image:
                round_len = len(tokenizer_image_token(round_text, tokenizer))
                instruction_len = len(tokenizer_image_token(parts[0], tokenizer)) + instruction_offset
            else:
                round_len = len(tokenizer(round_text).input_ids)
                instruction_len = len(tokenizer(parts[0]).input_ids) + instruction_offset
            if i != 0 and legacy_adjust and IS_TOKENIZER_GREATER_THAN_0_14:
                round_len -= 1
                instruction_len -= 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        _mismatch_guard(target, cur_len, total_len, tokenizer, conversation)

    return dict(input_ids=input_ids, labels=targets)


def preprocess_llama_2(sources, tokenizer, has_image=False) -> Dict:
    """LLAMA_2 masking (train_fsdp.py:486-566)."""
    return _preprocess_two_part(
        sources, tokenizer, has_image, sep="[/INST] ", sep2="</s>",
        instruction_offset=-2, legacy_adjust=False,
    )


def preprocess_v1(sources, tokenizer, has_image=False) -> Dict:
    """vicuna v1 / TWO masking (train_fsdp.py:569-652)."""
    conv = conversation_lib.default_conversation
    legacy_adjust = not getattr(tokenizer, "legacy", False)
    return _preprocess_two_part(
        sources, tokenizer, has_image,
        sep=conv.sep + conv.roles[1] + ": ", sep2=conv.sep2,
        instruction_offset=-2, legacy_adjust=legacy_adjust,
    )


def _preprocess_chunked(sources, tokenizer, has_image, instruction_offset,
                        legacy_round_delta, extra_round_delta=0):
    """Shared skeleton for MPT / PHI3 masking: rounds re-grouped as
    [system+user+gpt] then [user+gpt] pairs (train_fsdp.py:698-701)."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    input_ids = _tokenize_batch(conversations, tokenizer, has_image)
    targets = [ids.copy() for ids in input_ids]
    sep = conv.sep + conv.roles[1]

    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum()) \
            if tokenizer.pad_token_id is not None else len(target)
        rounds = conversation.split(conv.sep)
        merged_rounds = [conv.sep.join(rounds[:3])]
        for idx in range(3, len(rounds), 2):
            merged_rounds.append(conv.sep.join(rounds[idx:idx + 2]))
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, round_text in enumerate(merged_rounds):
            if round_text == "":
                break
            parts = round_text.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if has_image:
                round_len = len(tokenizer_image_token(round_text, tokenizer))
                instruction_len = len(tokenizer_image_token(parts[0], tokenizer)) + instruction_offset
            else:
                round_len = len(tokenizer(round_text).input_ids)
                instruction_len = len(tokenizer(parts[0]).input_ids) + instruction_offset
            if i != 0:
                round_len += legacy_round_delta + extra_round_delta
                instruction_len += legacy_round_delta + extra_round_delta
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        _mismatch_guard(target, cur_len, total_len, tokenizer, conversation)

    return dict(input_ids=input_ids, labels=targets)


def preprocess_mpt(sources, tokenizer, has_image=False) -> Dict:
    """MPT/chatml masking (train_fsdp.py:655-740)."""
    legacy = getattr(tokenizer, "legacy", False) and IS_TOKENIZER_GREATER_THAN_0_14
    return _preprocess_chunked(sources, tokenizer, has_image,
                               instruction_offset=-1,
                               legacy_round_delta=1 if legacy else 0)


def preprocess_phi3(sources, tokenizer, has_image=False) -> Dict:
    """PHI3 masking (train_fsdp.py:765-853): chunked like MPT plus a -1
    adjustment dropping the leading newline token on later rounds."""
    legacy = not getattr(tokenizer, "legacy", False) and IS_TOKENIZER_GREATER_THAN_0_14
    return _preprocess_chunked(sources, tokenizer, has_image,
                               instruction_offset=-1,
                               legacy_round_delta=-1 if legacy else 0,
                               extra_round_delta=-1)


def preprocess_plain(sources, tokenizer) -> Dict:
    """Pretrain captions (train_fsdp.py:743-762): <image> + caption + sep;
    only the caption supervised."""
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        source[0]["value"] = DEFAULT_IMAGE_TOKEN
        conversations.append(
            source[0]["value"] + source[1]["value"]
            + conversation_lib.default_conversation.sep
        )
    input_ids = [
        np.asarray(tokenizer_image_token(p, tokenizer), dtype=np.int64)
        for p in conversations
    ]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_len = len(tokenizer_image_token(source[0]["value"], tokenizer))
        target[:tokenized_len] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=targets)


def preprocess(sources, tokenizer, has_image: bool = False) -> Dict:
    """Dispatcher (train_fsdp.py:856-907) keyed on the active template."""
    conv = conversation_lib.default_conversation
    style = conv.sep_style
    S = conversation_lib.SeparatorStyle
    if style == S.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if style == S.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image)
    if style == S.LLAMA_3:
        return preprocess_llama_3(sources, tokenizer, has_image=has_image)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    if conv.version == "mpt":
        return preprocess_mpt(sources, tokenizer, has_image=has_image)
    if conv.version == "phi3":
        return preprocess_phi3(sources, tokenizer, has_image=has_image)

    # legacy v0: "### role: text\n" framing (train_fsdp.py:882-907)
    header = f"{conv.system}\n\n"
    conversations = []
    rendered_sources = []
    for source in sources:
        source = copy.deepcopy(source)
        conversation = header
        for sentence in source:
            from_str = sentence["from"]
            role = (conv.roles[0] if from_str.lower() == "human"
                    else conv.roles[1] if from_str.lower() == "gpt" else "unknown")
            sentence["value"] = "### " + role + ": " + sentence["value"] + "\n"
            conversation += sentence["value"]
        conversation += "### "
        conversations.append(conversation)
        rendered_sources.append(source)

    input_ids = [
        np.asarray(tokenizer_image_token(p, tokenizer), dtype=np.int64)
        for p in conversations
    ]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, rendered_sources):
        lens = [len(tokenizer_image_token(header, tokenizer))] + [
            len(tokenizer_image_token(s["value"], tokenizer)) for s in source
        ]
        speakers = [s["from"] for s in source]
        cur = lens[0]
        target[:cur] = IGNORE_INDEX
        for tok_len, speaker in zip(lens[1:], speakers):
            if speaker == "human":
                target[cur + 2:cur + tok_len] = IGNORE_INDEX
            cur += tok_len
    return dict(input_ids=input_ids, labels=targets)

"""Static-shape multimodal packing.

This module defines the token geometry of the framework: every ``<image>``
marker in a tokenized prompt is expanded into ``image_token_len + side``
slots (576 + 24 = 600 for the production config: a 24x24 latent-query grid
plus one newline column), and the *valid* (unpadded) region of the image is
encoded purely in the attention mask and position ids. This is the single
static-shape code path used for both training and inference prefill (the
reference forked on IS_XLA_AVAILABLE; we keep only the static/mask-driven
branch).

Math parity with the reference:
- ``get_padding_offset``      == train_fsdp.py:1039-1055
- ``prepare_image_info``      == train_fsdp.py:1057-1085
- ``prepare_multimodal_data`` == train_fsdp.py:1089-1165
- dummy-image insertion       == train_fsdp.py:1202-1217 (see collator)

All functions are pure numpy (host-side, runs in the input pipeline).
"""

from typing import List, Sequence, Tuple

import numpy as np

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


def get_padding_offset(cur_size: Tuple[int, int], original_size: Tuple[int, int]):
    """Offsets (left, right, top, bottom) of the pad region, in grid cells,
    after an aspect-preserving fit of ``original_size`` into ``cur_size``.

    Sizes are (width, height). Mirrors train_fsdp.py:1039-1055 exactly,
    including the int() truncations.
    """
    cur_w, cur_h = cur_size
    original_w, original_h = original_size

    original_aspect_ratio = original_w / original_h
    current_aspect_ratio = cur_w / cur_h

    if original_aspect_ratio > current_aspect_ratio:
        scale_factor = cur_w / original_w
        new_height = int(original_h * scale_factor)
        padding = (cur_h - new_height) // 2
        return 0, 0, padding, padding
    else:
        scale_factor = cur_h / original_h
        new_width = int(original_w * scale_factor)
        padding = (cur_w - new_width) // 2
        return padding, padding, 0, 0


def prepare_image_info(image_size: Tuple[int, int], image_token_len: int, newline: bool = False):
    """Attention mask + position ids for one image's token grid.

    Returns a flat bool mask over the (side x side [+ newline column]) grid
    marking tokens that fall inside the letterboxed image, and position ids
    that advance only over valid tokens (mask.cumsum - 1). Newline tokens in
    valid rows stay valid. Mirrors train_fsdp.py:1057-1085.
    """
    num_tokens_per_side = int(image_token_len ** 0.5)
    cols = num_tokens_per_side + 1 if newline else num_tokens_per_side
    attention_mask = np.ones((num_tokens_per_side, cols), dtype=bool)
    left, right, top, bottom = get_padding_offset(
        (num_tokens_per_side, num_tokens_per_side), image_size
    )
    if newline:
        if left > 0:
            attention_mask[:, :left] = 0
        if right > 0:
            attention_mask[:, -right - 1:-1] = 0
        if top > 0:
            attention_mask[:top, :] = 0
        if bottom > 0:
            attention_mask[-bottom:, :] = 0
    else:
        if left > 0:
            attention_mask[:, :left] = 0
        if right > 0:
            attention_mask[:, -right:] = 0
        if top > 0:
            attention_mask[:top, :] = 0
        if bottom > 0:
            attention_mask[-bottom:, :] = 0
    attention_mask = attention_mask.reshape(-1)
    position_ids = attention_mask.cumsum(0) - 1
    return attention_mask, position_ids.astype(np.int64)


def prepare_aux_masks(
    image_size: Tuple[int, int],
    image_token_len: int,
    image_aux_token_len_list: Sequence[int],
) -> List[np.ndarray]:
    """Per-tower windowed validity masks for SVA cross-attention.

    For each aux tower with a (side_aux x side_aux) grid, produces a
    [base_side^2, (side_aux/base_side)^2] bool mask: row q holds the validity
    of the tokens in query q's local window. All-invalid rows are force-set to
    True (train_fsdp.py:1136) so softmax never sees a fully-masked row.
    Mirrors train_fsdp.py:1129-1137.
    """
    base_side = int(image_token_len ** 0.5)
    masks = []
    for aux_token_len in image_aux_token_len_list:
        aux_side = int(aux_token_len ** 0.5)
        assert aux_side >= base_side and aux_side % base_side == 0, (
            f"aux grid {aux_side} must be a multiple of base grid {base_side}"
        )
        num_crops = aux_side // base_side
        mask, _ = prepare_image_info(image_size, aux_side ** 2)
        mask = mask.reshape(base_side, num_crops, base_side, num_crops)
        mask = mask.transpose(0, 2, 1, 3).reshape(base_side * base_side, num_crops * num_crops)
        mask = mask.copy()
        mask[mask.sum(axis=1) == 0] = True
        masks.append(mask)
    return masks


def insert_dummy_image(input_ids: np.ndarray, labels: np.ndarray, attention_mask: np.ndarray,
                       image_position: int):
    """Insert an IMAGE_TOKEN_INDEX at ``image_position`` for a text-only sample
    by right-shifting the tail one slot (dropping the final token). The slot is
    label-masked and attention-masked so it contributes nothing.
    Mirrors train_fsdp.py:1202-1217.
    """
    input_ids = input_ids.copy()
    labels = labels.copy()
    attention_mask = attention_mask.copy()
    input_ids[image_position + 1:] = input_ids[image_position:-1].copy()
    input_ids[image_position] = IMAGE_TOKEN_INDEX
    labels[image_position + 1:] = labels[image_position:-1].copy()
    labels[image_position] = IGNORE_INDEX
    attention_mask[image_position + 1:] = attention_mask[image_position:-1].copy()
    attention_mask[image_position] = False
    return input_ids, labels, attention_mask


def prepare_multimodal_data(
    input_ids: np.ndarray,
    labels: np.ndarray,
    attention_mask: np.ndarray,
    image_sizes: Sequence[Tuple[int, int]],
    image_token_len: int = 576,
    image_aux_token_len_list: Sequence[int] = (576,),
    max_length: int = 2048,
):
    """Expand each sample's single ``<image>`` marker into the padded slot
    block and build the per-sample attention mask / position ids / per-tower
    aux masks. Mirrors train_fsdp.py:1089-1165.

    Geometry per image: the IMAGE_TOKEN_INDEX token itself is kept (it marks
    the start of the block and is later overwritten by the first image
    embedding), followed by ``image_token_len + side - 1`` zero-id padding
    slots; labels are IGNORE_INDEX over all ``image_token_len + side`` slots.
    Position ids inside the block advance only over mask-valid tokens, and the
    text after the image continues from ``max(position) + 1``.

    Returns (input_ids, labels, attention_mask, position_ids,
    aux_masks_list) — all [B, max_length] (aux masks
    [B, image_token_len, window]) numpy arrays.
    """
    input_ids = np.asarray(input_ids)
    labels = np.asarray(labels)
    attention_mask = np.asarray(attention_mask).astype(bool)
    bs = input_ids.shape[0]

    out_ids, out_labels, out_mask, out_pos = [], [], [], []
    aux_masks_per_tower = [[] for _ in image_aux_token_len_list]

    side = int(image_token_len ** 0.5)
    block = image_token_len + side

    for b in range(bs):
        cur_ids = input_ids[b]
        cur_labels = labels[b]
        cur_mask = attention_mask[b]
        image_size = image_sizes[b]

        (im_positions,) = np.nonzero(cur_ids == IMAGE_TOKEN_INDEX)
        assert im_positions.size == 1, f"exactly one image per sample, got {im_positions.size}"
        boundaries = [-1] + im_positions.tolist() + [cur_ids.shape[0]]

        ids_parts, label_parts, mask_parts, pos_parts = [], [], [], []
        index = 0
        for i in range(len(boundaries) - 1):
            # text span; keep the image indicator token itself (for splicing)
            ids_parts.append(cur_ids[boundaries[i] + 1: boundaries[i + 1] + 1])
            label_parts.append(cur_labels[boundaries[i] + 1: boundaries[i + 1]])
            mask_parts.append(cur_mask[boundaries[i] + 1: boundaries[i + 1]])
            span = boundaries[i + 1] - (boundaries[i] + 1)
            pos_parts.append(np.arange(index, index + span, dtype=np.int64))
            index += span

            if i < len(boundaries) - 2:
                # image block: indicator token already appended; add block-1 pads
                ids_parts.append(np.zeros(block - 1, dtype=cur_ids.dtype))
                label_parts.append(np.full(block, IGNORE_INDEX, dtype=cur_labels.dtype))

                im_mask, im_pos = prepare_image_info(image_size, image_token_len, newline=True)
                for aux_i, aux_mask in enumerate(
                    prepare_aux_masks(image_size, image_token_len, image_aux_token_len_list)
                ):
                    aux_masks_per_tower[aux_i].append(aux_mask)
                im_pos = im_pos + index

                if cur_mask[boundaries[i + 1]]:
                    mask_parts.append(im_mask)
                    pos_parts.append(im_pos.astype(np.int64))
                    index = int(im_pos.max()) + 1
                else:
                    # dummy image in a text-only sample: fully masked block
                    mask_parts.append(np.zeros(block, dtype=bool))
                    pos_parts.append(np.zeros(block, dtype=np.int64))

        out_ids.append(np.concatenate(ids_parts)[:max_length])
        out_labels.append(np.concatenate(label_parts)[:max_length])
        out_mask.append(np.concatenate(mask_parts)[:max_length])
        out_pos.append(np.concatenate(pos_parts)[:max_length])

    new_input_ids = np.stack(out_ids)
    new_labels = np.stack(out_labels)
    new_attention_mask = np.stack(out_mask)
    new_position_ids = np.stack(out_pos)
    aux_masks_list = [np.stack(m) for m in aux_masks_per_tower]
    return new_input_ids, new_labels, new_attention_mask, new_position_ids, aux_masks_list

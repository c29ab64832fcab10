"""Supervised dataset + collator + modality-grouped sampler: the port's own
copy of cambrian_tpu/data/dataset.py, which is framework-neutral (numpy).

Re-designs the reference's input pipeline (train_fsdp.py:910-1236,
cambrian_trainer.py:92-162) with one fix called out in SURVEY.md §7: the
JSONL lazy dataset builds a byte-offset index once (O(N) total) instead of
re-scanning the file per item (reference train_fsdp.py:969-973 is O(N) per
*access*).

Outputs are numpy; the train loop pins them and copies them to the card
(train/trainer.py).
"""

import json
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..mm_utils import expand2square
from .packing import insert_dummy_image, prepare_multimodal_data
from .preprocess import preprocess, preprocess_multimodal

logger = logging.getLogger(__name__)


class LazySupervisedDataset:
    """Lazily-decoded supervised dataset over .json (list) or .jsonl files."""

    def __init__(self, data_path: str, tokenizer, data_args):
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.data_path = data_path
        self._records: Optional[list] = None
        self._offsets: Optional[np.ndarray] = None
        self._lengths_cache = None

        if data_path.endswith(".jsonl"):
            offsets = [0]
            with open(data_path, "rb") as f:
                for line in f:
                    offsets.append(offsets[-1] + len(line))
            self._offsets = np.asarray(offsets[:-1], dtype=np.int64)
        else:
            with open(data_path) as f:
                self._records = json.load(f)

    def __len__(self):
        return len(self._offsets) if self._records is None else len(self._records)

    def _get_record(self, i) -> dict:
        if self._records is not None:
            return self._records[i]
        with open(self.data_path, "rb") as f:
            f.seek(int(self._offsets[i]))
            return json.loads(f.readline())

    # -- sampler support (cambrian_trainer.py:92-162 feeds off these) -------

    @property
    def lengths(self) -> List[int]:
        if self._lengths_cache is None:
            lengths = []
            for i in range(len(self)):
                rec = self._get_record(i)
                img_tokens = 128 if "image" in rec else 0
                lengths.append(
                    sum(len(c["value"].split()) for c in rec["conversations"])
                    + img_tokens
                )
            self._lengths_cache = lengths
        return self._lengths_cache

    @property
    def modality_lengths(self) -> List[int]:
        """Positive for multimodal samples, negative for text-only
        (train_fsdp.py:935-951)."""
        out = []
        for i in range(len(self)):
            rec = self._get_record(i)
            cur = sum(len(c["value"].split()) for c in rec["conversations"])
            out.append(cur if "image" in rec else -cur)
        return out

    # -- item decoding -------------------------------------------------------

    def _load_image(self, rec):
        from PIL import Image

        image_file = rec["image"]
        folder = getattr(self.data_args, "image_folder", "") or ""
        image = Image.open(os.path.join(folder, image_file)).convert("RGB")
        return image

    def _process_image_all_towers(self, image):
        processors = self.data_args.image_processor_aux_list
        image_size = image.size
        use_native = getattr(self.data_args, "use_native_preprocess", True)
        if use_native:
            from . import native_image

            if native_image.available():
                arr = np.asarray(image.convert("RGB"), dtype=np.uint8)
                image_aux_list = []
                for processor in processors:
                    if type(processor).__name__ != "ImageProcessor":
                        break  # custom processors (e.g. SAM) keep their path
                    out = native_image.preprocess_batch(
                        [arr], processor.crop_size["height"],
                        processor.image_mean, processor.image_std,
                        resample=native_image.RESAMPLE_BICUBIC
                        if processor.resample == "bicubic"
                        else native_image.RESAMPLE_BILINEAR,
                    )
                    image_aux_list.append(out[0])
                else:
                    return image_aux_list, image_size
        image_aux_list = []
        for processor in processors:
            target = processor.crop_size["height"]
            img = expand2square(
                image, tuple(int(x * 255) for x in processor.image_mean)
            ).resize((target, target))
            image_aux_list.append(
                processor.preprocess(img, return_tensors="np")["pixel_values"][0]
            )
        return image_aux_list, image_size

    def __getitem__(self, i) -> Dict:
        try:
            rec = self._get_record(i)
            has_image = "image" in rec
            sources = [rec["conversations"]]
            if has_image:
                image_aux_list, image_size = self._process_image_all_towers(
                    self._load_image(rec)
                )
                sources = preprocess_multimodal(
                    [list(map(dict, s)) for s in sources], self.data_args
                )
            else:
                image_aux_list, image_size = None, None
            data = preprocess(sources, self.tokenizer, has_image=has_image)
            item = dict(input_ids=data["input_ids"][0], labels=data["labels"][0])
            if has_image:
                item["image_aux_list"] = image_aux_list
                item["image_size"] = image_size
            elif getattr(self.data_args, "is_multimodal", True):
                # dummy zero image for text-only samples (train_fsdp.py:1030-1035)
                processors = self.data_args.image_processor_aux_list
                item["image_aux_list"] = [
                    np.zeros((3, p.crop_size["height"], p.crop_size["width"]),
                             dtype=np.float32)
                    for p in processors
                ]
                item["image_size"] = (
                    processors[0].crop_size["height"],
                    processors[0].crop_size["width"],
                )
            return item
        except Exception as e:
            # corrupt sample -> fall back to item 0 (train_fsdp.py:983-986)
            if i == 0:
                raise
            logger.warning("failed to read sample %d (%s); using sample 0", i, e)
            return self[0]


@dataclass
class DataCollatorForSupervisedDataset:
    """Pad to max length, insert a dummy image token for text-only samples at
    ``image_position``, expand the image block (train_fsdp.py:1168-1236)."""

    tokenizer: object
    image_token_len: int
    image_aux_token_len_list: Sequence[int]
    image_position: int

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        max_length = self.tokenizer.model_max_length
        pad_id = self.tokenizer.pad_token_id
        if pad_id is None:
            pad_id = 0
        padding_side = getattr(self.tokenizer, "padding_side", "right")

        ids_list, labels_list = [], []
        for inst in instances:
            ids = np.asarray(inst["input_ids"], dtype=np.int64)
            labels = np.asarray(inst["labels"], dtype=np.int64)
            if ids.shape[0] >= max_length:
                ids, labels = ids[:max_length], labels[:max_length]
            else:
                pad = max_length - ids.shape[0]
                if padding_side == "left":
                    ids = np.concatenate([np.full(pad, pad_id, ids.dtype), ids])
                    labels = np.concatenate([np.full(pad, IGNORE_INDEX, labels.dtype), labels])
                else:
                    ids = np.concatenate([ids, np.full(pad, pad_id, ids.dtype)])
                    labels = np.concatenate([labels, np.full(pad, IGNORE_INDEX, labels.dtype)])
            ids_list.append(ids)
            labels_list.append(labels)

        input_ids = np.stack(ids_list)
        labels = np.stack(labels_list)
        attention_mask = input_ids != pad_id

        for i in range(len(input_ids)):
            if (input_ids[i] == IMAGE_TOKEN_INDEX).sum() == 0:
                input_ids[i], labels[i], attention_mask[i] = insert_dummy_image(
                    input_ids[i], labels[i], attention_mask[i], self.image_position
                )

        image_sizes = [inst["image_size"] for inst in instances]
        (new_input_ids, new_labels, new_attention_mask, new_position_ids,
         aux_masks_list) = prepare_multimodal_data(
            input_ids, labels, attention_mask, image_sizes,
            self.image_token_len, self.image_aux_token_len_list, max_length,
        )
        batch = dict(
            input_ids=new_input_ids,
            labels=new_labels,
            attention_mask=new_attention_mask,
            position_ids=new_position_ids,
            aux_masks=list(aux_masks_list),
        )
        if "image_aux_list" in instances[0]:
            per_tower = list(zip(*[inst["image_aux_list"] for inst in instances]))
            batch["images"] = [np.stack(t).astype(np.float32) for t in per_tower]
        return batch


def split_to_even_chunks(indices, lengths, num_chunks):
    """Partition ``indices`` into ``num_chunks`` equal-count chunks with
    balanced total sample length — the per-rank split of one global batch
    (semantics of cambrian_trainer.py:65-89). Each index goes to the
    currently-lightest chunk that still has room; when the count does not
    divide evenly, fall back to round-robin striding."""
    if len(indices) % num_chunks:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    loads = [0.0] * num_chunks
    for idx in indices:
        lightest = min(range(num_chunks), key=loads.__getitem__)
        chunks[lightest].append(idx)
        loads[lightest] += lengths[idx]
        if len(chunks[lightest]) == per_chunk:
            loads[lightest] = float("inf")  # full — stop assigning to it
    return chunks


def get_modality_length_grouped_indices(lengths, batch_size, world_size,
                                        generator: Optional[np.random.Generator] = None):
    """Sampler order with no modality-mixed global batches (semantics of
    cambrian_trainer.py:99-126). The sign of each length encodes modality
    (multimodal > 0, text-only < 0): each modality is length-grouped on its
    own and cut into world-sized batches; the two ragged tails merge into one
    final batch; whole batches are then shuffled."""
    generator = generator or np.random.default_rng(0)
    lengths = list(lengths)
    assert all(l != 0 for l in lengths), "should not have zero length"
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    if not mm or not lang:  # single-modality data: plain length grouping
        return get_length_grouped_indices(lengths, batch_size, world_size,
                                          generator)

    def batches_of(pairs):
        idxs, lens = zip(*pairs)
        order = get_length_grouped_indices(lens, batch_size, world_size,
                                           generator)
        flat = [idxs[i] for i in order]
        size = world_size * batch_size
        return [flat[i:i + size] for i in range(0, len(flat), size)]

    mm_batches = batches_of(mm)
    lang_batches = batches_of(lang)
    tail = mm_batches[-1] + lang_batches[-1]
    body = mm_batches[:-1] + lang_batches[:-1]
    body = [body[i] for i in generator.permutation(len(body))]
    if tail:
        body.append(sorted(tail))
    return [i for batch in body for i in batch]


def get_length_grouped_indices(lengths, batch_size, world_size, generator=None,
                               merge=True):
    """Shuffle globally, then sort each world-sized slice by descending
    length and split it into per-rank chunks of balanced total length
    (semantics of cambrian_trainer.py:129-141)."""
    generator = generator or np.random.default_rng(0)
    order = generator.permutation(len(lengths)).tolist()
    size = world_size * batch_size
    out = []
    for start in range(0, len(order), size):
        block = sorted(order[start:start + size],
                       key=lambda i: lengths[i], reverse=True)
        for chunk in split_to_even_chunks(block, lengths, world_size):
            out.extend(chunk)
    return out


class LengthGroupedSampler:
    """Modality/length-grouped sampler (cambrian_trainer.py:144-162)."""

    def __init__(self, batch_size, world_size, lengths,
                 generator=None, group_by_modality=False):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = lengths
        self.generator = generator
        self.group_by_modality = group_by_modality

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        if self.group_by_modality:
            indices = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, self.generator)
        else:
            indices = get_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, self.generator)
        return iter(indices)


def make_supervised_data_module(tokenizer, data_args) -> Dict:
    """(train_fsdp.py:1239-1264)."""
    train_dataset = LazySupervisedDataset(
        data_path=data_args.data_path, tokenizer=tokenizer, data_args=data_args
    )
    data_collator = DataCollatorForSupervisedDataset(
        tokenizer=tokenizer,
        image_token_len=data_args.image_token_len,
        image_aux_token_len_list=data_args.image_token_len_aux_list,
        image_position=data_args.image_position,
    )
    return dict(train_dataset=train_dataset, eval_dataset=None,
                data_collator=data_collator)

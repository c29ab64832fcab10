"""Multimodal host-side utilities: image preprocessing and image-token splicing.

Behavioral parity with the reference (cambrian/mm_utils.py):
- ``expand2square`` (:153-164) pads to square with the per-tower mean color.
- ``process_images`` (:186-201) runs per-tower pad-to-square + resize +
  normalize, returning one batched array per tower. Ours returns numpy
  ``float32`` NCHW arrays; device placement/dtype casting is the caller's job
  (the reference eagerly did ``.half().cuda()``).
- ``tokenizer_image_token`` / ``tokenizer_image_token_llama3`` (:204-240)
  splice ``IMAGE_TOKEN_INDEX`` (-200) between tokenized prompt chunks.

The preprocessing here is the *host* (PIL) path used for single-image
inference/serving; the high-throughput training pipeline uses the jitted XLA
equivalent in ``cambrian_tpu.data.image_pipeline``.
"""

import base64
from dataclasses import dataclass, field
from io import BytesIO
from typing import List, Optional, Sequence, Tuple

import numpy as np


def load_image_from_base64(image):
    from PIL import Image

    return Image.open(BytesIO(base64.b64decode(image)))


def expand2square(pil_img, background_color):
    """Pad to a square canvas of the longer side, centering the image on a
    ``background_color`` fill (behavior of reference mm_utils.py:153-164)."""
    from PIL import Image

    w, h = pil_img.size
    if w == h:
        return pil_img
    side = max(w, h)
    canvas = Image.new(pil_img.mode, (side, side), background_color)
    canvas.paste(pil_img, ((side - w) // 2, (side - h) // 2))
    return canvas


_PIL_RESAMPLE = {"bicubic": 3, "bilinear": 2, "nearest": 0, "lanczos": 1}


@dataclass
class ImageProcessor:
    """Per-tower image normalizer with the HF image-processor interface subset
    the framework relies on (crop_size / image_mean / preprocess).

    Matches HF CLIPImageProcessor semantics for a square input of exactly
    ``crop_size``: resize (no-op), center-crop (no-op), rescale 1/255,
    normalize (x - mean) / std, HWC -> CHW.
    """

    size: int = 336
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    resample: str = "bicubic"
    rescale_factor: float = 1.0 / 255.0

    @property
    def crop_size(self):
        return {"height": self.size, "width": self.size}

    def resize(self, pil_img):
        if pil_img.size != (self.size, self.size):
            pil_img = pil_img.resize((self.size, self.size), _PIL_RESAMPLE[self.resample])
        return pil_img

    def preprocess(self, pil_img, return_tensors: Optional[str] = None):
        pil_img = self.resize(pil_img.convert("RGB"))
        arr = np.asarray(pil_img, dtype=np.float32) * self.rescale_factor
        mean = np.asarray(self.image_mean, dtype=np.float32)
        std = np.asarray(self.image_std, dtype=np.float32)
        arr = (arr - mean) / std
        arr = arr.transpose(2, 0, 1)  # HWC -> CHW
        return {"pixel_values": arr[None]}


# Standard normalizations for the production towers.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def process_images(images: Sequence, image_processor: Sequence[ImageProcessor], model_cfg=None):
    """Multi-tower preprocessing (reference mm_utils.py:186-201).

    Args:
        images: list of PIL images.
        image_processor: list of per-tower processors.

    Returns:
        list (len = num towers) of float32 numpy arrays [B, 3, H_i, W_i].
    """
    def one_tower(img, proc):
        if hasattr(proc, "image_mean"):
            fill = tuple(int(c * 255) for c in proc.image_mean)
            side = proc.crop_size["height"]
            img = expand2square(img, fill).resize((side, side))
        return proc.preprocess(img, return_tensors="np")["pixel_values"][0]

    per_image = []  # [batch][tower]
    for img in images:
        # Eval datasets contain L/P/RGBA images; the per-tower mean fill is RGB.
        if getattr(img, "mode", "RGB") != "RGB":
            img = img.convert("RGB")
        per_image.append([one_tower(img, proc) for proc in image_processor])
    # stack each tower's column across the batch
    return [np.stack(col).astype(np.float32) for col in zip(*per_image)]


from .constants import IMAGE_TOKEN_INDEX  # noqa: E402  (after numpy-only block)


def tokenizer_image_token(prompt, tokenizer, image_token_index=IMAGE_TOKEN_INDEX,
                          return_tensors=None):
    """Tokenize a prompt containing ``<image>`` markers, splicing the image
    token index between chunks (behavior of reference mm_utils.py:204-223).

    Each ``<image>``-separated chunk is tokenized independently, so the
    tokenizer prepends BOS to every chunk; exactly one BOS (the first chunk's,
    when present) survives in the output."""
    chunks = [tokenizer(chunk).input_ids for chunk in prompt.split("<image>")]
    has_bos = bool(chunks and chunks[0] and
                   chunks[0][0] == tokenizer.bos_token_id)

    input_ids = [tokenizer.bos_token_id] if has_bos else []
    for i, chunk in enumerate(chunks):
        if i:
            input_ids.append(image_token_index)
        input_ids.extend(chunk[1:] if has_bos else chunk)

    if return_tensors is not None:
        if return_tensors in ("np", "jax"):
            return np.asarray(input_ids, dtype=np.int32)
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def tokenizer_image_token_llama3(prompt, tokenizer, image_token_index=IMAGE_TOKEN_INDEX,
                                 return_tensors=None):
    """LLaMA-3 variant without the BOS handling (mm_utils.py:226-240): chunks
    are concatenated as-tokenized with one image index between them."""
    chunks = [tokenizer(chunk).input_ids for chunk in prompt.split("<image>")]

    input_ids = []
    for i, chunk in enumerate(chunks):
        if i:
            input_ids.append(image_token_index)
        input_ids.extend(chunk)

    if return_tensors is not None:
        if return_tensors in ("np", "jax"):
            return np.asarray(input_ids, dtype=np.int32)
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def get_model_name_from_path(model_path):
    model_path = model_path.strip("/")
    model_paths = model_path.split("/")
    if model_paths[-1].startswith("checkpoint-"):
        return model_paths[-2] + "_" + model_paths[-1]
    else:
        return model_paths[-1]


class KeywordsStoppingCriteria:
    """Stop generation when any keyword appears at the tail of the output
    (semantics of reference mm_utils.py:252-284). Operates on numpy/int
    sequences (rows = prompt + generated ids), checking two ways:

    - token-level: the row's trailing ids equal a keyword's token ids;
    - text-level: the decoded tail window (at most the longest keyword's
      token count, and never reaching into the prompt) contains a keyword.

    ``__call__`` is batch-AND: stops only once every row has hit a keyword,
    matching the reference and fitting ``GenerationEngine``'s ``stopping=``
    hook directly.
    """

    def __init__(self, keywords, tokenizer, input_ids):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.start_len = np.atleast_2d(np.asarray(input_ids)).shape[1]
        self.keyword_ids = []
        for kw in self.keywords:
            ids = list(tokenizer(kw).input_ids)
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.keyword_ids.append(np.asarray(ids))
        self.max_keyword_len = max(
            (len(k) for k in self.keyword_ids), default=0)

    def _row_hit(self, row: np.ndarray) -> bool:
        for kw_ids in self.keyword_ids:
            n = len(kw_ids)
            if len(row) >= n and np.array_equal(row[-n:], kw_ids):
                return True
        window = min(len(row) - self.start_len, self.max_keyword_len)
        if window <= 0:
            return False
        tail = self.tokenizer.batch_decode(
            [row[-window:]], skip_special_tokens=True)[0]
        return any(kw in tail for kw in self.keywords)

    def call_for_batch(self, output_ids) -> bool:
        return self._row_hit(np.atleast_2d(np.asarray(output_ids))[0])

    def __call__(self, output_ids) -> bool:
        rows = np.atleast_2d(np.asarray(output_ids))
        return all(self._row_hit(row) for row in rows)


# ---------------------------------------------------------------------------
# anyres helpers (reference mm_utils.py:13-146; unused on the main path but
# part of the public API surface)
# ---------------------------------------------------------------------------

def select_best_resolution(original_size, possible_resolutions):
    original_width, original_height = original_size
    best_fit = None
    max_effective_resolution = 0
    min_wasted_resolution = float("inf")
    for width, height in possible_resolutions:
        scale = min(width / original_width, height / original_height)
        downscaled_width = int(original_width * scale)
        downscaled_height = int(original_height * scale)
        effective_resolution = min(
            downscaled_width * downscaled_height, original_width * original_height
        )
        wasted_resolution = (width * height) - effective_resolution
        if effective_resolution > max_effective_resolution or (
            effective_resolution == max_effective_resolution
            and wasted_resolution < min_wasted_resolution
        ):
            max_effective_resolution = effective_resolution
            min_wasted_resolution = wasted_resolution
            best_fit = (width, height)
    return best_fit


def resize_and_pad_image(image, target_resolution):
    import math

    from PIL import Image

    original_width, original_height = image.size
    target_width, target_height = target_resolution
    scale_w = target_width / original_width
    scale_h = target_height / original_height
    if scale_w < scale_h:
        new_width = target_width
        new_height = min(math.ceil(original_height * scale_w), target_height)
    else:
        new_height = target_height
        new_width = min(math.ceil(original_width * scale_h), target_width)
    resized_image = image.resize((new_width, new_height))
    new_image = Image.new("RGB", (target_width, target_height), (0, 0, 0))
    new_image.paste(
        resized_image,
        ((target_width - new_width) // 2, (target_height - new_height) // 2),
    )
    return new_image


def divide_to_patches(image, patch_size):
    patches = []
    width, height = image.size
    for i in range(0, height, patch_size):
        for j in range(0, width, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size):
    import ast

    possible_resolutions = (
        grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    )
    width, height = select_best_resolution(image_size, possible_resolutions)
    return width // patch_size, height // patch_size


def process_anyres_image(image, processor, grid_pinpoints):
    import ast

    possible_resolutions = (
        grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    )
    best_resolution = select_best_resolution(image.size, possible_resolutions)
    image_padded = resize_and_pad_image(image, best_resolution)
    patches = divide_to_patches(image_padded, processor.crop_size["height"])
    shortest = getattr(processor, "size", None)
    edge = shortest["shortest_edge"] if isinstance(shortest, dict) else processor.size
    image_original_resize = image.resize((edge, edge))
    image_patches = [image_original_resize] + patches
    arrs = [
        processor.preprocess(p, return_tensors="np")["pixel_values"][0] for p in image_patches
    ]
    return np.stack(arrs, axis=0)

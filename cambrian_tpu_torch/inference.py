"""Single-image inference CLI on the PyTorch port — the counterpart of the
repository's root ``inference.py``: load a checkpoint, assemble the
conversation prompt, preprocess the image per tower, pack, generate.

Usage:
    python -m cambrian_tpu_torch.inference --model_path /path/to/ckpt \
        --image path.jpg --question "What is in this image?" --conv_mode llama_3
"""

import argparse

import torch

from cambrian_tpu.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IMAGE_TOKEN_INDEX,
)
from cambrian_tpu.conversation import conv_templates
from cambrian_tpu.mm_utils import (
    process_images,
    tokenizer_image_token,
    tokenizer_image_token_llama3,
)


def process(image, question, tokenizer, image_processor, model_config,
            conv_mode="llama_3"):
    """Prompt assembly + per-tower preprocessing + image-token tokenization.
    Returns (input_ids, per-tower pixel arrays, [image size], prompt)."""
    if model_config.mm_use_im_start_end:
        qs = DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN + "\n" + question
    else:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + question
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()
    image_tensor = process_images([image], image_processor, model_config)
    tok_fn = tokenizer_image_token_llama3 if "llama_3" in conv_mode else tokenizer_image_token
    input_ids = tok_fn(prompt, tokenizer, IMAGE_TOKEN_INDEX, return_tensors="np")
    return input_ids, image_tensor, [image.size], prompt


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--question", default="What is shown in this image?")
    parser.add_argument("--conv_mode", default="llama_3")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--max_new_tokens", type=int, default=512)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from PIL import Image

    from .models.builder import load_pretrained_model

    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    tokenizer, model, image_processor, _ = load_pretrained_model(
        args.model_path, device=args.device, dtype=dtype)
    image = Image.open(args.image).convert("RGB")
    input_ids, image_tensor, image_size, _ = process(
        image, args.question, tokenizer, image_processor, model.config, args.conv_mode)
    output_ids = model.generate(
        input_ids, images=image_tensor, image_sizes=image_size,
        do_sample=args.temperature > 0, temperature=args.temperature,
        max_new_tokens=args.max_new_tokens, seed=args.seed)
    print(tokenizer.batch_decode(output_ids, skip_special_tokens=True)[0].strip())


if __name__ == "__main__":
    main()

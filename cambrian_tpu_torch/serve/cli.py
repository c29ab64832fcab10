"""Interactive REPL chat about one image, streaming each answer as it is
generated (cambrian_tpu/serve/cli.py).

Usage:
    python -m cambrian_tpu_torch.serve.cli --model-path /path/to/ckpt \
        --image-file photo.jpg [--load-8bit | --load-4bit] [--device cuda]

An empty line (or the end of input) exits. ``--device cpu`` runs in fp32.
"""

import argparse

import numpy as np
import torch

from ..constants import DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_TOKEN
from ..conversation import SeparatorStyle, conv_templates
from ..mm_utils import (
    get_model_name_from_path,
    process_images,
    tokenizer_image_token,
    tokenizer_image_token_llama3,
)
from ..models.builder import load_pretrained_model


def load_image(image_file):
    from io import BytesIO

    from PIL import Image

    if image_file.startswith(("http://", "https://")):
        import requests

        response = requests.get(image_file, timeout=30)
        return Image.open(BytesIO(response.content)).convert("RGB")
    return Image.open(image_file).convert("RGB")


def conv_mode_for(model_name: str) -> str:
    name = model_name.lower()
    if "llama3" in name or "llama-3" in name:
        return "llama_3"
    if "phi3" in name:
        return "phi3"
    if "34b" in name or "yi" in name:
        return "chatml_direct"
    return "vicuna_v1"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-file", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--conv-mode", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--debug", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    model_name = get_model_name_from_path(args.model_path)
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    tokenizer, model, image_processor, _ = load_pretrained_model(
        args.model_path, args.model_base, model_name, args.load_8bit, args.load_4bit,
        device=args.device, dtype=dtype)

    conv_mode = args.conv_mode or conv_mode_for(model_name)
    conv = conv_templates[conv_mode].copy()
    roles = conv.roles

    image = load_image(args.image_file)
    image_size = image.size
    image_tensor = process_images([image], image_processor, model.config)

    first_turn = True
    while True:
        try:
            inp = input(f"{roles[0]}: ")
        except EOFError:
            inp = ""
        if not inp:
            print("exit...")
            break

        print(f"{roles[1]}: ", end="", flush=True)
        if first_turn:
            if model.config.mm_use_im_start_end:
                inp = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
                       + DEFAULT_IM_END_TOKEN + "\n" + inp)
            else:
                inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
            first_turn = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        tok_fn = tokenizer_image_token_llama3 if conv_mode == "llama_3" \
            else tokenizer_image_token
        input_ids = np.asarray(tok_fn(prompt, tokenizer), dtype=np.int64)

        # every turn's prompt holds the first turn's image marker
        prev = ""
        stop = conv.sep if conv.sep_style == SeparatorStyle.SINGLE else conv.sep2
        for out_ids in model.generate_stream(
            input_ids, images=image_tensor, image_sizes=[image_size],
            do_sample=args.temperature > 0, temperature=args.temperature,
            max_new_tokens=args.max_new_tokens,
        ):
            text = tokenizer.decode(out_ids[0], skip_special_tokens=True)
            if stop and stop in text:
                text = text[: text.index(stop)]
                print(text[len(prev):], end="", flush=True)
                prev = text
                break
            print(text[len(prev):], end="", flush=True)
            prev = text
        print()
        conv.messages[-1][-1] = prev

        if args.debug:
            print("\n", {"prompt": prompt, "outputs": prev}, "\n")


if __name__ == "__main__":
    main()

"""Benchmark answer generation (cambrian_tpu/eval/runner.py) — the shared
``*_eval.py`` loop (reference eval/eval/mmmu/mmmu_eval.py:78-146) for every
registered benchmark, with ``--num_chunks/--chunk_idx`` index-range data
sharding (mmmu_eval.py:23-32, driven per-host by
eval/scripts/run_benchmark.sh:85-105), on the port's
``load_pretrained_model`` and ``generate``.

Usage:
    python -m cambrian_tpu_torch.eval.runner --benchmark mmmu \\
        --model_path ckpt/ --conv_mode llama_3 --answers_file answers.jsonl \\
        [--dataset_path local_dir_or_json] [--num_chunks 8 --chunk_idx 0] \\
        [--device cuda]

``--device cuda`` (the default) runs bf16 on the card and raises where there
is none; ``--device cpu`` runs fp32. Greedy answers (``--temperature 0``,
the default) are those of the JAX runner; sampled ones are drawn from a
``torch.Generator``, so they differ from the JAX package's.

``answer_record`` is one record's step (prompt, inputs, ``generate``, the
decoded row); given ``pixels``, the per-tower batches that
``process_images`` would make, it reads no image.
"""

import argparse
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from ..constants import DEFAULT_IMAGE_TOKEN
from ..conversation import conv_templates
from ..mm_utils import (
    process_images,
    tokenizer_image_token,
    tokenizer_image_token_llama3,
)
from .base import BENCHMARKS


def get_chunk(n: int, num_chunks: int, chunk_idx: int):
    """Index range chunking (mmmu_eval.py:23-32)."""
    per = math.ceil(n / num_chunks)
    start = chunk_idx * per
    return range(start, min(start + per, n))


def load_benchmark_dataset(benchmark, dataset_path: Optional[str] = None,
                           split: Optional[str] = None):
    split = split or benchmark.split
    if dataset_path:
        if dataset_path.endswith((".json", ".jsonl")):
            import datasets

            return datasets.load_dataset("json", data_files=dataset_path,
                                         split="train")
        import datasets

        ds = datasets.load_from_disk(dataset_path)
        if hasattr(ds, "keys") and split in getattr(ds, "keys", lambda: [])():
            return ds[split]
        return ds
    import datasets

    if benchmark.config:
        return datasets.load_dataset(benchmark.dataset, benchmark.config,
                                     split=split)
    return datasets.load_dataset(benchmark.dataset, split=split)


def build_inputs(prompt_dict, tokenizer, image_processor_list, model_config,
                 conv_mode: str, pixels=None, image_size=None):
    """Conversation-template prompt + per-tower preprocessing + tokenization
    (the reference's per-benchmark process() helpers). ``pixels``: the
    prompt's image as per-tower batches already processed, with its
    ``image_size`` (None: the towers' square), used in place of
    ``process_images``."""
    qs = prompt_dict["text"]
    image = prompt_dict.get("image")
    if image is not None and DEFAULT_IMAGE_TOKEN not in qs:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs

    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    tok_fn = tokenizer_image_token_llama3 if "llama_3" in conv_mode \
        else tokenizer_image_token
    input_ids = np.asarray(tok_fn(prompt, tokenizer), dtype=np.int64)

    image_tensor = None
    image_sizes = None
    if image is not None and pixels is not None:
        image_tensor = pixels
        image_sizes = None if image_size is None else [tuple(image_size)]
    elif image is not None:
        if not hasattr(image, "size"):
            from io import BytesIO

            from PIL import Image

            image = Image.open(BytesIO(image["bytes"])) \
                if isinstance(image, dict) else Image.fromarray(np.asarray(image))
        image = image.convert("RGB")
        image_sizes = [image.size]
        image_tensor = process_images([image], image_processor_list, model_config)
    return input_ids, image_tensor, image_sizes, prompt


def _dump_record(record, benchmark_name, i):
    """Schema-debugging aid (--dump_records): field names + truncated values,
    binary/image payloads elided."""
    import sys

    view = {}
    for k, v in record.items():
        if hasattr(v, "size") and not isinstance(v, (str, bytes)):
            view[k] = f"<image {getattr(v, 'size', '?')}>"
        elif isinstance(v, bytes):
            view[k] = f"<{len(v)} bytes>"
        else:
            s = repr(v)
            view[k] = s if len(s) <= 200 else s[:200] + "…"
    print(f"[dump_records] {benchmark_name}[{i}]: "
          f"{json.dumps(view, ensure_ascii=False, default=str)}",
          file=sys.stderr)


def answer_record(benchmark_name: str, record: dict, i: int, model_bundle, conv_mode: str,
                  max_new_tokens: int = 128, temperature: float = 0.0, pixels=None,
                  image_size=None) -> dict:
    """One record -> its answers row: the benchmark's prompt, the model
    inputs (``pixels`` / ``image_size`` as ``build_inputs`` takes them),
    ``generate`` and the decoded prediction."""
    benchmark = BENCHMARKS[benchmark_name]
    tokenizer, model, image_processor_list, _ = model_bundle
    prompt_dict = benchmark.build_prompt(record)
    input_ids, image_tensor, image_sizes, _ = build_inputs(
        prompt_dict, tokenizer, image_processor_list, model.config, conv_mode,
        pixels, image_size,
    )
    output_ids = model.generate(
        input_ids, images=image_tensor, image_sizes=image_sizes,
        do_sample=temperature > 0, temperature=temperature,
        max_new_tokens=max_new_tokens,
    )
    prediction = tokenizer.batch_decode(
        output_ids, skip_special_tokens=True)[0].strip()
    row = {
        "question_id": record.get("question_id", record.get(
            "id", record.get("index", int(i)))),
        "prompt": prompt_dict["text"],
        "text": prediction,
        "prediction": prediction,
        "answer": prompt_dict.get("answer"),
        "benchmark": benchmark_name,
    }
    for extra in ("choices", "answers", "image_id", "category",
                  "question_type", "submission_id"):
        if prompt_dict.get(extra) is not None:
            row[extra] = prompt_dict[extra]
    return row


def run_benchmark(benchmark_name: str, model_bundle, conv_mode: str,
                  answers_file: str, dataset_path: Optional[str] = None,
                  num_chunks: int = 1, chunk_idx: int = 0,
                  max_new_tokens: int = 128, temperature: float = 0.0,
                  limit: Optional[int] = None, split: Optional[str] = None,
                  dump_records: int = 0):
    """Generate answers for one benchmark chunk -> JSONL rows."""
    benchmark = BENCHMARKS[benchmark_name]
    ds = load_benchmark_dataset(benchmark, dataset_path, split)

    indices = list(get_chunk(len(ds), num_chunks, chunk_idx))
    if limit is not None:
        indices = indices[:limit]

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    np.random.seed(42)  # fixed seeds for reproducible runs (mmmu_eval.py:79-83)

    with open(answers_file, "w") as out:
        for n, i in enumerate(indices):
            record = dict(ds[int(i)])
            if n < dump_records:
                _dump_record(record, benchmark_name, int(i))
            row = answer_record(benchmark_name, record, int(i), model_bundle, conv_mode,
                                max_new_tokens, temperature)
            out.write(json.dumps(row) + "\n")
    return answers_file


def main(argv=None):
    from ..models.builder import load_pretrained_model

    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", required=True, choices=sorted(BENCHMARKS))
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--conv_mode", default="llama_3")
    parser.add_argument("--answers_file", required=True)
    parser.add_argument("--dataset_path", default=None)
    parser.add_argument("--split", default=None)
    parser.add_argument("--num_chunks", type=int, default=1)
    parser.add_argument("--chunk_idx", type=int, default=0)
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--dump_records", type=int, default=0,
                        help="print the first N raw records' fields to "
                             "stderr (schema debugging on first contact)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (bf16; raises without a card) or cpu (fp32)")
    args = parser.parse_args(argv)

    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    bundle = load_pretrained_model(args.model_path, device=args.device, dtype=dtype)
    run_benchmark(args.benchmark, bundle, args.conv_mode, args.answers_file,
                  args.dataset_path, args.num_chunks, args.chunk_idx,
                  args.max_new_tokens, args.temperature, args.limit,
                  args.split, args.dump_records)


if __name__ == "__main__":
    main()

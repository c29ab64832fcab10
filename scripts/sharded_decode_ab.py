"""Sharded decode of Cambrian-8B at world size 1, for one checkout of the
port: bf16 weights made on the card from a seed, ``GenerationEngine(mesh=...)``
on the (1,1,1) mesh over NCCL, text prompts of 645 tokens and 32 greedy
tokens. Prints the decode tokens/s of each request (``last_timings``, host
clock ending in a sync) and the ops of one profiled request by host time
and by device time (``torch.profiler``). Compare two checkouts in one call,
in turns (parent, change, change, parent):

    python3 scripts/sharded_decode_ab.py --repo PARENT_DIR --label parent
    python3 scripts/sharded_decode_ab.py --repo . --label change

``--repo`` is put first on ``sys.path``, so the port imported is that
checkout's. Needs one CUDA card.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=".")
    parser.add_argument("--label", default="")
    parser.add_argument("--requests", type=int, default=3)
    parser.add_argument("--out", help="append the result as a JSON line to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))

    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("sharded_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.ops import cuda_build
    from cambrian_tpu_torch.parallel.distributed import initialize_distributed
    from cambrian_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    cuda_build.build("flash_attention")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"tcp://localhost:{port}", 1, 0)
    try:
        mesh = create_mesh(MeshConfig(1, 1, 1), "cuda")
        dev = torch.device("cuda")
        cfg = cambrian_8b()
        sd = random_state_dict(cfg, torch.Generator(device=dev).manual_seed(0), 0.02,
                               dtype=torch.bfloat16, device=dev)
        model = CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
        del sd
        engine = GenerationEngine(model.lm, model.towers, 1024, torch.bfloat16, mesh=mesh)
        rng = np.random.default_rng(0)
        gcfg = GenerationConfig(max_new_tokens=32, temperature=0.0)
        rates = []
        for _ in range(args.requests):
            ids = rng.integers(5, cfg.vocab_size, (1, 645))
            mask, pos = np.ones(ids.shape, bool), np.arange(645)[None]
            engine.generate(ids, mask, pos, config=gcfg)
            tm = engine.last_timings
            rates.append(tm["decode_steps"] / tm["decode_ms"] * 1e3)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.generate(ids, mask, pos, config=GenerationConfig(max_new_tokens=9))
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()

        def top(key, n=12):
            rows = sorted(events, key=lambda e: -getattr(e, key))[:n]
            return [(e.key, round(getattr(e, key) / 1e3, 3), e.count) for e in rows]

        device_key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
                      else "self_cuda_time_total")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        result = dict(label=args.label, card=smi.stdout.strip(),
                      decode_tokens_per_s=rates, profiled_wall_ms=wall,
                      host_ms=top("self_cpu_time_total"), device_ms=top(device_key))
        print(json.dumps(result), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(result) + "\n")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

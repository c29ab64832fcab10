"""The benchmark of cambrian_tpu_torch on an NVIDIA H100: one cell a run.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(``gpu_bench/configs/<config>.json``) and its traffic mix
(``gpu_bench/traffic/<traffic>.json``); its limits are
``gpu_bench/limits/<cell>.json`` and each per-layer metric is read by
``gpu_bench/metrics/<metric>.py``. A run makes the weights on the card from
the seed, warms up the cell's own shapes (set-up), measures for
``--seconds``, checks what the timed path produced against the plain
references of ``gpu_bench/reference/`` and prints one JSON line last. With
``--trace 1`` it profiles a fixed stretch of the window and prints the
per-layer metrics instead of the end-to-end ones.

Two options make runs that have to come out not correct, and no benchmark
run uses them: ``--control 1`` runs the cell in the precision one step
below its configuration's (the program's own lower path where it has one,
else the reference in that precision in the program's place), and
``--fault half-batch`` puts in the program's place a training reference
that takes half of each batch, the mean over the rest.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpu_bench.harness import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", choices=("none", "half-batch"), default="none")
    return p.parse_args(argv)


def _sample(finished, budgets, seed: int, k: int):
    """The compared requests: the one with the most served tokens, and
    ``k - 1`` more drawn from the seed."""
    import numpy as np

    if not finished:
        return []
    longest = max(finished, key=lambda n: (budgets[n], -n))
    rest = sorted(n for n in finished if n != longest)
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def _reference_source(seed, specs, device, keep: bool):
    """The seed's weights again, a group at a time, in float32; ``keep``
    holds each group of the LM once made (the towers are made again at each
    use)."""
    import torch
    from gpu_bench.harness import weights

    groups = weights.groups(specs)
    made = {}

    def source(group):
        if group in made:
            return made[group]
        out = {k: v.float() for k, v in weights.make_group(seed, group, groups[group],
                                                            device).items()}
        if keep and group.startswith("lm."):
            made[group] = out
        return out

    return source


def in_place_run(args) -> bool:
    """A control or fault run: it reports no metric."""
    return bool(args.control) or args.fault != "none"


def _precise():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def serve_cell(args, cell, device):
    import torch
    from gpu_bench.harness import checks, program, serve, tracer
    from gpu_bench.reference import serve as ref_serve

    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    quantize = cfg["control"]["serving"]["quantize"] if args.control else "config"
    srv = serve.Server(cfg, traffic, args.seed, device, quantize)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    tr = tracer.Tracer(bool(args.trace), traffic["trace_chunks"])
    res = serve.run_closed(srv, args.seconds, lambda: tr)
    e2e = {"serve_tokens_per_s": res["tokens"] / res["seconds"], "setup_s": res["t0"] - START}
    attempted, failed = res["attempted"], res["failed"]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = common.forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {bad}")
    budgets = {n: r["budget"] for n, r in srv.requests.items()}
    # a sample of the finished requests, and what every request still in a
    # slot served so far: every slot, prompt and depth the window reached
    sample = _sample(res["finished"], budgets, args.seed, traffic["compare_requests"])
    served = {n: list(srv.requests[n]["req"].tokens) for n in sample + res["active"]}
    chosen = [n for n in sample + res["active"] if served[n]]
    specs = program.specs(program.model_config(cfg))
    log = srv.spans.log
    srv.free()

    _precise()
    reqs = []
    for n in chosen:
        r = serve.request_inputs(cfg, traffic, args.seed, n, device)
        reqs.append({"ids": torch.as_tensor(r["ids"], device=device), "pixels": r["pixels"],
                     "served": torch.as_tensor(served[n], device=device)})
    t_ref = time.perf_counter()
    with torch.no_grad():
        gaps = ref_serve.served_gaps(_reference_source(args.seed, specs, device, keep=False),
                                     cfg, reqs, quant=cfg["quantize"])
    complete = all(len(served[n]) == budgets[n] for n in sample) \
        and all(len(served[n]) < budgets[n] for n in res["active"])
    every = torch.cat(gaps) if gaps else torch.full((1,), float("inf"))
    readings = {"served_gap": float(every.max()), "served_mean_gap": float(every.mean())}
    print(f"served tokens' gaps: widest {readings['served_gap']!r}, mean "
          f"{readings['served_mean_gap']!r}, {int((every > 0).sum())} of {every.numel()} above 0",
          file=sys.stderr)
    result = {k: checks.check(readings[k], limit) for k, limit in limits.items()}
    correct = bool(chosen) and complete and all(c["ok"] for c in result.values())
    print(f"compared {len(sample)} of {len(res['finished'])} requests finished in the window "
          f"and the {len(chosen) - len(sample)} still in a slot at its close "
          f"({sum(len(served[n]) for n in chosen)} served tokens, the deepest at "
          f"{max(len(r['ids']) + len(r['served']) for r in reqs) if reqs else 0} ids and tokens), "
          f"the reference in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return e2e, tr, log, peak, attempted, failed, correct, result


def train_cell(args, cell, device):
    import torch
    from gpu_bench.harness import checks, program, train, tracer
    from gpu_bench.reference import train as ref_train

    cfg, job, limits = cell["config"], cell["traffic"], cell["limits"]
    specs = program.specs(program.model_config(cfg))
    samples = train.Samples(cfg, job, args.seed)
    on_card = torch.device(device).type == "cuda"
    tr = tracer.Tracer(bool(args.trace), job["trace_steps"])
    e2e, log, peak, attempted, failed = {}, {}, 0, 0, 0
    in_place = in_place_run(args)
    if in_place:
        batches = train.first_batches(samples, job, job["followed_steps"])
    else:
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        out_dir = str(common.ROOT / "build" / "gpu_bench_train")
        res = train.run(cfg, job, args.seed, args.seconds, device, tr, out_dir)
        e2e = {"train_tokens_per_s": res["tokens"] / res["seconds"],
               "setup_s": res["t0"] - START}
        peak, log, batches = res["peak"], res["log"], res["batches"]
        attempted = res["steps"]
        bad = common.forbidden_modules()
        if bad:
            raise SystemExit(f"modules of JAX or the JAX package are loaded: {bad}")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    _precise()
    if on_card:
        print(f"left allocated before the reference: {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
              file=sys.stderr)
    source = _reference_source(args.seed, specs, device, keep=True)

    def inputs(idx):
        out = []
        for i in idx:
            s = samples[i]
            out.append({"ids": torch.as_tensor(s["input_ids"], device=device),
                        "labels": torch.as_tensor(s["labels"], device=device),
                        "pixels": [torch.as_tensor(p, device=device)[None]
                                   for p in s["image_aux_list"]]})
        return out

    feed = [inputs(b) for b in batches]
    t_ref = time.perf_counter()
    ref = ref_train.follow(source, cfg, job, feed)
    print(f"the reference's {len(feed)} steps in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    if in_place:
        rounding = cfg["control"]["training"]["rounding"] if args.control else None
        part = [b[:len(b) // 2] for b in feed] if args.fault == "half-batch" else feed
        got = ref_train.follow(source, cfg, job, part, rounding=rounding)
        prog_losses, prog_grads = got["losses"], got["grads"]
        prog_change = got["change"]
    else:
        prog_losses, prog_grads = res["losses"], res["grads"]
        prog_change = {k: res["after"][k] - res["start"][k] for k in res["after"]}
    ref_grads = {k: v.cpu() for k, v in ref["grads"].items()}
    ref_change = {k: v.cpu() for k, v in ref["change"].items()}
    prog_grads = {k: v.cpu() for k, v in prog_grads.items()}
    prog_change = {k: v.cpu() for k, v in prog_change.items()}
    if set(prog_grads) != set(ref_grads):
        raise RuntimeError(f"trainable leaves differ: {sorted(set(prog_grads) ^ set(ref_grads))[:5]}")
    step_gaps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref["losses"])]
    grad_gap, grad_at = checks.leaf_gap(prog_grads, ref_grads, ref_grads)
    moving = checks.moving_leaves(ref_grads)
    change_gap, change_at = checks.leaf_gap(prog_change, ref_change, moving)
    print(f"losses {prog_losses} against the reference's {ref['losses']} (gaps {step_gaps}); "
          f"worst gradient leaf {grad_at}, worst change leaf {change_at} ({len(moving)} of "
          f"{len(ref_grads)} leaves move)", file=sys.stderr)
    readings = {"first_loss_gap": step_gaps[0], "loss_gap": max(step_gaps),
                "grad_gap": grad_gap, "change_gap": change_gap}
    result = {k: checks.check(readings[k], limit) for k, limit in limits.items()}
    correct = all(c["ok"] for c in result.values())
    return e2e, tr, log, peak, attempted, failed, correct, result


def main(argv=None, bench_file=None, data_dir=None, device=None):
    args = parse(argv)
    common.set_cache_dirs()
    cell = common.load_cell(args.workload, bench_file, data_dir)
    import torch

    if device is None:
        common.require_cards(cell["cell"]["chips"])
        device = "cuda:0"
        torch.cuda.set_device(0)
        torch.cuda.init()

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    on_card = torch.device(device).type == "cuda"
    print(f"card: {common.card_line() if on_card else 'none (' + device + ')'}",
          file=sys.stderr, flush=True)
    kind = cell["traffic"]["kind"]
    run = train_cell if kind == "train" else serve_cell
    e2e, tr, log, peak, attempted, failed, correct, result = run(args, cell, device)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["cell"]["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace and not in_place_run(args):
        from gpu_bench.harness import tracer

        if tr.finish() is None:
            raise SystemExit("the traced stretch never ran")
        metrics = tracer.per_layer(cell["per_layer"], tr.trace, log, cell["config"],
                                   cell["traffic"])
        dev.update(tracer.device_fields(tr.trace))
        breakdown = tracer.breakdown(tr.trace)
        print(f"trace: {len(tr.trace.device)} device ops, {tr.trace.unlinked} not tied to a "
              f"launch, {tr.trace.outside} launched outside their linked op; stopping the "
              f"profiler took {tr.stall:.3f} s of the window",
              file=sys.stderr)
    elif in_place_run(args):
        metrics = {}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    common.emit(correct, attempted, failed, metrics, dev, result, breakdown)


if __name__ == "__main__":
    main()

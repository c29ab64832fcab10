"""Multi-process helpers of the port's sharded tests
(tests/test_torch_parallel_{train,infer,lora,quant}.py,
tests/test_torch_vocab_parallel.py).

``start_ranks`` starts one spawned process a rank on the CPU (gloo, a
``file://`` rendezvous under the test's temporary directory, one thread a
process); ``join_ranks`` joins them within a time limit and returns what
each wrote. The
rank functions here import the port only, never JAX: the tests compute the
JAX references in their own process and hand the ranks numpy inputs.
"""

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def start_ranks(target, world: int, tmp_path, payload):
    """Start ``target(rank, world, payload)`` in ``world`` spawned
    processes; ``join_ranks`` collects them. The caller may work meanwhile
    (the JAX references)."""
    tmp = str(tmp_path)
    payload_path = os.path.join(tmp, "payload.pt")
    torch.save(payload, payload_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, tmp, payload_path))
             for r in range(world)]
    for p in procs:
        p.start()
    return tmp, procs


def join_ranks(started, timeout: float = 90.0):
    """Each rank's return value, rank order. A rank that raises, dies or is
    still running ``timeout`` seconds after the join starts fails the call
    (the others are stopped)."""
    tmp, procs = started
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [open(os.path.join(tmp, f"rank{r}.err")).read() for r in range(len(procs))
              if os.path.exists(os.path.join(tmp, f"rank{r}.err"))]
    if errors:
        raise RuntimeError("a rank failed:\n" + errors[0])
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return [torch.load(os.path.join(tmp, f"rank{r}.out"), weights_only=False)
            for r in range(len(procs))]


def run_ranks(target, world: int, tmp_path, payload, timeout: float = 90.0):
    """``start_ranks`` then ``join_ranks``."""
    return join_ranks(start_ranks(target, world, tmp_path, payload), timeout)


def _rank_main(target, rank, world, tmp, payload_path):
    torch.set_num_threads(1)
    try:
        from cambrian_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(f"file://{tmp}/rendezvous", world, rank)
        out = target(rank, world, torch.load(payload_path, weights_only=False))
        torch.save(out, os.path.join(tmp, f"rank{rank}.out"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (every rank takes part), or the tensor."""
    return (t.full_tensor() if hasattr(t, "placements") else t).detach().clone()


def build_model(payload):
    """The port's CambrianLM and towers of the payload's config and weights
    (fp32, CPU)."""
    from cambrian_tpu_torch.models.builder import CambrianForInference
    from cambrian_tpu_torch.models.config import CambrianConfig

    cfg = CambrianConfig.from_dict(payload["cfg"])
    m = CambrianForInference.from_state_dict(
        cfg, {k: v.clone() for k, v in payload["sd"].items()}, torch.float32)
    return m.lm, m.towers


def _trainer(lm, towers, payload, dims, stage, out_dir):
    from cambrian_tpu_torch.train.trainer import CambrianTrainer, TrainingArguments

    args = TrainingArguments(output_dir=out_dir, device="cpu", mesh_data=dims[0],
                             mesh_fsdp=dims[1], mesh_model=dims[2], bf16=False,
                             tune_mm_mlp_adapter=stage == 1, **payload["train_kw"])
    return CambrianTrainer(lm, towers, args, None, None)


def _optimizer_leaves(state):
    return {f"{n}/{k}": full(t) for n, st in state.optimizer.state_dict()["state"].items()
            for k, t in st.items()}


def train_rank(rank, world, payload):
    """3 steps of stage 1 and of stage 2 on each mesh of the payload, from
    its weights and global batches; then the stage-1 (1,2,2) state saved
    through the trainer, and restored under each of ``restore_meshes``."""
    from cambrian_tpu_torch.models.cambrian import valid_token_count
    from cambrian_tpu_torch.parallel.distributed import put_global_batch

    out = {"runs": {}, "restored": {}}
    saved = None
    for stage in (1, 2):
        for dims in payload["meshes"]:
            lm, towers = build_model(payload)
            ckpt_dir = os.path.join(payload["out_dir"], f"stage{stage}_{'x'.join(map(str, dims))}")
            trainer = _trainer(lm, towers, payload, dims, stage, ckpt_dir)
            state, step = trainer.prepare()
            run = {"loss": [], "grad_norm": [], "valid_tokens": []}
            for batch in payload["batches"]:
                local = put_global_batch(batch, trainer.mesh, "cpu")
                run["valid_tokens"].append(int(valid_token_count(local["labels"])))
                state, m = step(state, local)
                run["loss"].append(float(m["loss"]))
                run["grad_norm"].append(float(m["grad_norm"]))
            params = {n: full(p) for n, p in lm.named_parameters()}
            if rank == 0:
                run["params"] = params
            run["requires_grad"] = {n: p.requires_grad for n, p in lm.named_parameters()}
            run["grads_left"] = [n for n, p in lm.named_parameters() if p.grad is not None]
            run["trainable"] = sorted(state.optimizer.params)
            out["runs"][(stage, dims)] = run
            if stage == 1 and dims == payload["save_mesh"]:
                torch.manual_seed(payload["rng_seed"])
                rng = torch.get_rng_state()
                trainer._save_checkpoint(state, step=len(payload["batches"]))
                saved = dict(params=params, optimizer=_optimizer_leaves(state), rng=rng,
                             micro_step=state.step, ckpt=trainer.checkpoint_dir)
    for dims in payload["restore_meshes"]:
        # another mesh, other weights: everything must come from the checkpoint
        lm, towers = build_model(payload)
        with torch.no_grad():
            for p in lm.parameters():
                p.mul_(0.5)
        trainer = _trainer(lm, towers, payload, dims, 1, os.path.dirname(saved["ckpt"]))
        state, _ = trainer.prepare()
        torch.manual_seed(0)
        step = trainer._restore_checkpoint(state)
        got = dict(step=step, micro_step=state.step, rng=torch.get_rng_state(),
                   params={n: full(p) for n, p in lm.named_parameters()},
                   optimizer=_optimizer_leaves(state),
                   count=state.optimizer.count)
        out["restored"][dims] = {
            "step": got["step"], "micro_step": got["micro_step"] == saved["micro_step"],
            "rng": torch.equal(got["rng"], saved["rng"]),
            "count": got["count"],
            "params": [n for n, t in saved["params"].items()
                       if not torch.equal(got["params"][n], t)],
            "optimizer": [n for n, t in saved["optimizer"].items()
                          if not torch.equal(got["optimizer"][n], t)],
            "n_params": len(got["params"]), "n_optimizer": len(got["optimizer"]),
            "optimizer_nonzero": sum(bool(t.abs().sum() > 0) for t in
                                     saved["optimizer"].values()),
        }
    if rank == 0:
        out["saved_params"] = saved["params"]
    out["train"] = _train_loop(rank, payload)
    out["bf16"] = _bf16_step(payload)
    return out


def _bf16_step(payload):
    """Two stage-1 steps of the model built in bf16 (the trainer stores the
    frozen groups in bf16, norms and the trainable fp32 ones stay) on
    (1,2,2): FSDP2 units of one trainable dtype each. The loss and grad
    norm, and how many trainable tensors moved."""
    from cambrian_tpu_torch.models.builder import CambrianForInference
    from cambrian_tpu_torch.models.config import CambrianConfig
    from cambrian_tpu_torch.parallel.distributed import put_global_batch

    cfg = CambrianConfig.from_dict(payload["cfg"])
    m = CambrianForInference.from_state_dict(
        cfg, {k: v.clone() for k, v in payload["sd"].items()}, torch.bfloat16)
    trainer = _trainer(m.lm, m.towers, payload, (1, 2, 2), 1,
                       os.path.join(payload["out_dir"], "bf16"))
    trainer.args.bf16 = True
    state, step = trainer.prepare()
    before = {n: full(p) for n, p in state.optimizer.params.items()}
    dtypes = sorted({str(p.dtype) for p in state.optimizer.params.values()})
    for batch in payload["batches"][:2]:        # the first step's rate is 0 (warmup)
        state, metrics = step(state, put_global_batch(batch, trainer.mesh, "cpu"))
    moved = sum(not torch.equal(full(p), before[n]) for n, p in state.optimizer.params.items())
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                moved=moved, trainable=len(before), dtypes=dtypes)


class _Tokenizer:
    """What the collator reads of a tokenizer."""
    model_max_length = 160
    pad_token_id = 0
    padding_side = "right"


def _train_loop(rank, payload, lora=False):
    """``CambrianTrainer.train()`` on the (1,2,2) mesh over pre-tokenized
    samples: two optimizer steps of a global batch of 4 (of stage 1, or of
    LoRA), the final checkpoint and ``save_model`` (gathered, written by
    rank 0)."""
    from cambrian_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from cambrian_tpu_torch.data.dataset import DataCollatorForSupervisedDataset
    from cambrian_tpu_torch.models.config import CambrianConfig

    cfg = CambrianConfig.from_dict(payload["cfg"])
    rng = np.random.default_rng(5)
    items, lengths = [], []
    for i in range(8):
        n = int(rng.integers(40, 120))
        ids = rng.integers(5, cfg.vocab_size, n)
        labels = ids.copy()
        labels[:cfg.image_position + 4] = IGNORE_INDEX
        ids[cfg.image_position] = IMAGE_TOKEN_INDEX
        items.append(dict(input_ids=ids, labels=labels, image_size=(640, 360),
                          image_aux_list=[rng.standard_normal((3, 32, 32), dtype=np.float32)
                                          for _ in range(2)]))
        lengths.append(n)

    class Dataset(list):
        modality_lengths = lengths

    collator = DataCollatorForSupervisedDataset(
        tokenizer=_Tokenizer(), image_token_len=cfg.image_token_len,
        image_aux_token_len_list=list(cfg.mm_vision_tower_aux_token_len_list),
        image_position=cfg.image_position)
    lm, towers = build_model(payload)
    out_dir = os.path.join(payload["out_dir"], "lora_train_loop" if lora else "train_loop")
    trainer = (_lora_trainer(lm, towers, payload, (1, 2, 2), out_dir) if lora
               else _trainer(lm, towers, payload, (1, 2, 2), 1, out_dir))
    trainer.train_dataset, trainer.data_collator = Dataset(items), collator
    trainer.args.per_device_train_batch_size = 2
    trainer.args.dataloader_num_workers = 1
    trainer.args.logging_steps = 1
    trainer.global_batch_size = 2 * trainer.dp_size
    history = trainer.train()
    trainer.save_model()
    return dict(history=history, checkpoints=trainer._checkpoints(), out_dir=out_dir,
                global_batch=trainer.global_batch_size)


def infer_rank(rank, world, payload):
    """Greedy tokens of ``GenerationEngine(mesh=...)`` for each case of the
    payload: (its config and weights, the mesh, the prompt)."""
    from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine
    from cambrian_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    out = {}
    for name, case in payload["cases"].items():
        lm, towers = build_model(case)
        mesh = create_mesh(MeshConfig(*case["mesh"]), "cpu")
        engine = GenerationEngine(lm, towers, max_len=128, cache_dtype=torch.float32, mesh=mesh)
        ids, mask, pos, pixels, aux_masks = case["prompt"]
        feats = None if pixels is None else engine.encode_images(pixels)
        gcfg = GenerationConfig(max_new_tokens=case["new_tokens"], temperature=0.0)
        tokens = engine.generate(ids, mask, pos, feats, aux_masks, gcfg)
        out[name] = dict(tokens=np.asarray(tokens), kv_heads=engine.kv_heads,
                         rows=engine._local_rows(np.asarray(ids).shape[0]))
    return out


def _lora_trainer(lm, towers, payload, dims, out_dir):
    from cambrian_tpu_torch.train.trainer import CambrianTrainer, TrainingArguments

    args = TrainingArguments(output_dir=out_dir, device="cpu", mesh_data=dims[0],
                             mesh_fsdp=dims[1], mesh_model=dims[2], bf16=False,
                             lora_enable=True, lora_r=payload["rank"],
                             lora_alpha=payload["alpha"], **payload["train_kw"])
    return CambrianTrainer(lm, towers, args, None, None)


def _whole_adapters(adapters):
    return {f"{k}/{p}": full(t) for k, ad in adapters.items() for p, t in ad.items()}


def lora_rank(rank, world, payload):
    """LoRA on each mesh of the payload: the payload's adapters (whole,
    from numpy) distributed on the mesh, 3 steps of its global batches;
    the losses, grad norms, whole adapters, the base unchanged, and each
    factor's layout. Then the (1,4,1) run's checkpoint restored under
    ``restore_mesh`` (adapters and optimizer state, against the saved), and
    the merged model's export and the adapters' file written."""
    from cambrian_tpu_torch.parallel.distributed import put_global_batch
    from cambrian_tpu_torch.parallel.sharding import spec_of
    from cambrian_tpu_torch.train import lora

    out = {"runs": {}}
    saved = None
    for dims in payload["meshes"]:
        lm, towers = build_model(payload)
        base = {n: full(p) for n, p in lm.named_parameters()}
        out_dir = os.path.join(payload["out_dir"], "x".join(map(str, dims)))
        trainer = _lora_trainer(lm, towers, payload, dims, out_dir)
        trainer.args.lora_weight_path = payload["adapters_file"]
        state, step = trainer.prepare()
        run = {"loss": [], "grad_norm": []}
        for batch in payload["batches"]:
            state, m = step(state, put_global_batch(batch, trainer.mesh, "cpu"))
            run["loss"].append(float(m["loss"]))
            run["grad_norm"].append(float(m["grad_norm"]))
        run["adapters"] = _whole_adapters(trainer.adapters)
        run["layout"] = {f"{k}/{p}": spec_of(t) for k, ad in trainer.adapters.items()
                         for p, t in ad.items()}
        run["base_moved"] = [n for n, p in lm.named_parameters()
                             if not torch.equal(full(p), base[n])]
        run["grads_left"] = [n for n, p in lm.named_parameters() if p.grad is not None]
        out["runs"][dims] = run
        if dims == payload["save_mesh"]:
            trainer._save_checkpoint(state, step=len(payload["batches"]))
            saved = dict(adapters=run["adapters"], optimizer=_optimizer_leaves(state),
                         micro_step=state.step, out_dir=out_dir, lm=lm, towers=towers,
                         trainer=trainer)
    # the checkpoint under another mesh, from other adapters
    lm, towers = build_model(payload)
    trainer = _lora_trainer(lm, towers, payload, payload["restore_mesh"], saved["out_dir"])
    state, _ = trainer.prepare()
    got_step = trainer._restore_checkpoint(state)
    adapters = _whole_adapters(trainer.adapters)
    optimizer = _optimizer_leaves(state)
    out["restored"] = dict(
        step=got_step, micro_step=state.step == saved["micro_step"],
        adapters=[n for n, t in saved["adapters"].items() if not torch.equal(adapters[n], t)],
        optimizer=[n for n, t in saved["optimizer"].items() if not torch.equal(optimizer[n], t)],
        n_adapters=len(adapters), n_optimizer=len(optimizer),
        layout={f"{k}/{p}": spec_of(t) for k, ad in trainer.adapters.items()
                for p, t in ad.items()})
    # the end of a run on the saving mesh: the adapters' file and the merge,
    # then the gathered export
    first = saved["trainer"]
    whole = lora.lora_state_dict(first.adapters)
    if rank == 0:
        from cambrian_tpu_torch.checkpoint import safetensors_io

        safetensors_io.save_file(whole, os.path.join(saved["out_dir"],
                                                     "lora_adapters.safetensors"))
    lora.merge_lora(first.model, first.adapters, payload["alpha"], payload["rank"])
    export = os.path.join(saved["out_dir"], "hf")
    first.save_model(export)
    if rank == 0:       # the export is whole: the test's reader may start
        open(export + ".done", "w").close()
    out["train"] = _train_loop(rank, payload, lora=True)
    return out


def quant_rank(rank, world, payload):
    """Greedy tokens, the first step's logits (the rank's rows) and the
    layout of ``GenerationEngine(mesh=...)`` over a quantized model, for
    each case of the payload: (its config and weights, or a checkpoint that
    ``load_pretrained_model(load_4bit=True)`` reads; the mesh, the prompt,
    ``CAMBRIAN_INT4_V2``)."""
    from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine
    from cambrian_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from cambrian_tpu_torch.parallel.sharding import spec_of

    from cambrian_tpu_torch.models.builder import load_pretrained_model

    out = {}
    for name, case in payload["cases"].items():
        if "checkpoint" in case:
            _, model, _, _ = load_pretrained_model(case["checkpoint"], load_4bit=True,
                                                   device="cpu", dtype=torch.float32)
            lm, towers = model.lm, model.towers
        else:
            lm, towers = build_model(case)
        mesh = create_mesh(MeshConfig(*case["mesh"]), "cpu")
        engine = GenerationEngine(lm, towers, max_len=64, cache_dtype=torch.float32, mesh=mesh)
        ids, mask, pos = case["prompt"]
        if case.get("scale_on_weights"):
            os.environ["CAMBRIAN_INT4_V2"] = "1"
        try:
            tokens = engine.generate(ids, mask, pos, None, None,
                                     GenerationConfig(max_new_tokens=case["new_tokens"]))
        finally:
            os.environ.pop("CAMBRIAN_INT4_V2", None)
        layer = lm.layers_0
        mods = {"q_proj": layer.self_attn.q_proj, "o_proj": layer.self_attn.o_proj,
                "up_proj": layer.mlp.up_proj, "down_proj": layer.mlp.down_proj}
        tensors = {f"{site}.{leaf}": getattr(mod, leaf) for site, mod in mods.items()
                   for leaf in (mod._WEIGHT, "scale")}
        out[name] = dict(
            tokens=np.asarray(tokens), kv_heads=engine.kv_heads, plan=dict(lm.tp_plan),
            rows=engine._local_rows(np.asarray(ids).shape[0]),
            logits=engine.last_next_logits.detach().clone(),
            # each tensor's rank-local shape under tensor parallelism, and
            # the axes FSDP2 shards it over
            local={k: tuple(full(t).shape) for k, t in tensors.items()},
            fsdp={k: spec_of(t) for k, t in tensors.items()},
            norm=spec_of(layer.input_layernorm.weight))
    return out


def _vocab_layout(lm):
    """The embedding's and head's layout on this rank: spec, global and
    local shapes, the slab's place, whether an FSDP2 unit manages it, and
    how many parameters the units manage."""
    from cambrian_tpu_torch.parallel.sharding import fsdp_unit_params, spec_of, vocab_params

    managed = {id(p) for p in fsdp_unit_params(lm)}
    layout = lm.vocab_layout
    out = {"n_managed": len(managed), "split": layout.split, "start": layout.start,
           "rows": layout.rows}
    names = {id(p): n for n, p in lm.named_parameters()}
    for p in vocab_params(lm):
        out[names[id(p)]] = dict(spec=spec_of(p), shape=tuple(p.shape),
                                 local=tuple(p._local_tensor.shape), in_unit=id(p) in managed,
                                 slab=p._local_tensor.detach().clone())
    return out


class _WholeVocabWatch(TorchDispatchMode):
    """Records every op whose output holds (on this rank: a DTensor's local
    part) V x H elements, or a last dimension of V in two or more
    dimensions."""

    def __init__(self, vocab, hidden):
        super().__init__()
        self.vocab, self.hidden = vocab, hidden
        self.seen, self.ops = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t = getattr(t, "_local_tensor", t)
                if t.numel() == self.vocab * self.hidden or (
                        t.dim() >= 2 and t.shape[-1] == self.vocab):
                    self.seen.append((str(func), tuple(t.shape)))
        return out


def _vocab_step(payload, key, dims, out_dir, watch=False):
    """One stage-2 step of the payload's model ``key`` on ``dims`` through
    the trainer (under ``_WholeVocabWatch`` when asked): (trainer, state,
    {loss, grad_norm, the whole gradients the step handed the optimizer of
    the embedding and head}, the watch)."""
    from cambrian_tpu_torch.parallel.distributed import put_global_batch

    case = payload[key]
    lm, towers = build_model(case)
    trainer = _trainer(lm, towers, payload, dims, 2, out_dir)
    state, step = trainer.prepare()
    batch = put_global_batch(case["batches"][0], trainer.mesh, "cpu")
    grads = {}
    optimizer_step = state.optimizer.step

    def capture(g):     # the references: gathered after the step, outside the watch
        grads.update({n: t for n, t in g.items()
                      if n.split(".")[0] in ("embed_tokens", "lm_head")})
        return optimizer_step(g)

    state.optimizer.step = capture
    mode = None
    if watch:
        mode = _WholeVocabWatch(lm.cfg.vocab_size, lm.cfg.hidden_size)
        with mode:
            state, metrics = step(state, batch)
    else:
        state, metrics = step(state, batch)
    state.optimizer.step = optimizer_step
    return trainer, state, dict(loss=float(metrics["loss"]),
                                grad_norm=float(metrics["grad_norm"]),
                                grads={n: full(t) for n, t in grads.items()}), mode


def _restored(payload, key, dims, ckpt_root, saved):
    """The checkpoint under ``ckpt_root`` restored under ``dims`` into a
    model of other weights: the names of parameters and optimizer leaves
    that differ from ``saved``, and the embedding's layout there."""
    lm, towers = build_model(payload[key])
    with torch.no_grad():
        for p in lm.parameters():
            p.mul_(0.5)
    trainer = _trainer(lm, towers, payload, dims, 2, ckpt_root)
    state, _ = trainer.prepare()
    step = trainer._restore_checkpoint(state)
    params = {n: full(p) for n, p in lm.named_parameters()}
    optimizer = _optimizer_leaves(state)
    return dict(step=step, layout=_vocab_layout(lm),
                params=[n for n, t in saved["params"].items() if not torch.equal(params[n], t)],
                optimizer=[n for n, t in saved["optimizer"].items()
                           if not torch.equal(optimizer[n], t)],
                n_params=len(params), n_optimizer=len(optimizer))


def vocab_rank(rank, world, payload):
    """The vocab-parallel embedding, head and loss on four ranks: the
    layout on each mesh of the payload (V = 512 and the 515 that does not
    divide); the loss alone on each case's inputs (this rank's rows and
    slab); one stage-2 step on (1,2,2) of the V = 520 model under
    ``_WholeVocabWatch``, saved and restored under (2,2,1); the V = 515
    model's step, saved and restored under (4,1,1); a tied model's step;
    greedy tokens of the sharded engine, a planted tie among them."""
    from torch import nn

    from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine
    from cambrian_tpu_torch.models.cambrian import vocab_parallel_cross_entropy
    from cambrian_tpu_torch.models.config import CambrianConfig
    from cambrian_tpu_torch.parallel.distributed import (
        VocabParallel,
        dp_all_reduce,
        dp_coordinate,
    )
    from cambrian_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from cambrian_tpu_torch.parallel.sharding import shard_model

    out = {"layout": {}, "loss": {}, "serve": {}}
    meshes = {}

    def mesh_of(dims):
        if dims not in meshes:
            meshes[dims] = create_mesh(MeshConfig(*dims), "cpu")
        return meshes[dims]

    for key in ("v512", "v515"):
        for dims in payload["layout_meshes"]:
            lm, towers = build_model(payload[key])
            shard_model(lm, towers, mesh_of(dims))
            out["layout"][(key, dims)] = _vocab_layout(lm)

    for name, case in payload["loss"].items():
        cfg = CambrianConfig.from_dict(case["cfg"])
        mesh = mesh_of(case["mesh"])
        layout = VocabParallel(mesh, cfg.vocab_size)
        head = nn.Parameter(layout.distribute(torch.from_numpy(case["head"])))
        index, size = dp_coordinate(mesh)
        n = case["hidden"].shape[0] // size
        rows = slice(index * n, (index + 1) * n)
        hidden = torch.from_numpy(case["hidden"][rows]).requires_grad_(True)
        loss = vocab_parallel_cross_entropy(cfg, hidden, torch.from_numpy(case["labels"][rows]),
                                            head, layout, case["chunk"],
                                            torch.tensor(case["count"]))
        loss.backward()
        layout.sum_grad(head.grad)
        out["loss"][name] = dict(loss=float(dp_all_reduce(loss.detach().clone(), mesh)),
                                 rows=(rows.start, rows.stop), dhidden=hidden.grad,
                                 start=layout.start, dhead=head.grad._local_tensor.clone())

    root = payload["out_dir"]

    def saved(trainer, state):
        trainer._save_checkpoint(state, step=1)
        return dict(params={n: full(p) for n, p in trainer.model.named_parameters()},
                    optimizer=_optimizer_leaves(state))

    trainer, state, out["step_520"], watch = _vocab_step(
        payload, "v520", (1, 2, 2), os.path.join(root, "v520"), watch=True)
    out["watch"] = dict(seen=watch.seen, ops=watch.ops)
    out["restored_520"] = _restored(payload, "v520", (2, 2, 1), os.path.join(root, "v520"),
                                    saved(trainer, state))
    trainer, state, out["step_515"], _ = _vocab_step(payload, "v515", (1, 2, 2),
                                                     os.path.join(root, "v515"))
    out["restored_515"] = _restored(payload, "v515", (4, 1, 1), os.path.join(root, "v515"),
                                    saved(trainer, state))
    out["step_tied"] = _vocab_step(payload, "vtied", (1, 2, 2), os.path.join(root, "vtied"))[2]

    for name, case in payload["serve"].items():
        lm, towers = build_model(payload[case["model"]])
        engine = GenerationEngine(lm, towers, max_len=64, cache_dtype=torch.float32,
                                  mesh=mesh_of(case["mesh"]))
        ids, mask, pos = case["prompt"]
        gcfg = GenerationConfig(max_new_tokens=case["new_tokens"], temperature=0.0)
        tokens = engine.generate(ids, mask, pos, None, None, gcfg)
        first = engine.last_next_logits.detach().clone()
        stream = None
        for stream in engine.generate_stream(ids, mask, pos, None, None, gcfg):
            pass
        out["serve"][name] = dict(tokens=np.asarray(tokens), stream=np.asarray(stream),
                                  first_logits=first,
                                  rows=engine._local_rows(np.asarray(ids).shape[0]))
    return out

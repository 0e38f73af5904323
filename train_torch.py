"""Co3D training with the PyTorch port on one card, as train.py.

Same config (cfgs/default_train.yaml) and dotted-override CLI:

    python train_torch.py train.CO3D_DIR=... train.CO3D_ANNOTATION_DIR=... \\
        exp_dir=exp/run1
    python train_torch.py ... device=cpu      # the kernels' plain versions

The loop is train.py's: an epoch loop with a sampling-based eval every
``eval_interval`` epochs (not at epoch 0), the dynamic batch sampler (frames
per sequence drawn per batch, padded to a frame bucket, ``max_images``
images a batch), a producer thread that decodes and collates the next
batches while the card trains, ``batch_repeat`` tiling of the diffusion
batch, AdamW with warmup-cosine restarts and clipping at ``clip_grad``,
full-state checkpoints every ``ckpt_interval`` epochs and per-epoch
averages in ``<exp_dir>/stats.jsonl``.

It runs on the card (``device=cuda``, the default) through the train
kernels; ``device=cpu`` runs their plain versions. Weights are drawn from
``seed`` (``init_random_weights``) unless ``train.resume_ckpt`` names a
reference ``.pth`` (strict load) or a checkpoint directory (``True``: the
newest under ``exp_dir``), which restores the model, the optimizer and the
epoch.

Data parallelism, as train.py's ``train.dp``: one process a card, started
by torchrun (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``):

    torchrun --nproc_per_node=4 train_torch.py train.CO3D_DIR=... exp_dir=...

Rank r trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``device=cpu``),
draws its own sequences (the sampler's item seed offset by 1,000 r) in the
batch shapes that every rank shares (one ``shape_seed``), ``max_images`` a
rank, its own loss draws, and its own share of the eval sequences; the
train step sums the gradients over the ranks
(``training/step.train_step(distributed=True)``). Rank 0 alone writes the
checkpoints, ``stats.jsonl`` and the plots.

FSDP, as train.py's ``train.fsdp``: the world is a ``(train.dp,
train.fsdp)`` mesh (``train.dp`` defaults to the world size / train.fsdp;
any other product is refused), and ``train.fsdp`` above 1 shards the
parameters and the optimizer's moments over the mesh's "fsdp" dim
(``parallel/mesh.shard_model``; HSDP with ``train.dp`` above 1):

    torchrun --nproc_per_node=4 train_torch.py train.fsdp=2 train.CO3D_DIR=... exp_dir=...
    torchrun --nproc_per_node=2 train_torch.py device=cpu train.fsdp=2 ...   # gloo

Each rank still draws its own items, so the step is the data-parallel
step's on sharded weights; the eval samples on the gathered model, and
every rank takes part in writing a checkpoint (rank 0 writes the whole
tensors). A frozen extractor is sharded too, and gets no update.
"""

from __future__ import annotations

import os
import queue
import threading
import time


def data_producer(dataset, sampler, out_q, n_batches, stop_event, num_workers=8):
    """Decode and augment a batch's items in a worker pool (PIL releases the
    GIL) and collate them padded to the sampler's frame bucket, off the
    training thread. Exceptions reach the consumer, then the None sentinel."""
    from concurrent.futures import ThreadPoolExecutor

    from posediffusion_tpu_torch.data.sampler import collate_batch

    def put(item) -> bool:
        while not stop_event.is_set():
            try:
                out_q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    it = iter(sampler)
    pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
    try:
        for _ in range(n_batches):
            if stop_event.is_set():
                return
            spec = next(it)
            items = list(pool.map(dataset.__getitem__, spec))
            if not put(collate_batch(items, pad_frames_to=sampler.bucket_for(spec[0][1]))):
                return
        put(None)
    except Exception as e:  # noqa: BLE001 - forwarded to the training thread
        put(e)
        put(None)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _to_device(batch, device):
    import torch

    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def run(cfg) -> dict:
    """Train with a loaded config; returns a summary of the run (losses, the
    last eval metrics, the last checkpoint, the largest parameter change).
    Under torchrun's variables this process is one rank of a data-parallel
    or sharded run (the process group is set up here, and taken down at the
    end)."""
    import torch
    import torch.distributed as dist

    from posediffusion_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from posediffusion_tpu_torch.utils.config import device_from_cfg

    started = not dist.is_initialized() and maybe_initialize_distributed(
        torch.device(device_from_cfg(cfg)).type)
    try:
        return _run(cfg)
    finally:
        if started:
            dist.destroy_process_group()


def _run(cfg) -> dict:
    import numpy as np
    import torch

    from posediffusion_tpu_torch.data.factory import get_co3d_dataset
    from posediffusion_tpu_torch.data.sampler import DynamicBatchSampler, collate_batch
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.training.checkpoints import (
        latest_checkpoint,
        load_reference_checkpoint,
        restore,
        save,
    )
    from posediffusion_tpu_torch.training.optim import EXTRACTOR_PREFIX, make_optimizer
    from posediffusion_tpu_torch.parallel.distributed import local_rank, rank_and_world
    from posediffusion_tpu_torch.parallel.mesh import full, gathered, make_mesh, shard_model
    from posediffusion_tpu_torch.training.stats import StatsLogger
    from posediffusion_tpu_torch.training.step import eval_step, train_step
    from posediffusion_tpu_torch.utils.config import device_from_cfg, model_config_from_cfg
    from posediffusion_tpu_torch.utils.precision import pin_full_float32
    from posediffusion_tpu_torch.utils.seeding import seed_all_random_engines

    t = cfg.train
    rank, world = rank_and_world()
    distributed = torch.distributed.is_initialized()
    fsdp = int(t.get("fsdp") or 1)
    dp = int(t.get("dp") or 0) or world // fsdp
    if dp * fsdp != world:
        raise ValueError(f"train.dp x train.fsdp must be the world size (train.py:120): "
                         f"train.dp={t.get('dp')} (None: the world size / train.fsdp), "
                         f"train.fsdp={fsdp}, but the world size is {world}: one process a card")
    device = torch.device(device_from_cfg(cfg))
    if device.type == "cuda" and distributed:
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    if distributed:
        print(f"distributed: rank {rank} of {world} on {device}")
    pin_full_float32()
    seed_all_random_engines(cfg.seed, process_unique=True)
    is_main = rank == 0

    dataset, eval_dataset = get_co3d_dataset(cfg)
    print(f"train sequences: {len(dataset)}  eval sequences: {len(eval_dataset)}")
    buckets = tuple(t.get("frame_buckets") or (4, 8, 16, 24, 32, 51))
    # each rank draws its own items, all ranks one stream of batch shapes
    # (train.py:124-135); each rank evaluates its own share of the sequences
    sampler = DynamicBatchSampler(
        len(dataset), dataset_len=t.len_train, max_images=t.max_images,
        images_per_seq=tuple(t.images_per_seq), frame_buckets=buckets,
        seed=cfg.seed + 1000 * rank, shape_seed=cfg.seed + 31,
    )
    eval_share = np.arange(len(eval_dataset))[rank::world]
    eval_sampler = DynamicBatchSampler(
        len(eval_dataset), dataset_len=t.len_eval if len(eval_share) else 0,
        max_images=t.max_images // 2, images_per_seq=tuple(t.images_per_seq),
        frame_buckets=buckets, seed=cfg.seed + 1 + 1000 * rank,
        sequence_indices=eval_share if world > 1 else None, shape_seed=cfg.seed + 37,
    )

    config = model_config_from_cfg(cfg.MODEL)
    model = PoseDiffusionModel(config)
    init_random_weights(model, cfg.seed)
    model.to(device)
    if fsdp > 1:
        shard_model(model, make_mesh(world, fsdp, device.type))
        print(f"parameters sharded over a (dp {dp}, fsdp {fsdp}) mesh")
    optimizer, schedule = make_optimizer(
        model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
        clip_grad=t.clip_grad,
        frozen_prefixes=(EXTRACTOR_PREFIX,) if config.freeze_extractor else None,
    )
    if config.freeze_extractor:
        print("extractor frozen: no updates (incl. weight decay) to the backbone")
    gen = torch.Generator().manual_seed(cfg.seed + 1000 * rank)  # the loss's draws
    if t.resume_ckpt:
        resume = str(t.resume_ckpt)
        if resume.endswith(".pth"):
            load_reference_checkpoint(resume, model)
            print(f"Resumed weights from reference ckpt {resume}")
        else:
            path = latest_checkpoint(resume if os.path.isdir(resume) else cfg.exp_dir)
            if path:
                state = restore(path, model, optimizer)
                gen.set_state(state["generators"][rank] if "generators" in state
                              else state["generator"])
                print(f"Resumed full state from {path}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.1f}M on {device}")
    initial = {k: full(v).detach().cpu().clone() for k, v in model.named_parameters()}

    stats = StatsLogger(
        ["loss", "lr", "sec/it", "Auc_30", "Racc_5", "Racc_15", "Racc_30",
         "Tacc_5", "Tacc_15", "Tacc_30"],
        jsonl_path=os.path.join(cfg.exp_dir, "stats.jsonl") if is_main else None,
    )
    eval_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1 + 1000 * rank)
    losses, step_seconds, eval_metrics, ckpt = [], [], None, None
    start_epoch = optimizer.step_count // max(t.len_train, 1)
    for epoch in range(start_epoch, t.epochs):
        stats.new_epoch()
        seed_all_random_engines(cfg.seed + epoch, process_unique=True)

        if epoch != 0 and epoch % t.eval_interval == 0:
            print(f"---------- eval at epoch {epoch} ----------")
            model.eval()
            with gathered(model):  # every rank, whatever its share of the eval
                for bi, spec in enumerate(eval_sampler):
                    items = [eval_dataset[s] for s in spec]
                    batch = _to_device(collate_batch(
                        items, pad_frames_to=eval_sampler.bucket_for(spec[0][1])), device)
                    _, eval_metrics = eval_step(model, batch, generator=eval_gen)
                    stats.update(eval_metrics, stat_set="eval")
                    if bi % t.print_interval == 0:
                        print(stats.status_string("eval", max_it=t.len_eval))

        print(f"---------- train epoch {epoch} ----------")
        model.train()
        q = queue.Queue(maxsize=4)
        stop = threading.Event()
        producer = threading.Thread(
            target=data_producer,
            args=(dataset, sampler, q, t.len_train, stop, t.num_workers), daemon=True,
        )
        producer.start()
        try:
            step_i = 0
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise RuntimeError("data producer failed") from batch
                batch = _to_device(batch, device)
                t0 = time.perf_counter()
                metrics = train_step(model, optimizer, batch, batch_repeat=t.batch_repeat,
                                     generator=gen, distributed=distributed)
                step_seconds.append(time.perf_counter() - t0)
                losses.append(metrics["loss"])
                stats.update(metrics, stat_set="train")
                if step_i % t.print_interval == 0:
                    print(stats.status_string("train", max_it=t.len_train))
                step_i += 1
        finally:
            stop.set()
            producer.join(timeout=10)

        if is_main:
            stats.plot(os.path.join(cfg.exp_dir, "stats.png"))
        if epoch % t.ckpt_interval == 0 or epoch == t.epochs - 1:
            # every rank: a sharded model gathers its state, and each rank's
            # loss draws resume from its own generator
            gens = [gen.get_state()]
            if distributed:
                gens = [None] * world
                torch.distributed.all_gather_object(gens, gen.get_state())
            extra = {"generator": gens[0], **({"generators": gens} if distributed else {})}
            ckpt = save(cfg.exp_dir, model, optimizer, optimizer.step_count, extra=extra,
                        write=is_main)
            if is_main:
                print(f"saved checkpoint {ckpt}")

    stats.flush()
    if is_main:
        stats.plot(os.path.join(cfg.exp_dir, "stats.png"))
    change = max(float((full(p).detach().cpu() - initial[k]).abs().max())
                 for k, p in model.named_parameters())
    return {"losses": losses, "step_seconds": step_seconds, "steps": optimizer.step_count,
            "eval": eval_metrics, "checkpoint": ckpt, "param_change": change,
            "finite": bool(np.isfinite(losses).all()) if losses else False,
            "rank": rank, "world_size": world, "mesh": {"dp": dp, "fsdp": fsdp},
            "device": str(device),
            "backend": torch.distributed.get_backend() if distributed else None}


def main(argv=None):
    from posediffusion_tpu_torch.utils.config import cli_config

    cfg = cli_config("default_train", argv)
    print("Model Config:")
    print(cfg.to_yaml())
    return run(cfg)


if __name__ == "__main__":
    main()

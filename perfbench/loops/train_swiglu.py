"""The loop of ``train_swiglu`` traffic: ``train`` traffic's closed loop of
the program's train step (``loops/train.py``) on a configuration whose
backbone has DINOv2's SwiGLU feed-forward (``pd-dinov2-vitg14``), judged
against ``reference/vit_swiglu.py``.

The program's side (``program_config``, ``load_weights``, the window) is
``loops/train.py``'s, taken by import; what names the reference is this
file's own: the parameters' specs, the judged steps' inputs and the
reference's steps. Set-up builds the model before the kernel library, so a
program without the backbone fails at once, before any build.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from perfbench import compare, generate
from perfbench.loops.train import CHECK_STEPS, GIB, load_weights, program_config
from perfbench.reference import vit_swiglu as ref_model

reference_steps = ref_model.reference_steps  # the name calibrate_loop.py takes from a loop


def build(config: dict, seed: int, device):
    """The program's model with the seed's weights, and its optimizer, as
    ``train_torch.run`` makes them. The model is built on ``device``: its
    1.15B initial values, which the seed's weights overwrite, are drawn
    there rather than on the host."""
    from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionModel
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    pin_full_float32()
    with torch.device(device):
        model = PoseDiffusionModel(program_config(config))
    model.to(device)  # what a module makes from host arrays
    load_weights(model, generate.weights(ref_model.param_specs(config), seed,
                                         config["init"]["std"], device))
    o = config["optimizer"]
    optimizer, _ = make_optimizer(model, lr=o["lr"], T_0=o["restart_num"],
                                  iters_per_epoch=o["len_train"], clip_grad=o["clip_grad"],
                                  weight_decay=o["weight_decay"],
                                  warmup_ratio=o["warmup_ratio"])
    model.train()
    return model, optimizer


def first_steps(config: dict, traffic: dict, seed: int, dev):
    """``loops/train.first_steps`` with this file's ``build``, the model
    first: (model, optimizer, ring, what the check reads)."""
    from posediffusion_tpu_torch.training import step as program

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    phases, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    model, optimizer = build(config, seed, dev)
    lap("model_and_weights_s")
    if dev.type == "cuda":  # what the first kernel call would do: build or load the library
        from posediffusion_tpu_torch.ops import kernels

        kernels.load_library()
    lap("kernel_library_s")
    ring = generate.train_batches(traffic, config, seed, dev)
    lap("inputs_s")
    names = [n for n, _ in model.named_parameters()]
    b1 = config["optimizer"]["betas"][0]
    losses, first_grads = [], None
    for k in range(CHECK_STEPS):
        m = program.train_step(model, optimizer, ring[k % len(ring)],
                               batch_repeat=traffic["batch_repeat"],
                               draws=generate.train_draws(traffic, config, seed, k))
        losses.append(m["loss"])
        if k == 0:  # the checkpoint's moments, in the order of model.parameters()
            mu = optimizer.state_dict()["mu"]
            first_grads = {n: (m / (1 - b1)).norm().item() for n, m in zip(names, mu)}
            del mu
    after = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    lap("first_steps_s")
    return model, optimizer, ring, {"losses": losses, "first_grads": first_grads,
                                    "after": after, "phases": phases}


def run(config: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        tracer, t0: float, device="cuda") -> dict:
    """``loops/train.run`` on this file's set-up and judge."""
    from posediffusion_tpu_torch.training import step as program

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    before_loop = time.perf_counter() - t0  # interpreter, imports, manifest
    model, optimizer, ring, judged = first_steps(config, traffic, seed, dev)
    sync()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    steps = failed = 0
    k = CHECK_STEPS
    with tracer:
        with tracer.window():
            start = time.perf_counter()
            while True:
                with tracer.span("perfbench.draws"):
                    draws = generate.train_draws(traffic, config, seed, k)
                with tracer.span("perfbench.train_step"):
                    m = program.train_step(model, optimizer, ring[k % len(ring)],
                                           batch_repeat=traffic["batch_repeat"], draws=draws)
                steps += 1
                k += 1
                failed += int(not math.isfinite(m["loss"]))
                if time.perf_counter() - start >= seconds:
                    break
            sync()
            window_s = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = tracer.reduce()

    del model, optimizer, ring, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref, numbers = judge(config, traffic, seed, dev, judged)
    return {
        "attempted": steps, "failed": failed,
        "end_to_end": {"setup_s": setup_s, "train_step_ms": window_s / steps * 1e3,
                       "train_peak_gib": window_peak / GIB},
        "numbers": numbers, "limits": limits,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "setup_phases": dict(imports_s=before_loop, **judged["phases"]),
        "worst_leaves": ref["worst_leaves"],
        "context": {"config": config, "traffic": traffic, "steps": steps,
                    "window_s": window_s, "trace": trace},
    }


def judge(config: dict, traffic: dict, seed: int, dev, judged: dict):
    """The reference's first steps from the same inputs, and the numbers
    (``compare.train_numbers``) that compare the program's with them:
    (reference, numbers)."""
    w0, batches, draws = reference_inputs(config, traffic, seed, dev)
    ref = reference_steps(config, traffic, w0, batches, draws)
    change = {n: float((judged["after"][n].to(dev) - w0[n]).norm()) for n in w0}
    leaves = {}
    numbers = compare.train_numbers(judged["losses"], judged["first_grads"], change, ref, leaves)
    return dict(ref, worst_leaves=leaves), numbers


def reference_inputs(config: dict, traffic: dict, seed: int, dev):
    """(weights, batches, draws) of the judged steps, made again from the seed."""
    return (generate.weights(ref_model.param_specs(config), seed, config["init"]["std"], dev),
            generate.train_batches(traffic, config, seed, dev, count=CHECK_STEPS),
            [generate.train_draws(traffic, config, seed, k) for k in range(CHECK_STEPS)])

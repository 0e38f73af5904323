"""The loop of ``train`` traffic: the program's train step in a closed
loop, one step after another on a ring of batches resident on the card, as
``train_torch.run`` calls it.

Set-up builds the model from the configuration, fills its weights from the
seed, makes the optimizer as ``train_torch.run`` does, and runs the steps
that the check judges (``CHECK_STEPS``) through the window's own call on the
ring's first batches, which also warms every shape of the window. The
window then times the steps that follow until ``seconds`` have passed.
After it, with the program's state freed, the reference runs the same
first steps from the same weights, batches and draws, and the comparison
(``compare.train_numbers``) decides ``correct``.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from perfbench import compare, generate
from perfbench.reference import pose_diffusion as ref_model
from perfbench.reference.train import reference_steps

CHECK_STEPS = 3
GIB = 2**30


def program_config(config: dict):
    """The port's model configuration for a benchmark configuration."""
    from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionConfig

    ex, dn, d = config["extractor"], config["denoiser"], config["diffusion"]
    precision = config["precision"]
    return PoseDiffusionConfig(
        pose_encoding_type=d["pose_encoding_type"], target_dim=dn["target_dim"],
        modelname=ex["modelname"], z_dim=ex["embed_dim"], d_model=dn["d_model"],
        nhead=dn["nhead"], num_encoder_layers=dn["num_encoder_layers"],
        dim_feedforward=dn["dim_feedforward"], dropout=dn["dropout"],
        mlp_hidden_dim=dn["mlp_hidden_dim"], pivot_cam_onehot=dn["pivot_cam_onehot"],
        vit_depth=ex["depth"], vit_heads=ex["num_heads"], patch_size=ex["patch_size"],
        scale_factors=tuple(ex["scale_factors"]), timesteps=d["timesteps"],
        beta_1=d["beta_1"], beta_T=d["beta_T"], beta_schedule=d["beta_schedule"],
        objective=d["objective"], loss_type=d["loss_type"],
        compute_dtype=precision, denoiser_dtype=precision,
    )


@torch.no_grad()
def load_weights(model, weights: dict) -> None:
    """Copy the benchmark's weights into the program's parameters by name;
    every name and shape has to match."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters differ from the configuration's: program only "
                         f"{sorted(set(params) - set(weights))[:5]}, configuration only "
                         f"{sorted(set(weights) - set(params))[:5]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, configuration "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


def build(config: dict, seed: int, device):
    """The program's model with the seed's weights, and its optimizer, as
    ``train_torch.run`` makes them."""
    from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionModel
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    pin_full_float32()
    model = PoseDiffusionModel(program_config(config)).to(device)
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
    """Set-up: the model, its optimizer and the ring, then the judged steps
    through the window's own call (they warm it up too). Returns (model,
    optimizer, ring, what the check reads: the steps' losses, the first
    gradient's norm of each leaf as the optimizer took it, from the first
    moment of its ``state_dict`` (the checkpoint's layout) and the
    configuration's beta1, and the parameters after the steps, on the
    host)."""
    from posediffusion_tpu_torch.training import step as program

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    phases, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    if dev.type == "cuda":  # what the first kernel call would do: build or load the library
        from posediffusion_tpu_torch.ops import kernels

        kernels.load_library()
    lap("kernel_library_s")
    model, optimizer = build(config, seed, dev)
    lap("model_and_weights_s")
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
    """The reference's first steps from the same inputs, and the numbers that
    compare the program's (``first_steps``' losses, first gradients' norms
    and parameters after the steps) with them: (reference, numbers)."""
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

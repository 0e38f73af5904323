"""One whole GGS SGD phase per kernel launch, as
``posediffusion_tpu.ops.ggs_kernel``.

``ggs_phase_fused`` runs a phase (100 or 200 iterations of Sampson loss and
closed-form gradient, adaptive clip, torch-SGD momentum, sticky stop when the
contributing matches per frame fall below ``min_matches``) as one launch of
``csrc/ggs.cu``'s one-block kernel; ``ggs_phase_fused_chunked`` as one
cooperative launch whose blocks each own a chunk of pairs and sum their
unnormalised gradients every iteration. On CPU tensors both take their plain
versions beside them (``ops/kernels.py``: a Python loop over
``ops/ggs_grad.loss_and_grad_core`` with the same clip, momentum and stop).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from posediffusion_tpu_torch.ops.ggs_grad import (
    GroupedMatches,
    ggs_tables,
    pad_grouped_pairs,
)
from posediffusion_tpu_torch.ops.kernels import KERNELS, PLAIN

# Pairs per block of the chunked kernel: one per warp of its 4, so 190 pairs
# (20 frames) run as 48 blocks, all resident at once on 132 SMs.
CHUNK_PAIRS = 4


def default_chunk_pairs(n_pairs: int) -> int:
    return min(CHUNK_PAIRS, n_pairs)


def _phase(ops, x, gm, image_hw, update_R, update_T, update_FL, sampson_max,
           iters, lr, momentum, alpha, min_matches):
    return ops.ggs_phase(x.contiguous(), ggs_tables(gm), image_hw, update_R,
                         update_T, update_FL, sampson_max, iters, lr, momentum,
                         alpha, min_matches)


def _chunked(ops, x, gm, image_hw, update_R, update_T, update_FL, sampson_max,
             iters, lr, momentum, alpha, min_matches, chunk_pairs):
    chunk = chunk_pairs or default_chunk_pairs(gm.valid.shape[0])
    return ops.ggs_phase_chunked(
        x.contiguous(), ggs_tables(pad_grouped_pairs(gm, chunk)), image_hw,
        update_R, update_T, update_FL, sampson_max, iters, lr, momentum, alpha,
        min_matches, chunk)


def ggs_phase_fused(x: torch.Tensor, gm: GroupedMatches, image_hw: Tuple[int, int],
                    update_R: bool, update_T: bool, update_FL: bool,
                    sampson_max: float, iters: int, lr: float, momentum: float,
                    alpha: float, min_matches: float) -> torch.Tensor:
    """x (N, 9) after one phase; the kernel on a CUDA tensor."""
    return _phase(KERNELS, x, gm, image_hw, update_R, update_T, update_FL,
                  sampson_max, iters, lr, momentum, alpha, min_matches)


def ggs_phase_fused_plain(x: torch.Tensor, gm: GroupedMatches,
                          image_hw: Tuple[int, int], update_R: bool,
                          update_T: bool, update_FL: bool, sampson_max: float,
                          iters: int, lr: float, momentum: float, alpha: float,
                          min_matches: float) -> torch.Tensor:
    """The same phase in plain PyTorch on any device."""
    return _phase(PLAIN, x, gm, image_hw, update_R, update_T, update_FL,
                  sampson_max, iters, lr, momentum, alpha, min_matches)


def ggs_phase_fused_chunked(x: torch.Tensor, gm: GroupedMatches,
                            image_hw: Tuple[int, int], update_R: bool,
                            update_T: bool, update_FL: bool, sampson_max: float,
                            iters: int, lr: float, momentum: float, alpha: float,
                            min_matches: float,
                            chunk_pairs: Optional[int] = None) -> torch.Tensor:
    """The phase with the pair axis padded to chunks of ``chunk_pairs``
    (default: ``default_chunk_pairs``); the kernel on a CUDA tensor."""
    return _chunked(KERNELS, x, gm, image_hw, update_R, update_T, update_FL,
                    sampson_max, iters, lr, momentum, alpha, min_matches,
                    chunk_pairs)


def ggs_phase_fused_chunked_plain(x: torch.Tensor, gm: GroupedMatches,
                                  image_hw: Tuple[int, int], update_R: bool,
                                  update_T: bool, update_FL: bool,
                                  sampson_max: float, iters: int, lr: float,
                                  momentum: float, alpha: float,
                                  min_matches: float,
                                  chunk_pairs: Optional[int] = None) -> torch.Tensor:
    """The chunked phase in plain PyTorch on any device."""
    return _chunked(PLAIN, x, gm, image_hw, update_R, update_T, update_FL,
                    sampson_max, iters, lr, momentum, alpha, min_matches,
                    chunk_pairs)

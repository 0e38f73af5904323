"""One whole GGS SGD phase per kernel launch, as
``posediffusion_tpu.ops.ggs_kernel``.

``ggs_phase_fused`` runs a phase (100 or 200 iterations of Sampson loss and
closed-form gradient, adaptive clip, torch-SGD momentum, sticky stop when the
contributing matches per frame fall below ``min_matches``) as one launch of
``csrc/ggs.cu``'s kernel as one block; ``ggs_phase_fused_chunked`` as one
launch of a thread-block cluster whose blocks each own a chunk of pairs and
exchange their pairs' unnormalised gradients through distributed shared
memory every iteration. On CPU tensors both take their plain
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
from posediffusion_tpu_torch.ops.kernels import (
    GGS_CLUSTERS,
    KERNELS,
    PLAIN,
    ggs_cluster_size,
)


def default_chunk_pairs(gm: GroupedMatches) -> int:
    """Pairs a block of the chunked kernel owns: the P pairs split over the
    largest cluster the card schedules (``kernels.ggs_cluster_size``), over
    ``GGS_CLUSTERS[0]`` = 16 blocks off the card. 20 frames: 190 pairs, 12 a
    block, a warp each."""
    P, Q = gm.valid.shape
    cluster = (ggs_cluster_size(gm.B1.shape[1], P, Q) if gm.valid.is_cuda
               else GGS_CLUSTERS[0])
    return -(-P // cluster)


def _phase(ops, x, gm, image_hw, update_R, update_T, update_FL, sampson_max,
           iters, lr, momentum, alpha, min_matches):
    return ops.ggs_phase(x.contiguous(), ggs_tables(gm), image_hw, update_R,
                         update_T, update_FL, sampson_max, iters, lr, momentum,
                         alpha, min_matches)


def _chunked(ops, x, gm, image_hw, update_R, update_T, update_FL, sampson_max,
             iters, lr, momentum, alpha, min_matches, chunk_pairs):
    chunk = chunk_pairs or default_chunk_pairs(gm)
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

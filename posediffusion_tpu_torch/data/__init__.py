"""Co3D and RealEstate10K data pipelines: the port's own copies of the JAX
package's numpy modules (images, camera helpers, augmentation, the Co3D and
RealEstate10K readers, the dynamic batch sampler and collation).
"""

from posediffusion_tpu_torch.data.re10k import Re10KDataset

__all__ = ["Re10KDataset"]

"""Co3D data pipeline: the port's own copies of the JAX package's numpy modules
(images, camera helpers, augmentation, the Co3D reader, the dynamic batch
sampler and collation).
"""

"""Data parallelism over processes (``torch.distributed``), as
``posediffusion_tpu.parallel``'s data-parallel part."""

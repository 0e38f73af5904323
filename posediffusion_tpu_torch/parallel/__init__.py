"""Data parallelism over processes (``torch.distributed``) and parameter
sharding (FSDP) over a ("dp", "fsdp") mesh, as ``posediffusion_tpu.parallel``."""

"""Match extraction for GGS: SuperPoint, SuperGlue (on the CUDA kernels on a
card), native RANSAC verification. See ``extract.extract_match``."""

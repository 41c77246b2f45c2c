"""Hand-written CUDA kernels: the availability scan (``availscan``, its
plain PyTorch versions in ``ref``) and the fused causal attention
(``flash``, its plain version ``flash.attention_ref``), with their launch
wrappers."""

"""Attention ops: the dense core, the paged-KV helpers, the paged
attention kernels and the flash-attention forward and backward kernels,
each with its plain PyTorch version."""

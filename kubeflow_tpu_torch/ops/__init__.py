"""Attention ops: the dense core, the paged-KV helpers, and the paged
attention kernels with their plain PyTorch versions."""

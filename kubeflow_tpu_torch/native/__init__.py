"""Build and load the port's hand-written CUDA kernels and the repo's C++
shard reader."""

"""kubeflow_tpu_torch — the PyTorch/CUDA port of kubeflow_tpu, for an
NVIDIA H100.

The package mirrors the JAX package's module paths (serving/engine.py
ports kubeflow_tpu/serving/engine.py, and so on) and imports nothing of
it: the modules it needs from there are copied here. Every TPU kernel on
a ported path is a hand-written Hopper kernel under `ops/csrc/`, built
with nvcc at first use (`native/build.py`); on CPU tensors each kernel
wrapper runs its plain PyTorch version instead.
"""

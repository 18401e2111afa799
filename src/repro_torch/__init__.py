"""QPART on PyTorch for NVIDIA Hopper — the port of ``repro``.

Same subpackage layout and public names as the JAX package; every
entry point takes an explicit ``device`` and runs on ``cuda`` unless the
caller asks for the CPU. Kernels are hand-written CUDA C++ for
``sm_90a`` (``csrc/``), built at first use by ``kernels.build``; a CPU
tensor runs each kernel's plain PyTorch version instead.
"""

"""PlasticineLab on PyTorch and CUDA: differentiable-MPM soft-body
manipulation tasks, ported from the TPU package `plasticinelab_tpu`.

This slice runs the forward env path (`envs.make` -> `reset` -> `step`)
through hand-written CUDA kernels for Hopper (`csrc/`), with a plain PyTorch
version of each kernel used on the CPU.
"""

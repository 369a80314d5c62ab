"""The port's kernels: four hand-written CUDA kernels (``csrc/``), each with
its plain PyTorch version beside its wrapper, and the device dispatch over
them (``ops``)."""

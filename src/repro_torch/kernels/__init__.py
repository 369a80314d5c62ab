"""The port's kernels: eight hand-written CUDA kernels in seven sources
(``csrc/``), each with its plain PyTorch version beside its wrapper, and the
device dispatch over them (``ops``)."""

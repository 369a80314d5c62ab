"""repro_torch: DiFuseR on an NVIDIA H100, in PyTorch and CUDA.

A port of the ``repro`` package (JAX and Pallas on a TPU), which stays the
reference the port is held against. This package imports torch and numpy,
never jax and nothing of ``repro``.

Layout (module names follow ``repro``):

* ``graphs``    numpy graph container, generators, SNAP loader;
* ``diffusion`` the model zoo (wc, ic, lt, dic) lowering to edge operands;
* ``core``      sampling, FASST, sketch state, fixpoints, selection, Alg. 4
                driver;
* ``partition`` planners, the 2-D bucket builder, the serial-ring executor;
* ``kernels``   hand-written CUDA kernels with their plain versions, and the
                device dispatch over them;
* ``runtime``   ``RunSpec``, the ``single`` and ``serial`` backends, ``run``;
* ``launch``    ``python -m repro_torch im``.

Entry points run on CUDA unless ``device="cpu"`` is passed.
"""

#: the modules of the supported API surface, the reference's list
IM_API_MODULES = (
    "repro_torch.obs",
    "repro_torch.runtime",
    "repro_torch.core",
    "repro_torch.diffusion",
    "repro_torch.partition",
    "repro_torch.service",
    "repro_torch.tune",
    "repro_torch.graphs",
    "repro_torch.baselines",
    "repro_torch.configs",
    "repro_torch.launch.common",
)

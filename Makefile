# One entry point for the repo's verify/bench/lint loops.
#
#   make test           tier-1 suite (the ROADMAP verify command)
#   make test-property  hypothesis property suite (needs requirements-dev.txt)
#   make bench-smoke    fast benchmark pass (small graphs, CI-sized) +
#                       model-zoo smoke (every registered diffusion model)
#   make smoke-torch    the port's model-zoo smoke and its three examples, on
#                       the card (each script takes --device cpu on its own)
#   make lint           syntax + import sanity over src/tests/benchmarks/scripts
#                       and the port's examples_torch/scripts_torch

PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))
export PYTHONPATH

.PHONY: test test-property bench-smoke smoke-torch lint

test:
	python -m pytest -x -q

test-property:
	python -m pytest -q tests/test_property.py

bench-smoke:
	python scripts/check_models.py
	python -m benchmarks.run --fast

smoke-torch:
	python scripts_torch/check_models.py
	python examples_torch/quickstart.py
	python examples_torch/influence_service.py
	python examples_torch/distributed_im.py

# lint's import check covers the IM API surface (repro.IM_API_MODULES and
# friends). The LM seed-template modules were deleted in PR 5; everything
# left is importable API.
lint:
	python -m compileall -q src tests benchmarks examples scripts examples_torch scripts_torch
	python -c "import importlib; [importlib.import_module(m) for m in ('repro', 'repro.obs', 'repro.obs.trace', 'repro.obs.metrics', 'repro.obs.shardprof', 'repro.obs.slo', 'repro.obs.flight', 'repro.obs.report', 'repro.runtime', 'repro.runtime.session', 'repro.core.difuser', 'repro.diffusion', 'repro.diffusion.models', 'repro.partition', 'repro.partition.serial', 'repro.service', 'repro.service.engine', 'repro.kernels.fused_sweep', 'repro.tune', 'repro.tune.config', 'repro.tune.cache', 'repro.tune.autotuner', 'repro.configs', 'repro.launch.common', 'repro.launch.serve_im', 'repro.__main__', 'benchmarks.model_zoo', 'benchmarks.partition_balance', 'benchmarks.runtime_bench', 'benchmarks.trend')]; print('imports ok')"

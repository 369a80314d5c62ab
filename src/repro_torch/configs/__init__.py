"""Workload presets of the port's IM launchers (``difuser_workloads``)."""
from repro_torch.configs.difuser_workloads import PRESETS, IMWorkload

__all__ = ["PRESETS", "IMWorkload"]

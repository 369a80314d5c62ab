"""DiFuseR's workload presets (the paper's §5 experiments), the port's own
copy of the reference's ``configs/difuser_workloads.py``, field for field.

The presets mirror the paper's graph and degree regimes at sizes the host
oracle can referee. ``graph`` is a ``--graph`` spec of ``python -m
repro_torch im``; ``model`` a diffusion model (wc | ic[:p] | lt |
dic[:lambda]), one ``zoo-*`` preset each; ``partition`` the vertex
assignment of the 2-D partition (block | degree | edge | random), with the
``balance-*`` presets on the skewed R-MAT regime the planners exist for.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class IMWorkload:
    name: str
    graph: str          # --graph spec
    setting: str        # the paper's influence setting (edge-weight generator)
    k: int = 50
    registers: int = 1024
    model: str = "wc"   # diffusion model spec
    partition: str = "block"  # vertex-assignment strategy


PRESETS = {
    # the paper's Table 3/4 regimes, at container scale
    "livejournal-like": IMWorkload("livejournal-like", "rmat:13", "0.1"),
    "orkut-like": IMWorkload("orkut-like", "ba:4096", "0.01"),
    "youtube-like": IMWorkload("youtube-like", "er:8192", "0.005"),
    "mixed-n005": IMWorkload("mixed-n005", "rmat:12", "N0.05"),
    "mixed-u01": IMWorkload("mixed-u01", "rmat:12", "U0.1"),
    # one workload per diffusion model, on one topology
    "zoo-ic": IMWorkload("zoo-ic", "rmat:11", "0.1", k=16, registers=512,
                         model="ic:0.1"),
    "zoo-wc": IMWorkload("zoo-wc", "rmat:11", "0.1", k=16, registers=512,
                         model="wc"),
    "zoo-lt": IMWorkload("zoo-lt", "rmat:11", "0.1", k=16, registers=512,
                         model="lt"),
    "zoo-dic": IMWorkload("zoo-dic", "rmat:11", "0.1", k=16, registers=512,
                          model="dic:1.0"),
    # skewed Kronecker ids, hubs clustered at low ids: block assignment
    # straggles there and the planners pay off
    "balance-degree": IMWorkload("balance-degree", "rmat-skew:11", "0.1",
                                 k=16, registers=512, partition="degree"),
    "balance-edge": IMWorkload("balance-edge", "rmat-skew:11", "0.1",
                               k=16, registers=512, partition="edge"),
}

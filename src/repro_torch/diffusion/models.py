"""Diffusion model zoo: hash-fused samplers (ic / wc / lt / dic).

Each model is host preprocessing in numpy (``edge_params``, copied from the
reference package's ``diffusion/models.py`` so that both packages produce
byte-identical ``(h, lo, thr)`` operands) plus its ``predicate``, the numpy
function of ``core.sampling`` the device evaluates, named there by
``variant``:

* ``fused_predicate``, ``INTERVAL`` (wc, ic, dic): ``((X_r ^ h_e) - lo_e) <
  thr_e``;
* ``remix_interval_predicate``, ``REMIX`` (lt): ``(mix32(X_r ^ h_v) - lo_e)
  < thr_e``.

``register_model(name, factory)`` adds a family, as in the reference, and
``resolve`` caches one instance per spec. One thing the port cannot take
where the reference does: the CUDA kernels compile the two predicates in, so
a registered model's ``predicate`` must be one of these two functions;
``resolve`` refuses any other, naming them.

Each model also carries the Monte-Carlo hooks of the reference's zoo
(``live_edge_probability``, ``mc_sampler``: numpy draws for the oracle of
``baselines.mc_oracle``) and ``context_free_edges``, whether an edge's
activation law depends on that edge alone. That flag is the soundness
condition of both fast paths of ``service.delta``: it is False for lt, whose
in-edges share one interval partition, so every delta there rebuilds.

The CUDA kernels take the variant as a template parameter; the plain
PyTorch versions look the predicate up in ``core.sampling.PREDICATES``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core.sampling import (INTERVAL, REMIX, edge_hash, fused_predicate,
                                       remix_interval_predicate, vertex_hash,
                                       weight_to_threshold)
from repro_torch.diffusion.constants import DEFAULT_MODEL  # noqa: F401
from repro_torch.graphs.structs import Graph

_DELAY_SALT = 0x5D1C0FFE   # dic latency hash salt (independent of sampling)
_TWO32 = 4294967296.0
_U32_MAX = np.uint64(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class EdgeParams:
    """Per-edge predicate operands (numpy uint32, in the graph's edge order;
    padding edges have thr = 0 and never fire)."""

    h: np.ndarray
    lo: np.ndarray
    thr: np.ndarray


def _real_edge_mask(g: Graph) -> np.ndarray:
    mask = np.zeros(g.m, dtype=bool)
    mask[: g.m_real] = True
    return mask


#: the predicates the kernels compile in, by their variant number
VARIANTS = {fused_predicate: INTERVAL, remix_interval_predicate: REMIX}


class DiffusionModel:
    """A stateless model: host preprocessing plus its predicate (one of
    ``VARIANTS``), whose kernel variant is ``variant``."""

    name: str = ""
    spec: str = ""
    predicate = staticmethod(fused_predicate)
    context_free_edges: bool = True

    @property
    def variant(self) -> int:
        """The kernels' compile-time variant of ``predicate``."""
        return VARIANTS[self.predicate]

    def edge_params(self, g: Graph, *, seed: int = 0) -> EdgeParams:
        raise NotImplementedError

    def live_edge_probability(self, g: Graph) -> np.ndarray:
        """float64[m] independent live probability of each edge."""
        raise NotImplementedError

    def mc_sampler(self, g: Graph) -> Callable[[np.random.Generator], np.ndarray]:
        """A closure drawing one bool[m] live-edge sample in the graph's edge
        order from a numpy generator (the model's host state made once)."""
        p = self.live_edge_probability(g)
        return lambda rng: rng.random(g.m) < p

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.spec!r})"


class WeightedCascade(DiffusionModel):
    """``wc``: thresholds straight from the graph's weights, lo = 0."""

    name = "wc"

    def __init__(self, spec: str = "wc"):
        self.spec = spec

    def edge_params(self, g: Graph, *, seed: int = 0) -> EdgeParams:
        return EdgeParams(h=edge_hash(g.src, g.dst, seed=seed),
                          lo=np.zeros(g.m, dtype=np.uint32),
                          thr=weight_to_threshold(g.weight))

    def live_edge_probability(self, g: Graph) -> np.ndarray:
        p = np.asarray(g.weight, dtype=np.float64).copy()
        p[g.m_real:] = 0.0
        return p


class UniformIC(DiffusionModel):
    """``ic[:p]``: one probability p (default 0.1) on every real edge."""

    name = "ic"

    def __init__(self, spec: str = "ic", p: float = 0.1):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"ic probability must be in [0, 1], got {p}")
        self.spec = spec
        self.p = float(p)

    def edge_params(self, g: Graph, *, seed: int = 0) -> EdgeParams:
        w = np.where(_real_edge_mask(g), np.float32(self.p), np.float32(0.0))
        return EdgeParams(h=edge_hash(g.src, g.dst, seed=seed),
                          lo=np.zeros(g.m, dtype=np.uint32),
                          thr=weight_to_threshold(w))

    def live_edge_probability(self, g: Graph) -> np.ndarray:
        return np.where(_real_edge_mask(g), self.p, 0.0)


class DecayingIC(DiffusionModel):
    """``dic[:lambda]``: IC whose probability decays with a deterministic,
    hash-derived per-edge latency d in [0, 1): w_eff = w * exp(-lambda d)."""

    name = "dic"

    def __init__(self, spec: str = "dic", decay: float = 1.0):
        if decay < 0.0:
            raise ValueError(f"dic decay must be >= 0, got {decay}")
        self.spec = spec
        self.decay = float(decay)

    def edge_delay(self, g: Graph) -> np.ndarray:
        """float64[m]: each edge's deterministic latency in [0, 1), from a
        salted edge hash (an edge attribute, not sampling randomness)."""
        return edge_hash(g.src, g.dst, seed=_DELAY_SALT).astype(np.float64) / _TWO32

    def live_edge_probability(self, g: Graph) -> np.ndarray:
        w = np.asarray(g.weight, dtype=np.float64).copy()
        w[g.m_real:] = 0.0
        return w * np.exp(-self.decay * self.edge_delay(g))

    def edge_params(self, g: Graph, *, seed: int = 0) -> EdgeParams:
        w_eff = self.live_edge_probability(g).astype(np.float32)
        return EdgeParams(h=edge_hash(g.src, g.dst, seed=seed),
                          lo=np.zeros(g.m, dtype=np.uint32),
                          thr=weight_to_threshold(w_eff))


class LinearThreshold(DiffusionModel):
    """``lt``: Linear Threshold by live-edge sampling. Each vertex v splits
    [0, 2^32) into consecutive intervals of width b_uv 2^32 over its
    in-edges (b_uv = w_uv / max(1, sum of in-weights)); the per-(v, sample)
    uniform ``mix32(X_r ^ vertex_hash(v))`` lands in at most one of them."""

    name = "lt"
    predicate = staticmethod(remix_interval_predicate)
    context_free_edges = False

    def __init__(self, spec: str = "lt"):
        self.spec = spec

    def _interval_fractions(self, g: Graph) -> Tuple[np.ndarray, np.ndarray]:
        w = np.clip(np.asarray(g.weight, dtype=np.float64), 0.0, 1.0)
        w[g.m_real:] = 0.0
        dst = g.dst.astype(np.int64)
        total_in = np.zeros(g.n_pad, dtype=np.float64)
        np.add.at(total_in, dst, w)
        b = w / np.maximum(total_in, 1.0)[dst]
        order = np.argsort(dst, kind="stable")
        b_s = b[order]
        cum_hi = np.cumsum(b_s)
        cum_lo = cum_hi - b_s
        dst_s = dst[order]
        run_start = np.concatenate([[True], dst_s[1:] != dst_s[:-1]])
        base = np.maximum.accumulate(np.where(run_start, cum_lo, -np.inf))
        lo = np.empty_like(cum_lo)
        hi = np.empty_like(cum_hi)
        lo[order] = cum_lo - base
        hi[order] = cum_hi - base
        return lo, hi

    def edge_params(self, g: Graph, *, seed: int = 0) -> EdgeParams:
        lo_f, hi_f = self._interval_fractions(g)
        lo_u64 = np.minimum(np.round(lo_f * _TWO32), np.float64(_TWO32)).astype(np.uint64)
        hi_u64 = np.minimum(np.round(hi_f * _TWO32), np.float64(_TWO32)).astype(np.uint64)
        width = np.minimum(hi_u64 - lo_u64, _U32_MAX)
        lo = np.minimum(lo_u64, _U32_MAX).astype(np.uint32)
        return EdgeParams(h=vertex_hash(g.dst, seed=seed), lo=lo,
                          thr=width.astype(np.uint32))

    def mc_sampler(self, g: Graph) -> Callable[[np.random.Generator], np.ndarray]:
        """One uniform per vertex and draw; an edge is live where its
        destination's uniform lands in the edge's interval."""
        lo_f, hi_f = self._interval_fractions(g)
        dst = g.dst.astype(np.int64)

        def sample(rng: np.random.Generator) -> np.ndarray:
            t = rng.random(g.n_pad)[dst]
            return (lo_f <= t) & (t < hi_f)

        return sample


def _float_param(param, default: float, what: str) -> float:
    if param is None:
        return default
    try:
        return float(param)
    except ValueError as e:
        raise ValueError(f"bad {what} parameter {param!r}") from e


def _no_param(cls):
    def make(spec, param):
        if param is not None:
            raise ValueError(f"diffusion model {cls.name!r} takes no parameter, "
                             f"got {param!r}")
        return cls(spec)
    return make


#: name -> factory(spec, param or None), in registration order
_REGISTRY: Dict[str, Callable[[str, str], DiffusionModel]] = {}
#: spec -> its instance (models are stateless)
_RESOLVED: Dict[str, DiffusionModel] = {}


def register_model(name: str, factory: Callable[[str, str], DiffusionModel]) -> None:
    """Register a model family under ``name``: ``factory(spec, param)`` gets
    the whole spec and its ``:<param>`` suffix (None where absent) and
    returns an instance, whose ``predicate`` must be one of ``VARIANTS``."""
    if name in _REGISTRY:
        raise ValueError(f"diffusion model {name!r} already registered")
    _REGISTRY[name] = factory
    _RESOLVED.clear()


def available_models() -> Tuple[str, ...]:
    """The registered families' names, in registration order."""
    return tuple(_REGISTRY)


def resolve(spec: str) -> DiffusionModel:
    """Resolve ``name`` or ``name:param`` to its instance, one per spec.
    Raises ``ValueError`` where the model's predicate is not one the kernels
    compile in (``fused_predicate``, or ``remix_interval_predicate`` for
    lt)."""
    if not isinstance(spec, str) or not spec:
        raise TypeError(f"diffusion model spec must be a non-empty str, got {spec!r}")
    hit = _RESOLVED.get(spec)
    if hit is not None:
        return hit
    name, sep, param = spec.partition(":")
    factory = _REGISTRY.get(name)
    if factory is None:
        raise KeyError(f"unknown diffusion model {name!r}; registered: {sorted(_REGISTRY)}")
    model = factory(spec, param if sep else None)
    predicate = getattr(model, "predicate", None)
    if predicate not in VARIANTS:
        raise ValueError(
            f"diffusion model {spec!r}: its predicate {predicate!r} is not one the CUDA "
            "kernels compile in; use core.sampling.fused_predicate (threshold models) or "
            "core.sampling.remix_interval_predicate (lt)")
    _RESOLVED[spec] = model
    return model


register_model("wc", _no_param(WeightedCascade))
register_model("ic", lambda spec, param: UniformIC(
    spec, _float_param(param, 0.1, "ic probability")))
register_model("lt", _no_param(LinearThreshold))
register_model("dic", lambda spec, param: DecayingIC(
    spec, _float_param(param, 1.0, "dic decay")))

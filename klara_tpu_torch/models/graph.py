"""Model graph: named variables and dependence edges (counterpart of
klara_tpu/models/graph.py).

Variables are static descriptors; runtime values live in a plain
``{key: tensor}`` dict that a Gibbs sweep threads through the blocks.  User
functions receive that dict batch-first: a value the sweep updates carries a
leading chains axis, every other value is as given (see
``klara_tpu_torch.jobs.gibbs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from klara_tpu_torch.core.target import chain_sum


@dataclasses.dataclass(frozen=True)
class Variable:
    """Graph vertex."""

    key: str

    dotshape = "box"
    is_random = False
    is_dependent = False  # updated during a Gibbs sweep?


@dataclasses.dataclass(frozen=True)
class Constant(Variable):
    """Deterministic root vertex."""

    dotshape = "trapezium"


Hyperparameter = Constant


@dataclasses.dataclass(frozen=True)
class Data(Variable):
    """Observed-data vertex.  ``update(values) -> new value``, if given, is
    applied by GibbsJob at the start of every sweep, before any block; the
    value is then carried per chain."""

    update: Optional[Callable[[Dict[str, Any]], Any]] = None

    dotshape = "box"


@dataclasses.dataclass(frozen=True)
class Transformation(Variable):
    """Deterministic function of parent values."""

    transform: Callable[[Dict[str, Any]], Any] = None

    dotshape = "polygon"
    is_dependent = True


@dataclasses.dataclass(frozen=True)
class GibbsParameter(Variable):
    """Random vertex, with exactly one of:

    * ``setpdf(values) -> Distribution``: the full conditional, drawn
      directly each sweep;
    * ``logtarget(x, values) -> (C,)``: the unnormalised conditional
      log-density of a (C, ...) position, sampled by a nested MCMC block;
      ``loglikelihood``/``logprior`` may be given instead and are summed.

    ``setprior(values) -> Distribution`` optionally gives the prior, which
    ``Nested(reset_from_prior=True)`` draws nested starts from.
    """

    setpdf: Optional[Callable] = None
    logtarget: Optional[Callable] = None
    loglikelihood: Optional[Callable] = None
    logprior: Optional[Callable] = None
    setprior: Optional[Callable] = None

    dotshape = "circle"
    is_random = True
    is_dependent = True

    def conditional_logdensity(self, x, values: Dict[str, Any]):
        """Per-chain (C,) conditional log-density of a (C, ...) position."""
        if self.logtarget is not None:
            return self.logtarget(x, values)
        if self.loglikelihood is not None and self.logprior is not None:
            return self.loglikelihood(x, values) + self.logprior(x, values)
        if self.setpdf is not None:
            return chain_sum(self.setpdf(values).logpdf(x))
        raise ValueError(f"parameter {self.key!r} has no density specification")


Parameter = GibbsParameter


class GenericModel:
    """Lightweight digraph of variables: ``edges`` are (source_key,
    target_key) pairs and ``model[key]`` looks a vertex up."""

    def __init__(
        self,
        vertices: Sequence[Variable],
        edges: Sequence[Tuple[str, str]] = (),
        isdirected: bool = True,
        isindexed: bool = False,
    ):
        self.vertices = list(vertices)
        self.edges = list(edges)
        self.isdirected = isdirected
        self.ofkey = {v.key: i for i, v in enumerate(self.vertices)}
        if len(self.ofkey) != len(self.vertices):
            raise ValueError("duplicate vertex keys")
        for s, t in self.edges:
            if s not in self.ofkey or t not in self.ofkey:
                raise ValueError(f"edge ({s},{t}) references unknown vertex")

    def __getitem__(self, key: str) -> Variable:
        return self.vertices[self.ofkey[key]]

    def __contains__(self, key: str) -> bool:
        return key in self.ofkey

    def add_vertex(self, v: Variable):
        if v.key in self.ofkey:
            raise ValueError(f"duplicate vertex {v.key!r}")
        self.ofkey[v.key] = len(self.vertices)
        self.vertices.append(v)

    def add_edge(self, source: str, target: str):
        self.edges.append((source, target))

    @property
    def parameters(self):
        return [v for v in self.vertices if isinstance(v, GibbsParameter)]

    @property
    def dependents(self):
        """Parameters and Transformations in vertex order: the sweep order."""
        return [v for v in self.vertices if v.is_dependent]

    def parents_of(self, key: str):
        return [s for (s, t) in self.edges if t == key]

    def children_of(self, key: str):
        return [t for (s, t) in self.edges if s == key]

    def to_dot(self, name: str = "model") -> str:
        """Graphviz export."""
        lines = [f"digraph {name} {{"]
        for v in self.vertices:
            lines.append(f'  "{v.key}" [shape={v.dotshape}];')
        for s, t in self.edges:
            lines.append(f'  "{s}" -> "{t}";')
        lines.append("}")
        return "\n".join(lines)


def likelihood_model(variables, isindexed: bool = False) -> GenericModel:
    """Add an edge from every non-parameter to every parameter."""
    if isinstance(variables, Variable):
        variables = [variables]
    edges = [
        (v.key, p.key)
        for v in variables
        if not isinstance(v, GibbsParameter)
        for p in variables
        if isinstance(p, GibbsParameter)
    ]
    return GenericModel(variables, edges, isindexed=isindexed)

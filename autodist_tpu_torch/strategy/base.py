"""Strategy IR: the per-variable distribution plan.

Port of the JAX package's ``strategy/base.py:26-227``.  A Strategy is a
list of per-variable node configs (a synchronizer, PS or AllReduce, plus
an optional partitioner ``"a,b,c"``) and a graph config listing the
replica devices.  ``to_dict`` / ``serialize`` / ``deserialize`` give the
JSON of the JAX package, field for field, so a plan built by either
package reads the same in the other.
"""
from __future__ import annotations

import datetime
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from autodist_tpu_torch.const import DEFAULT_STRATEGY_DIR


@dataclass
class PSSynchronizerConfig:
    """Parameter-server sync: weight-update sharding over ``data``;
    ``staleness`` delays the applied gradient, ``local_replication``
    reads a periodically refreshed proxy copy."""

    reduction_destination: str = ""
    local_replication: bool = False
    sync: bool = True
    staleness: int = 0

    kind: str = "PS"


@dataclass
class AllReduceSynchronizerConfig:
    """All-reduce sync.  ``group`` ids merge consecutive variables into one
    collective group; ``compressor``, ``fused``, ``sync="reduce_scatter"``,
    a non-zero ``bucket_bytes``, an explicit ``overlap`` schedule and
    ``hier`` select the explicit bucketed step."""

    spec: str = "AUTO"
    compressor: str = "NoneCompressor"
    group: int = 0
    fused: bool = False
    sync: str = "all_reduce"
    bucket_bytes: int = 0
    overlap: str = "auto"
    hier: bool = False

    kind: str = "AllReduce"


def _synchronizer_from_dict(d: dict):
    kind = d.get("kind")
    fields = {k: v for k, v in d.items() if k != "kind"}
    if kind == "PS":
        return PSSynchronizerConfig(**fields)
    if kind == "AllReduce":
        return AllReduceSynchronizerConfig(**fields)
    raise ValueError(f"unknown synchronizer kind {kind!r}")


@dataclass
class VarConfig:
    """Per-variable node config."""

    var_name: str
    synchronizer: object = None
    partitioner: str = ""
    part_config: List["VarConfig"] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "var_name": self.var_name,
            "synchronizer": asdict(self.synchronizer)
            if self.synchronizer else None,
            "partitioner": self.partitioner,
            "part_config": [p.to_dict() for p in self.part_config],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VarConfig":
        return cls(
            var_name=d["var_name"],
            synchronizer=_synchronizer_from_dict(d["synchronizer"])
            if d.get("synchronizer") else None,
            partitioner=d.get("partitioner", ""),
            part_config=[cls.from_dict(p) for p in d.get("part_config", [])],
        )


@dataclass
class GraphConfig:
    """Whole-graph config: replica devices and the wanted mesh axes."""

    replicas: List[str] = field(default_factory=list)
    mesh_axes: Dict[str, int] = field(default_factory=dict)


class Strategy:
    """A distribution plan: ``node_config`` per variable + ``graph_config``;
    ids are UTC timestamps, the JAX package's scheme."""

    def __init__(self, node_config: Optional[List[VarConfig]] = None,
                 graph_config: Optional[GraphConfig] = None,
                 strategy_id: Optional[str] = None):
        self.node_config: List[VarConfig] = node_config or []
        self.graph_config: GraphConfig = graph_config or GraphConfig()
        self.id = strategy_id or datetime.datetime.now(
            datetime.timezone.utc).strftime("%Y%m%dT%H%M%SM%f")
        self.path = os.path.join(DEFAULT_STRATEGY_DIR, self.id)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "node_config": [n.to_dict() for n in self.node_config],
            "graph_config": {
                "replicas": list(self.graph_config.replicas),
                "mesh_axes": dict(self.graph_config.mesh_axes),
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Strategy":
        return cls(
            node_config=[VarConfig.from_dict(n) for n in d["node_config"]],
            graph_config=GraphConfig(
                replicas=d["graph_config"].get("replicas", []),
                mesh_axes=d["graph_config"].get("mesh_axes", {})),
            strategy_id=d["id"],
        )

    def serialize(self, path: Optional[str] = None) -> str:
        """Write the JSON so other ranks can load the chief's plan by id."""
        path = path or self.path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def deserialize(cls, strategy_id: str,
                    base_dir: Optional[str] = None) -> "Strategy":
        path = os.path.join(base_dir or DEFAULT_STRATEGY_DIR, strategy_id)
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def node_for(self, var_name: str) -> Optional[VarConfig]:
        """The node config of ``var_name``, or None."""
        for n in self.node_config:
            if n.var_name == var_name:
                return n
        return None


class StrategyBuilder:
    """Maps ``(GraphItem, ResourceSpec) -> Strategy``."""

    def build(self, graph_item, resource_spec) -> Strategy:
        raise NotImplementedError

    @staticmethod
    def replica_devices(resource_spec) -> List[str]:
        """All compute devices: GPUs, or CPUs of GPU-less nodes."""
        return [d.name_string() for d in resource_spec.devices]

    @staticmethod
    def reduction_device_names(resource_spec) -> List[str]:
        """The PS destinations a builder assigns: one per node CPU."""
        return [d.name_string() for d in resource_spec.cpu_devices]

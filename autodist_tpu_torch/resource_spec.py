"""Cluster resource description.

Port of the JAX package's ``resource_spec.py:140-355`` for what this slice
reads: the same yaml/dict schema (``nodes`` with ``address``, ``chips``
per node — the reference's ``gpus`` list is accepted too — ``cpus`` and
``chief``, and an optional ``mesh`` hint), with GPUs as the chips.  With
neither a file nor a dict, one node is derived from the visible CUDA
devices (a CPU-only node when there are none).  ``num_slices`` (the
two-tier topology of ``hier`` sync: slices of equal size, joined by the
slower network) is read and must tile the devices
(``resource_spec.py:122-136, 225-229, 270``).  The keys the cost model
and the analyzer's memory pass read have the JAX package's names, so one
yaml means the same in both packages; on GPUs they mean:

* ``network_bandwidth`` (Gb/s, default 1.0): the host network, as in the
  JAX package;
* ``ici_connected`` (bool): the chips are one NVLink domain (the JAX
  package's ICI), so collectives among them never fall back to the NIC;
* ``dcn_gbps`` (Gb/s): the network between slices, one NIC per GPU
  (:attr:`ResourceSpec.dcn_bytes_per_s` in bytes/s), which prices the
  cross-slice (``dcn``) legs of the two-tier hierarchy;
* ``hbm_gb`` (GiB): the memory of one card
  (:attr:`ResourceSpec.hbm_bytes_per_chip`), the budget of the memory
  pass.

``ssh`` is a later slice's (P12) and is ignored.

Example yaml::

    nodes:
      - address: 10.0.0.1
        chips: 8
        chief: true
    num_slices: 2     # optional: two slices of 4 chips
    dcn_gbps: 400     # optional: one 400 Gb/s NIC per GPU between slices
    hbm_gb: 80        # optional: the memory pass's budget per card
    mesh:
      data: 8
"""
from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class DeviceType(enum.Enum):
    CPU = "CPU"
    GPU = "GPU"


@dataclass(frozen=True)
class DeviceSpec:
    """Device name ``address:GPU:index``."""

    host_address: str
    device_type: DeviceType = DeviceType.GPU
    device_index: int = 0

    def name_string(self) -> str:
        return (f"{self.host_address}:{self.device_type.value}:"
                f"{self.device_index}")


@dataclass
class NodeSpec:
    address: str
    chips: int = 0
    cpus: List[int] = field(default_factory=list)
    chief: bool = False


class ResourceSpecError(ValueError):
    pass


#: the slice/device divisibility rule's name, quoted by the fail-fast
RULE_SLICE_MISMATCH = "legality/slice-mismatch"


def slice_mismatch_reason(num_devices: int, num_slices: int) -> Optional[str]:
    """Why ``num_slices`` cannot tile ``num_devices``, else None: every
    slice must hold the same whole number of chips."""
    if num_slices <= 1:
        return None
    if num_devices <= 0:
        return None  # device count unknown at this point; checked elsewhere
    if num_devices % num_slices != 0:
        return (f"{RULE_SLICE_MISMATCH}: num_slices={num_slices} does not "
                f"divide device count {num_devices}")
    return None


class ResourceSpec:
    """Parsed cluster description from a yaml path, a dict, or the local
    CUDA devices."""

    def __init__(self, resource_file: Optional[str] = None,
                 resource_info: Optional[dict] = None):
        self._nodes: List[NodeSpec] = []
        self.mesh_hint: Dict[str, int] = {}
        #: slices of the two-tier topology (1: one flat slice)
        self.num_slices: int = 1
        self.network_bandwidth_gbps: float = 1.0
        #: the chips are one NVLink domain
        self.ici_connected: bool = False
        #: the network between slices, Gb/s (None: not declared)
        self.dcn_gbps: Optional[float] = None
        #: the memory of one card, GiB (None: no budget declared)
        self.hbm_gb: Optional[float] = None
        if resource_info is None and resource_file is not None:
            if not os.path.exists(resource_file):
                raise ResourceSpecError(
                    f"Resource spec file not found: {resource_file}")
            import yaml   # only a file needs the yaml parser

            with open(resource_file, "r", encoding="utf-8") as f:
                resource_info = yaml.safe_load(f)
        if resource_info is not None:
            self._parse(resource_info)
        else:
            self._from_local_devices()
        self._validate()

    def _parse(self, info: dict) -> None:
        nodes = info.get("nodes")
        if not nodes:
            raise ResourceSpecError(
                "resource spec must contain a non-empty 'nodes' list")
        for raw in nodes:
            if "address" not in raw:
                raise ResourceSpecError(
                    f"node entry missing 'address': {raw}")
            chips = int(raw.get("chips", raw.get("tpus", 0)) or 0)
            if not chips and raw.get("gpus"):
                chips = len(raw["gpus"])
            self._nodes.append(NodeSpec(
                address=str(raw["address"]), chips=chips,
                cpus=[int(c) for c in raw.get("cpus", [])],
                chief=bool(raw.get("chief", False))))
        self.network_bandwidth_gbps = float(info.get("network_bandwidth", 1.0))
        self.ici_connected = bool(info.get("ici_connected", False))
        if info.get("num_slices") is not None:
            self.num_slices = int(info["num_slices"])
            if self.num_slices < 1:
                raise ResourceSpecError(
                    f"num_slices must be >= 1, got {self.num_slices}")
        if info.get("dcn_gbps") is not None:
            self.dcn_gbps = float(info["dcn_gbps"])
            if self.dcn_gbps <= 0:
                raise ResourceSpecError(
                    f"dcn_gbps must be positive, got {self.dcn_gbps}")
        if info.get("hbm_gb") is not None:
            self.hbm_gb = float(info["hbm_gb"])
            if self.hbm_gb <= 0:
                raise ResourceSpecError(
                    f"hbm_gb must be positive, got {self.hbm_gb}")
        self.mesh_hint = {str(k): int(v)
                          for k, v in (info.get("mesh") or {}).items()}
        if len(self._nodes) == 1:
            self._nodes[0].chief = True

    def _from_local_devices(self) -> None:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        self._nodes = [NodeSpec(address="localhost", chips=n, chief=True)]

    def _validate(self) -> None:
        chiefs = [n for n in self._nodes if n.chief]
        if len(chiefs) != 1:
            raise ResourceSpecError(
                f"resource spec must designate exactly one chief node, got "
                f"{len(chiefs)}")
        seen = set()
        for n in self._nodes:
            if n.address in seen:
                raise ResourceSpecError(f"duplicate node address {n.address}")
            seen.add(n.address)
            if n.chips == 0 and not n.cpus:
                n.cpus = [0]
        reason = slice_mismatch_reason(self.num_chips, self.num_slices)
        if reason is not None:
            raise ResourceSpecError(reason)

    @property
    def nodes(self) -> List[NodeSpec]:
        return list(self._nodes)

    @property
    def num_nodes(self) -> int:
        return len(self._nodes)

    @property
    def chief(self) -> str:
        return next(n.address for n in self._nodes if n.chief)

    @property
    def num_chips(self) -> int:
        return sum(n.chips for n in self._nodes)

    @property
    def dcn_bytes_per_s(self) -> Optional[float]:
        """The declared network between slices in bytes/s (None when the
        spec carries none): the constant of the ``dcn`` legs before any
        fitted calibration exists."""
        if self.dcn_gbps is None:
            return None
        return self.dcn_gbps * 1e9 / 8.0

    @property
    def hbm_bytes_per_chip(self) -> Optional[int]:
        """The declared memory of one card in bytes (None when the spec
        carries none): the memory pass's default budget."""
        if self.hbm_gb is None:
            return None
        return int(self.hbm_gb * (1 << 30))

    @property
    def cpu_devices(self) -> List[DeviceSpec]:
        """Each node's CPUs (``[0]`` when it lists none): the PS
        builders' reduction destinations."""
        return [DeviceSpec(n.address, DeviceType.CPU, i)
                for n in self._nodes for i in (n.cpus or [0])]

    @property
    def devices(self) -> List[DeviceSpec]:
        """Replica devices: each node's GPUs, or its CPUs when it has
        none."""
        out: List[DeviceSpec] = []
        for n in self._nodes:
            if n.chips:
                out.extend(DeviceSpec(n.address, DeviceType.GPU, i)
                           for i in range(n.chips))
            else:
                out.extend(DeviceSpec(n.address, DeviceType.CPU, i)
                           for i in n.cpus)
        return out

"""Charging-station electrical architecture (paper §4 "EV Station Layout", Fig. 3).

The station is a tree: the root is the grid connection, internal nodes are
splitter/transformer/cable assemblies with a maximum current ``I_H`` and an
efficiency ``eta_H``, and leaves are EVSEs (charging ports).

TPU adaptation (DESIGN.md §3): the pointer tree is flattened at construction
time into dense arrays —

  * ``member``       (n_nodes, n_evse) 0/1 — leaf j lies in the subtree of node i
  * ``node_limit``   (n_nodes,)  max current I_H [A]
  * ``node_eff``     (n_nodes,)  efficiency eta_H in (0, 1]
  * per-EVSE vectors (voltage, I_max, efficiency, is_dc)

so that the Eq. 5 constraint check becomes two matmuls and a min-reduce.
All arrays are materialised as numpy at build time; the environment converts
them to torch tensors.

This module is a copy of the JAX package's ``repro.core.station`` (numpy
only), kept here so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Effective voltages (paper: the voltage "already encodes the phases",
# i.e. it stands for V * sqrt(phi)).  AC: 3-phase 400V line-to-line at 16A
# -> sqrt(3)*400*16 ~= 11.1 kW.  DC fast charger: 500 V at 300 A -> 150 kW.
AC_VOLTAGE = float(np.sqrt(3) * 400.0)  # ~692.8 "effective" volts
DC_VOLTAGE = 500.0
AC_MAX_CURRENT = 16.0
DC_MAX_CURRENT = 300.0


@dataclasses.dataclass
class EVSE:
    """A charging port (leaf of the station tree)."""

    voltage: float = AC_VOLTAGE  # effective volts (encodes phases)
    max_current: float = AC_MAX_CURRENT  # amps
    efficiency: float = 0.95
    is_dc: bool = False

    @property
    def max_power_kw(self) -> float:
        return self.voltage * self.max_current / 1000.0


def ac_evse(efficiency: float = 0.95) -> EVSE:
    return EVSE(AC_VOLTAGE, AC_MAX_CURRENT, efficiency, is_dc=False)


def dc_evse(efficiency: float = 0.95) -> EVSE:
    return EVSE(DC_VOLTAGE, DC_MAX_CURRENT, efficiency, is_dc=True)


@dataclasses.dataclass
class Node:
    """Internal node: splitter/transformer/cable assembly with a current cap."""

    max_current: float
    efficiency: float = 1.0
    children: Sequence["Node | EVSE"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BatteryConfig:
    """Optional station battery (modelled like an EVSE; paper §4)."""

    enabled: bool = True
    voltage: float = 800.0
    max_current: float = 250.0  # -> 200 kW
    capacity_kwh: float = 400.0
    efficiency: float = 0.97
    tau: float = 0.8  # bulk->absorption transition point of the charge curve
    init_soc: float = 0.5


@dataclasses.dataclass(frozen=True)
class StationLayout:
    """Flattened station architecture (static arrays, see module docstring)."""

    n_evse: int
    n_nodes: int
    member: np.ndarray  # (n_nodes, n_evse) float32 0/1
    node_limit: np.ndarray  # (n_nodes,) amps
    node_eff: np.ndarray  # (n_nodes,)
    evse_voltage: np.ndarray  # (n_evse,) effective volts
    evse_max_current: np.ndarray  # (n_evse,) amps
    evse_eff: np.ndarray  # (n_evse,) port efficiency
    evse_path_eff: np.ndarray  # (n_evse,) product of efficiencies root->leaf
    evse_is_dc: np.ndarray  # (n_evse,) float32 0/1
    battery: BatteryConfig
    # 0/1 per EVSE: 0 marks a padding lane added by :func:`pad_layout` so
    # heterogeneous stations can share one array shape (FleetEnv).  ``None``
    # means "all real" (the common single-station case).
    evse_mask: np.ndarray | None = None

    @property
    def evse_max_power_kw(self) -> np.ndarray:
        return self.evse_voltage * self.evse_max_current / 1000.0

    @property
    def mask(self) -> np.ndarray:
        """(n_evse,) float32 0/1 validity mask (ones when unpadded)."""
        if self.evse_mask is None:
            return np.ones(self.n_evse, dtype=np.float32)
        return self.evse_mask


def flatten_tree(root: Node, battery: BatteryConfig | None = None) -> StationLayout:
    """Flatten a station tree into the dense arrays used by the simulator."""
    leaves: list[EVSE] = []
    nodes: list[Node] = []
    # (node_index, leaf_indices) accumulated during DFS
    node_members: list[list[int]] = []
    leaf_path_eff: list[float] = []

    def dfs(n: Node | EVSE, path_eff: float) -> list[int]:
        if isinstance(n, EVSE):
            leaves.append(n)
            leaf_path_eff.append(path_eff * n.efficiency)
            return [len(leaves) - 1]
        nodes.append(n)
        my_idx = len(nodes) - 1
        node_members.append([])  # placeholder, filled after children
        mine: list[int] = []
        for c in n.children:
            mine.extend(dfs(c, path_eff * n.efficiency))
        node_members[my_idx] = mine
        return mine

    dfs(root, 1.0)
    n_evse, n_nodes = len(leaves), len(nodes)
    if n_evse == 0:
        raise ValueError("station tree has no EVSE leaves")

    member = np.zeros((n_nodes, n_evse), dtype=np.float32)
    for i, mem in enumerate(node_members):
        member[i, mem] = 1.0

    return StationLayout(
        n_evse=n_evse,
        n_nodes=n_nodes,
        member=member,
        node_limit=np.array([n.max_current for n in nodes], dtype=np.float32),
        node_eff=np.array([n.efficiency for n in nodes], dtype=np.float32),
        evse_voltage=np.array([l.voltage for l in leaves], dtype=np.float32),
        evse_max_current=np.array([l.max_current for l in leaves], dtype=np.float32),
        evse_eff=np.array([l.efficiency for l in leaves], dtype=np.float32),
        evse_path_eff=np.array(leaf_path_eff, dtype=np.float32),
        evse_is_dc=np.array([float(l.is_dc) for l in leaves], dtype=np.float32),
        battery=battery or BatteryConfig(enabled=False),
    )


# ---------------------------------------------------------------------------
# Padding to a common shape (FleetEnv: heterogeneous stations in one vmap)
# ---------------------------------------------------------------------------
# Padding a station must be a *no-op* for the dynamics of its real lanes:
#   * padded EVSE columns are all-zero in ``member`` so they never load a node,
#   * padded lanes carry ``evse_mask == 0`` so arrivals skip them — they stay
#     unoccupied forever and their current is forced to 0 by the occupancy
#     gate in ``apply_actions``,
#   * padded nodes get an effectively-infinite budget so ``constraint_scale``
#     treats them as unconstrained,
#   * electrical constants are padded with 1.0 (not 0.0) so normalisations
#     like ``current / I_max`` in the observation stay finite.
_PAD_NODE_BUDGET = 1e9


def pad_layout(layout: StationLayout, n_evse: int, n_nodes: int) -> StationLayout:
    """Pad ``layout`` to ``(n_nodes, n_evse)`` with inert lanes/nodes."""
    if n_evse < layout.n_evse or n_nodes < layout.n_nodes:
        raise ValueError(
            f"cannot pad {layout.n_nodes}x{layout.n_evse} down to {n_nodes}x{n_evse}"
        )
    if n_evse == layout.n_evse and n_nodes == layout.n_nodes:
        return layout
    pe, pn = n_evse - layout.n_evse, n_nodes - layout.n_nodes

    def pad1(x: np.ndarray, k: int, value: float) -> np.ndarray:
        return np.concatenate([x, np.full(k, value, dtype=x.dtype)])

    member = np.zeros((n_nodes, n_evse), dtype=np.float32)
    member[: layout.n_nodes, : layout.n_evse] = layout.member
    return dataclasses.replace(
        layout,
        n_evse=n_evse,
        n_nodes=n_nodes,
        member=member,
        node_limit=pad1(layout.node_limit, pn, _PAD_NODE_BUDGET),
        node_eff=pad1(layout.node_eff, pn, 1.0),
        evse_voltage=pad1(layout.evse_voltage, pe, 1.0),
        evse_max_current=pad1(layout.evse_max_current, pe, 1.0),
        evse_eff=pad1(layout.evse_eff, pe, 1.0),
        evse_path_eff=pad1(layout.evse_path_eff, pe, 1.0),
        evse_is_dc=pad1(layout.evse_is_dc, pe, 0.0),
        evse_mask=pad1(layout.mask, pe, 0.0),
    )


# ---------------------------------------------------------------------------
# Bundled architectures (Table 1: "Simple: Single Charger Type",
# "Simple: Multiple Charger Types", custom trees per Fig. 3)
# ---------------------------------------------------------------------------
def single_charger_type(
    n_chargers: int = 16,
    dc: bool = False,
    grid_limit_frac: float = 0.7,
    battery: BatteryConfig | None = None,
) -> StationLayout:
    """Fig. 3a: one splitter, one charger type.

    ``grid_limit_frac`` sets the root current cap as a fraction of the sum of
    the port maxima (i.e. the grid connection is deliberately undersized, which
    is what makes current scheduling a non-trivial problem).
    """
    mk = dc_evse if dc else ac_evse
    ports = [mk() for _ in range(n_chargers)]
    limit = grid_limit_frac * sum(p.max_current for p in ports)
    root = Node(max_current=limit, efficiency=0.98, children=ports)
    return flatten_tree(root, battery)


def multi_charger_type(
    n_dc: int = 10,
    n_ac: int = 6,
    grid_limit_frac: float = 0.7,
    type_limit_frac: float = 0.85,
    battery: BatteryConfig | None = None,
) -> StationLayout:
    """Fig. 3b: one splitter per charger type under a shared grid connection.

    Default (10 DC, 6 AC) matches the paper's 16-charger experimental station.
    """
    dcs = [dc_evse() for _ in range(n_dc)]
    acs = [ac_evse() for _ in range(n_ac)]
    dc_node = Node(
        max_current=type_limit_frac * sum(p.max_current for p in dcs),
        efficiency=0.99,
        children=dcs,
    )
    ac_node = Node(
        max_current=type_limit_frac * sum(p.max_current for p in acs),
        efficiency=0.99,
        children=acs,
    )
    total = dc_node.max_current + ac_node.max_current
    root = Node(
        max_current=grid_limit_frac * total, efficiency=0.98, children=[dc_node, ac_node]
    )
    return flatten_tree(root, battery)


def deep_split(
    n_groups: int = 4,
    chargers_per_group: int = 4,
    dc: bool = True,
    grid_limit_frac: float = 0.6,
    group_limit_frac: float = 0.8,
    battery: BatteryConfig | None = None,
) -> StationLayout:
    """Fig. 3c: multiple splitters per type, imposing nested current limits."""
    mk = dc_evse if dc else ac_evse
    groups = []
    for _ in range(n_groups):
        ports = [mk() for _ in range(chargers_per_group)]
        groups.append(
            Node(
                max_current=group_limit_frac * sum(p.max_current for p in ports),
                efficiency=0.99,
                children=ports,
            )
        )
    total = sum(g.max_current for g in groups)
    root = Node(max_current=grid_limit_frac * total, efficiency=0.98, children=groups)
    return flatten_tree(root, battery)


ARCHITECTURES = {
    "single_ac_16": lambda **kw: single_charger_type(16, dc=False, **kw),
    "single_dc_16": lambda **kw: single_charger_type(16, dc=True, **kw),
    "paper_16": lambda **kw: multi_charger_type(10, 6, **kw),
    "mixed_8_8": lambda **kw: multi_charger_type(8, 8, **kw),
    "deep_4x4": lambda **kw: deep_split(4, 4, **kw),
    # smaller sites: varying n_evse/n_nodes exercises FleetEnv shape padding
    "single_dc_8": lambda **kw: single_charger_type(8, dc=True, **kw),
    "kiosk_ac_4": lambda **kw: single_charger_type(4, dc=False, **kw),
    "deep_2x4": lambda **kw: deep_split(2, 4, **kw),
}

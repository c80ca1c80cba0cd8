"""Device mesh + sharding layout for the routing data plane.

The reference scales out with mria replication + gen_rpc forwarding
(SURVEY.md §2.5); the device equivalents are collectives over the cards'
links.  Axis mapping (broker → mesh):

- ``dp``  (data/batch): the publish-topic batch dimension B. Matching is
  embarrassingly parallel across topics — the analogue of EMQX's
  connection/worker-pool parallelism (§2.5-1/2).
- ``tp``  (fan-out/tensor): the subscriber-bitmap word dimension W.
  Fan-out over 10M+ subscribers is a bitmap-OR whose bandwidth scales
  linearly with tp — the analogue of subscriber sharding at >1024 subs
  (emqx_broker_helper.erl:55,82-92).
- ``sp``  (sequence): topic depth L is walked sequentially inside the
  kernel — intentionally NOT sharded: L ≤ 16 while B is thousands, so the
  parallel win lives on dp/tp (this is the design answer to
  ring/Ulysses-style sequence parallelism for this workload).
- ``sub`` (subscription space): the trie supports TWO layouts.
  *Replicated* (the v1 decision, still the TrieIndex default — the
  reference's full route-table replication per node,
  emqx_router.erl:148-153): matching is local, only fan-out shards.
  *Sharded* (ShardedTrieIndex): the fid space partitions into S
  per-shard tries stacked into [S, ...] buffers whose shard axis rides
  ``tp`` (``trie_sub`` below) — each device holds only its subscription
  slice, so 10M-filter HBM residency and match bandwidth both scale
  with tp instead of being a single card's problem.

During a replicated-trie step, match runs with B sharded over BOTH axes
(dp×tp — full data parallelism), then matched fids gather along tp to
dp-only so the bitmap-OR can run with W sharded over tp.  During a
SHARDED-trie step the batch is dp-only (tp-replicated — every shard sees
every topic); each shard matches + compacts its slice in place, and the
tp gather moves the [B, S·M] merged compacted-fid tensor before the same
tp-sharded bitmap-OR.  Either way the collective moves only compacted
fids, never candidate blocks or bitmaps.

One process drives every device of the mesh (the reference's single
controller): a mesh is a ``[dp, tp]`` array of ``torch.device``, and a
:class:`Sharding` says which mesh axes split which tensor dimension and
cuts a host tensor into the piece each device holds.  A device may repeat
(the CPU eight times, or one card four times): every piece is then a
copy of its own, so each position of the mesh holds what a device of its
own would.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

DP = "dp"
TP = "tp"


class Mesh:
    """A ``[dp, tp]`` array of ``torch.device`` with axis names
    ``("dp", "tp")``.  ``shape`` maps each axis name to its extent
    (``mesh.shape[TP]``), ``devices`` is the numpy object array, and
    ``device_type`` the one type every device has ("cuda" or "cpu")."""

    axis_names = (DP, TP)

    def __init__(self, devices: np.ndarray) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty [dp, tp] array of "
                             f"devices, got shape {devices.shape}")
        types = {d.type for d in devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted(types)}")
        self.devices = devices
        self.device_type = types.pop()
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def positions(self) -> list[tuple[int, int]]:
        """The mesh positions ``(i, j)``, dp-major."""
        dp, tp = self.devices.shape
        return [(i, j) for i in range(dp) for j in range(tp)]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (dp, tp) mesh. Default split: tp = min(4, largest pow2 divisor).

    ``devices`` defaults to the visible cards (``cuda:0 … cuda:k-1``);
    with no card and no ``devices`` this raises — it never falls back to
    the CPU.  ``devices`` may repeat a device; mixing device types
    raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[torch.device("
                "'cpu')] * n for a mesh of the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = devices[:n]
    if shape is None:
        tp = math.gcd(n, 4)
        shape = (n // tp, tp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape))


@dataclass(frozen=True)
class Sharding:
    """Which mesh axes split which tensor dimension: ``spec[d]`` is None
    (dimension d replicated), an axis name, or a tuple of axis names (the
    dimension split over their product, the first axis major).
    Dimensions past the spec are replicated."""

    mesh: Mesh
    spec: tuple

    def _axes(self, d: int) -> tuple:
        a = self.spec[d] if d < len(self.spec) else None
        return () if a is None else (a,) if isinstance(a, str) else tuple(a)

    def slices(self, shape: Sequence[int], i: int, j: int) -> tuple:
        """The index of mesh position ``(i, j)``'s piece of a tensor of
        ``shape``; raises where a split dimension does not divide evenly
        (as the reference's ``device_put`` does)."""
        coord = {DP: i, TP: j}
        out = []
        for d, n in enumerate(shape):
            axes = self._axes(d)
            parts = math.prod(self.mesh.shape[a] for a in axes)
            if n % parts:
                raise ValueError(
                    f"dimension {d} of size {n} does not split evenly over "
                    f"the mesh axes {axes} ({parts} parts)")
            k = 0
            for a in axes:
                k = k * self.mesh.shape[a] + coord[a]
            step = n // parts
            out.append(slice(k * step, (k + 1) * step))
        return tuple(out)

    def split(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        """``x`` cut into each position's piece, a contiguous copy on that
        position's device: ``pieces[i][j]``."""
        return [[x[self.slices(x.shape, i, j)].contiguous().to(
                    self.mesh.devices[i, j], copy=True)
                 for j in range(self.mesh.shape[TP])]
                for i in range(self.mesh.shape[DP])]


def router_shardings(mesh: Mesh) -> dict[str, Sharding]:
    """The shardings of the routing step's operands."""

    def s(*spec):
        return Sharding(mesh, spec)

    return {
        "replicated": s(),
        "batch_full": s((DP, TP)),       # tokens/lengths/sys: B over dp×tp
        "batch_dp": s(DP),               # fids after the gather: B over dp
        "bitmaps": s(None, TP),          # [F, W]: W over tp, F replicated
        "fanout_out": s(DP, TP),         # [B, W] result tiles
        "trie_sub": s(TP),               # stacked trie [S, ...]: S over tp
    }

"""Mesh co-evaluation group: the serving tier's device-
placement plan for one batch spanning every host.

Counterpart of ``dcf_tpu/serve/meshgroup.py``: the same plans for the
same workers and batch sizes (``tests/test_torch_mesh.py``).

The pod has two orthogonal placements, and this module exists to keep
them separate:

* the **ring** (``serve.shardmap``) places KEYS: rendezvous hashing
  decides which host owns which key, and route-mode dispatch sends a
  request to its key's owner — one host, one key;
* the **mesh** (this module) places DEVICES: a co-evaluated batch is
  split into contiguous point slices, one per mesh worker, every
  worker evaluates the SAME key over its slice, and the router
  concatenates the shares back in plan order — all hosts, one batch.

``MeshGroup`` is the mesh analogue of ``ShardMap`` and follows its
discipline: pure placement — no sockets, no health state (the router
owns suspicion and degradation), no clocks — and immutable, so an
in-flight co-evaluation keeps the plan it started with while the
router re-forms the group.  Formation is EPOCH-FENCED: a group remembers the ring epoch it was formed under, and
the router refuses to scatter over a group whose epoch trails the
current ring — membership moved, the worker set may be stale, the
group must be re-formed (``MeshUnavailableError`` / degrade to
route-mode, never a scatter onto ejected hosts).

Slices are 32-point aligned: the shard batcher packs points into
32-lane words, so a misaligned split would force every worker after
the first into a re-pack of its whole slice — alignment keeps the
zero-copy relay intact across the scatter.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MeshGroup", "MeshSlice"]

# The batcher's lane-word width: co-evaluate slice boundaries land on
# multiples of it so every scattered sub-view stays pack-aligned.
SLICE_ALIGN = 32


@dataclass(frozen=True)
class MeshSlice:
    """One worker's contiguous share of a co-evaluated batch:
    ``count`` points starting at ``offset`` of the caller's order
    (gather concatenates the slices back in this order)."""

    host_id: str
    offset: int
    count: int


class MeshGroup:
    """Immutable co-evaluation group over a set of worker host ids.

    ``host_ids``: the ring members that take scattered slices — stored
    sorted, same set-not-list discipline as ``ShardMap`` (two routers
    forming the group from the same members agree on the plan).
    ``epoch``: the ring epoch at formation — the fence the router
    checks before every scatter."""

    def __init__(self, host_ids, *, epoch: int = 0):
        ids = tuple(host_ids)
        if not ids:
            # api-edge: mesh membership contract — an empty group has
            # nobody to scatter to; the router clears the group instead
            raise ValueError("a mesh group needs at least one worker")
        if len(set(ids)) != len(ids):
            # api-edge: mesh membership contract — a duplicated worker
            # would be handed two slices of the same batch
            raise ValueError(f"duplicate mesh worker host_ids in "
                             f"{list(ids)}")
        self._ids = tuple(sorted(ids))
        self._epoch = int(epoch)

    @property
    def epoch(self) -> int:
        return self._epoch

    def host_ids(self) -> list[str]:
        return list(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, host_id: str) -> bool:
        return host_id in self._ids

    def plan(self, m: int) -> list[MeshSlice]:
        """Split an ``m``-point batch into per-worker slices.

        Contiguous, in worker (sorted host_id) order, every boundary a
        multiple of ``SLICE_ALIGN`` except the batch end; lane words
        are dealt round-robin-evenly (first workers take the remainder
        word), and a worker whose share rounds to zero words takes no
        slice — a 17-point batch over 8 workers is ONE slice, not
        seven empty scatters."""
        if m < 1:
            # api-edge: plan contract — the router validates payloads
            # before planning, so an empty plan is a caller bug
            raise ValueError(f"cannot plan a {m}-point batch")
        words = -(-m // SLICE_ALIGN)
        n = len(self._ids)
        base, rem = divmod(words, n)
        slices: list[MeshSlice] = []
        offset = 0
        for i, host_id in enumerate(self._ids):
            w = base + (1 if i < rem else 0)
            if w == 0:
                continue
            count = min(w * SLICE_ALIGN, m - offset)
            if count <= 0:
                break
            slices.append(MeshSlice(host_id, offset, count))
            offset += count
        return slices

    def __repr__(self) -> str:
        return f"MeshGroup({list(self._ids)}, epoch={self._epoch})"
